'''
Engine of the port: input DSL parsing, embed-type decision and the
pipeline stages (counterpart of tscode_tpu/embedder.py).

Ported: parsing, pairings, keywords, every embed (the string embed; the
cyclical embed of two or three molecules and the chelotropic embed,
non-rigid, which bends molecules on the internal force field, or RIGID;
the monomolecular embed, which bends one molecule; the multiembed, which
docks every arrangement of the reactive atoms of two polyfunctional
molecules) and the refine route of REFINE or refine>, which takes an
ensemble as the structures; the operators (operators.operate), run
before the embed; the compenetration stage (kernel K2 where the fragment
sizes are known), the fitness stage, the similarity prunes (TFD, MOI,
and the bucketed RMSD prune with kernel K3 and the symmetry-corrected
RMSD prune), the optimisation stages on the external calculators
(force-field pre-optimisation, loose and tight; semiempirical/DFT loose
and tight, ORCA's three-step schedule; each followed by the prunes),
metadynamics augmentation, the csearch augmentation routine, saddle
refinement (SADDLE/TS) and the NCI report, structure writes, the run
report and resume after any of the seven stages; and the data runs of
scan>, neb>, saddle>, mep_relax>, automep> and pka>, which end with their
data (data_termination).

The calculators run as subprocesses on a thread pool
(calculators.dispatch); no torch op runs inside a job. Without a
calculator an input that optimises raises the JAX package's InputError
(optimization._no_calc_error) once the candidates are pruned.

The conformer searches draw their random numbers from `rng`, an
np.random.RandomState given to the constructor (unseeded when none is
given, as numpy's global generator is for the JAX package).

The device and dtype are explicit: `Embedder(filename, device='cuda')`
raises when there is no card, and the dtype defaults to float32 on CUDA
and float64 on the CPU; the stages' energies and masks are float64 and
the internal-force-field saddle refinement runs in float64 whatever the
dtype. Termination returns instead of exiting, so the engine is usable
as a library (the CLI wraps it).
'''

import json
import logging
import math
import os
import pickle
import random
import re
import sys
import time
from collections import Counter
from copy import deepcopy

import numpy as np
import torch

from tscode_tpu_torch.errors import (InputError, SegmentedGraphError,
                                     ZeroCandidatesError)
from tscode_tpu_torch.graphs import get_quadruplets, get_sum_graph, graphize
from tscode_tpu_torch.io_xyz import write_xyz
from tscode_tpu_torch.molecule import Molecule, align_by_moi, align_structures
from tscode_tpu_torch.options import KEYWORDS, Options, OptionSetter
from tscode_tpu_torch.orbitals import get_atom_builder
from tscode_tpu_torch.pt import SYMBOLS
from tscode_tpu_torch.quotes import quotes
from tscode_tpu_torch.references import references
from tscode_tpu_torch.settings import DEFAULT_LEVELS
from tscode_tpu_torch.utils import (auto_newline, clean_directory,
                              saturation_check, time_to_string)
from tscode_tpu_torch import __version__
from tscode_tpu_torch.backend import default_dtype, get_device, span
from tscode_tpu_torch.embeds.cyclical import cyclical_embed
from tscode_tpu_torch.embeds.monomolecular import monomolecular_embed
from tscode_tpu_torch.embeds.string import string_embed
from tscode_tpu_torch.multiembed import multiembed_dispatcher
from tscode_tpu_torch.ops.clash import (count_intra_clashes_np,
                                        cross_fragment_pair_mask)
from tscode_tpu_torch.ops.kernels.clash import compenetration_mask_kernel
from tscode_tpu_torch.ops.linalg import cartesian_product, rmsd_and_max
from tscode_tpu_torch.ops.moi import prune_by_moment_of_inertia
from tscode_tpu_torch.ops.rmsd_prune import prune_conformers_rmsd
from tscode_tpu_torch.ops.tfd import prune_conformers_tfd
from tscode_tpu_torch.parallel.sharding import (get_default_mesh, mesh_for,
                                                sharded_compenetration_mask)
from tscode_tpu_torch.pivots import set_pivots
from tscode_tpu_torch.rot_rmsd import prune_conformers_rmsd_rot_corr
from tscode_tpu_torch.torsions import csearch


class Embedder:
    '''Set-up state machine: parses the input file, loads molecules,
    reads pairings, applies keywords and decides the embed type.'''

    def __init__(self, filename, stamp=None, procs=None, threads=None,
                 run_in_place=False, *, device, dtype=None, rng=None):
        self.device = get_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.rng = rng if rng is not None else np.random.RandomState()
        self.t_start_run = time.perf_counter()
        if not run_in_place:
            d = os.path.dirname(os.path.abspath(filename))
            os.chdir(d)
            filename = os.path.basename(filename)

        self.stamp = stamp if stamp is not None else \
            time.ctime().replace(' ', '_').replace(':', '-')[4:-8]

        self.avail_cpus = len(os.sched_getaffinity(0))
        self.threads = int(threads) if threads is not None else \
            max(self.avail_cpus // 4, 1)
        self.procs = int(procs) if procs is not None else 4

        log_filename = f'tscode_{self.stamp}.log'
        try:
            os.remove(log_filename)
        except FileNotFoundError:
            pass
        self.logfile = open(log_filename, 'a', buffering=1, encoding='utf-8')

        try:
            self.write_banner_and_info()

            self.options = Options()
            self.embed = None
            self.warnings = []
            self.pairing_dists = {}

            inp = self._parse_input(filename)
            self.objects = [Molecule(name, c_ids, attrs=attrs)
                            for name, c_ids, attrs in inp]
            self.ids = np.array([mol.n_atoms for mol in self.objects])
            self.graphs = [mol.graph for mol in self.objects]

            self._read_pairings()
            self.check_objects_compenetration()
            self.check_saturation()
            self._set_options(filename)
            self._calculator_setup()
            self._print_references()
            self._apply_operators()
            self._setup()

            if self.options.debug:
                for mol in self.objects:
                    if mol.reactive_atoms and len(mol.reactive_atoms[0]) > 0:
                        mol.write_hypermolecule()
                        self.log(f'--> DEBUG: written hypermolecule file '
                                 f'for ({mol.name})')
                self.log()

            if self.options.check_structures:
                self._inspect_structures()

        except SystemExit:
            raise
        except Exception as e:
            logging.exception(e)
            self.logfile.close()
            raise

    def _inspect_structures(self):
        '''CHECK keyword: write every molecule's hypermolecule file
        (conformers plus orbital lobes as X dummy atoms), then exit.'''
        self.log('--> Structures check requested. Writing hypermolecule '
                 'files and shutting down.\n')
        for mol in self.objects:
            if mol.reactive_atoms and len(mol.reactive_atoms[0]) > 0:
                name = mol.write_hypermolecule()
                self.log(f'    {mol.name}: orbital geometry written to '
                         f'{name}')
            else:
                self.log(f'    {mol.name}: no reactive atoms - nothing '
                         f'to inspect')
        sys.exit()

    # ------------------------------------------------------------ logging

    def log(self, string='', p=True):
        if p:
            print(string)
        self.logfile.write(str(string) + '\n')

    def write_banner_and_info(self):
        banner = (
            '\n'
            '  ================================================================\n'
            '   tscode_tpu_torch - Transition State Conformational Docker\n'
            '   (PyTorch + CUDA port)\n'
            f'   version {__version__:<12} | device {str(self.device):<8} '
            f'| dtype {str(self.dtype).split(".")[-1]:<8}\n'
            f'   procs {self.procs:<4} | threads {self.threads:<4} '
            f'| cpus {self.avail_cpus:<4}\n'
            f'   {time.ctime()[0:-8]}\n'
            '  ================================================================\n')
        self.log(banner)

    # ------------------------------------------------------------ parsing

    def _echo_input(self, filename, raw_lines):
        '''Render the input file into the log, framed and line-numbered.'''
        body = [line.rstrip('\n') for line in raw_lines]
        width = max(map(len, body), default=0)
        frame = '    ' + '=' * (width + 8)
        self.log(f'--> Input file: {filename}\n')
        self.log(frame)
        for num, text in enumerate(body, start=1):
            self.log(f'{num:>3} |  {text:<{width}}  |')
        self.log(frame + '\n')

    @staticmethod
    def _reactive_indices_of(fragments):
        '''Bare reactive indices from letter-tagged fragments like
        ["2a", "5b", "7"]. A letter appearing on two fragments of the
        SAME line marks an internal constraint, whose indices are not
        reactive.'''
        parsed = [(int(re.sub(r'\D', '', frag)),
                   re.sub(r'[^A-Za-z]', '', frag)) for frag in fragments]
        tag_uses = Counter(tag for _, tag in parsed if tag)
        return tuple(idx for idx, tag in parsed
                     if tag_uses.get(tag, 0) <= 1)

    def _parse_input(self, filename):
        '''Input DSL: an optional keyword line, then one molecule line
        each: `op1> op2> file.xyz 2a 5b k=v`.
        Returns [(filename, reactive_indices, attrs)].'''
        with open(filename, 'r') as f:
            raw_lines = f.readlines()

        self._echo_input(filename, raw_lines)

        # drop comments/blanks; allow "DIST(a=1.8, b=2.0)"-style spaces
        lines = [line.replace(', ', ',') for line in raw_lines
                 if line[0] not in ('#', '\n')]

        try:
            # the first line is a keyword line iff any token's stem
            # (before any '=' or '(') is a known keyword
            first_stems = (re.split(r'[=(]', tok, maxsplit=1)[0].upper()
                           for tok in lines[0].split())
            if any(stem in KEYWORDS for stem in first_stems):
                self.kw_line, *self.mol_lines = lines
            else:
                self.kw_line = ''
                self.mol_lines = lines

            inp = []
            for _l, line in enumerate(self.mol_lines):
                if '>' in line:
                    # nested operators apply right-to-left
                    *ops, line = (part.strip()
                                  for part in line.rstrip('\n').split('>'))
                    self.options.operators_dict[_l] = list(reversed(ops))
                    self.options.operators.append(
                        self.mol_lines[_l].rstrip('\n'))

                molname, *fragments = line.split()
                attrs = {}
                reactive = []
                for frag in fragments:
                    if '=' in frag:
                        key, eq, value = frag.partition('=')
                        if not key or not value or '=' in value:
                            raise InputError(
                                f"Error reading attribute '{frag}'. "
                                f"Syntax: 'var=value'")
                        attrs[key] = value
                    else:
                        reactive.append(frag)

                reactive_indices = (self._reactive_indices_of(reactive)
                                    if reactive else None)
                inp.append((molname, reactive_indices, attrs))
            return inp

        except InputError:
            raise
        except Exception as e:
            print(e)
            raise InputError(
                f'Error in reading molecule input for {filename}. '
                f'Please check your syntax.')

    # one molecule-line fragment: an atom index plus optional letter tags
    _TAGGED_INDEX = re.compile(r'(\d+)([A-Za-z]*)\Z')

    def _read_pairings(self):
        '''Letter pairings (a-z interactions, A-Z fixed, x/y/z NCI) from
        molecule lines, in global (concatenated-pose) atom numbering:
          pairings_table  {letter: [atom, atom]}  across molecules
          pairings_dict   {mol: {letter: local_atom | (atom, atom)}}
          internal_constraints  pairs tagged twice on ONE molecule that
            also carry an imposed distance on the keyword line'''
        self.pairings_dict = {m: {} for m in range(len(self.objects))}
        self.kw_line = getattr(self, 'kw_line', '')
        mol_offsets = np.concatenate([[0], np.cumsum(self.ids)])[:-1] \
            if self.ids is not None else np.zeros(len(self.mol_lines), int)

        by_letter = {}          # letter -> [global atom, ...]
        untagged = []           # bare indices (implicit '?' pairing)

        for mol, line in enumerate(self.mol_lines):
            tokens = line.split('>')[-1].split()[1:]
            offset = int(mol_offsets[mol]) if mol < len(mol_offsets) else 0

            for token in tokens:
                if '=' in token:
                    continue    # molecule attribute, not an index
                match = self._TAGGED_INDEX.match(token)
                if match is None:
                    continue
                local = int(match.group(1))
                tags = match.group(2)

                if not tags:
                    untagged.append(local + offset)
                    continue
                for letter in tags:
                    by_letter.setdefault(letter, []).append(local + offset)
                    # per-molecule view keeps LOCAL numbering; a repeat
                    # on the same molecule upgrades the entry to a tuple
                    seen = self.pairings_dict[mol].get(letter)
                    self.pairings_dict[mol][letter] = \
                        local if seen is None else (seen, local)

        self.pairings_table = {letter: sorted(atoms)
                               for letter, atoms in sorted(by_letter.items())}

        for letter, atoms in self.pairings_table.items():
            if len(atoms) == 1:
                raise SyntaxError(
                    f"Letter '{letter}' is only specified once. "
                    f"Please flag the second reactive atom.")
            if len(atoms) > 2:
                raise SyntaxError(
                    f"Letter '{letter}' is specified more than two times. "
                    f"Please remove the unwanted letters.")

        if len(self.mol_lines) in (2, 3) and len(untagged) == 2:
            self.pairings_table['?'] = sorted(untagged)

        internal = [
            [pair] for letter, pair in self.pairings_table.items()
            if f'{letter}=' in self.kw_line
            and any(isinstance(view.get(letter), tuple)
                    for view in self.pairings_dict.values())]
        self.internal_constraints = (np.concatenate(internal) if internal
                                     else np.array([], dtype=int))

    # ------------------------------------------------------------- checks

    def check_objects_compenetration(self):
        for mol in self.objects:
            counts = count_intra_clashes_np(mol.atomcoords)
            for c, n in enumerate(counts):
                if n > 0:
                    s = (f'--> WARNING! {mol.name}, conformer {c + 1}, looks '
                         f'compenetrated ({n} interatomic distance'
                         f'{"s" if n > 1 else ""} < 0.5 A)')
                    self.warnings.append(s)
                    self.log(s)

    def check_saturation(self):
        self.log()
        for mol in self.objects:
            charge = int(mol.attrs.get('charge', 0))
            if saturation_check(mol.atomnos, charge):
                self.log(f'--> {mol.name}: saturation check passed '
                         f'(even saturation index)')
            else:
                s = (f'--> WARNING! {mol.name}: saturation check failed. Odd '
                     f'saturation index (charge={charge}). Radical or bad '
                     f'input geometry?')
                self.log(s)
                self.warnings.append(s)

    # ------------------------------------------------------------ options

    def _set_options(self, filename):
        try:
            OptionSetter(self).set_options()
        except (SyntaxError, NotImplementedError):
            raise
        except Exception as e:
            print(e)
            raise InputError(
                f'Error in reading keywords from {filename}. '
                f'Please check your syntax.')

    # operators whose run ends with their data: _setup routes the run
    # to data_termination and nothing is embedded or optimised
    DATA_OPERATORS = ('pka>', 'scan>', 'neb>', 'saddle>', 'mep_relax>',
                      'automep>')

    def _data_run(self):
        return any(tag in op for op in self.options.operators
                   for tag in self.DATA_OPERATORS)

    def _calculator_setup(self):
        if self.options.theory_level is None and self.options.calculator:
            self.options.theory_level = DEFAULT_LEVELS.get(
                self.options.calculator)

    def _print_references(self):
        '''Log the literature references of the run settings.'''
        self.log('--> If you use this software in your publication, '
                 'please cite the TSCoDe manuscript:\n'
                 f'    {references["TSCoDe"]}')

        cite_ff = self.options.ff_calc == 'XTB'
        cite_gfn2 = self.options.calculator == 'XTB'
        if cite_ff or cite_gfn2:
            s = f'    GFN-FF : {references["GFN-FF"]}\n' if cite_ff else ''
            s += (f'    GFN2-XTB : {references["GFN2-XTB"]}\n'
                  if cite_gfn2 else '')
            self.log('\n--> Your run also makes use of other software: '
                     f'please cite these references as well.\n{s}')
        self.log()

    def _set_custom_orbs(self, orb_string):
        '''DIST(a=2.345,...): rebuild orbitals with imposed
        half-distances.'''
        for mol in self.objects:
            if not mol.reactive_atoms:
                mol.compute_orbitals(
                    override='Single' if self.options.simpleorbitals else None)

        self.pairing_dists = {p.split('=')[0]: float(p.split('=')[1])
                              for p in orb_string.split(',')}

        for letter, dist in self.pairing_dists.items():
            if letter not in self.pairings_table:
                raise SyntaxError(
                    f"Letter '{letter}' is specified in DIST but not "
                    f"present in molecules string.")
            for i, mol in enumerate(self.objects):
                r_index = self.pairings_dict[i].get(letter)
                if r_index is None:
                    continue
                indices = (r_index,) if isinstance(r_index, (int, np.integer)) \
                    else r_index
                for r_i in indices:
                    for c in range(mol.n_confs):
                        # internal-constraint indices are not reactive
                        # and carry no orbital objects
                        if r_i in mol.reactive_atoms.get(c, {}):
                            builder = get_atom_builder(mol.graph, r_i)
                            mol.reactive_atoms[c][r_i] = builder(
                                mol, r_i, conf=c, orb_dim=dist / 2)
        self.orb_string = orb_string

    def _set_embedder_structures_from_mol(self):
        '''REFINE / refine>: the input ensemble becomes the structures.'''
        self.structures = self.objects[0].atomcoords
        self.atomnos = self.objects[0].atomnos
        if self.pairings_table:
            self.constrained_indices = np.array(
                [list(self.pairings_table.values()) for _ in self.structures])
        else:
            self.constrained_indices = np.array(
                [[] for _ in self.structures])
        self.ids = None
        self.energies = np.zeros(len(self.structures))
        self.exit_status = np.ones(len(self.structures), dtype=bool)
        self.embed_graph = get_sum_graph(
            [graphize(self.structures[0], self.atomnos)],
            self.constrained_indices[0])

    def _apply_operators(self):
        '''Run the op> prefixes right-to-left per molecule (reference
        embedder.py:853-907); DRYRUN skips them.'''
        from tscode_tpu_torch.operators import operate
        for mol_index, op_list in self.options.operators_dict.items():
            for op in op_list:
                if self.options.dryrun:
                    self.log(f'--> Dry run requested: skipping operator '
                             f'"{op}>"')
                    continue
                self.objects[mol_index] = operate(op, self,
                                                  self.objects[mol_index])

    # -------------------------------------------------------------- setup

    def _setup(self, p=True):
        '''Embed-type decision, angle grids, orbitals and pivots.'''
        if self._data_run():
            # these operators already ran in _apply_operators and the run
            # terminates with their data
            self.embed = 'data'
            return

        if any('refine>' in op for op in self.options.operators) or \
                self.options.noembed:
            self.embed = 'refine'
            return

        for mol in self.objects:
            if self.options.max_confs < mol.n_confs:
                self.log(f'--> {mol.name} - kept {self.options.max_confs}/'
                         f'{mol.n_confs} conformations for the embed '
                         f'(override with CONFS=n)\n')
                mol.atomcoords = mol.atomcoords[:self.options.max_confs]

        if all(len(mol.reactive_indices) == 0 for mol in self.objects):
            self.embed = None
            return

        override = 'Single' if self.options.simpleorbitals else None

        if len(self.objects) == 1:
            mol = self.objects[0]
            if len(mol.reactive_indices) != 2:
                self.embed = 'error'
                return
            self.embed = 'monomolecular'
            mol.compute_orbitals(override=override)
            set_pivots(mol, suprafacial=self.options.suprafacial)
            self.options.only_refined = True
            self.options.fix_angles_in_deformation = True

        elif len(self.objects) in (2, 3):
            n_reactive = [len(mol.reactive_indices) for mol in self.objects]
            cyclical = all(n == 2 for n in n_reactive)
            chelotropic = sorted(n_reactive) == [1, 2]
            string = len(self.objects) == 2 and n_reactive == [1, 1]
            multiembed = (len(self.objects) == 2 and
                          all(n >= 2 for n in n_reactive) and not cyclical)

            if cyclical or chelotropic or multiembed:
                self._setup_cyclical(
                    'cyclical' if cyclical else
                    'multiembed' if multiembed else 'chelotropic',
                    override, p)
            elif not string:
                raise InputError(
                    'Bad input - The only molecular configurations accepted '
                    'are:\n'
                    '1) One molecule with two reactive centers '
                    '(monomolecular embed)\n'
                    '2) One molecule with four indices (dihedral embed)\n'
                    '3) Two or three molecules with two reactive centers '
                    'each (cyclical embed)\n'
                    '4) Two molecules with one reactive center each '
                    '(string embed)\n'
                    '5) Two molecules, one with a single reactive center '
                    'and the other with two (chelotropic embed)\n'
                    '6) Two molecules with at least two reactive centers each')
            else:
                self.embed = 'string'
                self.options.rotation_steps = 36
                for mol in self.objects:
                    if not mol.reactive_atoms:
                        mol.compute_orbitals(override=override)
                if hasattr(self.options, 'custom_rotation_steps'):
                    self.options.rotation_steps = \
                        self.options.custom_rotation_steps
                self.systematic_angles = [
                    n * 360 / self.options.rotation_steps
                    for n in range(self.options.rotation_steps)]
        else:
            raise InputError(
                'Bad input - could not set up an appropriate embed type '
                '(too many structures specified?)')

        if p:
            if self.options.shrink:
                for mol in self.objects:
                    mol.scale_orbs(self.options.shrink_multiplier)
                    set_pivots(mol, suprafacial=self.options.suprafacial)
                self.options.only_refined = True

            self.candidates = self._get_number_of_candidates()
            self.log(f'--> Setup performed correctly. '
                     f'{self.candidates or "Many"} candidates will be '
                     f'generated.\n')

    def _large_embed(self):
        '''The large-embed rule: over 100 conformers and no LET, run()
        makes a cyclical or chelotropic embed rigid.'''
        return not self.options.let and \
            max(mol.n_confs for mol in self.objects) > 100

    def _setup_cyclical(self, kind, override, p):
        '''The embeds built on the cyclical sweep: `kind` is 'cyclical'
        (two or three molecules, two reactive atoms each), 'chelotropic'
        (its single reactive atoms' orbitals enlarged by 0.2 A) or
        'multiembed' (orbitals only: each arrangement is set up as a
        cyclical embed of its own). Sets the (A, M) grid of per-molecule
        step angles over +-rotation_range and the pivots.'''
        self.embed = kind
        if kind == 'chelotropic':
            for mol in self.objects:
                mol.compute_orbitals(override=override)
                for c in range(mol.n_confs):
                    for index, atom in list(mol.reactive_atoms[c].items()):
                        orb_dim = np.linalg.norm(atom.center[0] - atom.coord)
                        mol.reactive_atoms[c][index] = get_atom_builder(
                            mol.graph, index)(mol, index, conf=c,
                                              orb_dim=orb_dim + 0.2)
        self.options.rotation_steps = 5
        if hasattr(self.options, 'custom_rotation_steps'):
            self.options.rotation_steps = self.options.custom_rotation_steps
        steps = self.options.rotation_steps
        self.systematic_angles = cartesian_product(
            *[np.arange(steps + 1) for _ in self.objects]) \
            * 2 * self.options.rotation_range / steps \
            - self.options.rotation_range
        if p:
            for mol in self.objects:
                if not mol.reactive_atoms:
                    mol.compute_orbitals(override=override)
                set_pivots(mol, suprafacial=self.options.suprafacial)
        if kind == 'multiembed':
            for mol in self.objects:
                mol.compute_orbitals(override=override)

    def _get_number_of_candidates(self):
        '''One molecule: its pivots over all conformers. String embed:
        spin steps times the lobe-conformer products. Multiembed: 0,
        logged as Many (each arrangement counts its own).
        Cyclical sweeps: two orientations per angle tuple, conformer
        tuple and pivot tuple, times four for three molecules; pairings
        fix orientations of a cyclical embed (half of two molecules'; a
        quarter or, from two pairings up, an eighth of three's).'''
        if len(self.objects) == 1:
            mol = self.objects[0]
            return int(sum(len(mol.pivots[c]) for c in range(mol.n_confs)))
        if self.embed == 'string':
            return int(self.options.rotation_steps * np.prod(
                [sum(len(mol.get_r_atoms(c)[0].center)
                     for c in range(mol.n_confs)) for mol in self.objects]))
        if self.embed == 'multiembed':
            return 0
        candidates = 2 * len(self.systematic_angles) * np.prod(
            [mol.n_confs for mol in self.objects])
        if len(self.objects) == 3:
            candidates *= 4
        if self.pairings_table and self.embed == 'cyclical':
            if len(self.objects) == 2:
                candidates /= 2
            else:
                candidates /= 4 if len(self.pairings_table) == 1 else 8
        candidates *= np.prod([len(mol.pivots[0]) for mol in self.objects])
        return int(candidates)

    def pairing_ok_fn(self):
        '''Callable(ids) testing that an arrangement carries every
        user-imposed pairing, or None without pairings.'''
        if not self.pairings_table:
            return None
        table = {tuple(v) for v in self.pairings_table.values()}
        internal = {tuple(sorted(pair)) for pair in
                    (self.internal_constraints.tolist()
                     if len(self.internal_constraints) else [])}

        def ok(ids):
            pairs = {tuple(sorted(pair)) for pair in ids}
            return all(p in pairs or p in internal for p in table)
        return ok

    # ---------------------------------------------------------- pairings

    def get_pairing_dist_from_letter(self, letter):
        '''Target distance for a pairing letter: imposed (DIST) or the
        sum of the two orbital half-dimensions.'''
        if letter in self.pairing_dists:
            return self.pairing_dists[letter]

        d = 0
        try:
            for i, mol in enumerate(self.objects):
                r_index = self.pairings_dict[i].get(letter)
                if r_index is None:
                    continue
                if isinstance(r_index, (int, np.integer)):
                    d += mol.get_orbital_length(r_index)
                else:
                    return None  # internal constraint without imposed dist
            return d if d > 0 else None
        except Exception:
            return None

    def get_pairing_dists_from_constrained_indices(self, pair):
        '''Target distance for a constrained cumulative-index pair.'''
        try:
            letter = next(
                lett for lett, ids in self.pairings_table.items()
                if (ids[0] == min(pair) and ids[1] == max(pair)))
            return self.get_pairing_dist_from_letter(letter)
        except StopIteration:
            return None

    # ------------------------------------------------------------- output

    def write_structures(self, tag, indices=None, energies=True,
                         relative=True, extra='', align='indices', p=True):
        if energies:
            rel_e = self.energies
            if relative:
                rel_e = rel_e - np.min(self.energies)

        if len(self.structures) > 10000 and not self.options.let:
            self.log(f'Truncated {tag} output structures to 10000 (from '
                     f'{len(self.structures)} - keyword LET to override).')
            output_structures = self.structures[:10000]
        else:
            output_structures = self.structures

        if align == 'moi':
            aligned = align_by_moi(output_structures, self.atomnos)
        else:
            aligned = align_structures(output_structures, indices=indices)

        self.outname = f'tscode_{tag}_{self.stamp}.xyz'
        with open(self.outname, 'w') as f:
            for i, structure in enumerate(aligned):
                title = f'Structure {i + 1} - {tag}'
                if energies:
                    title += f' - Rel. E. = {round(rel_e[i], 3)} kcal/mol '
                title += extra
                write_xyz(structure, self.atomnos, f, title=title)

        if p:
            self.log(f'Wrote {len(output_structures)} {tag} structures to '
                     f'{self.outname} file.\n')

    def write_mol_info(self):
        for mol in self.objects:
            s = f'--> {mol.name}: {mol.n_confs} conformer' \
                f'{"s" if mol.n_confs > 1 else ""}, {mol.n_atoms} atoms'
            if len(mol.reactive_indices):
                s += (f', reactive indices '
                      f'{[int(i) for i in mol.reactive_indices]}')
            self.log(s)
        self.log()

    def write_options(self):
        self.log('--> Options:\n')
        for line in repr(self.options).split('\n'):
            self.log('    ' + line)
        self.log()

    def log_warnings(self):
        for warning in self.warnings:
            self.log(warning)

    def write_quote(self):
        entry = random.choice(quotes)
        self.log('\n' + auto_newline(entry['quote']))
        if entry['author']:
            self.log(f'    - {entry["author"]}\n')

    def normal_termination(self):
        clean_directory()
        self.write_quote()
        self.log(f'\n--> tscode_tpu_torch normal termination: total time '
                 f'{time_to_string(time.perf_counter() - self.t_start_run, verbose=True)}.')

        if len(getattr(self, 'structures', [])) > 0 \
                and len(getattr(self, 'energies', [])) > 0:
            energies = self.energies[:10]
            if np.max(energies - np.min(energies)) > 0:
                self.log(f'\n--> Energies of output structures (first 10, '
                         f'{self.options.theory_level}/'
                         f'{self.options.calculator})\n')
                self.log('> #                Rel. E.           RMSD')
                self.log('-------------------------------------------')
                for i, energy in enumerate(energies - energies[0]):
                    if i == 0:
                        rmsd_value = '(ref)'
                    else:
                        r, _ = rmsd_and_max(
                            torch.as_tensor(self.structures[i]
                                            - self.structures[i].mean(0)),
                            torch.as_tensor(self.structures[0]
                                            - self.structures[0].mean(0)))
                        rmsd_value = f'{float(r):.2f} A'
                    self.log(f'> Candidate {str(i + 1):2}  :  {energy:.2f} '
                             f'kcal/mol  :  {rmsd_value}')
        self.write_run_report()
        self.logfile.close()

    def write_run_report(self):
        '''Machine-readable run summary: per-stage timings and survivor
        counts, the device, the string embed's counts, novelty lane and
        time split, final energetics, warnings.'''
        timings = getattr(self, 'stage_timings', None)
        if not timings:
            return
        report = {
            'stamp': self.stamp,
            'embed': getattr(self, 'embed', None),
            'device': str(self.device),
            'dtype': str(self.dtype).split('.')[-1],
            'total_seconds': round(
                time.perf_counter() - self.t_start_run, 3),
            'stages': timings,
            'final_structures': int(len(getattr(self, 'structures', ()))),
            'warnings': len(getattr(self, 'warnings', ())),
        }
        if getattr(self, 'embed_info', None):
            report[f'{self.embed}_embed'] = self.embed_info
        if getattr(self, 'similarity_info', None):
            report['similarity'] = self.similarity_info
        if getattr(self, 'search_info', None):
            report['csearch'] = self.search_info
        if getattr(self, 'refine_info', None):
            report['refine'] = self.refine_info
        energies = getattr(self, 'energies', None)
        if energies is not None and len(energies) and \
                np.max(energies - np.min(energies)) > 0:
            rel = np.asarray(energies) - float(np.min(energies))
            report['rel_energies_kcal'] = [round(float(e), 3)
                                           for e in rel[:100]]
        path = f'tscode_report_{self.stamp}.json'
        try:
            with open(path, 'w') as f:
                json.dump(report, f, indent=1)
            self.log(f'--> Wrote run report to {path}', p=False)
        except OSError as e:
            # never fail a completed run at termination over telemetry
            self.log(f'--> Could not write run report: {e}', p=False)

    def run(self, resume_from=None):
        '''Run the pipeline on a copy of this embedder's state.'''
        try:
            run = RunEmbedding(self)
            run.run(resume_from=resume_from)
            return run
        except Exception as e:
            logging.exception(e)
            raise


def _timed_stage(fn):
    '''Record (stage, wall seconds, structures in/out) on the run, dumped
    in tscode_report_<stamp>.json at termination; the stage is a span of
    the --trace profile under the same name.'''
    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        before = len(getattr(self, 'structures', None)
                     if getattr(self, 'structures', None) is not None else ())
        with span(fn.__name__):
            out = fn(self, *args, **kwargs)
        after = len(getattr(self, 'structures', None)
                    if getattr(self, 'structures', None) is not None else ())
        if not hasattr(self, 'stage_timings'):
            self.stage_timings = []
        self.stage_timings.append({
            'stage': fn.__name__,
            'seconds': round(time.perf_counter() - t0, 3),
            'structures_in': int(before),
            'structures_out': int(after)})
        return out
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class RunEmbedding(Embedder):
    '''Runs the pipeline stages over array state.'''

    # attributes masked together through the pruning stages
    MASKABLE = ('structures', 'energies', 'constrained_indices', 'exit_status')

    def __init__(self, embedder):
        # copy the set-up embedder's state; Options is deep-copied so
        # in-place keyword changes during a run never leak back
        for attr in dir(embedder):
            if not attr.startswith('__') and attr != 'run':
                value = getattr(embedder, attr)
                if not callable(value):
                    setattr(self, attr, value)
        self.options = deepcopy(embedder.options)
        self.embed_info = {}
        self.similarity_info = []

    def rel_energies(self):
        return self.energies - np.min(self.energies)

    def apply_mask(self, attributes, mask):
        for attr in attributes:
            if hasattr(self, attr):
                value = getattr(self, attr)
                if isinstance(value, np.ndarray) and len(value) == len(mask):
                    setattr(self, attr, value[mask])

    def zero_candidates_check(self):
        if len(self.structures) == 0:
            self.log_warnings()
            raise ZeroCandidatesError()

    def _mesh(self, n_items=None, threshold=4096):
        '''The device mesh the pipeline shards over, or None: the default
        mesh of the run's device type; with n_items given, only when the
        size gate (n_items >= threshold) holds (TSCODE_MESH=1 forces the
        sharded paths at any size).'''
        if n_items is None:
            return get_default_mesh(device=self.device)
        return mesh_for(n_items, threshold, device=self.device)

    # ---------------------------------------------------------- pipeline

    @_timed_stage
    def generate_candidates(self):
        '''The embed on the run's device: string, cyclical or
        chelotropic (or, for an arrangement of a multiembed, its slice
        `precomputed_embed` of the shared sweep), monomolecular, or
        multiembed; the refine route has its structures already.'''
        if self.embed == 'refine':
            self.log('\n')
            return

        if self.embed == 'string':
            structures, constrained = string_embed(
                self.objects[0], self.objects[1], self.systematic_angles,
                clash_thresh=self.options.clash_thresh, log=self.log,
                device=self.device, dtype=self.dtype, info=self.embed_info,
                mesh=self._mesh())
            self.structures = structures
            self.constrained_indices = constrained
        elif self.embed in ('cyclical', 'chelotropic'):
            pre = getattr(self, 'precomputed_embed', None)
            if pre is not None:
                # an empty slice behaves as an empty embed
                structures, constrained = pre
                if len(structures) == 0:
                    raise ZeroCandidatesError(
                        '--> Cyclical embed did not find any suitable '
                        'disposition of molecules.')
                self.structures = structures
                self.constrained_indices = constrained
            else:
                self.structures = cyclical_embed(self)
        elif self.embed == 'monomolecular':
            monomolecular_embed(self)
        elif self.embed == 'multiembed':
            self.structures = multiembed_dispatcher(self)
        else:
            raise InputError(f'Embed type {self.embed!r} not recognized.')

        self.atomnos = np.concatenate(
            [mol.atomnos for mol in self.objects])

        additional_bonds = self.constrained_indices[0]
        if len(self.internal_constraints) > 0:
            additional_bonds = np.concatenate(
                (self.internal_constraints, additional_bonds))
        self.embed_graph = get_sum_graph(self.graphs, additional_bonds)

        self.log(f'Generated {len(self.structures)} transition state '
                 f'candidates '
                 f'({time_to_string(time.perf_counter() - self.t_start_run)})\n')

        self.write_structures('embedded', energies=False)

        if self.options.debug:
            self.dump_status('generate_candidates')

    @_timed_stage
    def compenetration_refining(self):
        '''The string and cyclical embeds screened every pose already,
        and the monomolecular embed docks nothing. Other routes are
        screened here: with fragment sizes (ids: the
        chelotropic embed and the multiembed parent), the cross-fragment
        clash screen (kernel K2 on CUDA); on the refine route, each
        structure's pairs closer than 0.5 A (pairs at distance 0
        excluded, as the reference does). Then the placeholder energies
        and exit status.'''
        if self.embed not in ('string', 'cyclical', 'monomolecular'):
            self.log('--> Checking structures for compenetrations')
            t_start = time.perf_counter()
            if self.ids is not None:
                pm = cross_fragment_pair_mask(tuple(self.ids))
                mesh = self._mesh(len(self.structures))
                if mesh is not None:
                    mask = sharded_compenetration_mask(
                        torch.as_tensor(self.structures, dtype=self.dtype),
                        pm, mesh, thresh=self.options.clash_thresh,
                        max_clashes=self.options.max_clashes)
                else:
                    mask = compenetration_mask_kernel(
                        torch.as_tensor(self.structures, dtype=self.dtype,
                                        device=self.device),
                        pm, thresh=self.options.clash_thresh,
                        max_clashes=self.options.max_clashes).cpu().numpy()
            else:
                mask = (count_intra_clashes_np(self.structures, thresh=0.5)
                        <= self.options.max_clashes)
            self.apply_mask(('structures', 'constrained_indices'), mask)
            t_end = time.perf_counter()

            if False in mask:
                self.log(f'Discarded {np.count_nonzero(~mask)} candidates '
                         f'for compenetration ({np.count_nonzero(mask)} '
                         f'left, {time_to_string(t_end - t_start)})')
            else:
                self.log(f'All {len(mask)} structures passed the '
                         f'compenetration check')
            self.log()
            self.zero_candidates_check()

        self.energies = np.full(len(self.structures), 1e10)
        self.exit_status = np.zeros(len(self.structures), dtype=bool)

    @_timed_stage
    def fitness_refining(self, threshold=5, verbose=False):
        '''Discard the structures whose summed absolute deviation from
        the imposed pairing distances exceeds `threshold` (A). Host
        numpy.'''
        if verbose:
            self.log(' \n--> Fitness pruning - removing inaccurate structures')

        targets = {}     # a target depends on the index pair alone

        def target_of(pair):
            key = (int(pair[0]), int(pair[1]))
            if key not in targets:
                targets[key] = \
                    self.get_pairing_dists_from_constrained_indices(pair)
            return targets[key]

        mask = np.ones(len(self.structures), dtype=bool)
        for s, (structure, constraints) in enumerate(
                zip(self.structures, self.constrained_indices)):
            error = 0.0
            for pair in constraints:
                target = target_of(pair)
                if target is not None:
                    d = np.linalg.norm(structure[pair[0]] - structure[pair[1]])
                    error += abs(d - target)
            mask[s] = error <= threshold

        self.apply_mask(self.MASKABLE, mask)

        if False in mask:
            self.log(f'Discarded {np.count_nonzero(~mask)} candidates for '
                     f'unfitness ({np.count_nonzero(mask)} left)')
        elif verbose:
            self.log('All candidates meet the imposed criteria.')
        self.log()
        self.zero_candidates_check()

    def _note_prune(self, stage, before, t_start):
        self.similarity_info.append({
            'stage': stage, 'structures_in': int(before),
            'structures_out': int(len(self.structures)),
            'seconds': time.perf_counter() - t_start})

    @_timed_stage
    def similarity_refining(self, tfd=True, moi=True, rmsd=True,
                            verbose=False):
        '''TFD prune, then MOI prune (up to 500 structures); with rmsd,
        the bucketed RMSD prune on the run's device (up to 1e5
        structures; kernel K3 on CUDA) and the symmetry-corrected RMSD
        prune on the host (up to 500). Each prune's counts and seconds
        go to the run report.'''
        if verbose:
            self.log('--> Similarity Processing')

        before = len(self.structures)
        attr = ('constrained_indices', 'energies', 'exit_status')

        if (tfd and len(self.objects) > 1 and hasattr(self, 'embed_graph')
                and self.embed_graph.is_single_molecule):
            t_start = time.perf_counter()
            quadruplets = get_quadruplets(self.embed_graph)
            if len(quadruplets) > 0:
                before_tfd = len(self.structures)
                self.structures, mask = prune_conformers_tfd(
                    self.structures, quadruplets, device=self.device,
                    dtype=self.dtype, mesh=self._mesh(len(self.structures)))
                self.apply_mask(attr, mask)
                self._note_prune('tfd', before_tfd, t_start)
                if False in mask:
                    self.log(f'Discarded {np.count_nonzero(~mask)} structures '
                             f'for TFD similarity ({np.count_nonzero(mask)} '
                             f'left, {time_to_string(time.perf_counter() - t_start)})')

        if moi and len(self.structures) <= 500:
            before3 = len(self.structures)
            t_start = time.perf_counter()
            self.structures, mask = prune_by_moment_of_inertia(
                self.structures, self.atomnos, device=self.device,
                mesh=self._mesh(len(self.structures)))
            self.apply_mask(attr, mask)
            self._note_prune('moi', before3, t_start)
            if before3 > len(self.structures):
                self.log(f'Discarded {np.count_nonzero(~mask)} candidates '
                         f'for MOI similarity ({np.count_nonzero(mask)} left, '
                         f'{time_to_string(time.perf_counter() - t_start)})')

        if rmsd and len(self.structures) <= 1e5:
            before1 = len(self.structures)
            t_start = time.perf_counter()
            _, mask = prune_conformers_rmsd(
                self.structures, self.atomnos, rmsd_thr=self.options.rmsd,
                device=self.device, dtype=self.dtype,
                # only when forced: the pool is copied to every card, and
                # no size is yet measured where that pays (PERF.md)
                mesh=self._mesh(len(self.structures), threshold=math.inf))
            # the prune returns its copy on the device in the run's
            # dtype; keep the host float64 rows it selects
            self.structures = self.structures[mask]
            self.apply_mask(attr, mask)
            self._note_prune('rmsd', before1, t_start)
            if before1 > len(self.structures):
                self.log(f'Discarded {np.count_nonzero(~mask)} candidates '
                         f'for RMSD similarity ({np.count_nonzero(mask)} '
                         f'left, {time_to_string(time.perf_counter() - t_start)})')

            # symmetry-corrected pass (<= 500 structures, dummy rotors)
            if len(self.structures) <= 500 and hasattr(self, 'embed_graph'):
                before2 = len(self.structures)
                t_start = time.perf_counter()
                self.structures, mask = prune_conformers_rmsd_rot_corr(
                    self.structures, self.atomnos, self.embed_graph,
                    max_rmsd=self.options.rmsd, verbose=verbose,
                    logfunction=self.log if verbose else None)
                self.apply_mask(attr, mask)
                self._note_prune('rmsd_rot_corr', before2, t_start)
                if before2 > len(self.structures):
                    self.log(f'Discarded {np.count_nonzero(~mask)} '
                             f'candidates for symmetry-corrected RMSD '
                             f'similarity ({np.count_nonzero(mask)} left, '
                             f'{time_to_string(time.perf_counter() - t_start)})')

        if verbose and len(self.structures) == before:
            self.log(f'All structures passed the similarity check.{" " * 15}')
        self.log()

    # ---------------------------------------------- augmentation stages

    def csearch_augmentation(self, text='', max_structs=1000):
        '''Hydrogen-bond-preserving random torsional augmentation of
        every candidate, then the similarity prunes without RMSD
        (reference embedder.py:1893-1948).'''
        self.log(f'--> Performing conformational augmentation of TS '
                 f'candidates {text}')
        before = len(self.structures)
        t_start = time.perf_counter()
        n_out = 100 if len(self.structures) * 100 < max_structs else \
            round(max_structs / len(self.structures))
        n_out = max(1, n_out)

        for s, (structure, constraints) in enumerate(zip(
                np.copy(self.structures),
                np.copy(self.constrained_indices))):
            try:
                new_structures = csearch(
                    structure, self.atomnos,
                    constrained_indices=constraints, keep_hb=True, mode=2,
                    n_out=n_out, title=f'Candidate_{s + 1}',
                    logfunction=lambda *_a, **_k: None, rng=self.rng,
                    device=self.device)
            except SegmentedGraphError:
                new_structures = []

            if len(new_structures) != 0:
                self.structures = np.concatenate(
                    (self.structures, new_structures))
                self.energies = np.concatenate(
                    (self.energies, [1e10 for _ in new_structures]))
                self.constrained_indices = np.concatenate(
                    (self.constrained_indices,
                     [constraints for _ in new_structures]))

        self.exit_status = np.ones(len(self.structures), dtype=bool)
        self.similarity_refining(rmsd=False)
        self.log(f'Conformational augmentation completed - generated '
                 f'{len(self.structures) - before} new conformers '
                 f'({time_to_string(time.perf_counter() - t_start)})\n')

    def csearch_augmentation_routine(self):
        '''Up to 3 augmentation+FF rounds, stopping after 2 without a new
        minimum (reference embedder.py:1950-1983).'''
        if not self.options.csearch_aug:
            return
        null_runs = 0
        for i in range(3):
            min_e = np.min(self.energies)
            self.csearch_augmentation(text=f'(step {i + 1}/3)',
                                      max_structs=self.options.max_confs)
            self.force_field_refining()
            if np.min(self.energies) < min_e:
                delta = min_e - np.min(self.energies)
                self.log(f'--> Lower minima found: {round(delta, 2)} '
                         f'kcal/mol below previous best\n')
            else:
                self.log('--> No new minima found.\n')
                null_runs += 1
            if null_runs == 2:
                break

    @_timed_stage
    def metadynamics_augmentation(self):
        '''XTB MTD sampling around every candidate
        (reference embedder.py:1858-1891).'''
        from tscode_tpu_torch.calculators.xtb import xtb_metadyn_augmentation

        self.log('--> Performing XTB Metadynamic augmentation of TS '
                 'candidates')
        before = len(self.structures)
        t_start = time.perf_counter()

        for s, (structure, constraints) in enumerate(zip(
                np.copy(self.structures),
                np.copy(self.constrained_indices))):
            new_structures = xtb_metadyn_augmentation(
                structure, self.atomnos, constrained_indices=constraints,
                new_structures=5, title=s)
            self.structures = np.concatenate(
                (self.structures, new_structures))
            self.energies = np.concatenate(
                (self.energies, [0 for _ in new_structures]))
            self.constrained_indices = np.concatenate(
                (self.constrained_indices,
                 [constraints for _ in new_structures]))

        self.exit_status = np.ones(len(self.structures), dtype=bool)
        self.log(f'Metadynamics augmentation completed - found '
                 f'{len(self.structures) - before} new conformers '
                 f'({time_to_string(time.perf_counter() - t_start)})\n')

    @_timed_stage
    def saddle_refining(self):
        '''First-order saddle refinement of every candidate by the dimer
        method: on the run's QM surface when a calculator is configured
        (gradients from calculators.gradients, the host-loop dimer), on
        the internal force field otherwise (the captured dimer step,
        float64 on the run's device, one structure at a time as the JAX
        package runs it).'''
        if self.options.calculator is not None:
            self.log(f'--> Saddle refinement (dimer method, '
                     f'{self.options.theory_level} via '
                     f'{self.options.calculator})')
            from tscode_tpu_torch.calculators.gradients import \
                make_gradient_fn
            from tscode_tpu_torch.saddle import dimer_saddle_callback
            grad_fn = make_gradient_fn(
                self.atomnos, calculator=self.options.calculator,
                method=self.options.theory_level,
                solvent=self.options.solvent,
                charge=self.options.charge, procs=self.procs)

            new_structures, statuses = [], []
            for i, structure in enumerate(self.structures):
                c, e, ok = dimer_saddle_callback(structure, grad_fn)
                new_structures.append(np.asarray(c))
                statuses.append(bool(ok))
                self.energies[i] = float(e)
        else:
            self.log('--> Saddle refinement (dimer method, internal FF)')
            from tscode_tpu_torch.ff import (build_ff_params, ff_energy,
                                             merge_ff_params,
                                             params_to_device)
            from tscode_tpu_torch.saddle import dimer_saddle

            offsets = np.cumsum(
                [0] + [len(g.nodes) for g in self.graphs])[:-1]
            params_list = []
            pos = 0
            for g in self.graphs:
                n_at = len(g.nodes)
                params_list.append(build_ff_params(
                    self.structures[0][pos:pos + n_at],
                    self.atomnos[pos:pos + n_at], g))
                pos += n_at
            params = params_to_device(merge_ff_params(params_list, offsets),
                                      self.device, torch.float64)

            new_structures, statuses = [], []
            for i, structure in enumerate(self.structures):
                # the tables flow through energy_args: one captured
                # dimer step serves every structure
                c, e, ok = dimer_saddle(
                    torch.as_tensor(structure, dtype=torch.float64,
                                    device=self.device),
                    ff_energy, energy_args=(params,))
                new_structures.append(c.cpu().numpy())
                statuses.append(bool(ok))
                self.energies[i] = float(e)

        self.structures = np.array(new_structures)
        self.exit_status = np.array(statuses)
        self.log(f'Saddle-refined {int(np.sum(self.exit_status))}/'
                 f'{len(self.structures)} candidates\n')
        self.similarity_refining()
        self.write_structures('saddle', energies=True)

    # ------------------------------------------------- optimization hooks

    @_timed_stage
    def force_field_refining(self, conv_thr='tight',
                             only_fixed_constraints=False,
                             prevent_scrambling=False):
        from tscode_tpu_torch.optimization import force_field_refine
        force_field_refine(self, conv_thr=conv_thr,
                           only_fixed_constraints=only_fixed_constraints,
                           prevent_scrambling=prevent_scrambling)

    @_timed_stage
    def optimization_refining(self, conv_thr='tight', maxiter=None,
                              only_fixed_constraints=False):
        from tscode_tpu_torch.optimization import optimization_refine
        optimization_refine(self, conv_thr=conv_thr, maxiter=maxiter,
                            only_fixed_constraints=only_fixed_constraints)

    # ------------------------------------------------------- debug dumps

    def dump_status(self, outname, only_fixed_constraints=False):
        '''DEBUG artifacts of a stage: energies, structures, constraints
        and a pickle of the run state.'''
        if hasattr(self, 'energies'):
            with open(f'{outname}_energies.dat', 'w') as f:
                for i, energy in enumerate(self.energies):
                    txt = (f'{round(energy - np.min(self.energies), 2)} '
                           f'kcal/mol' if energy != 1e10 else 'SCRAMBLED')
                    f.write(f'Candidate {i:5} : {txt}\n')

        with open(f'{outname}_structures.xyz', 'w') as f:
            exit_status = getattr(self, 'exit_status',
                                  np.zeros(len(self.structures), bool))
            energies = (self.rel_energies() if hasattr(self, 'energies')
                        else np.zeros(len(self.structures)))
            for i, (structure, status, energy) in enumerate(zip(
                    align_structures(self.structures), exit_status,
                    energies)):
                kind = 'REFINED - ' if status else 'NOT REFINED - '
                write_xyz(structure, self.atomnos, f,
                          title=f'Structure {i + 1} - {kind}Rel. E. = '
                                f'{round(energy, 3)} kcal/mol')

        with open(f'{outname}_constraints.dat', 'w') as f:
            for i, constraints in enumerate(self.constrained_indices):
                if only_fixed_constraints:
                    constraints = np.array(
                        [v for k, v in self.pairings_table.items()
                         if k.isupper()])
                elif len(self.internal_constraints) > 0:
                    constraints = np.concatenate(
                        [constraints, self.internal_constraints])
                d_str = [self.get_pairing_dists_from_constrained_indices(c)
                         for c in constraints]
                f.write(f'Candidate {i:5} : '
                        f'{np.asarray(constraints).tolist()} -> {d_str}\n')

        state = {
            'structures': self.structures,
            'constrained_indices': self.constrained_indices,
            'graphs': self.graphs,
            'options': self.options,
            'atomnos': self.atomnos,
        }
        if hasattr(self, 'energies'):
            state['energies'] = self.energies
        with open(f'{outname}_runembedding.pickle', 'wb') as f:
            pickle.dump(state, f)

    # ------------------------------------------------------------ resume

    RESUME_STAGES = ('generated', 'pruned', 'ff_pre', 'ff_loose',
                     'ff_tight', 'opt_loose', 'opt_tight')

    def save_resume(self, stage):
        '''Persist the run state so an interrupted run can continue.'''
        state = {
            'stage': stage,
            'structures': self.structures,
            'energies': getattr(self, 'energies', None),
            'constrained_indices': self.constrained_indices,
            'exit_status': getattr(self, 'exit_status', None),
            'atomnos': self.atomnos,
            'embed': self.embed,
            'kw_line': self.kw_line,
        }
        with open(f'tscode_resume_{self.stamp}.pkl', 'wb') as f:
            pickle.dump(state, f)

    def load_resume(self, path):
        '''Restore array state; returns the completed stage name.'''
        with open(path, 'rb') as f:
            state = pickle.load(f)
        if state['embed'] != self.embed:
            raise InputError(
                f'Resume file embed type {state["embed"]!r} does not '
                f'match this input ({self.embed!r}).')
        self.structures = state['structures']
        self.constrained_indices = state['constrained_indices']
        self.atomnos = state['atomnos']
        if state['energies'] is not None:
            self.energies = state['energies']
        if state['exit_status'] is not None:
            self.exit_status = state['exit_status']
        # the embed graph is rebuilt (not picklable with attributes)
        additional_bonds = self.constrained_indices[0] if \
            len(self.constrained_indices) else []
        if len(self.internal_constraints) > 0 and len(additional_bonds):
            additional_bonds = np.concatenate(
                (self.internal_constraints, additional_bonds))
        self.embed_graph = get_sum_graph(self.graphs, additional_bonds)
        self.log(f'--> Resumed {len(self.structures)} structures from '
                 f'{path} (completed stage: {state["stage"]})')
        return state['stage']

    def _stage_done(self, stage):
        if self.resume_stage is None:
            return False
        return self.RESUME_STAGES.index(stage) <= \
            self.RESUME_STAGES.index(self.resume_stage)

    # --------------------------------------------------------------- run

    def run(self, resume_from=None):
        self.resume_stage = None
        if resume_from is not None:
            self.resume_stage = self.load_resume(resume_from)
        self.write_mol_info()

        if self.embed is None:
            self.log('--> No embed requested, exiting.\n')
            self.normal_termination()
            return

        if self.embed == 'error':
            self.log('--> Embed type not recognized, exiting.\n')
            self.normal_termination()
            return

        if self.embed == 'data':
            self.data_termination()
            return

        if self.embed in ('cyclical', 'chelotropic') and \
                not self.options.rigid and self._large_embed():
            self.options.rigid = True
            self.log('--> Large embed: RIGID keyword added for efficiency '
                     '(override with LET)')

        self.write_options()

        if self.options.dryrun:
            self.log('\n--> Dry run requested: exiting.')
            self.normal_termination()
            return

        try:
            if not self._stage_done('generated'):
                self.generate_candidates()
                self.save_resume('generated')

            if self.options.bypass:
                self.write_structures('unoptimized', energies=False)
                self.normal_termination()
                return

            if not self._stage_done('pruned'):
                self.compenetration_refining()
                self.similarity_refining(rmsd=(self.embed == 'refine'),
                                         verbose=True)
                self.save_resume('pruned')

            if self.options.optimization:
                self.optimization_stages()
            else:
                self.write_structures('unoptimized', energies=False)

        except ZeroCandidatesError:
            t_end_run = time.perf_counter()
            s = ('    Every embedded pose was discarded along the way. '
                 'First double-check the reactive indices and letter '
                 'pairings in the input; if those are right, some knobs '
                 'worth turning:\n'
                 '    - SHRINK pulls orbital centers outward, which helps '
                 'when the compenetration check rejects everything.\n'
                 '    - Widening the pairing distances with DIST gives the '
                 'fragments more room for the same reason.\n'
                 '    - CLASHES relaxes the clash-rejection thresholds '
                 'directly.\n'
                 '    - Higher STEPS values simply generate a larger '
                 'starting pool.\n')
            self.log(f'\n--> Program termination: No candidates found - '
                     f'Total time '
                     f'{time_to_string(t_end_run - self.t_start_run)}')
            self.log(s)
            self.logfile.close()
            clean_directory()
            return

        if self.options.metadynamics:
            self.metadynamics_augmentation()
            self.optimization_refining()
            self.similarity_refining()

        self.csearch_augmentation_routine()

        if self.options.saddle:
            self.saddle_refining()

        if self.options.nci and self.options.optimization:
            from tscode_tpu_torch.nci import print_nci
            print_nci(self)

        self.log_warnings()
        self.normal_termination()

    def optimization_stages(self):
        '''The force-field stages (pre-optimisation with every bond held
        when XTB docks two or more molecules, loose, tight on the fixed
        constraints), then the calculator's (ORCA first takes 3 and 5
        iterations, then loose and tight), each saved for resume
        (reference embedder.py:2300-2330).'''
        if self.options.ff_opt:
            if len(self.objects) > 1 and \
                    self.options.ff_calc == 'XTB' and \
                    not self._stage_done('ff_pre'):
                self.force_field_refining(conv_thr='loose',
                                          prevent_scrambling=True)
                self.save_resume('ff_pre')
            if not self._stage_done('ff_loose'):
                self.force_field_refining(conv_thr='loose')
                self.save_resume('ff_loose')
            if not self._stage_done('ff_tight'):
                self.force_field_refining(
                    conv_thr='tight', only_fixed_constraints=True)
                self.save_resume('ff_tight')

        if not (self.options.ff_opt and
                self.options.theory_level == getattr(
                    self.options, 'ff_level', None)):
            if self.options.calculator == 'ORCA' and \
                    not self._stage_done('opt_loose'):
                # stepwise ensemble pruning for expensive levels
                # (reference embedder.py:2313-2323)
                self.log('--> Performing ORCA optimization '
                         '(3 iterations, step 1/3)\n')
                self.optimization_refining(maxiter=3)
                self.log('--> Performing ORCA optimization '
                         '(5 iterations, step 2/3)\n')
                self.optimization_refining(maxiter=5)
                self.log('--> Performing ORCA optimization '
                         '(convergence, step 3/3)\n')
            if not self._stage_done('opt_loose'):
                self.optimization_refining(conv_thr='loose')
                self.save_resume('opt_loose')
            if not self._stage_done('opt_tight'):
                self.optimization_refining(
                    conv_thr='tight', only_fixed_constraints=True)
                self.save_resume('opt_tight')

    def data_termination(self):
        '''scan>, neb>, saddle>, mep_relax>, automep> and pka> runs show
        their data instead of embedding: pka> molecules get the pKa
        ladder, two or more scan> molecules the cumulative scan plot.'''
        # per-molecule operator names only (the full input lines in
        # options.operators would double-count and match filenames)
        ops = [op.split('>')[0].strip()
               for mol_ops in self.options.operators_dict.values()
               for op in mol_ops]
        if any(op == 'pka' for op in ops):
            self.pka_termination()
        if len([op for op in ops if op == 'scan']) > 1:
            self.scan_termination()
        self.log('--> Data run (pka>/scan>) complete.\n')
        self.normal_termination()

    def pka_termination(self):
        '''Formatted pKa ladder for every pka> molecule: free-energy
        legs, and absolute pKas vs the PKA(mol)=n reference when given
        (reference embedder.py:2395-2449).'''
        self.log('\n--> pKa energetics (from best conformers)')
        solv = self.options.solvent or 'gas phase'

        rows = [(mol.rootname,
                 f'{mol.reactive_indices[0]}'
                 f'({SYMBOLS[mol.atomnos[mol.reactive_indices[0]]]})',
                 mol.pka_data[0], round(mol.pka_data[1], 3))
                for mol in self.objects if hasattr(mol, 'pka_data')]
        headers = ['Name', '#(Symb)', 'Process', 'Energy (kcal/mol)']

        if hasattr(self, 'pka_ref'):
            dg_ref = next(mol.pka_data[1] for mol in self.objects
                          if mol.name == self.pka_ref[0])
            rt_ln10 = np.log(10) * 1.9872036e-3 * 298.15
            headers.append(f'pKa ({solv}, 298.15 K)')
            rows = [row + (round(
                ((mol.pka_data[1] - dg_ref) if 'HA' in mol.pka_data[0]
                 else (dg_ref - mol.pka_data[1])) / rt_ln10
                + self.pka_ref[1], 3),)
                for row, mol in zip(rows, (
                    m for m in self.objects if hasattr(m, 'pka_data')))]

        widths = [max(len(str(r[c])) for r in rows + [tuple(headers)])
                  for c in range(len(headers))]
        fmt = ' | '.join(f'{{:<{w}}}' for w in widths)
        self.log('    ' + fmt.format(*headers))
        self.log('    ' + '-+-'.join('-' * w for w in widths))
        for row in rows:
            self.log('    ' + fmt.format(*row))

        if self.options.theory_level is not None:
            self.log(f'\n  Level used is {self.options.theory_level} via '
                     f'{self.options.calculator}' +
                     (f', using the ALPB solvation model for '
                      f'{self.options.solvent}'
                      if self.options.solvent is not None else ''))

        # acid/base pair: report the proton-transfer equilibrium
        with_data = [m for m in self.objects if hasattr(m, 'pka_data')]
        if len(with_data) == 2:
            tags = tuple(m.pka_data[0] for m in with_data)
            if 'HA -> A-' in tags and 'B -> BH+' in tags:
                dg = sum(m.pka_data[1] for m in with_data)
                k_eq = np.exp(-dg / (1.9872036e-3 * 298.15))
                self.log('\n  Equilibrium data:')
                self.log(f'    HA + B -> BH+ + A-    '
                         f'K({solv}, 298.15 K) = {round(k_eq, 3)}')
                self.log(f'                         '
                         f'dG({solv}, 298.15 K) = {round(dg, 3)} kcal/mol')

    def scan_termination(self):
        '''Cumulative plot of the distance scans of every scan>
        molecule (where matplotlib is installed).'''
        from tscode_tpu_torch.utils import pyplot
        name = f'{self.stamp}_cumulative_plt.svg'
        plt = pyplot()
        if plt is None:
            self.log(f'\n--> matplotlib is not installed: skipped the '
                     f'cumulative scan plot {name}')
            return
        plt.figure()
        for mol in self.objects:
            if hasattr(mol, 'scan_data'):
                plt.plot(*mol.scan_data, label=mol.rootname)
        plt.legend()
        plt.title('Unified scan energetics')
        plt.xlabel('Distance (A)')
        plt.gca().invert_xaxis()
        plt.ylabel('Rel. E. (kcal/mol)')
        plt.savefig(name)
        plt.close()
        self.log(f'\n--> Written cumulative scan plot at {name}')
