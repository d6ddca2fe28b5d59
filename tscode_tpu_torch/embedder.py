'''
Engine of the port for the string route: input DSL parsing, embed-type
decision and the pipeline stages (counterpart of tscode_tpu/embedder.py).

Ported: parsing, pairings, keywords, the string branch of the set-up,
candidate generation by string embed, the compenetration stage (which the
string route skips), the TFD and MOI similarity prunes, structure
writes, the run report and resume. Every other route raises
NotImplementedError naming its ROADMAP.md item, before any embed work:
the other embed families, operators, optimisation (inputs without NOOPT
or BYPASS need calculators), SADDLE/TS, metadynamics and csearch
augmentation.

The device and dtype are explicit: `Embedder(filename, device='cuda')`
raises when there is no card, and the dtype defaults to float32 on CUDA
and float64 on the CPU. Termination returns instead of exiting, so the
engine is usable as a library (the CLI wraps it).
'''

import json
import logging
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

from tscode_tpu_torch.errors import InputError, ZeroCandidatesError
from tscode_tpu_torch.graphs import get_quadruplets, get_sum_graph
from tscode_tpu_torch.io_xyz import write_xyz
from tscode_tpu_torch.molecule import Molecule, align_by_moi, align_structures
from tscode_tpu_torch.options import KEYWORDS, Options, OptionSetter
from tscode_tpu_torch.quotes import quotes
from tscode_tpu_torch.references import references
from tscode_tpu_torch.settings import DEFAULT_LEVELS
from tscode_tpu_torch.utils import (auto_newline, clean_directory,
                              saturation_check, time_to_string)
from tscode_tpu_torch import __version__
from tscode_tpu_torch.backend import default_dtype, get_device
from tscode_tpu_torch.embeds.string import string_embed
from tscode_tpu_torch.ops.clash import count_intra_clashes_np
from tscode_tpu_torch.ops.linalg import rmsd_and_max
from tscode_tpu_torch.ops.moi import prune_by_moment_of_inertia
from tscode_tpu_torch.ops.tfd import prune_conformers_tfd
from tscode_tpu_torch.pivots import set_pivots


def not_ported(what, item):
    '''The error of a route this port does not run yet; `item` is a
    ROADMAP.md item number, or a string naming several.'''
    label = f'item {item}' if isinstance(item, int) else f'items {item}'
    return NotImplementedError(
        f'{what} is not ported to tscode_tpu_torch yet (ROADMAP.md '
        f'{label}); run it with the JAX package: python -m tscode_tpu')


class Embedder:
    '''Set-up state machine: parses the input file, loads molecules,
    reads pairings, applies keywords and decides the embed type.'''

    def __init__(self, filename, stamp=None, procs=None, threads=None,
                 run_in_place=False, *, device, dtype=None):
        self.device = get_device(device)
        self.dtype = dtype or default_dtype(self.device)
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
            self._check_ported_options()
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

    def _check_ported_options(self):
        '''Keywords whose stages this port does not run raise here,
        before any embed work.'''
        o = self.options
        if o.saddle:
            raise not_ported('SADDLE/TS saddle refinement', 15)
        if o.metadynamics:
            raise not_ported('MTD metadynamics augmentation', 15)
        if o.csearch_aug:
            raise not_ported('csearch augmentation', 14)
        if o.optimization:
            raise not_ported(
                'Optimisation of the candidates (an input without NOOPT '
                'or BYPASS needs the force-field and calculator layers)',
                '13 and 15')

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

        from tscode_tpu_torch.orbitals import get_atom_builder

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
        '''REFINE / refine>: the refine route.'''
        raise not_ported('The refine route (REFINE keyword, refine> '
                         'operator)', 11)

    def _apply_operators(self):
        if self.options.operators_dict:
            ops = sorted({op for mol_ops in
                          self.options.operators_dict.values()
                          for op in mol_ops})
            raise not_ported(f'Operators ({", ".join(o + ">" for o in ops)})',
                             15)

    # -------------------------------------------------------------- setup

    def _setup(self, p=True):
        '''Embed-type decision and angle grid of the string route; the
        other embed types raise NotImplementedError.'''
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
            if len(self.objects[0].reactive_indices) == 2:
                raise not_ported('The monomolecular embed', 12)
            self.embed = 'error'
            return

        elif len(self.objects) in (2, 3):
            n_reactive = [len(mol.reactive_indices) for mol in self.objects]
            cyclical = all(n == 2 for n in n_reactive)
            chelotropic = sorted(n_reactive) == [1, 2]
            string = len(self.objects) == 2 and n_reactive == [1, 1]
            multiembed = (len(self.objects) == 2 and
                          all(n >= 2 for n in n_reactive) and not cyclical)

            if cyclical or chelotropic or multiembed:
                kind = ('cyclical' if cyclical else
                        'multiembed' if multiembed else 'chelotropic')
                raise not_ported(f'The {kind} embed', 12)

            if not string:
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
            self.log(f'--> Setup performed correctly. {self.candidates} '
                     f'candidates will be generated.\n')

    def _get_number_of_candidates(self):
        '''String embed: spin steps times the lobe-conformer products.'''
        return int(self.options.rotation_steps * np.prod(
            [sum(len(mol.get_r_atoms(c)[0].center)
                 for c in range(mol.n_confs)) for mol in self.objects]))

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
            report['string_embed'] = self.embed_info
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
    in tscode_report_<stamp>.json at termination.'''
    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        before = len(getattr(self, 'structures', None)
                     if getattr(self, 'structures', None) is not None else ())
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

    def rel_energies(self):
        return self.energies - np.min(self.energies)

    def apply_mask(self, attributes, mask):
        for attr in attributes:
            if hasattr(self, attr):
                value = getattr(self, attr)
                if isinstance(value, np.ndarray) and len(value) == len(mask):
                    setattr(self, attr, value[mask])

    # ---------------------------------------------------------- pipeline

    @_timed_stage
    def generate_candidates(self):
        '''String embed on the run's device.'''
        structures, constrained = string_embed(
            self.objects[0], self.objects[1], self.systematic_angles,
            clash_thresh=self.options.clash_thresh, log=self.log,
            device=self.device, dtype=self.dtype, info=self.embed_info)
        self.structures = structures
        self.constrained_indices = constrained

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
        '''The string embed screened every pose already: no screen here,
        only the placeholder energies and exit status.'''
        self.energies = np.full(len(self.structures), 1e10)
        self.exit_status = np.zeros(len(self.structures), dtype=bool)

    @_timed_stage
    def similarity_refining(self, tfd=True, moi=True, verbose=False):
        '''TFD prune, then MOI prune (up to 500 structures). The RMSD
        prunes of the JAX package run only on the refine route here
        (ROADMAP.md item 11).'''
        if verbose:
            self.log('--> Similarity Processing')

        before = len(self.structures)
        attr = ('constrained_indices', 'energies', 'exit_status')

        if (tfd and len(self.objects) > 1 and hasattr(self, 'embed_graph')
                and self.embed_graph.is_single_molecule):
            t_start = time.perf_counter()
            quadruplets = get_quadruplets(self.embed_graph)
            if len(quadruplets) > 0:
                self.structures, mask = prune_conformers_tfd(
                    self.structures, quadruplets, device=self.device,
                    dtype=self.dtype)
                self.apply_mask(attr, mask)
                if False in mask:
                    self.log(f'Discarded {np.count_nonzero(~mask)} structures '
                             f'for TFD similarity ({np.count_nonzero(mask)} '
                             f'left, {time_to_string(time.perf_counter() - t_start)})')

        if moi and len(self.structures) <= 500:
            before3 = len(self.structures)
            t_start = time.perf_counter()
            self.structures, mask = prune_by_moment_of_inertia(
                self.structures, self.atomnos, device=self.device)
            self.apply_mask(attr, mask)
            if before3 > len(self.structures):
                self.log(f'Discarded {np.count_nonzero(~mask)} candidates '
                         f'for MOI similarity ({np.count_nonzero(mask)} left, '
                         f'{time_to_string(time.perf_counter() - t_start)})')

        if verbose and len(self.structures) == before:
            self.log(f'All structures passed the similarity check.{" " * 15}')
        self.log()

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

    RESUME_STAGES = ('generated', 'pruned')

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
        if state['stage'] not in self.RESUME_STAGES:
            raise not_ported(f'Resuming after stage {state["stage"]!r} '
                             f'(optimisation)', '13 and 15')
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
                self.similarity_refining(verbose=True)
                self.save_resume('pruned')

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

        self.log_warnings()
        self.normal_termination()
