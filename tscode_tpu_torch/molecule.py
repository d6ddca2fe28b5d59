'''
Molecule model: conformer ensembles with reactive-atom orbital geometry.

TPU-first re-design of the reference's Hypermolecule / Pivot
(TSCoDe's hypermolecule_class.py:120-408): ensembles are
held as padded-ready (n_confs, n_atoms, 3) float64 arrays, orbital
construction is a two-phase pure pass (classify -> flags -> build) rather
than the reference's mutable two-step class init, and every derived
quantity the device sweeps need (lobe centers, pivot tables) is exposed
as stacked numpy arrays.
'''

import os
import shutil
import subprocess

import numpy as np

from tscode_tpu_torch.errors import CCReadError
from tscode_tpu_torch.graphs import (graphize, is_sigmatropic_names,
                               is_vicinal_names, neighbors)
from tscode_tpu_torch.io_xyz import read_xyz
from tscode_tpu_torch.orbitals import (build_sp3, get_atom_builder,
                                 pre_init_type_name)
from tscode_tpu_torch.pt import SYMBOLS


def _kabsch_host(P, Q):
    '''Rotation U with P @ U ~ Q (the rmsd-package kabsch convention the
    reference relies on, hypermolecule_class.py:63).'''
    C = P.T @ Q
    V, _, W = np.linalg.svd(C)
    if np.linalg.det(V) * np.linalg.det(W) < 0:
        V = V.copy()
        V[:, -1] = -V[:, -1]
    return V @ W


def align_structures(structures, indices=None):
    '''
    Align every structure to the first by Kabsch over `indices`
    (all atoms when None), centering each on the index centroid.
    structures: (B, N, 3) -> aligned (B, N, 3).
    (reference hypermolecule_class.py:38-72)
    '''
    structures = np.array(structures, dtype=float)
    if isinstance(indices, (list, tuple)):
        indices = np.array(indices)
    idx = slice(0, structures.shape[1]) if (indices is None or len(np.atleast_1d(indices)) == 0) \
        else np.asarray(indices).ravel()

    structures -= structures[:, idx].mean(axis=1, keepdims=True)
    if len(structures) < 2:
        return structures

    try:
        # one batched SVD for every structure (numpy gufunc) — the
        # per-structure loop cost ~0.6 s on 2k-structure write paths
        C = np.einsum('na,tnb->tab', structures[0][idx],
                      structures[1:][:, idx])
        V, _, W = np.linalg.svd(C)
        flip = np.linalg.det(V) * np.linalg.det(W) < 0
        V[flip, :, -1] = -V[flip, :, -1]
        matrices = V @ W
    except np.linalg.LinAlgError:
        # degenerate geometry somewhere in the batch: per-structure
        # fallback, identity for the offending rows
        matrices = np.stack([np.eye(3)] * (len(structures) - 1))
        for t in range(1, len(structures)):
            try:
                matrices[t - 1] = _kabsch_host(structures[0][idx],
                                               structures[t][idx])
            except np.linalg.LinAlgError:
                pass

    out = np.concatenate([
        structures[:1],
        np.einsum('tij,tnj->tni', matrices, structures[1:])])
    return out


def _inertia_moments_host(structures, masses):
    '''Principal moments of inertia, ascending, in plain numpy — same
    math as ops.linalg.get_inertia_moments but host-side: this runs on
    small output ensembles at write time, where dragging JAX in (and
    possibly initializing a device backend outside ensure_backend)
    costs far more than a batch of 3x3 eigensolves.'''
    m = np.asarray(masses, dtype=float)
    com = (m[:, None] * structures).sum(axis=1) / m.sum()
    x = structures - com[:, None, :]
    r2 = np.sum(x * x, axis=-1)
    term1 = (m * r2).sum(axis=-1)[:, None, None] * np.eye(3)
    term2 = np.einsum('n,bni,bnj->bij', m, x, x)
    return np.linalg.eigvalsh(term1 - term2)


def align_by_moi(structures, atomnos):
    '''
    Align every structure to the first by superimposing diagonal
    moments-of-inertia frames (reference hypermolecule_class.py:74-118).
    '''
    from tscode_tpu_torch.pt import masses_of

    structures = np.array(structures, dtype=float)
    masses = masses_of(atomnos)

    structures -= structures.mean(axis=1, keepdims=True)
    out = np.zeros_like(structures)
    out[0] = structures[0]

    moments = _inertia_moments_host(structures, masses)

    ref_vecs = np.eye(3) * moments[0]
    for t in range(1, len(structures)):
        tgt_vecs = np.eye(3) * moments[t]
        try:
            matrix = _kabsch_host(ref_vecs, tgt_vecs)
        except np.linalg.LinAlgError:
            matrix = np.eye(3)
        out[t] = (matrix @ structures[t].T).T
    return out


def smi_to_3d(smiles, basename):
    '''SMILES -> 3D .xyz via obabel when available
    (reference utils.py:442-450); raises CCReadError otherwise.'''
    if shutil.which('obabel') is None:
        raise CCReadError(
            f'{smiles!r} is not a file and SMILES embedding requires '
            f'openbabel (obabel executable not found).')
    out = f'{basename}.xyz'
    # same flags as the reference (utils.py:446): -h forces explicit
    # hydrogens; --gen3d takes no operand (a stray value is parsed as an
    # extra input file on some openbabel builds)
    subprocess.run(['obabel', f'-:{smiles}', '-oxyz', f'-O{out}',
                    '-h', '--gen3d'], check=True, capture_output=True)
    return out


class Molecule:
    '''
    A conformer ensemble with optional reactive atoms.

    Attributes mirror what the embed layers consume:
      atomcoords (n_confs, n_atoms, 3) float64, centroid-centered
      atomnos    (n_atoms,) int
      graph      NetworkX bond graph of conformer 0
      reactive_indices  np.ndarray of int
      reactive_atoms    {conf: {index: ReactiveAtom}} once computed
      sigmatropic       [bool per conf], sp3_sigmastar bool
      rotation / position  pose transform set by the embedder
    '''

    def __init__(self, filename, reactive_indices=None, debug=False,
                 attrs=None):
        if not os.path.isfile(filename):
            if '.' in filename:
                raise SyntaxError(
                    f'Molecule {filename} cannot be read. Please check your syntax.')
            filename = smi_to_3d(filename, 'generated_3D_coords')

        self.rootname = filename.split('.')[0]
        self.name = filename
        self.debug = debug
        self.attrs = dict(attrs or {})     # molecule-line var=value attributes

        if isinstance(reactive_indices, np.ndarray):
            self.reactive_indices = reactive_indices
        else:
            self.reactive_indices = (np.array(reactive_indices)
                                     if isinstance(reactive_indices, (tuple, list))
                                     else np.array([], dtype=int))

        data = read_xyz(filename)
        coordinates = np.array(data.atomcoords)

        self.atomnos = np.asarray(data.atomnos)
        self.position = np.zeros(3)
        self.rotation = np.eye(3)

        if len(self.reactive_indices) and (
                self.reactive_indices.min() < 0
                or self.reactive_indices.max() >= len(self.atomnos)):
            from tscode_tpu_torch.errors import InputError
            raise InputError(
                f'Reactive indices {self.reactive_indices.tolist()} out of '
                f'range for {filename} ({len(self.atomnos)} atoms).')

        self.centroid = coordinates.mean(axis=(0, 1))
        self.atomcoords = coordinates - self.centroid
        self.graph = graphize(self.atomcoords[0], self.atomnos)

        self.reactive_atoms = {}
        self.sigmatropic = [False] * len(self.atomcoords)
        self.sp3_sigmastar = False

    def __repr__(self):
        r = self.rootname
        if self.reactive_atoms.get(0):
            r += f' {[str(a) for a in self.reactive_atoms[0].values()]}'
        return r

    @property
    def n_confs(self):
        return len(self.atomcoords)

    @property
    def n_atoms(self):
        return self.atomcoords.shape[1]

    # alias kept for parity with reference call sites
    @property
    def reactive_atoms_classes_dict(self):
        return self.reactive_atoms

    def compute_orbitals(self, override=None, confs=None):
        '''
        Classify reactive atom types, derive the sigmatropic / vicinal
        flags from the pre-init type names (faithful to the reference's
        init ordering, hypermolecule_class.py:195-217), then build each
        conformer's orbital geometry.

        confs: optional conformer ids to (re)build; other conformers
        keep their current atoms (containers are copied first, so a
        scoped rebuild never mutates a molecule sharing them). Used by
        the bending loop, where only the bent conformer's coordinates
        change per iteration.
        '''
        if len(self.reactive_indices) == 0:
            # reference parity: one (empty) entry per conformer
            # (hypermolecule_class.py:195-199 always builds the
            # per-conformer dict), so refine-mode companions can be
            # indexed by conformer without KeyError
            self.reactive_atoms = {c: {} for c in range(self.n_confs)}
            return

        self._orbital_override = override     # reused by scale_orbs
        self._builders = {
            int(i): get_atom_builder(self.graph, i, override=override)
            for i in self.reactive_indices}
        builders = self._builders
        pre_names = [pre_init_type_name(self, builders[int(i)], i)
                     for i in self.reactive_indices]

        self.sp3_sigmastar = is_vicinal_names(
            pre_names, self.reactive_indices, self.graph)

        if confs is None:
            rebuild = range(self.n_confs)
            self.sigmatropic = [
                is_sigmatropic_names(pre_names, self.atomcoords[c],
                                     self.reactive_indices, self.graph)
                for c in range(self.n_confs)]
            self.reactive_atoms = {}
        else:
            rebuild = confs
            self.sigmatropic = list(self.sigmatropic)
            for c in rebuild:
                self.sigmatropic[c] = is_sigmatropic_names(
                    pre_names, self.atomcoords[c],
                    self.reactive_indices, self.graph)
            self.reactive_atoms = dict(self.reactive_atoms)

        self._validate_lg()
        for c in rebuild:
            self.reactive_atoms[c] = {
                int(i): builders[int(i)](self, int(i), conf=c,
                                         **self._builder_kwargs(int(i)))
                for i in self.reactive_indices}

    def _builder_kwargs(self, i):
        '''Per-atom builder kwargs. The molecule-line lg= index is only
        passed to the sp3 atom it is actually bonded to — the reference
        rejects an unbonded leaving-group index
        (reactive_atoms_classes.py:163-168) — so a second sp3 reactive
        atom on the same molecule auto-infers its own leaving group.'''
        lg = self.attrs.get('lg')
        if (lg is not None and self._builders.get(i) is build_sp3
                and int(lg) in neighbors(self.graph, i)):
            return {'leaving_group_index': int(lg)}
        return {}

    def _validate_lg(self):
        '''Fail loudly when lg= names an atom bonded to none of the sp3
        reactive atoms (a silent ignore would mask a typo; the
        reference re-prompts interactively in this case).'''
        lg = self.attrs.get('lg')
        if lg is None:
            return
        if not any(self._builders.get(int(i)) is build_sp3
                   and int(lg) in neighbors(self.graph, int(i))
                   for i in self.reactive_indices):
            from tscode_tpu_torch.errors import InputError
            raise InputError(
                f'lg={lg} on {self.name}: atom {lg} is not bonded to '
                f'any sp3 reactive atom '
                f'({self.reactive_indices.tolist()}).')

    def scale_orbs(self, value):
        '''Rescale every orbital length by `value` (SHRINK keyword,
        reference hypermolecule_class.py:283-290). Atoms are rebuilt
        with the SAME type override and leaving-group index used by
        compute_orbitals, so only the length changes — never the
        orbital type or direction.'''
        for c in range(self.n_confs):
            for i, atom in self.reactive_atoms[c].items():
                orb_dim = np.linalg.norm(atom.center[0] - atom.coord)
                self.reactive_atoms[c][i] = self._builders[i](
                    self, i, conf=c, orb_dim=orb_dim * value,
                    **self._builder_kwargs(i))

    def restore_orb_lengths(self, lengths, confs=None):
        '''Rebuild reactive atoms imposing per-atom orbital lengths
        (index -> A), preserving type override and leaving group — the
        analog of the reference's orb_memo + atom.init(update=True,
        orb_dim=...) used during bending (ase_manipulations.py:849-858).
        confs: optional conformer ids to restrict the rebuild to (the
        bending loop passes the bent conformer).'''
        for c in (range(self.n_confs) if confs is None else confs):
            self.reactive_atoms[c] = dict(self.reactive_atoms[c])
            for i in list(self.reactive_atoms[c]):
                want = lengths.get(i)
                if want is None:
                    continue
                self.reactive_atoms[c][i] = self._builders[i](
                    self, i, conf=c, orb_dim=float(want),
                    **self._builder_kwargs(i))

    def get_r_atoms(self, c):
        return list(self.reactive_atoms[c].values())

    def get_centers(self, c):
        '''Per-reactive-atom lobe centers as a LIST of (K_i, 3) arrays —
        atoms can have different lobe counts, which numpy 2 refuses to
        pack into one ragged array (the reference's np.array object-
        array form, hypermolecule_class.py:296-302, consumed one row at
        a time anyway).'''
        return [np.asarray(atom.center) for atom in self.get_r_atoms(c)]

    def get_orbital_length(self, index):
        from tscode_tpu_torch.errors import NoOrbitalError
        if index not in self.reactive_indices:
            raise NoOrbitalError(
                f'Index provided must be a molecule reactive index ({index}, {self.name})')
        atom = self.reactive_atoms[0][index]
        return float(np.linalg.norm(atom.center[0] - atom.coord))

    def get_alignment_indices(self):
        '''Reactive atoms plus their bonded neighbors
        (reference hypermolecule_class.py:244-260).'''
        if len(self.reactive_indices) == 0:
            return None
        indices = set()
        for atom in self.reactive_indices:
            # the reference unions raw adjacency keys, which include the
            # atom itself via graphize's self-loop — a terminal reactive
            # atom still contributes 2 alignment points
            indices |= {int(atom)} | set(neighbors(self.graph, int(atom)))
        return list(indices)

    def write_hypermolecule(self):
        '''Debug output: every conformer with X dummy atoms at lobe centers
        (reference hypermolecule_class.py:350-364).'''
        hyp_name = self.rootname + '_hypermolecule.xyz'
        with open(hyp_name, 'w') as f:
            for c in range(self.n_confs):
                orbs = np.vstack([a.center for a in self.get_r_atoms(c)])
                f.write(f'{len(orbs) + self.n_atoms}\n')
                f.write(f'tscode_tpu hypermolecule {c} for {self.rootname} '
                        f'- reactive indices {self.reactive_indices}\n')
                for i, atom in enumerate(self.atomcoords[c]):
                    f.write('%-5s %-8s %-8s %-8s\n' % (
                        SYMBOLS[int(self.atomnos[i])],
                        round(atom[0], 6), round(atom[1], 6), round(atom[2], 6)))
                for orb in orbs:
                    f.write('%-5s %-8s %-8s %-8s\n' % (
                        'X', round(orb[0], 6), round(orb[1], 6), round(orb[2], 6)))
        return hyp_name


class Pivot:
    '''
    Vector connecting two orbital lobe centers for cyclical embeds
    (reference hypermolecule_class.py:376-408). For chelotropic
    molecules both lobes belong to the same reactive atom.
    '''

    __slots__ = ('start', 'end', 'start_atom', 'end_atom',
                 'pivot', 'meanpoint', 'index')

    def __init__(self, c1, c2, a1, a2, index1, index2):
        self.start = c1
        self.end = c2
        self.start_atom = a1
        self.end_atom = a2
        self.pivot = c2 - c1
        self.meanpoint = (c1 + c2) / 2.0
        self.index = (index1, index2)

    def __repr__(self):
        return (f'Pivot(index={self.index}, '
                f'norm={round(float(np.linalg.norm(self.pivot)), 3)})')
