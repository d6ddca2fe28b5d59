'''
XTB adapter: constrained optimizations, free energies, CREST searches.

Behavioral port of TSCoDe's calculators/_xtb.py with two
structural changes: jobs run in isolated scratch dirs via subprocess
cwd= (thread-safe, no os.chdir), and the recursive step-wise constrained
approach is an iterative loop rather than Python recursion (no
RecursionError hard-exit).
'''

import os
import subprocess

import numpy as np

from tscode_tpu_torch.calculators.common import EH_TO_KCAL, energy_grepper, scratch_dir
from tscode_tpu_torch.graphs import get_sum_graph
from tscode_tpu_torch.io_xyz import write_xyz

_STEP = 0.3    # recursive constrained-approach step size (A)


def read_from_xtbtraj(filename):
    '''Last frame + energy (kcal/mol) from an xtb optimization trajectory
    (reference _xtb.py:341-357).'''
    with open(filename) as f:
        lines = f.readlines()
    first_coord_line = len(lines) - next(
        i for i, line in enumerate(reversed(lines)) if 'energy:' in line)
    block = lines[first_coord_line:]
    coords = np.array([line.split()[1:4] for line in block], dtype=float)
    energy = float(lines[first_coord_line - 1].split()[1]) * EH_TO_KCAL
    return coords, energy


def _write_xtb_input(path, constrained_indices, constrained_distances,
                     constrained_dihedrals, constrained_dih_angles,
                     method, maxiter, trajname, outname, spring_constant,
                     constrain_string):
    s = (f'$opt\n   logfile={trajname}\n   output={outname}\n'
         f'   maxcycle={maxiter}\n')

    if constrained_indices is not None and len(constrained_indices):
        s += f'\n$constrain\n   force constant={spring_constant}\n'
        dists = constrained_distances if constrained_distances is not None \
            else [None] * len(constrained_indices)
        for (a, b), distance in zip(constrained_indices, dists):
            distance = distance if distance is not None else 'auto'
            s += f'   distance: {a + 1}, {b + 1}, {distance}\n'

    if constrained_dihedrals is not None and len(constrained_dihedrals):
        if constrained_indices is None or not len(constrained_indices):
            s += '\n$constrain\n'
        for (a, b, c, d), angle in zip(constrained_dihedrals,
                                       constrained_dih_angles):
            s += f'   dihedral: {a + 1}, {b + 1}, {c + 1}, {d + 1}, {angle}\n'

    if constrain_string is not None:
        s += '\n$constrain\n' + constrain_string

    if method.upper() in ('GFN-XTB', 'GFNXTB'):
        s += '\n$gfn\n   method=1\n'
    elif method.upper() in ('GFN2-XTB', 'GFN2XTB'):
        s += '\n$gfn\n   method=2\n'
    s += '\n$end'

    with open(path, 'w') as f:
        f.write(s)


def _xtb_flags(method, opt, conv_thr, charge, procs, solvent):
    flags = ['--norestart']
    if opt:
        flags += ['--opt', str(conv_thr)]
    if method.upper() in ('GFN-FF', 'GFNFF'):
        flags.append('--gfnff')
    if charge != 0:
        flags += ['--chrg', str(charge)]
    if procs is not None:
        flags += ['-P', str(procs)]
    if solvent is not None:
        if solvent == 'methanol':
            flags += ['--gbsa', 'methanol']
        else:
            flags += ['--alpb', solvent]
    elif method.upper() in ('GFN-FF', 'GFNFF'):
        # GFN-FF accuracy benefits from implicit CH2Cl2
        flags += ['--alpb', 'ch2cl2']
    return flags


def xtb_opt(coords, atomnos, constrained_indices=None,
            constrained_distances=None, constrained_dihedrals=None,
            constrained_dih_angles=None, method='GFN2-xTB', maxiter=500,
            solvent=None, charge=0, title='temp', read_output=True,
            procs=4, opt=True, conv_thr='tight', assert_convergence=False,
            constrain_string=None, recursive_stepsize=_STEP,
            spring_constant=1, **kwargs):
    '''
    Constrained xtb optimization (reference _xtb.py:30-294). Returns
    (coords, energy kcal/mol, success). The step-wise constrained
    approach walks each imposed distance toward its target in
    `recursive_stepsize` increments with loose spring constants, to avoid
    scrambling on large initial deviations.
    '''
    coords = np.asarray(coords, dtype=float).copy()

    if constrained_indices is not None and len(constrained_indices) == 0:
        constrained_indices = None
    if constrained_distances is not None and len(constrained_distances) == 0:
        constrained_distances = None

    # step-wise approach to distant targets (iterative version of the
    # reference's recursion, _xtb.py:116-163)
    if constrained_distances is not None and constrained_indices is not None:
        for i, (target_d, ci) in enumerate(zip(constrained_distances,
                                               constrained_indices)):
            if target_d is None or len(ci) != 2:
                continue
            a, b = ci
            # walk the pre-target from the CURRENT distance toward the
            # final target, one recursive_stepsize per loose opt — each
            # snap moves <= one step (the reference builds this chain
            # through recursion depth, _xtb.py:116-163; a pre-target set
            # one step from the FINAL target would snap the atom the
            # whole remaining distance in one move, scrambling exactly
            # what this mechanism exists to prevent)
            for _ in range(200):
                d = np.linalg.norm(coords[b] - coords[a])
                delta = d - target_d
                if abs(delta) <= recursive_stepsize:
                    break
                pre_t = d - recursive_stepsize * np.sign(delta)
                vec = (coords[b] - coords[a])
                coords[b] -= vec / np.linalg.norm(vec) * (d - pre_t)
                pre = list(constrained_distances)
                pre[i] = pre_t
                coords, _, _ = xtb_opt(
                    coords, atomnos, constrained_indices,
                    constrained_distances=pre, method=method,
                    solvent=solvent, charge=charge, maxiter=50,
                    title=title, procs=procs, conv_thr='loose',
                    constrain_string=constrain_string,
                    recursive_stepsize=1e9,   # no nested stepping
                    spring_constant=0.25)
            d = np.linalg.norm(coords[b] - coords[a])
            delta = d - target_d
            vec = (coords[b] - coords[a])
            coords[b] -= vec / np.linalg.norm(vec) * delta

    maxiter = maxiter if maxiter is not None else 0
    outname = 'xtbopt.xyz'
    trajname = f'{title}_opt_log.xyz'

    with scratch_dir(title) as cwd:
        with open(os.path.join(cwd, f'{title}.xyz'), 'w') as f:
            write_xyz(coords, atomnos, f, title=title)
        _write_xtb_input(os.path.join(cwd, f'{title}.inp'),
                         constrained_indices, constrained_distances,
                         constrained_dihedrals, constrained_dih_angles,
                         method, maxiter, trajname, outname,
                         spring_constant, constrain_string)

        flags = _xtb_flags(method, opt, conv_thr, charge, procs, solvent)
        with open(os.path.join(cwd, f'{title}.out'), 'w') as f:
            try:
                subprocess.check_call(
                    ['xtb', f'{title}.xyz', '--input', f'{title}.inp'] + flags,
                    stdout=f, stderr=subprocess.STDOUT, cwd=cwd)
            except subprocess.CalledProcessError:
                if assert_convergence:
                    raise

        if not read_output:
            return None

        energy = None
        if opt:
            traj_path = os.path.join(cwd, trajname)
            if os.path.isfile(traj_path):
                coords, energy = read_from_xtbtraj(traj_path)
        else:
            energy = energy_grepper(os.path.join(cwd, f'{title}.out'),
                                    'TOTAL ENERGY', 3)
            if energy is not None:
                # single points report in Eh; everything this module
                # returns is kcal/mol (reference _xtb.py:427-438)
                energy *= EH_TO_KCAL

    return coords, energy, True


def xtb_pre_opt(coords, atomnos, graphs, constrained_indices=None,
                constrained_distances=None, **kwargs):
    '''Pre-optimization constraining EVERY bond of the molecular graphs
    (reference _xtb.py:296-339), preventing identity scrambling.'''
    sum_graph = get_sum_graph(graphs, extra_edges=constrained_indices)
    constr_list = [[a, b] for a, b in constrained_indices] \
        if constrained_indices is not None else []

    constrain_string = '$constrain\n'
    for a, b in ((a, b) for a, b in sum_graph.edges if a != b):
        if constrained_distances is not None and [a, b] in constr_list:
            distance = constrained_distances[constr_list.index([a, b])]
        else:
            distance = 'auto'
        constrain_string += f'  distance: {a + 1}, {b + 1}, {distance}\n'
    constrain_string += '\n$end'

    return xtb_opt(coords, atomnos,
                   constrained_indices=constrained_indices,
                   constrained_distances=constrained_distances,
                   constrain_string=constrain_string, **kwargs)


def xtb_get_free_energy(coords, atomnos, method='GFN2-xTB', solvent=None,
                        charge=0, title='temp', sph=False, procs=4,
                        **kwargs):
    '''Free energy via --ohess/--bhess (reference _xtb.py:440-512).
    Returns G in kcal/mol or None.'''
    with scratch_dir(title) as cwd:
        with open(os.path.join(cwd, f'{title}.xyz'), 'w') as f:
            write_xyz(coords, atomnos, f, title=title)

        flags = ['--norestart', '--bhess' if sph else '--ohess']
        if method.upper() in ('GFN-FF', 'GFNFF'):
            flags.append('--gfnff')
        elif method.upper() in ('GFN-XTB', 'GFNXTB'):
            flags += ['--gfn', '1']
        if charge != 0:
            flags += ['--chrg', str(charge)]
        if procs is not None:
            flags += ['-P', str(procs)]
        if solvent is not None:
            flags += (['--gbsa', 'methanol'] if solvent == 'methanol'
                      else ['--alpb', solvent])

        outpath = os.path.join(cwd, f'{title}.out')
        with open(outpath, 'w') as f:
            try:
                subprocess.check_call(['xtb', f'{title}.xyz'] + flags,
                                      stdout=f, stderr=subprocess.STDOUT,
                                      cwd=cwd)
            except subprocess.CalledProcessError:
                return None

        g = energy_grepper(outpath, 'TOTAL FREE ENERGY', 4)
        return g * EH_TO_KCAL if g is not None else None


def parse_xtb_scoord(filename):
    '''Parse an xtb scoord.N file (Bohr) into Angstrom coordinates.'''
    BOHR = 0.529177210903
    coords = []
    with open(filename) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4 and parts[3].isalpha():
                coords.append([float(p) * BOHR for p in parts[:3]])
    return np.array(coords)


def xtb_metadyn_augmentation(coords, atomnos, constrained_indices=None,
                             new_structures=5, title=0, **kwargs):
    '''GFN-FF metadynamics sampling around a structure, constraints held
    (reference _xtb.py:528-584). Returns (n, N, 3) structures
    (the input plus new_structures-1 snapshots).'''
    with scratch_dir(f'mtd{title}') as cwd:
        with open(os.path.join(cwd, 'temp.xyz'), 'w') as f:
            write_xyz(coords, atomnos, f, title='temp')

        s = ('$md\n'
             f'   time={new_structures}\n'
             '   step=1\n'
             '   temp=300\n'
             '$end\n'
             '$metadyn\n'
             f'   save={new_structures}\n'
             '$end')
        if constrained_indices is not None and len(constrained_indices):
            s += '\n$constrain\n'
            for a, b in constrained_indices:
                d = round(float(np.linalg.norm(coords[a] - coords[b])), 5)
                s += f'   distance: {a + 1}, {b + 1}, {d}\n'
        with open(os.path.join(cwd, 'temp.inp'), 'w') as f:
            f.write(s)

        with open(os.path.join(cwd, 'mtd.log'), 'w') as f:
            subprocess.check_call(
                ['xtb', '--md', '--input', 'temp.inp', 'temp.xyz',
                 '--gfnff'],
                stdout=f, stderr=subprocess.STDOUT, cwd=cwd)

        structures = [coords]
        for n in range(1, new_structures):
            name = os.path.join(cwd, f'scoord.{n}')
            if os.path.isfile(name):
                structures.append(parse_xtb_scoord(name))
    return np.array(structures)


_CREST_METHOD_FLAGS = {
    'GFN-FF': '--gfnff', 'GFNFF': '--gfnff',
    'GFN2-XTB': '--gfn2', 'GFN2': '--gfn2',
    'GFN2-XTB//GFN-FF': '--gfn2//gfnff', 'GFN2//GFNFF': '--gfn2//gfnff',
}


def crest_mtd_search(coords, atomnos, constrained_indices=None,
                     constrained_distances=None,
                     method='GFN2-xTB//GFN-FF', solvent=None, charge=0,
                     kcal=10, ncimode=False, title='temp', procs=4,
                     **kwargs):
    '''CREST metadynamic conformational search
    (reference _xtb.py:599-793). Returns (ensemble coords, energies).
    The method maps to CREST's --gfnff/--gfn2/--gfn2//gfnff flags
    (reference :722-731) so retry-at-stabler-method works.'''
    with scratch_dir(title) as cwd:
        with open(os.path.join(cwd, f'{title}.xyz'), 'w') as f:
            write_xyz(coords, atomnos, f, title=title)

        mflag = _CREST_METHOD_FLAGS.get(method.upper() if method else '',
                                        '--gfn2//gfnff')
        flags = [mflag, '--noreftopo', '--ewin', str(kcal)]
        if ncimode:
            flags.append('--nci')
        if charge != 0:
            flags += ['--chrg', str(charge)]
        if procs is not None:
            flags += ['-T', str(procs)]
        if solvent is not None:
            flags += ['--alpb', solvent]

        if constrained_indices is not None and len(constrained_indices):
            # constrain the reactive distances, metadynamics on the rest
            cinp = '$constrain\n  force constant=1\n'
            atoms = sorted({int(i) + 1 for pair in constrained_indices
                            for i in pair})
            if constrained_distances is None:
                constrained_distances = [None] * len(constrained_indices)
            for (a, b), cd in zip(constrained_indices,
                                  constrained_distances):
                cd = 'auto' if cd is None else cd
                cinp += f'  distance: {a + 1}, {b + 1}, {cd}\n'
            all_atoms = set(range(1, len(atomnos) + 1)) - set(atoms)
            if all_atoms:
                ranges = ','.join(str(i) for i in sorted(all_atoms))
                cinp += f'$metadyn\n  atoms: {ranges}\n'
            cinp += '$end\n'
            with open(os.path.join(cwd, 'constraints.inp'), 'w') as f:
                f.write(cinp)
            flags += ['--cinp', 'constraints.inp']

        with open(os.path.join(cwd, f'{title}.out'), 'w') as f:
            subprocess.check_call(['crest', f'{title}.xyz'] + flags,
                                  stdout=f, stderr=subprocess.STDOUT,
                                  cwd=cwd)

        from tscode_tpu_torch.io_xyz import read_xyz
        data = read_xyz(os.path.join(cwd, 'crest_conformers.xyz'))
        energies = []
        for comment in data.comments:
            try:
                energies.append(float(comment.split()[0]) * EH_TO_KCAL)
            except (ValueError, IndexError):
                # unparsable comment: +inf, so a bad parse can never
                # rank that conformer as the global minimum
                energies.append(np.inf)
        return data.atomcoords, np.array(energies)


def crest_mtd_search_operator(embedder, mol):
    '''mtd_search> operator: replace a molecule's ensemble with CREST
    conformers (reference operators.py:433-584, core path).'''
    from tscode_tpu_torch.settings import CREST_AVAILABLE
    if not CREST_AVAILABLE:
        from tscode_tpu_torch.errors import InputError
        raise InputError('mtd_search> requires the crest binary on PATH.')

    embedder.log(f'--> {mol.rootname}: CREST metadynamic search')

    # internal pairing constraints (same letter twice on this molecule)
    # hold through the search with their imposed distances (reference
    # operators.py:480-544)
    mol_id = embedder.objects.index(mol) if mol in embedder.objects else None
    internal, internal_d = None, None
    if mol_id is not None and mol_id in getattr(embedder, 'pairings_dict', {}):
        pairs = [tgt for tgt in embedder.pairings_dict[mol_id].values()
                 if isinstance(tgt, tuple)]
        if pairs:
            internal = np.array(pairs)
            internal_d = [
                embedder.get_pairing_dists_from_constrained_indices(cp)
                for cp in pairs]

    ensembles = []
    for c in range(mol.n_confs):
        kwargs = dict(
            constrained_indices=internal,
            constrained_distances=internal_d,
            solvent=embedder.options.solvent,
            charge=embedder.options.charge,
            kcal=embedder.options.kcal_thresh or 10,
            ncimode=embedder.options.crestnci,
            title=f'{mol.rootname}_mtd{c}', procs=embedder.procs)
        try:
            coords, _conf_energies = crest_mtd_search(
                mol.atomcoords[c], mol.atomnos, **kwargs)
        except subprocess.CalledProcessError:
            # structure-level fault tolerance: retry at plain GFN2-XTB,
            # slower but more stable (reference operators.py:531-546)
            embedder.log('    Metadynamics run failed with '
                         'GFN2-XTB//GFN-FF, retrying with just GFN2-XTB '
                         '(slower but more stable)')
            coords, _conf_energies = crest_mtd_search(
                mol.atomcoords[c], mol.atomnos, method='GFN2-XTB',
                **kwargs)
        ensembles.append(coords)

    new_coords = np.concatenate(ensembles)

    # TFD -> RMSD -> rotationally-corrected RMSD pruning of the merged
    # ensemble (reference operators.py:563-570)
    from tscode_tpu_torch.ops.tfd import prune_conformers_tfd
    from tscode_tpu_torch.graphs import get_quadruplets
    quads = get_quadruplets(mol.graph)
    if len(quads):
        _, keep = prune_conformers_tfd(new_coords, quads,
                                       device=embedder.device)
        new_coords = new_coords[keep]
    if len(new_coords) < 5e4:
        # the pruned copy lies on the device in the run's dtype; keep
        # the host float64 rows it selects
        from tscode_tpu_torch.ops.rmsd_prune import prune_conformers_rmsd
        _, keep = prune_conformers_rmsd(new_coords, mol.atomnos,
                                        device=embedder.device,
                                        dtype=embedder.dtype)
        new_coords = new_coords[keep]
    if len(new_coords) < 1e3:
        from tscode_tpu_torch.rot_rmsd import prune_conformers_rmsd_rot_corr
        new_coords, _ = prune_conformers_rmsd_rot_corr(
            new_coords, mol.atomnos, mol.graph)

    from tscode_tpu_torch.molecule import Molecule
    new_mol = Molecule.__new__(Molecule)
    new_mol.__dict__.update(mol.__dict__)
    new_mol.atomcoords = np.asarray(new_coords)
    new_mol.reactive_atoms = {}
    if len(mol.reactive_indices):
        new_mol.compute_orbitals()
    embedder.log(f'    kept {len(new_coords)} conformers')
    return new_mol
