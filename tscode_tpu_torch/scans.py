'''
Scan operators: distance scans (2 indices) and dihedral (atropisomer)
scans (4 indices) (counterpart of tscode_tpu/scans.py).

Each scan point is a constrained relaxation on the internal harmonic
force field (graph-restrained), float64 on the run's device: batched
FIRE on one structure, one launch of the force field's FIRE kernel a
point on the card (the tables, pairs, targets and freeze mask flow
through energy_args). With a calculator chosen, each point is a
constrained optimisation on it (calculators.dispatch.optimize) and the
sub-peak refinements run on its gradients (calculators.gradients: the
host-loop dimer, the callback NEB).

The plots are written where matplotlib is installed; the log says when
one was skipped.
'''

import time

import numpy as np
import torch

from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.ff import FireTerms, ff_energy, molecule_params
from tscode_tpu_torch.io_xyz import write_xyz
from tscode_tpu_torch.ops.linalg import dihedral as dihedral_fn
from tscode_tpu_torch.optimizers import fire_minimize_batch, spring_energy
from tscode_tpu_torch.pt import COVALENT_RADII
from tscode_tpu_torch.utils import (get_scan_peak_index, pyplot,
                                    time_to_string)


def _ff_spring_energy(c, p, prs, tgt):
    # module-level, carrying the FIRE kernel's terms (fire_terms below)
    return ff_energy(c, p) + spring_energy(c, prs, tgt, k=50.0)


# the terms of the force-field FIRE kernel
_ff_spring_energy.fire_terms = lambda p, prs, tgt: FireTerms(
    p, spring_pairs=prs, spring_targets=tgt, spring_k=50.0)


def _measure(coords, quad, device):
    '''The dihedral of the quad atoms of coords (numpy), degrees.'''
    return float(dihedral_fn(torch.as_tensor(
        coords[list(quad)], dtype=torch.float64, device=device)))


def _relax_point(embedder, mol, coords, pair=None, pair_dist=None,
                 dihedral=None, dihedral_angle=None, move_mask=None):
    '''One constrained relaxation on the internal force field, on the
    run's device: a harmonic spring (k = 50) holds `pair` at pair_dist,
    or `dihedral` is imposed geometrically and its four atoms frozen.
    With a calculator chosen, a constrained optimisation on it instead.
    Returns (coords numpy, energy kcal/mol).'''
    if embedder.options.calculator is not None:
        from tscode_tpu_torch.calculators.dispatch import optimize
        kwargs = {}
        if dihedral is not None:
            kwargs = dict(constrained_dihedrals=np.array([dihedral]),
                          constrained_dih_angles=np.array([dihedral_angle]))
        new_coords, energy, _ = optimize(
            coords, mol.atomnos, embedder.options.calculator,
            method=embedder.options.theory_level,
            constrained_indices=(np.array([pair]) if pair is not None
                                 else None),
            constrained_distances=([pair_dist] if pair is not None
                                   else None),
            solvent=embedder.options.solvent,
            charge=embedder.options.charge,
            procs=embedder.procs, check=False, **kwargs)
        return new_coords, energy

    from tscode_tpu_torch.rot_rmsd import _rotate
    from tscode_tpu_torch.torsions import get_rotation_mask

    device = embedder.device
    params = molecule_params(mol, device)
    work = coords.copy()
    freeze = None
    if dihedral is not None:
        # impose the torsion geometrically, then relax with the four
        # dihedral atoms frozen to hold the rotated value
        delta = dihedral_angle - _measure(work, dihedral, device)
        mask = (move_mask if move_mask is not None
                else get_rotation_mask(mol.graph, tuple(dihedral)))
        cand = _rotate(work, tuple(dihedral), delta, mask)
        # the rotation mask may have been inverted (its >half-atoms
        # optimization), flipping the sign of the imposed change
        achieved = _measure(cand, dihedral, device)
        err_fwd = abs((achieved - dihedral_angle + 180) % 360 - 180)
        if err_fwd > 1e-3:
            cand = _rotate(work, tuple(dihedral), -delta, mask)
        work = cand
        freeze = np.zeros(len(work), dtype=bool)
        freeze[list(dihedral)] = True

    x = torch.as_tensor(work, dtype=torch.float64, device=device)[None]
    if pair is not None:
        pairs = torch.as_tensor(np.array([pair]), dtype=torch.int64,
                                device=device)
        targets = torch.as_tensor(np.array([pair_dist]), dtype=torch.float64,
                                  device=device)
        relaxed, e, _ = fire_minimize_batch(
            x, _ff_spring_energy, n_steps=200, fmax=0.05,
            freeze_mask=freeze, energy_args=(params, pairs, targets))
    else:
        relaxed, e, _ = fire_minimize_batch(
            x, ff_energy, n_steps=200, fmax=0.05, freeze_mask=freeze,
            energy_args=(params,))
    return relaxed[0].cpu().numpy(), float(e[0])


def scan_operator(embedder, mol):
    '''Dispatch on the index count.'''
    assert mol.n_confs == 1, \
        'The scan> operator works on a single .xyz geometry.'
    assert len(mol.reactive_indices) in (2, 4), \
        'The scan> operator needs two or four indices ' \
        f'({len(mol.reactive_indices)} were provided)'

    if len(mol.reactive_indices) == 2:
        distance_scan(embedder, mol)
    else:
        dihedral_scan(embedder, mol)
    return mol


def distance_scan(embedder, mol, step_size=0.05):
    '''Approach (non-bonded) or separate (bonded) two atoms in steps of
    step_size A, looking for the energy maximum. Writes the trajectory,
    the maximum and a plot. Returns (dists, relative energies,
    structures, index of the maximum).'''
    embedder.t_start_run = time.perf_counter()
    t_start = time.perf_counter()

    i1, i2 = (int(i) for i in mol.reactive_indices)
    coords = mol.atomcoords[0].copy()
    d = float(np.linalg.norm(coords[i1] - coords[i2]))

    # separate bonded pairs, approach non-bonded ones
    bonded = mol.graph.has_edge(i1, i2)
    step = step_size if bonded else -step_size

    embedder.log(
        f'--> {mol.rootname} - Performing a distance scan '
        f'{"approaching" if step < 0 else "separating"} indices {i1} and '
        f'{i2} - step size {round(step, 2)} A\n    Theory level is '
        f'{embedder.options.theory_level} via '
        f'{embedder.options.calculator or "internal FF"}')

    r_sum = COVALENT_RADII[int(mol.atomnos[i1])] + \
        COVALENT_RADII[int(mol.atomnos[i2])]
    if step < 0:
        max_iterations = round((d - 0.9 * r_sum) / abs(step))
    else:
        max_iterations = round((1.8 * r_sum - d) / abs(step))
    max_iterations = max(max_iterations, 1)

    dists, energies, structures = [], [], []
    e_0 = None
    for it in range(max_iterations):
        t_step = time.perf_counter()
        coords, energy = _relax_point(embedder, mol, coords,
                                      pair=(i1, i2), pair_dist=d)
        if e_0 is None:
            e_0 = energy
        energies.append(energy - e_0)
        dists.append(d)
        structures.append(coords.copy())
        embedder.log(f'Step {it + 1}/{max_iterations} - d={round(d, 2)} A '
                     f'- {round(energy - e_0, 2):4} kcal/mol - '
                     f'{time_to_string(time.perf_counter() - t_step)}')
        d += step

    id_max = get_scan_peak_index(energies)

    title = mol.rootname + ' distance scan'
    plt = pyplot()
    if plt is None:
        embedder.log('--> matplotlib is not installed: skipped the plot '
                     f'of the {title}')
    else:
        plt.figure()
        plt.plot(dists, energies, color='tab:red', label='Scan energy',
                 linewidth=3)
        plt.plot(dists[id_max], energies[id_max], color='gold',
                 label='Energy maximum (TS guess)', marker='o',
                 markersize=3)
        plt.legend()
        plt.title(title)
        plt.xlabel(f'indices {i1}-{i2} distance (A)')
        if step > 0:
            plt.gca().invert_xaxis()
        plt.ylabel('Rel. E. (kcal/mol)')
        plt.savefig(f'{title.replace(" ", "_")}_plt.svg')

    with open(f'{mol.rootname}_scan.xyz', 'w') as f:
        for i, (s, dd, e) in enumerate(zip(structures, dists, energies)):
            write_xyz(s, mol.atomnos, f,
                      title=f'Scan point {i + 1}/{len(structures)} - '
                            f'd({i1}-{i2}) = {round(dd, 2)} A - '
                            f'Rel. E = {round(e, 2)} kcal/mol')

    with open(f'{mol.rootname}_scan_max.xyz', 'w') as f:
        write_xyz(structures[id_max], mol.atomnos, f,
                  title=f'Scan point {id_max + 1}/{len(structures)} - '
                        f'd({i1}-{i2}) = {round(dists[id_max], 3)} A - '
                        f'Rel. E = {round(energies[id_max], 3)} kcal/mol')

    embedder.log(f'\n--> Written {len(structures)} structures to '
                 f'{mol.rootname}_scan.xyz '
                 f'({time_to_string(time.perf_counter() - t_start)})')
    embedder.log(f'--> Written energy maximum to '
                 f'{mol.rootname}_scan_max.xyz\n')

    mol.scan_data = (dists, energies)
    return dists, energies, structures, id_max


def atropisomer_peaks(energies, min_thr=0.1, max_thr=75):
    '''Indices of local maxima within the threshold window: strict rise
    on the left, non-strict fall on the right, and a peak must equal the
    maximum of the five points around it; the last two indices are never
    peaks. Index 0 compares its left neighbor against the wrapped last
    value. For i < 2 the window is clipped to [max(i-2, 0), i+3).'''
    e = np.asarray(energies)
    _l = len(e)
    return [i for i in range(max(_l - 2, 0))
            if e[i - 1] < e[i] >= e[i + 1]
            and max_thr > e[i] > min_thr
            and e[i] == e[max(i - 2, 0):i + 3].max()]


def _moved_atoms_mask(embedder, mol, quad):
    '''Which atoms rotate when driving the quad torsion. Contiguous
    acyclic quads rotate the i2-side subtree (default mask, None); a
    quad inside a cycle, or a non-contiguous one (LET), moves only the
    last atom and lets relaxation carry the rest.'''
    import networkx as nx

    i1, i2, i3, i4 = quad
    contiguous = all(mol.graph.has_edge(a, b)
                     for a, b in zip(quad[:-1], quad[1:]))
    if not contiguous:
        if not embedder.options.let:
            raise InputError(
                'The specified dihedral angle is made up of non-contiguous '
                'atoms. To prevent errors, the run has been stopped. '
                'Override this behavior with the LET keyword.')
        embedder.log('    Non-contiguous dihedral indices: moving only the '
                     'last index (LET override).')
    else:
        graph = mol.graph.copy()
        graph.remove_edge(i2, i3)
        if nx.has_path(graph, i1, i3):
            embedder.log('    The dihedral angle is comprised within a '
                         'cycle: switching to safe scan (moving only the '
                         'last index).')
        else:
            return None          # default: full subtree rotation mask

    mask = np.zeros(mol.n_atoms, dtype=bool)
    mask[i4] = True
    return mask


def _dihedral_sweep(embedder, mol, start_coords, quad, step_deg, min_steps,
                    move_mask, title, ad_libitum=False, max_steps=1000):
    '''Sequential relaxed sweep of the quad torsion by step_deg per
    point. Fixed length (min_steps) by default; with ad_libitum, keeps
    going past min_steps until the energy profile shows the hill was
    crossed. Returns (angles deg, absolute energies kcal/mol,
    structures).'''
    coords = np.asarray(start_coords).copy()
    angle = _measure(coords, quad, embedder.device)
    angles, energies, structures = [], [], []

    for k in range(max_steps):
        coords, energy = _relax_point(embedder, mol, coords, dihedral=quad,
                                      dihedral_angle=angle,
                                      move_mask=move_mask)
        angles.append(angle)
        energies.append(energy)
        structures.append(coords.copy())
        angle += step_deg

        if k + 1 >= min_steps:
            if not ad_libitum:
                break
            crest = max(energies)
            if ((crest - energies[-1]) > 1.0
                    or energies[-1] < energies[0]
                    or (energies[-1] - min(energies)) > 50.0):
                break

    embedder.log(f'    {title}: {len(structures)} points '
                 f'({step_deg:+g} deg steps)', p=False)
    return angles, energies, structures


def _refine_subpeak(embedder, mol, fine_S, fine_E, sub_peak, label):
    '''SADDLE (dimer) or NEB refinement of one accurate-scan sub-peak,
    per the run's options, on the calculator's gradients when one is
    chosen and on the internal force field otherwise; the plain
    sub-peak geometry without either option. Returns (coords, absolute
    energy), or None when the refined geometry scrambled.'''
    from tscode_tpu_torch.utils import molecule_check

    guess = fine_S[sub_peak]

    if embedder.options.saddle:
        embedder.log(f'  > Saddle opt on {label}')
        if embedder.options.calculator is not None:
            from tscode_tpu_torch.calculators.gradients import \
                make_gradient_fn
            from tscode_tpu_torch.saddle import dimer_saddle_callback
            grad_fn = make_gradient_fn(
                mol.atomnos, calculator=embedder.options.calculator,
                method=embedder.options.theory_level,
                solvent=embedder.options.solvent,
                charge=embedder.options.charge, procs=embedder.procs)
            refined, energy, _ = dimer_saddle_callback(guess, grad_fn)
        else:
            from tscode_tpu_torch.saddle import saddle_refine_structure
            refined, energy, _ = saddle_refine_structure(
                guess, mol.atomnos, mol.graph, device=embedder.device)
        if molecule_check(guess, refined, mol.atomnos):
            return refined, energy
        embedder.log(f'    {label}: saddle opt scrambled the structure - '
                     'discarded')
        return None

    if embedder.options.neb:
        embedder.log(f'  > NEB TS opt on {label}')
        lo = fine_S[sub_peak - 2]
        hi = fine_S[(sub_peak + 1) % len(fine_S)]
        if embedder.options.calculator is not None:
            from tscode_tpu_torch.calculators.gradients import \
                make_chain_gradient_fn
            from tscode_tpu_torch.neb import run_neb_callback
            chain_fn = make_chain_gradient_fn(
                mol.atomnos, calculator=embedder.options.calculator,
                method=embedder.options.theory_level,
                solvent=embedder.options.solvent,
                charge=embedder.options.charge, procs=embedder.procs)
            chain, energies, ts_index = run_neb_callback(
                lo, hi, chain_fn, n_images=5, device=embedder.device)
        else:
            from tscode_tpu_torch.neb import run_neb
            chain, energies, ts_index = run_neb(
                lo, hi, ff_energy, n_images=5,
                energy_args=(molecule_params(mol, embedder.device),),
                device=embedder.device)
        refined = np.asarray(chain[ts_index])
        if molecule_check(lo, refined, mol.atomnos):
            return refined, float(energies[ts_index])
        embedder.log(f'    {label}: NEB TS scrambled the structure - '
                     'discarded')
        return None

    return guess, fine_E[sub_peak]


def dihedral_scan(embedder, mol, prelim_step=10):
    '''
    Atropisomer workflow: clockwise and counterclockwise coarse scans of
    the driven torsion, peak detection above the kcal threshold, an ad
    libitum re-scan in steps of a tenth over each peak, optional
    SADDLE/NEB refinement of every sub-peak, then the RMSD prune of the
    collected maxima (on the run's device: kernel K3 on the card) and an
    MOI-aligned 'maxima' ensemble with barrier heights. Per-direction
    trajectory and plot files.
    '''
    embedder.t_start_run = time.perf_counter()
    quad = tuple(int(i) for i in mol.reactive_indices)
    coords0 = mol.atomcoords[0].copy()

    # scans default to a 5 kcal/mol peak threshold unless KCAL was given
    thr_kcal = (embedder.options.kcal_thresh
                if 'KCAL' in embedder.kw_line.upper() else 5.0)

    from tscode_tpu_torch.molecule import align_structures

    embedder.log(f'--> {mol.rootname} - dihedral scan on atoms {quad}, '
                 f'{prelim_step} deg preliminary steps, both directions '
                 f'({embedder.options.calculator or "internal FF"})')

    move_mask = _moved_atoms_mask(embedder, mol, quad)
    n_coarse = int(360 / prelim_step)
    plt = pyplot()

    maxima_S, maxima_E = [], []
    for step_deg, direction in ((prelim_step, 'clockwise'),
                                (-prelim_step, 'counterclockwise')):
        angles, energies, structures = _dihedral_sweep(
            embedder, mol, coords0, quad, step_deg, n_coarse, move_mask,
            title=f'Preliminary scan ({direction})')
        e_min = min(energies)

        # per-direction trajectory, energies relative to the scan minimum
        scan_name = f'{mol.rootname}_torsion_scan_{direction}.xyz'
        with open(scan_name, 'w') as f:
            aligned = align_structures(np.array(structures),
                                       indices=list(quad[:-1]))
            for i, s in enumerate(aligned):
                write_xyz(s, mol.atomnos, f,
                          title=f'Scan point {i + 1}/{len(structures)} - '
                                f'dihedral = {round(angles[i], 1)} deg - '
                                f'Rel. E = {round(energies[i] - e_min, 2)}'
                                ' kcal/mol')

        if plt:
            plt.figure()
            plt.plot(angles, [e - e_min for e in energies], '-',
                     color='tab:blue', linewidth=3, alpha=0.5,
                     label=f'Preliminary scan ({direction})')

        peaks = atropisomer_peaks(energies, min_thr=e_min + thr_kcal,
                                  max_thr=e_min + 75.0)
        embedder.log(f'    {direction} scan: {len(peaks)} peak'
                     f'{"s" if len(peaks) != 1 else ""} above '
                     f'{thr_kcal} kcal/mol')

        for p, peak in enumerate(peaks):
            # accurate re-scan: steps of a tenth from one coarse point
            # before the peak, ad libitum until the hill is crossed
            fine_A, fine_E, fine_S = _dihedral_sweep(
                embedder, mol, structures[peak - 1], quad, step_deg / 10,
                min_steps=20, move_mask=move_mask, ad_libitum=True,
                title=f'Accurate scan {p + 1}/{len(peaks)} ({direction})')

            if plt:
                plt.plot(fine_A, [e - e_min for e in fine_E], '-o',
                         color='tab:red', markersize=1, linewidth=2,
                         alpha=0.5,
                         label='Accurate scan' if p == 0 else None)

            sub_peaks = atropisomer_peaks(fine_E, min_thr=e_min + thr_kcal,
                                          max_thr=e_min + 75.0)
            if not sub_peaks:
                embedder.log('    No suitable sub-peaks found.')
                continue

            for sp_i, sp in enumerate(sub_peaks):
                label = (f'sub-peak {sp_i + 1}/{len(sub_peaks)} of peak '
                         f'{p + 1} ({direction})')
                result = _refine_subpeak(embedder, mol, fine_S, fine_E,
                                         sp, label)
                if result is None:
                    continue
                refined, energy = result
                maxima_S.append(refined)
                maxima_E.append(energy)
                embedder.log(
                    f'    peak near {round(angles[peak], 1)} deg refined '
                    f'to {round(fine_A[sp], 1)} deg '
                    f'({round(energy - e_min, 2)} kcal/mol)')
                if plt:
                    plt.plot(fine_A[sp], fine_E[sp] - e_min, color='gold',
                             marker='o', markersize=3,
                             label='Maxima' if not maxima_S[:-1] else None)

        plot_name = f'{mol.rootname}_torsion_scan_{direction}_plt.svg'
        if plt:
            plt.legend()
            plt.xlabel(f'Dihedral angle {quad}')
            plt.ylabel('Rel. E (kcal/mol)')
            plt.savefig(plot_name)
            plt.close()
        else:
            embedder.log('--> matplotlib is not installed: skipped the '
                         f'plot {plot_name}')

    if not maxima_S:
        embedder.log(
            '\n--> Dihedral scan did not find any suitable maxima above '
            f'the set threshold ({thr_kcal} kcal/mol). Observe the '
            'generated energy plots and try lowering the threshold value '
            '(KCAL keyword).')
        mol.torsion_scan_data = None
        return [], [], []

    # the collected maxima: RMSD prune, energy sort, MOI-aligned
    # 'maxima' ensemble with barrier heights
    from tscode_tpu_torch.ops.rmsd_prune import prune_conformers_rmsd

    structures, keep = prune_conformers_rmsd(
        np.array(maxima_S), mol.atomnos, rmsd_thr=embedder.options.rmsd,
        device=embedder.device)
    structures = structures.cpu().numpy()
    energies = np.array(maxima_E, dtype=float)[np.asarray(keep, bool)]
    if not np.all(keep):
        embedder.log(f'Discarded {int(np.sum(~np.asarray(keep, bool)))} '
                     'maxima for RMSD similarity '
                     f'({len(structures)} left)')

    order = np.argsort(energies)
    embedder.structures = structures[order]
    embedder.energies = energies[order]
    embedder.atomnos = mol.atomnos
    embedder.write_structures('maxima', indices=list(quad), relative=True,
                              extra='(barrier height)', align='moi')

    # not mol.scan_data: that attribute feeds the cumulative distance
    # plot of scan_termination
    mol.torsion_scan_data = (embedder.energies.copy(),)
    return list(embedder.structures), list(embedder.energies), \
        list(embedder.structures)
