'''
Refinement orchestration: the host-side dispatch queue that fans
structures out to external calculators and folds results back into the
pipeline state.

Re-design of the reference's ProcessPoolExecutor loops
(TSCoDe's embedder.py:1390-1590, 1636-1829):
 * jobs run on a thread pool — the work is subprocess-bound, so threads
   give the same parallelism without fork overhead, and the scratch-dir
   adapters are thread-safe;
 * results are keyed by SUBMISSION index. The reference indexes its
   state arrays with the as_completed() enumeration counter
   (embedder.py:1462-1481), which silently mismatches structures,
   energies and constraints whenever completion order differs from
   submission order — reproduced here correctly, not faithfully.

(Counterpart of tscode_tpu/calculators/dispatch.py.) No torch op runs
inside a job: the scramble checks are host numpy, and the prunes run on
the main thread after the fold-in, on the run's device.
'''

import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

from tscode_tpu_torch.backend import traced
from tscode_tpu_torch.settings import DEFAULT_LEVELS
from tscode_tpu_torch.utils import (molecule_check, scramble_check,
                                    time_to_string, timing_wrapper)


def _opt_funcs():
    from tscode_tpu_torch.calculators.gaussian import gaussian_opt
    from tscode_tpu_torch.calculators.mopac import mopac_opt
    from tscode_tpu_torch.calculators.orca import orca_opt
    from tscode_tpu_torch.calculators.xtb import xtb_opt
    return {'MOPAC': mopac_opt, 'ORCA': orca_opt,
            'GAUSSIAN': gaussian_opt, 'XTB': xtb_opt}


def optimize(coords, atomnos, calculator, method=None, maxiter=None,
             conv_thr='tight', constrained_indices=None,
             constrained_distances=None, mols_graphs=None, procs=1,
             solvent=None, charge=0, max_newbonds=0, title='temp',
             check=True, logfunction=None, **kwargs):
    '''
    Single-structure constrained optimization + scramble check
    (reference optimization_methods.py:44-130).
    Returns (opt_coords, energy kcal/mol, success).
    '''
    if mols_graphs is not None:
        total = sum(len(g.nodes) for g in mols_graphs)
        assert len(coords) == total

    if method is None:
        method = DEFAULT_LEVELS[calculator]

    constrained_indices = np.array(()) if constrained_indices is None \
        else constrained_indices
    opt_func = _opt_funcs()[calculator]

    t_start = time.perf_counter()
    opt_coords, energy, success = opt_func(
        coords, atomnos, constrained_indices=constrained_indices,
        constrained_distances=constrained_distances, method=method,
        procs=procs, solvent=solvent, maxiter=maxiter, conv_thr=conv_thr,
        title=title, charge=charge, **kwargs)
    elapsed = time.perf_counter() - t_start

    if success:
        if check:
            if mols_graphs is not None:
                success = scramble_check(
                    opt_coords, atomnos,
                    np.asarray(constrained_indices).ravel(),
                    mols_graphs, max_newbonds=max_newbonds)
            else:
                success = molecule_check(coords, opt_coords, atomnos,
                                         max_newbonds=max_newbonds)
        if logfunction is not None:
            state = 'REFINED' if success else 'SCRAMBLED'
            logfunction(f'    - {title} - {state} {time_to_string(elapsed)}')
        return opt_coords, energy, success

    if logfunction is not None:
        logfunction(f'    - {title} - CRASHED')
    return coords, energy, False


def dynamic_energy_thr(rel_energies, kcal_thresh, keep_min=0.1):
    '''Energy window widened until at least keep_min of the candidates
    survive (reference embedder.py:1831-1856).'''
    thr = kcal_thresh
    n = len(rel_energies)
    if n == 0:
        return thr
    while np.count_nonzero(rel_energies < thr) / n < keep_min:
        thr += 5.0
        if thr > 1e6:
            break
    return thr


def _constraints_for(embedder, i, only_fixed_constraints):
    if only_fixed_constraints:
        return np.array([value for key, value in
                         embedder.pairings_table.items() if key.isupper()])
    if len(embedder.internal_constraints) > 0:
        return np.concatenate([embedder.constrained_indices[i],
                               embedder.internal_constraints])
    return embedder.constrained_indices[i]


@traced
def _refine_stage(embedder, opt_callable, level_tag, workers,
                  conv_thr='tight', maxiter=None,
                  only_fixed_constraints=False, spring_constant=1,
                  procs_per_job=2, extra_kwargs=None):
    '''Shared fan-out/fold-in loop for FF and SE/DFT refinement stages.'''
    extra_kwargs = extra_kwargs or {}
    n = len(embedder.structures)
    t_start = time.perf_counter()
    cum_time = 0.0

    with ThreadPoolExecutor(max_workers=max(workers, 1)) as executor:
        futures = {}
        for i, structure in enumerate(np.copy(embedder.structures)):
            constraints = _constraints_for(embedder, i,
                                           only_fixed_constraints)
            pairing_dists = [
                embedder.get_pairing_dists_from_constrained_indices(c)
                for c in constraints]
            fut = executor.submit(
                timing_wrapper, opt_callable, structure, embedder.atomnos,
                constrained_indices=constraints,
                constrained_distances=pairing_dists,
                solvent=embedder.options.solvent,
                charge=embedder.options.charge,
                maxiter=maxiter, conv_thr=conv_thr,
                procs=procs_per_job, title=f'Candidate_{i+1}',
                spring_constant=spring_constant, **extra_kwargs)
            futures[fut] = i

        done = 0
        for fut in as_completed(futures):
            i = futures[fut]
            (new_structure, new_energy, ok), t_struct = fut.result()
            cum_time += t_struct
            done += 1

            if ok:
                constraints = _constraints_for(embedder, i, False)
                ok = scramble_check(
                    new_structure, embedder.atomnos,
                    excluded_atoms=np.asarray(constraints).ravel(),
                    mols_graphs=embedder.graphs,
                    max_newbonds=embedder.options.max_newbonds,
                    logfunction=embedder.log if embedder.options.debug
                    else None,
                    title=f'Candidate_{i+1}')

            embedder.exit_status[i] = ok
            if ok and new_energy is not None:
                embedder.structures[i] = new_structure
                embedder.energies[i] = new_energy
            else:
                embedder.energies[i] = 1e10

            chk_freq = max(workers, 1) * embedder.options.checkpoint_frequency
            if done % chk_freq == chk_freq - 1:
                _write_checkpoint(embedder, level_tag)
                elapsed = time.perf_counter() - t_start
                average = elapsed / done
                embedder.log(
                    f'    - Optimized {done:>4}/{n:>4} structures - updated '
                    f'checkpoint (avg. {time_to_string(average)}/struc, '
                    f'{round(cum_time / elapsed, 1)}x speedup)', p=False)

    elapsed = time.perf_counter() - t_start
    # the run report's `refine`: each stage's jobs, thread workers, wall
    # seconds and the seconds its jobs took together
    if not hasattr(embedder, 'refine_info'):
        embedder.refine_info = []
    embedder.refine_info.append({
        'level': level_tag, 'conv_thr': conv_thr, 'maxiter': maxiter,
        'jobs': n, 'workers': max(workers, 1), 'seconds': elapsed,
        'job_seconds': cum_time,
        'refined': int(np.count_nonzero(embedder.exit_status))})
    embedder.log(f'{level_tag} optimization took {time_to_string(elapsed)} '
                 f'(~{time_to_string(elapsed / max(n, 1))} per structure, '
                 f'{round(cum_time / max(elapsed, 1e-9), 1)}x speedup)')
    embedder.log(f'Successfully optimized '
                 f'{int(np.count_nonzero(embedder.exit_status))}/{n} '
                 f'candidates at {level_tag} level.')


def _write_checkpoint(embedder, level_tag):
    from tscode_tpu_torch.io_xyz import write_xyz
    from tscode_tpu_torch.molecule import align_structures
    with open(embedder.outname, 'w') as f:
        for j, (structure, status, energy) in enumerate(zip(
                align_structures(embedder.structures),
                embedder.exit_status, embedder.rel_energies())):
            kind = 'REFINED - ' if status else 'NOT REFINED - '
            write_xyz(structure, embedder.atomnos, f,
                      title=f'Structure {j + 1} - {kind}Rel. E. = '
                            f'{round(energy, 3)} kcal/mol ({level_tag})')


def _sort_by_energy(embedder):
    order = np.argsort(embedder.energies, kind='stable')
    for attr in ('energies', 'structures', 'constrained_indices',
                 'exit_status'):
        setattr(embedder, attr, getattr(embedder, attr)[order])


def ff_refine_pipeline(embedder, conv_thr='tight',
                       only_fixed_constraints=False,
                       prevent_scrambling=False):
    '''Force-field refinement stage (reference embedder.py:1390-1590).'''
    from tscode_tpu_torch.calculators.xtb import xtb_opt, xtb_pre_opt

    embedder.outname = f'tscode_checkpoint_{embedder.stamp}.xyz'
    if not only_fixed_constraints:
        _write_checkpoint(embedder, embedder.options.ff_level)
        embedder.log(f'\n--> Checkpoint output - Wrote '
                     f'{len(embedder.structures)} unoptimized structures to '
                     f'{embedder.outname} file before FF optimization.\n')

    task = ('Structure optimization (tight) / relaxing interactions'
            if only_fixed_constraints else
            f'Structure {"pre-" if prevent_scrambling else ""}'
            f'optimization (loose)')
    embedder.log(f'--> {task} ({embedder.options.ff_level} level via '
                 f'{embedder.options.ff_calc}, {embedder.avail_cpus} '
                 f'thread{"s" if embedder.avail_cpus > 1 else ""})')

    if embedder.options.ff_calc == 'XTB':
        if prevent_scrambling:
            def opt_callable(coords, atomnos, **kw):
                return xtb_pre_opt(coords, atomnos,
                                   graphs=embedder.graphs,
                                   method=embedder.options.ff_level, **kw)
        else:
            def opt_callable(coords, atomnos, **kw):
                return xtb_opt(coords, atomnos,
                               method=embedder.options.ff_level, **kw)
    elif embedder.options.ff_calc == 'OB':
        # FFCALC=OB: constrained UFF/MMFF94 minimization through
        # OpenBabel (bindings preferred, CLI fallback for free opts).
        # No xtb_pre_opt analog exists — the scramble gate below is the
        # safety net for the prevent_scrambling pass.
        from tscode_tpu_torch.calculators.openbabel import (openbabel_opt,
                                                      probe_openbabel)

        # systemic problems (no bindings AND no CLI, bad FFLEVEL) fail
        # fast here; the per-job except below stays for genuine
        # per-structure crashes
        probe_openbabel(embedder.options.ff_level or 'UFF')

        def opt_callable(coords, atomnos, constrained_indices=None,
                         constrained_distances=None, title='temp_ob',
                         **kw):
            try:
                return openbabel_opt(
                    coords, atomnos,
                    constrained_indices=constrained_indices,
                    constrained_distances=constrained_distances,
                    method=embedder.options.ff_level or 'UFF',
                    title=title)
            except Exception:
                # crashed job -> masked out, run continues (same
                # fault-tolerance contract as the QM engines)
                return None, None, False
    else:
        raise NotImplementedError(
            f'FF refinement via {embedder.options.ff_calc} is not wired '
            f'up; use XTB (GFN-FF) or OB (OpenBabel UFF/MMFF94).')

    _refine_stage(embedder, opt_callable, embedder.options.ff_level,
                  workers=embedder.avail_cpus, conv_thr=conv_thr,
                  only_fixed_constraints=only_fixed_constraints,
                  spring_constant=0.2 if prevent_scrambling else 1,
                  procs_per_job=2)

    _sort_by_energy(embedder)
    mask = embedder.rel_energies() < 1e10
    embedder.apply_mask(embedder.MASKABLE, mask)
    if False in mask:
        embedder.log(f'Discarded {np.count_nonzero(~mask)} scrambled '
                     f'candidates ({np.count_nonzero(mask)} left)')

    embedder.fitness_refining(threshold=2)
    embedder.zero_candidates_check()
    embedder.similarity_refining()

    if embedder.options.optimization and \
            embedder.options.ff_level != embedder.options.theory_level and \
            conv_thr != 'tight':
        s = (f'--> Checkpoint output - Updated {len(embedder.structures)} '
             f'optimized structures to {embedder.outname} file before '
             f'{embedder.options.calculator} optimization.')
    else:
        embedder.outname = (f'tscode_'
                            f'{"ensemble" if embedder.embed == "refine" else "poses"}'
                            f'_{embedder.stamp}.xyz')
        s = (f'--> Checkpoint output - Updated {len(embedder.structures)} '
             f'optimized structures to {embedder.outname} file')
    embedder.log(s + '\n')
    _write_checkpoint(embedder, embedder.options.ff_level)

    if not only_fixed_constraints:
        embedder.energies.fill(0)


def optimization_refine_pipeline(embedder, conv_thr='tight', maxiter=None,
                                 only_fixed_constraints=False):
    '''Semiempirical/DFT refinement stage (reference embedder.py:1636-1829).'''
    embedder.outname = (f'tscode_'
                        f'{"ensemble" if embedder.embed == "refine" else "poses"}'
                        f'_{embedder.stamp}.xyz')

    task = ('Structure optimization (tight) / relaxing interactions'
            if only_fixed_constraints else 'Structure optimization (loose)')
    embedder.log(f'--> {task} ({embedder.options.theory_level} level via '
                 f'{embedder.options.calculator}, {embedder.threads} '
                 f'thread{"s" if embedder.threads > 1 else ""})')

    embedder.energies.fill(0)

    calc = embedder.options.calculator
    opt_func = _opt_funcs()[calc]

    def opt_callable(coords, atomnos, **kw):
        if calc != 'XTB':
            kw.pop('conv_thr', None)
            kw.pop('spring_constant', None)
        return opt_func(coords, atomnos,
                        method=embedder.options.theory_level, **kw)

    _refine_stage(embedder, opt_callable, embedder.options.theory_level,
                  workers=max(embedder.avail_cpus // 4, 1),
                  conv_thr=conv_thr, maxiter=maxiter,
                  only_fixed_constraints=only_fixed_constraints,
                  spring_constant=2 if only_fixed_constraints else 1,
                  procs_per_job=embedder.procs)

    if embedder.options.only_refined:
        mask = embedder.exit_status.astype(bool)
        embedder.apply_mask(embedder.MASKABLE, mask)
        if False in mask:
            embedder.log(f'Discarded {np.count_nonzero(~mask)} candidates '
                         f'for unsuccessful optimization '
                         f'({np.count_nonzero(mask)} left)')

    _sort_by_energy(embedder)

    if embedder.options.kcal_thresh is not None and only_fixed_constraints:
        thr = dynamic_energy_thr(embedder.rel_energies(),
                                 embedder.options.kcal_thresh)
        mask = embedder.rel_energies() < thr
        embedder.apply_mask(embedder.MASKABLE, mask)
        if False in mask:
            embedder.log(f'Discarded {np.count_nonzero(~mask)} candidates '
                         f'for energy ({np.count_nonzero(mask)} left, '
                         f'threshold {thr} kcal/mol)')

    embedder.fitness_refining(threshold=2)
    embedder.zero_candidates_check()
    embedder.similarity_refining()

    _write_checkpoint(embedder, embedder.options.theory_level)
    embedder.log(f'--> Wrote {len(embedder.structures)} optimized '
                 f'structures to {embedder.outname}')

    if not only_fixed_constraints:
        embedder.energies.fill(0)


def optimize_batch_pipeline(embedder, structures, atomnos, calc=None,
                            method=None, constrained_indices=None,
                            constrained_distances=None, logfunction=print):
    '''Batch optimization for csearch ff_opt
    (reference torsion_module.py:787-807).'''
    calc = calc or (embedder.options.ff_calc if embedder else 'XTB')
    method = method or DEFAULT_LEVELS.get(calc)
    structures = np.array(structures)
    energies = np.zeros(len(structures))

    t_start = time.perf_counter()
    workers = embedder.avail_cpus if embedder else 4

    with ThreadPoolExecutor(max_workers=max(workers, 1)) as executor:
        futures = {executor.submit(
            optimize, s, atomnos, calc, method=method,
            constrained_indices=constrained_indices,
            constrained_distances=constrained_distances,
            title=f'csearch_{i}'): i
            for i, s in enumerate(np.copy(structures))}
        for fut in as_completed(futures):
            i = futures[fut]
            opt_coords, energy, ok = fut.result()
            if ok:
                structures[i] = opt_coords
                energies[i] = energy
            else:
                energies[i] = 1e10

    logfunction(f'Optimized {len(structures)} structures at {method} level '
                f'({time_to_string(time.perf_counter() - t_start)})')
    return structures, energies


def optimize_ensemble_pipeline(embedder, mol):
    '''opt> operator: optimize every conformer, prune by RMSD and energy
    window (reference operators.py:226-279).'''
    calc = embedder.options.calculator
    method = embedder.options.theory_level or DEFAULT_LEVELS[calc]
    embedder.log(f'--> {mol.rootname}: optimizing '
                 f'{mol.n_confs} conformers at {method} level')

    # internal constraints (same letter twice on this molecule) hold
    # through the optimization, with their imposed distances
    # (reference operators.py:237-239, _get_internal_constraints :769-780)
    mol_id = embedder.objects.index(mol) if mol in embedder.objects else None
    constrained_indices, constrained_distances = None, None
    if mol_id is not None and mol_id in getattr(embedder, 'pairings_dict', {}):
        pairs = [tgt for tgt in embedder.pairings_dict[mol_id].values()
                 if isinstance(tgt, tuple)]
        if pairs:
            constrained_indices = np.array(pairs)
            constrained_distances = [
                embedder.get_pairing_dists_from_constrained_indices(cp)
                for cp in pairs]

    structures, energies = optimize_batch_pipeline(
        embedder, mol.atomcoords, mol.atomnos, calc=calc, method=method,
        constrained_indices=constrained_indices,
        constrained_distances=constrained_distances,
        logfunction=embedder.log)

    order = np.argsort(energies, kind='stable')
    structures, energies = structures[order], energies[order]
    mask = (energies - energies.min()) < 20.0
    structures, energies = structures[mask], energies[mask]

    # the pruned copy lies on the device in the run's dtype; keep the
    # host float64 rows it selects
    from tscode_tpu_torch.ops.rmsd_prune import prune_conformers_rmsd
    _, keep = prune_conformers_rmsd(structures, mol.atomnos,
                                    device=embedder.device,
                                    dtype=embedder.dtype)
    structures = structures[keep]

    from tscode_tpu_torch.molecule import Molecule
    new_mol = Molecule.__new__(Molecule)
    new_mol.__dict__.update(mol.__dict__)
    new_mol.atomcoords = structures
    new_mol.reactive_atoms = {}
    if len(mol.reactive_indices):
        new_mol.compute_orbitals()
    embedder.log(f'    kept {len(structures)} conformers')
    return new_mol
