'''
Refinement orchestration: the force-field and semiempirical/DFT
optimisation stages (counterpart of tscode_tpu/optimization.py; the
reference's optimization_methods.py and embedder.py:1390-1829).

The stages run the external calculators through calculators.dispatch;
with no calculator chosen they raise the JAX package's InputError, so
every pure-geometry route (NOOPT, BYPASS) runs without one.
`adjust_spacings_batch` relaxes a batch of structures on the internal
force field with batched FIRE, float64 on the run's device (one launch
of the force field's FIRE kernel per phase on the card), sharded over
the structures when a mesh is there for the batch (FIRE's state is per
structure, so the result is the same).
'''

import functools

import numpy as np
import torch

from tscode_tpu_torch.errors import InputError


def _no_calc_error(stage):
    return InputError(
        f'{stage} requires an external calculator (xtb/orca/gaussian/mopac) '
        f'but none was found on PATH. Re-run with NOOPT to skip '
        f'optimization, or install a calculator.')


def force_field_refine(embedder, conv_thr='tight',
                       only_fixed_constraints=False,
                       prevent_scrambling=False):
    if embedder.options.ff_calc is None:
        raise _no_calc_error('Force-field refinement')
    from tscode_tpu_torch.calculators.dispatch import ff_refine_pipeline
    ff_refine_pipeline(embedder, conv_thr=conv_thr,
                       only_fixed_constraints=only_fixed_constraints,
                       prevent_scrambling=prevent_scrambling)


def optimization_refine(embedder, conv_thr='tight', maxiter=None,
                        only_fixed_constraints=False):
    if embedder.options.calculator is None:
        raise _no_calc_error('Structure optimization')
    from tscode_tpu_torch.calculators.dispatch import \
        optimization_refine_pipeline
    optimization_refine_pipeline(
        embedder, conv_thr=conv_thr, maxiter=maxiter,
        only_fixed_constraints=only_fixed_constraints)


def _spacing_energy(coords, params, sp, st, ncip, k_spring, k_nci):
    '''The force field plus the springs on the pairings with a target
    and the half-springs (active beyond 2.5 A) on the non-covalent
    pairings: the objective of adjust_spacings_batch. Module-level, with
    every table and constant in energy_args: one function, carrying the
    FIRE kernel's terms (fire_terms), serves each phase.'''
    from tscode_tpu_torch.ff import ff_energy, pair_distances
    e = ff_energy(coords, params)
    if sp.shape[0]:
        d = pair_distances(coords, sp)
        e = e + k_spring * torch.sum((d - st) ** 2, dim=-1)
    if ncip.shape[0]:
        dn = pair_distances(coords, ncip)
        e = e + k_nci * torch.sum(torch.clamp(dn - 2.5, min=0.0) ** 2,
                                  dim=-1)
    return e


def _spacing_terms(params, sp, st, ncip, k_spring, k_nci):
    '''_spacing_energy's terms for the force-field FIRE kernel: the
    springs and the half-springs (onset ff.HALF_SPRING_ONSET = 2.5 A).'''
    from tscode_tpu_torch.ff import FireTerms
    return FireTerms(params, spring_pairs=sp, spring_targets=st,
                     spring_k=k_spring, half_pairs=ncip, half_k=k_nci)


_spacing_energy.fire_terms = _spacing_terms


def adjust_spacings_batch(embedder, structures, atomnos):
    '''Pull every pairing with a target distance to that distance while
    keeping the rest of the geometry physical: the batched analog of the
    reference's ase_adjust_spacings (ase_manipulations.py:216-312).

    A coarse FIRE phase with springs (k = 50) and half-springs on the
    non-covalent pairings (k = 500, beyond 2.5 A), then a tight phase
    with springs ten times stiffer and no half-springs, each over the
    whole batch at once, float64 on embedder.device; the internal force
    field plays the calculator and keeps the molecules from scrambling.
    Returns (structures (B, N, 3), pure force-field energies (B,),
    success (B,) bool), numpy.
    '''
    from tscode_tpu_torch.ff import (build_ff_params, merge_ff_params,
                                     params_to_device)
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.optimizers import (fire_minimize_batch,
                                             fire_minimize_batch_sharded)
    from tscode_tpu_torch.parallel.sharding import mesh_for
    from tscode_tpu_torch.utils import scramble_check

    structures = np.asarray(structures, dtype=float)
    atomnos = np.asarray(atomnos)

    # springs: pairings with a known target distance; x/y/z letters are
    # non-covalent contacts with NO target (reference embedder.py:1592-1607)
    # and only get the >2.5 A halfspring like every lowercase pairing
    spring_pairs, spring_targets = [], []
    nci_pairs = []
    for letter, pair in embedder.pairings_table.items():
        is_nci = isinstance(letter, str) and letter in 'xyz'
        target = None if is_nci else \
            embedder.get_pairing_dist_from_letter(letter)
        if target is not None:
            spring_pairs.append(tuple(pair))
            spring_targets.append(float(target))
        if isinstance(letter, str) and letter.islower():
            nci_pairs.append(tuple(pair))

    if not spring_pairs:
        # no targets: plain constrained optimization is equivalent
        # (reference ase_manipulations.py:233-249)
        from tscode_tpu_torch.calculators.dispatch import \
            optimize_batch_pipeline
        return optimize_batch_pipeline(embedder, structures, atomnos)

    device = embedder.device
    f64 = torch.float64
    graphs = getattr(embedder, 'graphs', None) or \
        [graphize(structures[0], atomnos)]
    offsets = np.cumsum([0] + [g.number_of_nodes() for g in graphs])[:-1]
    params = params_to_device(merge_ff_params(
        [build_ff_params(structures[0][off:off + g.number_of_nodes()],
                         atomnos[off:off + g.number_of_nodes()], g)
         for g, off in zip(graphs, offsets)], offsets), device, f64)

    def index(a):
        return torch.as_tensor(np.array(a, dtype=np.int64).reshape(-1, 2),
                               device=device)

    def scalar(x):
        return torch.tensor(x, dtype=f64, device=device)

    sp, ncip = index(spring_pairs), index(nci_pairs)
    st = torch.as_tensor(np.array(spring_targets), dtype=f64, device=device)

    # mesh scale-out: a slice of the batch per device, no collective
    mesh = mesh_for(len(structures), device=device)
    if mesh is not None:
        relax = functools.partial(fire_minimize_batch_sharded, mesh=mesh)
    else:
        relax = fire_minimize_batch

    batch = torch.as_tensor(structures, dtype=f64, device=device)
    # coarse phase: springs + halfsprings (reference :264-270)
    batch, _, _ = relax(
        batch, _spacing_energy, n_steps=500,
        energy_args=(params, sp, st, ncip, scalar(50.0), scalar(500.0)))
    # tight phase: springs only, 10x stiffer (reference Spring.tighten +
    # set_constraint(springs) at :271-279)
    batch, _, _ = relax(
        batch, _spacing_energy, n_steps=200,
        energy_args=(params, sp, st, ncip, scalar(500.0), scalar(0.0)))
    # the force-field energy without the biasing springs
    with torch.no_grad():
        pure = _spacing_energy(batch, params, sp, st, ncip, scalar(0.0),
                               scalar(0.0))

    out = batch.cpu().numpy()
    constrained = np.array(spring_pairs, dtype=int)
    success = np.array([
        scramble_check(s, atomnos, constrained.ravel(), graphs,
                       max_newbonds=embedder.options.max_newbonds)
        for s in out])
    return out, pure.cpu().numpy(), success


def optimize_batch(embedder, structures, atomnos, calc=None, method=None,
                   constrained_indices=None, logfunction=print):
    '''Optimize every structure of a batch (csearch ff_opt hook,
    reference torsion_module.py:787-807). Requires a calculator.'''
    if calc is None and (embedder is None or
                         embedder.options.ff_calc is None):
        raise _no_calc_error('Batch force-field optimization')
    from tscode_tpu_torch.calculators.dispatch import optimize_batch_pipeline
    return optimize_batch_pipeline(embedder, structures, atomnos,
                                   calc=calc, method=method,
                                   constrained_indices=constrained_indices,
                                   logfunction=logfunction)


def optimize_ensemble(embedder, mol):
    if embedder.options.calculator is None:
        raise _no_calc_error('Ensemble optimization (opt>)')
    from tscode_tpu_torch.calculators.dispatch import \
        optimize_ensemble_pipeline
    return optimize_ensemble_pipeline(embedder, mol)
