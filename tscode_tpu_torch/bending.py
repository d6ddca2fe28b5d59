'''
Molecule bending: deform a conformer so two orbital lobes approach a
target distance (counterpart of tscode_tpu/bending.py).

The bend loop minimises the internal harmonic force field (graph-restrained
bonds and angles plus repulsion) plus a pair spring on the reactive
atoms, stepping the spring target until the PIVOT length (orbital lobe
to orbital lobe) reaches the threshold; orbitals are rebuilt from the
bent geometry between steps. An external (energy, gradient) callback can
replace the force field through the same loop.

The bend runs in float64 on the device it is given, whatever the dtype
of the sweep that follows: its loop is a chain of discrete decisions
(a stall under 0.01 A, the threshold, a pivot that vanishes, the
scramble check), so a float32 bend would hand the sweep other molecules
than the float64 one.

Bent results are cached per (conformer geometry, pivot indices, rounded
target); a hit returns the same Molecule object.
'''

import numpy as np
import torch

from tscode_tpu_torch.ff import (K_BOND, FireTerms, build_ff_params,
                                 ff_energy, pair_distances, params_to_device)
from tscode_tpu_torch.optimizers import (fire_band_init, fire_band_update,
                                         fire_minimize_batch, spring_energy)
from tscode_tpu_torch.pivots import set_pivots
from tscode_tpu_torch.utils import molecule_check

_BEND_BOND_K = 2000.0   # kcal/mol/A^2: near-rigid bonds during bending
# steps and force threshold (kcal/mol/A) of one relaxation of the bend
BEND_FIRE_STEPS = 300
BEND_FMAX = 0.05


def _bend_energy(c, params, pairs, targets, k):
    '''FF + reactive-pair spring; a module-level function carrying the
    FIRE kernel's terms (fire_terms), one for every bend iteration and
    every molecule. k is a 0-dim tensor: the bend loop escalates it
    when progress stalls.

    Bonds are additionally stiffened to _BEND_BOND_K, so the deformation
    goes into angles and dihedrals, never into covalent stretches.'''
    e = ff_energy(c, params) + spring_energy(c, pairs, targets, k=k)
    bonds, bond_r0 = params[0], params[1]
    if bonds.shape[0]:
        d = pair_distances(c, bonds)
        e = e + (_BEND_BOND_K - K_BOND) * torch.sum((d - bond_r0) ** 2,
                                                    dim=-1)
    return e


# the terms of the force-field FIRE kernel: bonds at _BEND_BOND_K, the
# reactive-pair spring with k on the device
_bend_energy.fire_terms = lambda params, pairs, targets, k: FireTerms(
    params, bond_k=_BEND_BOND_K, spring_pairs=pairs, spring_targets=targets,
    spring_k=k)


def _relax_with_gradient(coords, gradient_fn, pair, target, k=20.0,
                         n_steps=50, fmax=0.05, dt0=0.05):
    '''Host relaxation on an external (E, grad) callback plus the
    reactive-pair spring: the external-surface form of the bend step.
    gradient_fn takes (N, 3) numpy coordinates and returns (energy,
    gradient (N, 3)). The integrator is optimizers.fire_band_update on
    float64 CPU tensors; only the force assembly is bend-specific.
    Returns coords (N, 3) numpy.'''
    c = np.asarray(coords, dtype=float).copy()
    i1, i2 = pair

    def total_force(x):
        g = gradient_fn(x)[1]
        delta = x[i1] - x[i2]
        d = max(np.linalg.norm(delta), 1e-12)
        # d/dx of k*(d - target)^2
        sg = 2.0 * k * (d - target) * delta / d
        g = np.array(g, dtype=float)
        g[i1] += sg
        g[i2] -= sg
        return -g

    dt0 = torch.tensor(dt0, dtype=torch.float64)
    state = fire_band_init(torch.from_numpy(c), dt0)
    for _ in range(n_steps):
        if bool(state[5]):
            break
        f = total_force(state[0].numpy())
        state = fire_band_update(state, torch.from_numpy(f), dt0, fmax)
    return state[0].numpy()


def bend_key(mol, pivot, threshold, conf=0):
    '''Cache key for one (conformer geometry, pivot, target) bend: the
    CONFORMER's coordinate sum, the pivot's sorted atom indices and the
    target rounded to 0.001 A.'''
    return (float(np.sum(mol.atomcoords[conf])), tuple(sorted(pivot.index)),
            round(threshold, 3))


def _pivot_length(mol, conf, pivot_index):
    for p in mol.pivots[conf]:
        if p.index == pivot_index:
            return float(np.linalg.norm(p.pivot)), p
    # the pivot may disappear if lobe counts change
    return None, None


def bend_molecule(mol, conf, pivot, threshold, max_iter=40,
                  fix_angles=False, cache=None, suprafacial=False,
                  protect_double_bonds=False, logfunction=None,
                  title='bend', gradient_fn=None, stats=None, *, device):
    '''
    Bend `mol`'s conformer `conf` until the pivot between the two
    reactive-atom orbitals is <= threshold (A). Returns a NEW Molecule
    (same ensemble, bent conformer replaced, orbitals+pivots rebuilt),
    the input molecule itself when the bend scrambled it, or the cached
    result of an earlier call with the same key.

    fix_angles is kept for parity with the reference's signature but is
    inherently satisfied: the internal FF restrains every angle to its
    input value. protect_double_bonds (EZPROT) adds E/Z dihedral
    restraints. device: where the relaxations run (float64). stats: a
    dict that, when given, counts this call under 'hits' (cache), or
    'bends', 'relaxations' (FIRE calls) and 'reverts'.
    '''
    if stats is None:
        stats = {}

    def count(what, n=1):
        stats[what] = stats.get(what, 0) + n

    if cache is not None:
        key = bend_key(mol, pivot, threshold, conf=conf)
        if key in cache:
            count('hits')
            return cache[key]
    count('bends')

    from tscode_tpu_torch.molecule import Molecule
    new_mol = Molecule.__new__(Molecule)
    new_mol.__dict__.update(mol.__dict__)
    new_mol.atomcoords = mol.atomcoords.copy()

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    i1, i2 = (int(i) for i in mol.reactive_indices[:2])
    orb_memo = {i: float(np.linalg.norm(atom.center[0] - atom.coord))
                for i, atom in mol.reactive_atoms[conf].items()}
    params = params_to_device(build_ff_params(
        mol.atomcoords[conf], mol.atomnos, mol.graph,
        protect_double_bonds=protect_double_bonds), device, torch.float64)
    pairs = torch.as_tensor([[i1, i2]], device=device)

    coords = mol.atomcoords[conf].copy()
    pivot_index = pivot.index
    current_len = float(np.linalg.norm(pivot.pivot))

    # orbital geometry offset: pivot length vs reactive-atom distance
    atom_dist = float(np.linalg.norm(coords[i1] - coords[i2]))
    offset = atom_dist - current_len

    # adaptive spring: start gentle, stiffen when the pivot stops
    # moving (spring/FF equilibrium short of the target)
    k_spring, k_max = 20.0, 1000.0
    prev_len = None

    for it in range(max_iter):
        if current_len <= threshold:
            break
        if prev_len is not None and abs(prev_len - current_len) < 0.01:
            if k_spring >= k_max:
                # stuck at max stiffness: stop; the embed uses whatever
                # the bend achieved
                if logfunction:
                    logfunction(f'{title}: bend stuck at pivot length '
                                f'{current_len:.2f} A (target '
                                f'{threshold:.2f} A)')
                break
            k_spring = min(k_spring * 4.0, k_max)
        prev_len = current_len

        # step the atom-pair target toward the pivot goal
        target_piv = max(threshold, current_len - 0.3)
        target_atoms = target_piv + offset

        count('relaxations')
        if gradient_fn is not None:
            # external surface: host FIRE on the (E, grad) callback
            # + the same reactive-pair spring
            coords = _relax_with_gradient(coords, gradient_fn,
                                          (i1, i2), target_atoms,
                                          k=k_spring)
        else:
            relaxed, _, _ = fire_minimize_batch(
                t(coords)[None], _bend_energy, n_steps=BEND_FIRE_STEPS,
                fmax=BEND_FMAX,
                energy_args=(params, pairs, t([target_atoms]),
                             t(k_spring)))
            coords = relaxed[0].cpu().numpy()

        # rebuild orbitals + pivots from the bent geometry, keeping the
        # ORIGINAL orbital type override (SIMPLEORBITALS) and lengths
        # (SHRINK scaling). Only the bent conformer changed, so the
        # rebuild is scoped to it (confs=[conf]); the other conformers
        # keep the input molecule's atoms/pivots, which are exactly what
        # a full rebuild would reproduce from their unchanged
        # coordinates.
        new_mol.atomcoords = new_mol.atomcoords.copy()
        new_mol.atomcoords[conf] = coords
        new_mol.compute_orbitals(
            override=getattr(mol, '_orbital_override', None),
            confs=[conf])
        new_mol.restore_orb_lengths(orb_memo, confs=[conf])
        set_pivots(new_mol, suprafacial=suprafacial, confs=[conf])

        current_len, p = _pivot_length(new_mol, conf, pivot_index)
        if current_len is None:
            if logfunction:
                logfunction(f'{title}: pivot {pivot_index} vanished during '
                            f'bending; keeping last geometry')
            break
        atom_dist = float(np.linalg.norm(coords[i1] - coords[i2]))
        offset = atom_dist - current_len

    if not new_mol.reactive_atoms:
        new_mol.compute_orbitals(
            override=getattr(mol, '_orbital_override', None))
        new_mol.restore_orb_lengths(orb_memo)
        set_pivots(new_mol, suprafacial=suprafacial)

    # scramble check: at most ONE new bond (the approaching reactive
    # termini) is accepted; otherwise revert to the input molecule
    if not molecule_check(mol.atomcoords[conf], new_mol.atomcoords[conf],
                          mol.atomnos, max_newbonds=1):
        if logfunction:
            logfunction(f'{title}: bending scrambled the structure; '
                        f'reverting to the unbent molecule')
        count('reverts')
        new_mol = mol

    if cache is not None:
        cache[key] = new_mol
    return new_mol
