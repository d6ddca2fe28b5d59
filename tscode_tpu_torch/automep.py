'''
AutoMEP: autogenerate a ring-flip MEP for 7-9-membered rings
(counterpart of tscode_tpu/automep.py; reference TSCoDe's
automep.py:15-133). The interpolation and the dihedrals run on the
run's device, in float64.

Endpoints: the two input geometries. A planar TS guess is built by
driving every in-ring dihedral to 0 (and exocyclic ones to 180),
the chain is interpolated through it, and interior images relax with
all bonds restrained. Requires XTB (the planar-guess constrained
optimization needs a real potential); the ring/dihedral discovery
helpers are pure and tested hermetically.
'''

import numpy as np
import torch
from networkx import cycle_basis

from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.graphs import neighbors
from tscode_tpu_torch.io_xyz import write_xyz
from tscode_tpu_torch.molecule import align_structures
from tscode_tpu_torch.neb import idpp_interpolate
from tscode_tpu_torch.ops.linalg import dihedral as dihedral_fn


def cycle_to_dihedrals(cycle):
    '''All consecutive 4-tuples around a ring (reference automep.py:122-133).'''
    dihedrals = []
    n = len(cycle)
    for i in range(n):
        dihedrals.append([cycle[i % n], cycle[(i + 1) % n],
                          cycle[(i + 2) % n], cycle[(i + 3) % n]])
    return dihedrals


def get_exocyclic_dihedrals(graph, cycle):
    '''Dihedrals anchoring each exocyclic substituent to the ring
    (reference automep.py:109-120).'''
    exo_dihs = []
    for index in cycle:
        for exo_id in neighbors(graph, index):
            if exo_id not in cycle:
                dummy1 = next(i for i in cycle
                              if i not in (exo_id, index)
                              and i in neighbors(graph, index))
                dummy2 = next(i for i in cycle
                              if i not in (exo_id, index, dummy1)
                              and i in neighbors(graph, dummy1))
                exo_dihs.append([exo_id, index, dummy1, dummy2])
    return exo_dihs


def automep(embedder, n_images=9):
    '''(reference automep.py:15-107)'''
    if embedder.options.calculator != 'XTB':
        raise InputError('automep> requires the XTB calculator.')
    if len(embedder.objects) != 2:
        raise InputError('Provide two molecules as start/endpoints.')

    from tscode_tpu_torch.calculators.xtb import xtb_opt, xtb_pre_opt

    mol = embedder.objects[0]
    coords = mol.atomcoords[0]

    cycles = [c for c in cycle_basis(mol.graph) if len(c) in (7, 8, 9)]
    if len(cycles) != 1:
        raise InputError('Automep only works for single 7/8/9-membered '
                         'ring flips at the moment.')

    embedder.log(f'--> AutoMEP - Building MEP for {len(cycles[0])}-membered '
                 f'ring inversion')

    coords, _, _ = xtb_opt(coords, mol.atomnos,
                           method=embedder.options.theory_level,
                           solvent=embedder.options.solvent,
                           procs=embedder.procs)

    dihedrals = cycle_to_dihedrals(cycles[0])
    exocyclic = get_exocyclic_dihedrals(mol.graph, cycles[0])
    target_angles = np.array([0] * len(dihedrals) + [180] * len(exocyclic))

    ts_guess, _, _ = xtb_opt(
        coords, mol.atomnos,
        constrained_dihedrals=dihedrals + exocyclic,
        constrained_dih_angles=target_angles,
        method=embedder.options.theory_level,
        solvent=embedder.options.solvent, procs=embedder.procs)

    aligned = align_structures(np.array([
        coords, ts_guess, embedder.objects[1].atomcoords[0]]))
    half = n_images // 2 + 1
    mep = np.concatenate([
        idpp_interpolate(aligned[0], aligned[1], half,
                         device=embedder.device),
        idpp_interpolate(aligned[1], aligned[2], n_images - half + 1,
                         device=embedder.device)[1:]])

    constrained_indices = [[a, b] for a, b in mol.graph.edges if a != b]
    constrained_distances = [float(np.linalg.norm(coords[a] - coords[b]))
                             for a, b in constrained_indices]

    quads = dihedrals + exocyclic
    for g in range(1, len(mep) - 1):
        # the interior image's dihedrals, float64 on the run's device
        angles_now = [float(dihedral_fn(torch.as_tensor(
            mep[g][q], dtype=torch.float64, device=embedder.device)))
            for q in quads]
        opt_geom, _, _ = xtb_pre_opt(
            mep[g], mol.atomnos, graphs=[mol.graph],
            constrained_indices=constrained_indices,
            constrained_distances=constrained_distances,
            constrained_dihedrals=quads,
            constrained_dih_angles=angles_now,
            method=embedder.options.theory_level,
            solvent=embedder.options.solvent, procs=embedder.procs)
        mep[g] = opt_geom

    mep = align_structures(mep)
    outname = f'{mol.rootname}_automep.xyz'
    with open(outname, 'w') as f:
        for c in mep:
            write_xyz(c, mol.atomnos, f)
    embedder.log(f'\n--> Saved autogenerated MEP as {outname}\n')
    return outname
