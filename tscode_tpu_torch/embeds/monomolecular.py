'''
Monomolecular embed: one molecule, two reactive atoms. Every conformer
is bent about each of its pivots until the orbitals come within 1 A of
each other (counterpart of tscode_tpu/embeds/monomolecular.py). The
bends run in float64 on the embedder's device.
'''

import numpy as np

from tscode_tpu_torch.bending import bend_molecule
from tscode_tpu_torch.errors import ZeroCandidatesError
from tscode_tpu_torch.operators import qm_gradient_source

# A: the pivot length every bend aims for
TARGET = 1.0


def monomolecular_embed(embedder):
    '''Returns the structures: the whole bent ensemble once per
    (conformer, pivot). Sets the embedder's structures, atomnos,
    energies, exit_status, graphs and constrained_indices;
    embedder.embed_info receives the counts of bends, FIRE relaxations,
    cache hits and reverts.'''
    if len(embedder.objects) != 1:
        raise ValueError('the monomolecular embed takes one molecule')
    mol = embedder.objects[0]

    embedder.log(f'\n--> Performing monomolecular embed '
                 f'({embedder.candidates} candidates)')

    cache = getattr(embedder, 'bent_mols_cache', None)
    if cache is None:
        cache = embedder.bent_mols_cache = {}
    stats = {'bends': 0, 'relaxations': 0, 'hits': 0, 'reverts': 0}

    structures = []
    for c in range(mol.n_confs):
        for p, pivot in enumerate(mol.pivots[c]):
            bent = bend_molecule(
                mol, c, pivot, TARGET, cache=cache,
                suprafacial=embedder.options.suprafacial,
                fix_angles=embedder.options.fix_angles_in_deformation,
                protect_double_bonds=embedder.options
                .double_bond_protection,
                logfunction=embedder.log,
                title=f'{mol.rootname} - pivot {p}',
                gradient_fn=qm_gradient_source(embedder, mol),
                stats=stats, device=embedder.device)
            for conformer in bent.atomcoords:
                structures.append(conformer)

    if not structures:
        raise ZeroCandidatesError(
            '--> Monomolecular embed generated no structures.')

    embedder.structures = np.array(structures)
    embedder.atomnos = mol.atomnos
    embedder.energies = np.zeros(len(embedder.structures))
    embedder.exit_status = np.zeros(len(embedder.structures), dtype=bool)
    embedder.graphs = [mol.graph]
    if getattr(embedder, 'embed_info', None) is not None:
        embedder.embed_info.update(
            candidates=len(structures), bends=stats['bends'],
            bend_relaxations=stats['relaxations'], bend_hits=stats['hits'],
            bend_reverts=stats['reverts'], device=str(embedder.device))

    if embedder.pairings_table:
        embedder.constrained_indices = np.array(
            [list(embedder.pairings_table.values())
             for _ in embedder.structures])
    else:
        embedder.constrained_indices = np.array(
            [[] for _ in embedder.structures])

    return embedder.structures
