'''
Moment-of-inertia duplicate pruning (rotamers, enantiomers): counterpart
of tscode_tpu/ops/moi.py.

The principal moments of the heavy atoms are computed on the device in
float64 (the closed-form 3x3 eigensolver of ops/linalg), whatever the
run's working dtype: the test is a 1e-2 relative threshold on moments,
and reduced-precision products move structures across it. The
first-similar-successor edges and the keep-first-of-component rule run
on the host, as in the reference.
'''

import networkx as nx
import numpy as np
import torch

from tscode_tpu_torch.pt import masses_of
from tscode_tpu_torch.ops.linalg import get_inertia_moments


def moi_similarity_matrix(structures, masses, max_deviation=1e-2,
                          device='cpu'):
    '''(B, B) numpy bool: pair (i, j) similar when all three relative
    moment deviations |m_i - m_j| / m_i are below max_deviation (the
    asymmetric denominator of the reference).'''
    moments = get_inertia_moments(
        torch.as_tensor(np.asarray(structures), dtype=torch.float64,
                        device=device),
        torch.as_tensor(np.asarray(masses), dtype=torch.float64,
                        device=device))
    mi = moments[:, None, :]
    mj = moments[None, :, :]
    rel = torch.abs(mi - mj) / mi
    return torch.all(rel < max_deviation, dim=-1).cpu().numpy()


def prune_by_moment_of_inertia(structures, atomnos, max_deviation=1e-2,
                               device='cpu'):
    '''Returns (pruned_structures, keep_mask) as numpy arrays. Heavy
    atoms only. Each structure links to its FIRST similar successor;
    each connected component keeps its first node in the networkx
    graph's order.'''
    structures = np.asarray(structures)
    atomnos = np.asarray(atomnos)
    heavy = atomnos != 1

    n = len(structures)
    if n <= 1:
        return structures, np.ones(n, dtype=bool)

    sim = moi_similarity_matrix(structures[:, heavy],
                                masses_of(atomnos[heavy]), max_deviation,
                                device=device)
    np.fill_diagonal(sim, False)

    matches = []
    for i in range(n):
        js = np.nonzero(sim[i, i + 1:])[0]
        if len(js):
            matches.append((i, i + 1 + int(js[0])))

    mask = np.ones(n, dtype=bool)
    if matches:
        g = nx.Graph(matches)
        groups = [tuple(g.subgraph(c).nodes)
                  for c in nx.connected_components(g)]
        for group in groups:
            for i in set(group) - {group[0]}:
                mask[i] = False

    return structures[mask], mask
