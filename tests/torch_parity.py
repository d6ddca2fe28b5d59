'''Shared helpers of the port's tests (tests/test_torch_*.py). Inputs are
made with numpy from a seed and handed to both the JAX package and the
port (tscode_tpu_torch), so the two are compared on the same numbers.'''

import numpy as np
import pytest
import torch

# the suite runs in several worker processes beside JAX's own thread
# pools; torch's intra-op threads spin between ops and, oversubscribed,
# slowed these files ~30x
torch.set_num_threads(1)


def t64(a):
    '''numpy (or jax) array -> CPU float64 tensor.'''
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def to_np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture
def cuda_device():
    '''The card, or a skip: these tests launch the CUDA kernels, which
    build and run only on an NVIDIA GPU.'''
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; on the card run '
                    'python -m pytest tests/test_torch_cuda.py -m cuda '
                    '--noconftest')
    return torch.device('cuda')


def near_dup_blocks(rng, B, L, N, scale=1.5):
    '''(B, L, N, 3) blocks of noisy copies of four base structures per
    block, noise levels chosen so pair rmsds fall on both sides of 0.5 A
    (and for N > 4 inside the band where the maxdev gate decides), and
    m_real (B,) live rows per block.'''
    base = rng.normal(size=(B, 4, N, 3)) * scale
    which = rng.integers(0, 4, size=(B, L))
    sigma = rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=(B, L))
    P = base[np.arange(B)[:, None], which] + \
        rng.normal(size=(B, L, N, 3)) * sigma[..., None, None]
    return P, rng.integers(1, L + 1, size=B).astype(np.int32)


def near_dup_pool(rng, n, N, n_base, scale=1.5):
    '''(n, N, 3) pool of noisy copies of n_base structures in random
    order, with the noise levels of near_dup_blocks.'''
    base = rng.normal(size=(n_base, N, 3)) * scale
    sigma = rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=n)
    return base[rng.integers(0, n_base, size=n)] + \
        rng.normal(size=(n, N, 3)) * sigma[:, None, None]


def tfd_grid_fps(rng, q, dup=0.4, jitter=1.0):
    '''Fingerprints of a clustered 3^q torsion grid, as a conformer search
    makes them: every combination of three staggered angles a torsion, in
    random order; a share `dup` of the rows replaced by copies of other
    rows; every angle jittered by `jitter` degrees (normal) and wrapped to
    [-180, 180), float32. Pairs of copies sum to ~8 degrees over seven
    torsions at jitter 1, so a TFD prune's chunks hold hits, misses and
    long walks.'''
    axes = np.meshgrid(*[np.array([-60.0, 60.0, 180.0])] * q, indexing='ij')
    grid = np.stack([a.ravel() for a in axes], axis=1)
    grid = grid[rng.permutation(len(grid))]
    n = len(grid)
    who = rng.random(n) < dup
    grid[who] = grid[rng.integers(0, n, int(who.sum()))]
    fps = grid + rng.normal(size=grid.shape) * jitter
    return ((fps + 180) % 360 - 180).astype(np.float32)


def tfd_clustered_fps(rng, n, q, n_clusters, spread):
    '''n float32 fingerprints of q torsions around n_clusters random
    centers, `spread` degrees (normal) from them, wrapped.'''
    centers = rng.uniform(-180, 180, size=(n_clusters, q))
    fps = centers[rng.integers(0, n_clusters, n)] + \
        rng.normal(size=(n, q)) * spread
    return ((fps + 180) % 360 - 180).astype(np.float32)


# the TFD prune's search: the ensembles whose every pass the tests hold,
# and hand-made passes (n, d, k, num_active, Q) at the reference's quirks
TFD_ENSEMBLES = {
    'grid_3^7': lambda: tfd_grid_fps(np.random.default_rng(17), 7),
    'clustered_1500': lambda: tfd_clustered_fps(np.random.default_rng(4),
                                                1500, 6, 60, 1.2),
}
TFD_PASS_CASES = [
    (50, 10, 5, 23, 6),        # num_active < d (k - 1): the last chunk empty
    (50, 10, 5, 41, 6),        # the last chunk one row
    (50, 10, 5, 42, 6),        # the last chunk two rows
    (7, 1, 5, 7, 3),           # chunks of one row
    (1030, 515, 2, 1030, 4),   # chunks across the 512-row tile
    (1536, 511, 3, 1400, 5),   # 511, 511 past num_active's 1,400, 378
    (4100, 4100, 1, 4100, 1),  # one chunk across the 4,096-column tile
    (8193, 4096, 2, 8193, 2),  # 4,096 and 4,097 rows
    (900, 300, 3, 700, 40),    # Q = 40, the last chunk ending early
]


def tfd_pass_fps(n, q):
    '''The fingerprints of a hand-made pass of TFD_PASS_CASES.'''
    return tfd_clustered_fps(np.random.default_rng(n + q), n, q,
                             max(2, n // 6), 10.0 / q * 0.6)


def lazy_keep(ok, gate):
    '''The block sweep kernel B1's dedup in its order, on the host: ok
    (rows, A) numpy bool, gate(b, t, t0) whether pose t of row b passes
    both gates against pose t0. In each row the smallest live angle
    (passed the screen, not yet dropped) is kept and every live angle
    after it is gated against it, dropping out on a hit. Returns (keep
    (rows, A) bool, the gate pairs evaluated).'''
    ok = np.asarray(ok, dtype=bool)
    keep = np.zeros_like(ok)
    n = 0
    for b in range(ok.shape[0]):
        live = [int(t) for t in np.flatnonzero(ok[b])]
        while live:
            t0 = live.pop(0)
            keep[b, t0] = True
            n += len(live)
            live = [t for t in live if not gate(b, t, t0)]
    return keep, n


def dimer_case(name, seed=0):
    '''(coords (N, 3), ff.FFParams) of a dimer input made with numpy:
    'hcooh' HCOOH's fixture jittered by 0.15 A (seed) on the fixture's
    topology, its tables from the jittered frame (as
    saddle_refine_structure builds them); 'ring' the nine-carbon
    chlorocycloalkane's sub-peak guess `seed` of the SADDLE scan's JAX
    x64 record (tests/golden/dihedral_scan.npz, phase 18's input), on the
    ring's topology; 'merged' HCOOH and C2H4 3 A apart, jittered, on
    tables merged over the two molecules as the SADDLE stage merges
    them (ff.merge_ff_params).'''
    import os
    from tscode_tpu_torch import ff
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    from tscode_tpu_torch.suite_inputs import chlorocycloalkane
    rng = np.random.default_rng(seed)
    if name == 'ring':
        ring, nos = chlorocycloalkane(9)
        x = np.load(os.path.join(os.path.dirname(__file__), 'golden',
                                 'dihedral_scan.npz'))['saddle_guess'][seed]
        return x, ff.build_ff_params(x, nos, graphize(ring, nos))
    names = ('HCOOH.xyz',) if name == 'hcooh' else ('HCOOH.xyz', 'C2H4.xyz')
    mols = [read_xyz(os.path.join(FIXTURE_DIR, n)) for n in names]
    parts, frames, offsets = [], [], [0]
    for k, m in enumerate(mols):
        x0 = m.atomcoords[0]
        x = x0 + rng.normal(size=x0.shape) * 0.15 + np.array([3.0 * k, 0, 0])
        parts.append(ff.build_ff_params(x, m.atomnos, graphize(x0, m.atomnos)))
        frames.append(x)
        offsets.append(offsets[-1] + len(x0))
    x = np.concatenate(frames)
    if len(parts) == 1:
        return x, parts[0]
    return x, ff.merge_ff_params(parts, np.array(offsets[:-1]))
