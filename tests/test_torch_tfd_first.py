'''The TFD prune's first-similar-successor search a pass at a time
(tscode_tpu_torch/ops/kernels/tfd.py, kernel T1's plain twin on the
CPU) against the JAX package's tile loop, tscode_tpu.ops.tfd.
_first_similar_successor, chunk by chunk; the prune's mask against the
JAX package's; the sharded pass on a four-entry CPU mesh against the
unsharded one; and the routing: a CUDA tensor reaches the kernel or
raises, never the twin.

The JAX tile loop sums its wrapped differences in float32 (its
fingerprints' dtype), the port in float64, so a row may differ where one
of its pair sums lies within float32 rounding of the threshold: such
rows (a sum within NEAR degrees of it, at or before the row's first
hit) are excluded and counted, and their number is asserted small: on
these inputs none of (a)'s 26,306 rows compared, 1 of 4,100 rows at
Q = 1 and 5 of 8,193 at Q = 2 in (b).'''

import networkx as nx
import numpy as np
import pytest
import torch

from tscode_tpu.ops import tfd as jt
from tscode_tpu_torch.ops import tfd as tt
from tscode_tpu_torch.ops.kernels import tfd as kt
from tscode_tpu_torch.parallel.sharding import (make_mesh,
                                                sharded_first_similar_successor)
from torch_parity import (TFD_ENSEMBLES, TFD_PASS_CASES, tfd_grid_fps,
                          tfd_pass_fps)

THRESH = 10.0
NEAR = 1e-3          # degrees: a pair sum this close to THRESH is a tie


def reference_chunks(n, d, k, num_active):
    '''(lo, hi) of every chunk of a pass, cut as the reference cuts them
    (numba_functions.py, the JAX package's prune loop), independently of
    the port's pass_chunks; chunks of one row or none included.'''
    return [(d * s, num_active if s == k - 1 else d * (s + 1))
            for s in range(k)]


def near_rows(fps, lo, hi, first):
    '''Chunk-relative rows of [lo, hi) with a pair sum within NEAR of
    THRESH up to and including the row's first hit (to the chunk's end
    without one), float64: only such a pair can move the first hit
    between float32 and float64 sums.'''
    t = torch.as_tensor(fps[lo:hi])
    s = tt.wrapped_l1(t, t).numpy()
    L = hi - lo
    i, j = np.arange(L)[:, None], np.arange(L)[None, :]
    last = np.where(first >= 0, first, L - 1)[:, None]
    tie = (np.abs(s - THRESH) < NEAR) & (j > i) & (j <= last)
    return tie.any(axis=1)


def held_against_jax(fps, d, k, num_active, got):
    '''One pass's result against the JAX tile loop, chunk by chunk, rows
    near a tie excluded. Returns (rows compared, rows excluded, hits).'''
    n = len(fps)
    compared = excluded = hits = 0
    covered = np.zeros(n, dtype=bool)
    for lo, hi in reference_chunks(n, d, k, num_active):
        if hi - lo <= 1:
            continue
        covered[lo:hi] = True
        want = jt._first_similar_successor(fps[lo:hi], THRESH)
        tie = near_rows(fps, lo, hi, got[lo:hi])
        ok = ~tie
        np.testing.assert_array_equal(got[lo:hi][ok], want[ok],
                                      err_msg=f'pass k={k} chunk {lo}:{hi}')
        compared += int(ok.sum())
        excluded += int(tie.sum())
        hits += int((got[lo:hi] >= 0).sum())
    assert (got[~covered] == -1).all()
    return compared, excluded, hits


def recorded_passes(monkeypatch, fps):
    '''prune_conformers_tfd on `fps`, each pass's call recorded:
    returns (mask, [(d, k, num_active, first numpy)]).'''
    passes = []
    entry = tt.first_successor_pass

    def spy(tf, d, k, num_active, thresh, rows=None):
        out = entry(tf, d, k, num_active, thresh, rows)
        passes.append((d, k, num_active, out.numpy().copy()))
        return out
    monkeypatch.setattr(tt, 'first_successor_pass', spy)
    dummy = np.zeros((len(fps), 1, 3))
    quads = np.zeros((fps.shape[1], 4), dtype=int)
    _, mask = tt.prune_conformers_tfd(dummy, quads, tf_mat=fps,
                                      device='cpu')
    monkeypatch.undo()
    return mask, passes


@pytest.mark.parametrize('name', sorted(TFD_ENSEMBLES))
def test_every_pass_matches_the_jax_tile_loop(monkeypatch, name):
    '''(a) Every pass of the prune's schedule, chunk by chunk, against
    JAX's _first_similar_successor (x64 on the CPU, float32 sums). The
    prune calls the pass entry once a pass: the gate's passes, no more.'''
    fps = TFD_ENSEMBLES[name]()
    mask, passes = recorded_passes(monkeypatch, fps)
    n = len(fps)
    ks = [k for _, k, _, _ in passes]
    assert ks == sorted(ks, reverse=True) and ks[-1] == 1 and len(ks) >= 5
    totals = np.zeros(3, dtype=int)
    for d, k, num_active, got in passes:
        assert d == n // k and got.shape == (n,) and got.dtype == np.int32
        totals += held_against_jax(fps, d, k, num_active, got)
        walked = kt.walked_pairs(got, d, k, num_active)
        assert walked >= int((got >= 0).sum())
    compared, excluded, hits = totals
    # rows excluded for a float32 tie with JAX: a handful at most
    assert excluded <= max(3, compared // 1000), (excluded, compared)
    assert hits > 100 and compared > 4 * n
    assert 0 < mask.sum() < n


@pytest.mark.parametrize('n,d,k,num_active,q', TFD_PASS_CASES)
def test_chunk_table_quirks(n, d, k, num_active, q):
    '''(b) Hand-made passes at the reference's quirks against the JAX
    tile loop, and the same pass cut into row slices.'''
    fps = tfd_pass_fps(n, q)
    tf = torch.as_tensor(fps)
    got = kt.first_successor_pass(tf, d, k, num_active, THRESH).numpy()
    assert got.shape == (n,) and got.dtype == np.int32
    compared, excluded, hits = held_against_jax(fps, d, k, num_active, got)
    assert excluded <= max(2, compared // 1000)
    cover = kt.pass_rows(d, k, num_active)
    assert (got[cover:] == -1).all()
    for r0, r1 in ((0, n // 3), (n // 3, n - 1), (n - 1, n), (5, 5)):
        part = kt.first_successor_pass(tf, d, k, num_active, THRESH,
                                       rows=(r0, r1)).numpy()
        np.testing.assert_array_equal(part, got[r0:r1])
    chunks = [c for c in reference_chunks(n, d, k, num_active)
              if c[1] - c[0] > 1]
    assert list(kt.pass_chunks(d, k, num_active)) == chunks
    if n > 50:
        assert hits > 0 and (got[:cover] < 0).any()


@pytest.mark.parametrize('name', sorted(TFD_ENSEMBLES))
def test_prune_mask_matches_jax(name):
    '''(c) The prune's mask against the JAX package's on the same
    fingerprints.'''
    fps = TFD_ENSEMBLES[name]()
    dummy = np.zeros((len(fps), 1, 3))
    quads = np.zeros((fps.shape[1], 4), dtype=int)
    _, got = tt.prune_conformers_tfd(dummy, quads, tf_mat=fps, device='cpu')
    _, want = jt.prune_conformers_tfd(dummy, quads, tf_mat=fps)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_sharded_passes_match_unsharded(monkeypatch):
    '''(d) On a mesh naming the CPU four times: every pass of the grid's
    prune sharded equals the unsharded pass, and the sharded prune's mask
    the unsharded one.'''
    fps = TFD_ENSEMBLES['grid_3^7']()
    mesh = make_mesh(devices=['cpu'] * 4)
    want, passes = recorded_passes(monkeypatch, fps)
    tf = torch.as_tensor(fps)
    for d, k, num_active, first in passes:
        got = sharded_first_similar_successor(tf, THRESH, mesh, d=d, k=k,
                                              num_active=num_active)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, first)
    dummy = np.zeros((len(fps), 1, 3))
    quads = np.zeros((fps.shape[1], 4), dtype=int)
    _, got_mask = tt.prune_conformers_tfd(dummy, quads, tf_mat=fps,
                                          device='cpu', mesh=mesh)
    np.testing.assert_array_equal(got_mask, want)


def tile_walk(fps, d, k, num_active, thresh, rows=None, plan=None):
    '''T1's walk on the host, as csrc/tfd_first.cu walks it on the plan
    (kt.pass_plan of the pass unless given): blocks of kt.BLOCK_WARPS
    consecutive rows of [r0, r1), each in the windows kt.windows gives
    (their count, of `segment` candidates each) from its first row + 1 on; a block stages
    tiles of plan['tile'] candidates (1,024 a step where tile is 0) from
    its window's start; each live row (a chunk of two rows or more, a
    candidate after it in the window, no hit found by an earlier window)
    scans the tile's candidates in (i, hi) 32 at a time in order, the
    float64 wrapped sums in torsion order, and stops at its first hit or
    at its chunk's or window's end; the block stops when none of its rows
    is live; a row's result is its smallest hit over the windows. Returns
    (first (r1 - r0,) int32, the tiles the blocks staged as (j0, j1), the
    candidates evaluated).'''
    n, Q = fps.shape
    plan = plan or kt.pass_plan(Q, d, k, num_active)
    span = plan['tile'] or 1024
    seg, n_win = kt.windows(plan, d, k, num_active)
    seg = seg or n + span
    r0, r1 = (0, n) if rows is None else rows
    f64 = fps.astype(np.float64)
    first = np.full(r1 - r0, -1, dtype=np.int32)
    tiles, evaluated = [], 0
    for b0 in range(r0, r1, kt.BLOCK_WARPS):
        for y in range(n_win):
            w0 = b0 + 1 + y * seg
            w1 = w0 + seg
            live = {}
            for i in range(b0, min(r1, b0 + kt.BLOCK_WARPS)):
                step = min(i // d, k - 1)
                lo = d * step
                hi = num_active if step == k - 1 else d * (step + 1)
                if hi - lo > 1 and max(w0, i + 1) < min(w1, hi) and \
                        first[i - r0] < 0:
                    live[i] = (lo, hi)
            j0 = w0
            while live and j0 < w1:
                tiles.append((j0, j0 + span))
                for i, (lo, hi) in list(live.items()):
                    jlo, jhi = max(j0, i + 1), min(j0 + span, w1, hi)
                    for base in range(jlo, jhi, 32):
                        j = np.arange(base, min(base + 32, jhi))
                        acc = np.zeros(len(j))
                        for q in range(Q):
                            dq = np.abs(f64[i, q] - f64[j, q])
                            acc += np.minimum(dq, np.abs(dq - 360.0))
                        evaluated += len(j)
                        hit = np.flatnonzero(acc < thresh)
                        if hit.size:
                            first[i - r0] = base + hit[0] - lo
                            del live[i]
                            break
                    if i in live and jhi >= min(w1, hi):
                        del live[i]
                j0 += span
    return first, tiles, evaluated


# (tile, window): the plan's, small tiles, short windows
WALK_PLANS = [(None, None), (64, 128), (32, 64), (0, 0), (0, 2048)]


@pytest.mark.parametrize('tile, segment', WALK_PLANS)
@pytest.mark.parametrize('n,d,k,num_active,q', TFD_PASS_CASES)
def test_tile_walk_equals_the_twin_on_the_quirks(n, d, k, num_active, q,
                                                 tile, segment):
    '''T1's tile walk (tile_walk, the kernel's block and tile order on
    the host) equals the plain twin on the hand-made passes (chunks past
    num_active, an empty or one-row last chunk, chunks of one row,
    chunks across the JAX tiles), whole and in shard slices, on tiles of
    the plan's size (Q = 40 stages 192 candidates), of 64 and 32, and
    unstaged; some of its tiles cross a chunk's end, and a walk costs no
    more candidates than the first design's steps of 32.'''
    fps = tfd_pass_fps(n, q)
    tf = torch.as_tensor(fps)
    plan = kt.launch_plan(q, tile, segment)
    if tile is None:
        assert plan['tile'] == (192 if q == 40 else 256)
    want = kt.first_successor_pass(tf, d, k, num_active, THRESH).numpy()
    got, tiles, evaluated = tile_walk(fps, d, k, num_active, THRESH,
                                      plan=plan)
    np.testing.assert_array_equal(got, want)
    walked = kt.walked_pairs(want, d, k, num_active)
    _, n_win = kt.windows(plan, d, k, num_active)
    assert walked <= evaluated <= walked + 31 * n * (1 + n // 32) + \
        (n_win > 1) * n * n
    ends = [hi for _, hi in kt.pass_chunks(d, k, num_active)]
    crossing = [t for t in tiles if any(t[0] < e < t[1] for e in ends)]
    if len(ends) > 1 and plan['tile'] and plan['tile'] < d:
        assert crossing
    if segment and segment < d - kt.BLOCK_WARPS:
        assert n_win > 1
    for r0, r1 in ((0, n // 3), (n // 3, n - 1), (n - 1, n), (5, 5)):
        part, _, _ = tile_walk(fps, d, k, num_active, THRESH, rows=(r0, r1),
                               plan=plan)
        np.testing.assert_array_equal(part, want[r0:r1])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_tile_walk_equals_the_twin_on_random_passes(seed):
    '''On seeded clustered fingerprints and a random pass (k, num_active
    below n, a row slice), the tile walk on random plans equals the
    twin.'''
    rng = np.random.default_rng(seed)
    n, q = int(rng.integers(40, 700)), int(rng.integers(1, 12))
    fps = tfd_pass_fps(n, q)
    k = int(rng.integers(1, 6))
    d = n // k
    num_active = int(rng.integers(d * (k - 1), n + 1))
    r0 = int(rng.integers(0, n // 2))
    r1 = int(rng.integers(r0, n + 1))
    want = kt.first_successor_pass(torch.as_tensor(fps), d, k, num_active,
                                   THRESH, rows=(r0, r1)).numpy()
    tile = int(rng.choice([32, 64, 128, 256]))
    plan = kt.launch_plan(q, tile, tile * int(rng.choice([0, 1, 2, 4])))
    got, _, _ = tile_walk(fps, d, k, num_active, THRESH, rows=(r0, r1),
                          plan=plan)
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).any() or r1 - r0 < 2


def test_launch_plan_sizes_the_tile_by_q():
    '''The tile: 256 candidates while they fit in 64 KB with the block's
    rows (Q = 8: 16,960 bytes), fewer for larger Q, 32 past 64 KB while
    32 fit the block's shared memory (Q = 200), none (candidates read
    from device memory) past it, so any Q runs; windows of four steps,
    as many as the longest chunk needs; a pass of chunks of 2,048 rows or
    fewer unstaged.'''
    assert kt.launch_plan(8) == {'tile': 256, 'smem': 16960,
                                 'segment': 1024}
    assert kt.launch_plan(33)['tile'] == 224
    assert kt.launch_plan(200)['tile'] == 32
    assert kt.launch_plan(1000)['tile'] == 0
    assert kt.launch_plan(1000)['smem'] == 0
    assert kt.launch_plan(1000)['segment'] == 4096
    # csearch_string's k = 1 pass: 4,936 rows in one chunk, 5 windows
    assert kt.windows(kt.launch_plan(8), 6561, 1, 4936) == (1024, 5)
    assert kt.windows(kt.launch_plan(8), 656, 10, 6561) == (0, 1)
    assert kt.windows(kt.launch_plan(8, 256, 0), 6561, 1, 4936) == (0, 1)
    # a pass whose chunks are all short walks unstaged
    assert kt.pass_plan(8, 6561, 1, 4936)['tile'] == 256
    assert kt.pass_plan(8, 3280, 2, 6561)['tile'] == 256
    assert kt.pass_plan(8, 1312, 5, 6561)['tile'] == 0
    assert kt.pass_plan(8, 656, 10, 6561)['tile'] == 0
    assert kt.pass_plan(8, 656, 10, 6561)['segment'] == 4096
    for q in (1, 8, 33, 200, 700):
        assert kt.launch_plan(q)['smem'] <= 227 * 1024
    with pytest.raises(ValueError):
        kt.launch_plan(8, 48)
    with pytest.raises(ValueError):
        kt.launch_plan(8, 256, 1000)
    with pytest.raises(ValueError):
        kt.launch_plan(1000, 32)


@pytest.mark.parametrize('tile', [256, 32, 0])
@pytest.mark.parametrize('rows', [10 ** 6, 3 * 10 ** 8, 2 ** 31 - 1])
def test_windows_always_cover_the_walk(tile, rows):
    '''The windows of a pass never number more than the grid's y limit
    (MAX_WINDOWS): past it the segment widens by whole steps, so the
    windows still cover the longest chunk's walk and no row's hit can
    fall beyond the last one.'''
    plan = kt.launch_plan(8, tile)
    step = tile or 1024
    for d, k, num_active in ((rows, 1, rows), (rows // 3, 3, rows)):
        segment, count = kt.windows(plan, d, k, num_active)
        reach = kt.longest_chunk(d, k, num_active) + kt.BLOCK_WARPS
        assert 1 < count <= kt.MAX_WINDOWS
        assert segment % step == 0 and segment >= plan['segment']
        assert segment * count >= reach > segment * (count - 1)
        if reach <= plan['segment'] * kt.MAX_WINDOWS:
            assert segment == plan['segment']


class OnCard(torch.Tensor):
    '''A CPU tensor that says it lies on the card: the routing test's
    stand-in for a CUDA tensor.'''

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_never_reaches_the_twin(monkeypatch):
    '''(e) On a tensor that says it is on the card, the pass entry takes
    the kernel's path (which raises here, with no card) and never the
    plain twin.'''
    calls = []
    monkeypatch.setattr(kt, 'first_successor_pass_plain',
                        lambda *a, **k: calls.append(a))
    tf = torch.as_tensor(tfd_grid_fps(np.random.default_rng(3), 4)) \
        .as_subclass(OnCard)
    with pytest.raises((RuntimeError, ValueError)):
        kt.first_successor_pass(tf, 81, 1, 81, THRESH)
    assert calls == []
    kt.first_successor_pass(tf.as_subclass(torch.Tensor), 81, 1, 81, THRESH)
    assert len(calls) == 1


def test_chunk_matches_equal_the_loop(monkeypatch):
    '''The match set built from the pass's array in one step equals the
    per-row loop's, in the same insertion order, and the graph built
    from it as a list (as the prune builds it) has the same nodes and
    edges, in the same order, as the graph of the loop's set, and keeps
    the same first nodes, on every chunk of (a)'s passes.'''
    fps = TFD_ENSEMBLES['grid_3^7']()
    _, passes = recorded_passes(monkeypatch, fps)
    n_chunks = 0
    for d, k, num_active, first in passes:
        for lo, hi in kt.pass_chunks(d, k, num_active):
            seg = first[lo:hi]
            loop = set()
            for i_rel in range(hi - lo):
                if seg[i_rel] >= 0:
                    loop.add((int(i_rel), int(seg[i_rel])))
            got = tt.chunk_matches(seg)
            assert got == loop and list(got) == list(loop)
            if got:
                n_chunks += 1
                graphs = (nx.Graph(list(got)), nx.Graph(loop))
                assert list(graphs[0].nodes) == list(graphs[1].nodes)
                assert list(graphs[0].edges) == list(graphs[1].edges)
                kept = [[tuple(g.subgraph(c).nodes)[0]
                         for c in nx.connected_components(g)]
                        for g in graphs]
                assert kept[0] == kept[1]
    assert n_chunks > 10
