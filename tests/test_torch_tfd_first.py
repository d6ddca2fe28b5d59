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
