'''Conformer-search parity, float64 on the CPU: tscode_tpu_torch.torsions
and tscode_tpu_torch.cluster against tscode_tpu.torsions and
scikit-learn on the same seeded inputs. Back-off coordinates within
1e-9 A and flags equal; DBSCAN labels exactly sklearn's; searched
conformers equal to the JAX package's frame for frame (1e-6 A), with
numpy's global generator seeded for the JAX package and an explicit
RandomState of the same seed for the port. Where the JAX package calls
sklearn's KMeans (unseeded there, so no reference draws exist), the
test hands it the port's own k-means result, so the selection around it
is compared exactly.

    python tests/test_torch_csearch.py

times the back-off of csearch_string's search (the C10H21Cl chain,
6,561 candidates) on the CPU with each of its two loops.'''

import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import jax.numpy as jnp  # noqa: E402
from tscode_tpu import torsions as jt
from tscode_tpu.io_xyz import read_xyz
from tscode_tpu_torch import cluster
from tscode_tpu_torch import torsions as tt
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.ops.kernels import clash
from tscode_tpu_torch.suite_inputs import chloroalkane
from torch_parity import t64, to_np

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'fixtures')
ATOL = 1e-9
QUIET = dict(logfunction=lambda *a, **k: None)


def c2f2h4():
    data = read_xyz(os.path.join(FIX, 'C2F2H4.xyz'))
    return np.array(data.atomcoords[0]), np.array(data.atomnos)


def torsions_of(coords, atomnos, pkg=tt):
    '''The rotable torsions of a molecule as the search finds them, and
    its graph.'''
    graph = graphize(coords, atomnos)
    torsions = pkg.get_torsions(graph, [], pkg.get_double_bonds_indices(
        coords, atomnos))
    for t in torsions:
        t.sort_torsion(graph, np.array([]))
    return torsions, graph


def masks(graph, torsion):
    move = tt.get_rotation_mask(graph, torsion.torsion)
    other = ~move
    other[list(torsion.torsion[1:3])] = False
    return move, other


def jax_backoff(coords, torsion, move, other, angles, steps):
    out, rot = jt._rotate_batch_with_backoff(
        jnp.asarray(coords), jnp.asarray(np.array(torsion.torsion)),
        jnp.asarray(move), jnp.asarray(angles), jnp.asarray(other),
        jnp.asarray(steps))
    return np.asarray(out), np.asarray(rot)


@pytest.mark.parametrize('mol,scale,top,bucket', [
    ('C2F2H4', 1.0, 60, 12), ('C2F2H4', 0.7, 240, 48),
    ('C6', 1.0, 120, 24), ('C6', 0.8, 355, 72), ('C6', 0.8, 0, 0)])
@pytest.mark.parametrize('loop', ['_pending_rows', '_whole_batch'])
def test_backoff_equals_the_jax_package(mol, scale, top, bucket, loop,
                                        monkeypatch):
    '''Jittered, optionally shrunk molecules (shrinking forces clashes
    and so retreats) rotated by angles in 5-degree steps from 0 to `top`
    (angle 0 included); the JAX package runs its retreat loop to its
    bucket of steps, the port to the largest angle's own count, with the
    CPU's loop and with the card's (every step on the whole batch) run
    on CPU tensors.'''
    monkeypatch.setattr(tt, '_pending_rows', {
        '_pending_rows': tt._pending_rows,
        '_whole_batch': clash.whole_batch}[loop])
    rng = np.random.default_rng(11)
    base, nos = c2f2h4() if mol == 'C2F2H4' else chloroalkane(6)
    torsions, graph = torsions_of(base, nos)
    B = 64
    coords = (base + rng.normal(size=(B,) + base.shape) * 0.05) * scale
    angles = rng.integers(0, top // 5 + 1, size=B) * 5.0
    angles[:3] = [0.0, top, top]
    retreats = 0
    for torsion in torsions:
        move, other = masks(graph, torsion)
        want, want_rot = jax_backoff(coords, torsion, move, other, angles,
                                     bucket)
        got, got_rot = tt.rotate_batch_with_backoff(
            t64(coords), torsion.torsion, move, t64(angles), other,
            int(angles.max() // 5))
        np.testing.assert_array_equal(to_np(got_rot), want_rot)
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=ATOL)
        assert not to_np(got_rot)[angles == 0].any()
        full = to_np(tt.rotate_batch_with_backoff(
            t64(coords), torsion.torsion, move, t64(angles), np.zeros_like(
                other), 0)[0])
        retreats += int((np.abs(to_np(got) - full).max(axis=(1, 2))
                         [want_rot] > 1e-6).sum())
    if scale < 1 and top:
        assert retreats > 0


def test_apply_torsion_group_equals_the_jax_package():
    '''Every angle set of the C6 chain's four rotors (81 candidates; the
    JAX package pads them to 128) from jittered starting points.'''
    rng = np.random.default_rng(3)
    base, nos = chloroalkane(6)
    torsions, graph = torsions_of(base, nos)
    jtors, jgraph = torsions_of(base, nos, jt)
    angles = tt.cartesian_product(*[np.array(t.get_angles())
                                    for t in torsions])
    coords = (base + rng.normal(size=(len(angles),) + base.shape) * 0.05) * 0.85
    want, want_n = jt._apply_torsion_group(jnp.asarray(coords), jtors, jgraph,
                                           angles)
    got, got_n = tt.apply_torsion_group(t64(coords), torsions, graph, angles)
    assert len(torsions) == 4 and len(angles) == 81
    np.testing.assert_array_equal(to_np(got_n), np.asarray(want_n))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert 0 < int((to_np(got_n) < 4).sum()) < 81


@pytest.mark.parametrize('seed', range(6))
def test_dbscan_labels_equal_sklearn(seed):
    sk = pytest.importorskip('sklearn.cluster')
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    points = rng.normal(size=(n, 3)) * rng.uniform(1, 6)
    for eps in (0.5, 1.0, 2.0, 4.0):
        want = sk.dbscan(points, eps=eps, min_samples=1)[1]
        np.testing.assert_array_equal(cluster.dbscan_labels(points, eps),
                                      want)


def test_group_torsions_dbscan_equals_the_jax_package():
    '''Twelve synthetic torsions whose bond centres form clusters of 2
    to 6 (the largest splits at a smaller eps): the same groups, in the
    same order.'''
    rng = np.random.default_rng(4)
    sizes = (2, 6, 3, 1)
    centres = np.array([[0, 0, 0], [20, 0, 0], [0, 20, 0], [0, 0, 20]])
    coords, quads = [], []
    for c, size in zip(centres, sizes):
        for _ in range(size):
            mid = c + rng.normal(size=3) * 1.5
            base = len(coords)
            coords += [mid - [1.2, 0, 0], mid - [0.7, 0, 0],
                       mid + [0.7, 0, 0], mid + [1.2, 0, 0]]
            quads.append((base, base + 1, base + 2, base + 3))
    coords = np.array(coords)
    for max_size in (3, 5):
        want = jt.group_torsions_dbscan(coords, [jt.Torsion(*q) for q in quads],
                                        max_size=max_size)
        got = tt.group_torsions_dbscan(coords, [tt.Torsion(*q) for q in quads],
                                       max_size=max_size)
        assert [[t.torsion for t in g] for g in got] == \
            [[t.torsion for t in g] for g in want]
        assert max(len(g) for g in got) <= max_size and len(got) > 4


def kmeans_blobs(seed, k=5, per=30, dim=6):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, dim)) * 20
    who = rng.permutation(np.repeat(np.arange(k), per))
    return centres[who] + rng.normal(size=(k * per, dim)), who


@pytest.mark.parametrize('seed', range(3))
def test_kmeans_finds_sklearns_partition(seed):
    '''Well-separated blobs: the port's k-means and sklearn's KMeans
    give the same partition, up to the labels' order, and the port's
    centres are the clusters' means.'''
    sk = pytest.importorskip('sklearn.cluster')
    X, who = kmeans_blobs(seed)
    labels, centres = cluster.kmeans(X, 5, np.random.RandomState(seed),
                                     device='cpu')
    want = sk.KMeans(n_clusters=5, n_init=cluster.N_INIT,
                     random_state=seed).fit(X).labels_
    # one label of each maps to one label of the other: the same
    # partition (and it is the blobs')
    assert len(set(labels.tolist())) == 5
    assert len(set(zip(labels.tolist(), want.tolist()))) == 5
    assert len(set(zip(labels.tolist(), who.tolist()))) == 5
    for c in range(5):
        np.testing.assert_allclose(centres[c], X[labels == c].mean(axis=0),
                                   rtol=0, atol=1e-9)


def test_kmeans_is_seeded_by_its_generator():
    X, _ = kmeans_blobs(7, k=8, per=10)
    a = cluster.kmeans(X, 12, np.random.RandomState(1), device='cpu')
    b = cluster.kmeans(X, 12, np.random.RandomState(1), device='cpu')
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert len(set(a[0].tolist())) == 12
    with pytest.raises(ValueError):
        cluster.kmeans(X, len(X) + 1, np.random.RandomState(1), device='cpu')


class PortKMeans:
    '''Stand-in for sklearn.cluster.KMeans inside the JAX package: the
    port's k-means, drawn from the same seeded stream as the port's.'''
    rng = None

    def __init__(self, n_clusters, n_init, **_):
        assert n_init == cluster.N_INIT
        self.k = n_clusters

    def fit(self, X):
        self.labels_, self.cluster_centers_ = cluster.kmeans(
            X, self.k, PortKMeans.rng, device='cpu')
        return self


def searched(mol, seed, monkeypatch, **kw):
    '''(JAX package's, port's) conformers of one search of `mol`.'''
    coords, nos = c2f2h4() if mol == 'C2F2H4' else \
        chloroalkane(int(mol[1:]))
    sk = pytest.importorskip('sklearn.cluster')
    monkeypatch.setattr(sk, 'KMeans', PortKMeans)
    PortKMeans.rng = np.random.RandomState(seed)
    np.random.seed(seed)
    want = jt.csearch(coords, nos, **kw, **QUIET)
    rec = {}
    got = tt.csearch(coords, nos, **kw, **QUIET, rng=np.random.RandomState(
        seed), device='cpu', stats=rec)
    assert rec['conformers'] == len(got)
    return np.asarray(want), got, rec


@pytest.mark.parametrize('mol,kw,branch', [
    ('C2F2H4', dict(mode=1), 'all'),
    ('C6', dict(mode=1, n_out=30), 'kmeans'),
    ('C6', dict(mode=1, n_out=30, keep_hb=True), 'kmeans'),
    ('C8', dict(mode=1, n_out=320), 'choice'),
    ('C6', dict(mode=2, n_out=30), 'random'),
    ('C8', dict(mode=2, n_out=500), 'random'),
])
def test_csearch_equals_the_jax_package(mol, kw, branch, monkeypatch):
    '''The searched conformers frame for frame: mode 1 keeping all, or
    selecting through k-means (n_out <= 300; csearch_hb> too) or
    through the seeded draw of distinct structures (n_out > 300); mode 2
    (rsearch>) through the seeded shuffle.'''
    want, got, rec = searched(mol, 5, monkeypatch, **kw)
    assert got.shape == want.shape and len(got) > 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    n_out = kw.get('n_out', 100)
    if branch == 'all':
        assert len(got) < n_out
    else:
        assert len(got) == n_out
    if branch == 'choice':
        assert rec['candidates'] > n_out > 300
    assert rec['torsions'] == {'C2F2H4': 1, 'C6': 4, 'C8': 6}[mol]


def test_segmented_molecule_raises_in_both(monkeypatch):
    '''Two molecules with no hydrogen bond between them: csearch_hb>
    raises SegmentedGraphError in both packages.'''
    from tscode_tpu.errors import SegmentedGraphError as JaxError
    from tscode_tpu_torch.errors import SegmentedGraphError
    coords, nos = c2f2h4()
    pair = np.concatenate([coords, coords + [8.0, 0, 0]])
    nos2 = np.concatenate([nos, nos])
    with pytest.raises(JaxError):
        jt.csearch(pair, nos2, keep_hb=True, **QUIET)
    with pytest.raises(SegmentedGraphError):
        tt.csearch(pair, nos2, keep_hb=True, rng=np.random.RandomState(0),
                   device='cpu', **QUIET)


def test_stability_mode_needs_item_15():
    '''Mode 0 optimises every group's conformers on a calculator: with
    none given (no embedder, no calc) it raises the JAX package's
    InputError, word for word (search mode 0 on the stand-in xtb:
    tests/test_torch_opt_operators.py).'''
    from tscode_tpu.errors import InputError as JaxInputError
    from tscode_tpu_torch.errors import InputError
    coords, nos = chloroalkane(6)
    with pytest.raises(JaxInputError) as want:
        jt.csearch(coords, nos, mode=0, ff_opt=True, **QUIET)
    with pytest.raises(InputError) as got:
        tt.csearch(coords, nos, mode=0, ff_opt=True,
                   rng=np.random.RandomState(0), device='cpu', **QUIET)
    assert str(got.value) == str(want.value)
    assert 'requires an external calculator' in str(got.value)


def time_backoff_loops(reps=2):
    '''Seconds of the back-off in csearch_string's search (mode 1,
    n_out 1,000) on the CPU, with the CPU's loop and with the card's
    loop, `reps` runs each; both must give the same conformers.'''
    coords, nos = chloroalkane(10)
    out = {}
    for name, loop in (('pending_rows', tt._pending_rows),
                       ('whole_batch', clash.whole_batch)):
        entry, tt._pending_rows = tt._pending_rows, loop
        try:
            for _ in range(reps):
                rec = {}
                got = tt.csearch(coords, nos, n_out=1000, stats=rec,
                                 rng=np.random.RandomState(0), device='cpu',
                                 **QUIET)
                out.setdefault(name, []).append(rec['backoff_s'])
        finally:
            tt._pending_rows = entry
        out.setdefault('conformers', []).append(got)
    a, b = out.pop('conformers')
    assert a.shape == b.shape and np.abs(a - b).max() <= 1e-9
    return out


if __name__ == '__main__':
    import torch
    torch.set_num_threads(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    t0 = time.perf_counter()
    secs = time_backoff_loops()
    print({k: [round(x, 4) for x in v] for k, v in secs.items()},
          f'threads {torch.get_num_threads()}, '
          f'{time.perf_counter() - t0:.1f} s in all')
