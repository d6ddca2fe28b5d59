'''The block sweep (embeds/cyclical.block_screen, kernel B1 on the card)
on the CPU, float64: its plain twin against the JAX package's fused
block programs (_block_screen_mapped_compact for two molecules,
_block_screen_multi for three) on da_cyclical at 4 conformers and the
trimolecular input with RIGID at 4 (one conformer of HCOOH); the sweep's
compacted form (block_screen and screen_survivors: the twin, then its
poses by the keep mask) against the JAX programs' mask compaction,
unsharded and on a four-device CPU mesh; B1's lazy dedup rule (the gate
pairs it evaluates) against the full-matrix greedy keep, also in tiles
of angles as B1 walks them; the card's chunk rule and B1's launch
plans; the routing of a CUDA tensor. The kernel itself runs only on the
card (tests/test_torch_cuda.py).'''

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu.embeds import cyclical as jc
from tscode_tpu.ops import clash as jclash
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.embeds import cyclical as tc
from tscode_tpu_torch.ops.kernels import block_screen as b1
from tscode_tpu_torch.ops.kernels.clash import clash_ok_plain
from tscode_tpu_torch.ops.kernels.qcp import pair_list_hits
from tscode_tpu_torch.parallel.sharding import make_mesh
from tscode_tpu_torch.suite_inputs import config_files
from torch_parity import lazy_keep, to_np

CPU = torch.device('cpu')


def set_up(cls, path, **kw):
    cwd = os.getcwd()
    try:
        emb = cls(path, stamp='setup', **kw)
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    return emb


@pytest.fixture(scope='module')
def da4(tmp_path_factory):
    '''da_cyclical at 4 conformers: (port Embedder, its block dict, the
    twin's (poses, keep) on all 128 block rows, the JAX program's).'''
    d = tmp_path_factory.mktemp('da4')
    te = set_up(Embedder, config_files('da_cyclical', str(d), 4),
                device='cpu')
    m1, m2 = te.objects
    blk = tc.bimol_rigid_blocks(m1, m2, 5, te.pairing_ok_fn())
    angles = np.asarray(te.systematic_angles, dtype=float)
    coords, grid, pairs, rows = tc.sweep_inputs(blk, (m1, m2), angles, CPU,
                                                torch.float64)
    confs, *geo = rows(0, len(blk['ids']))
    plain = tc.block_screen_plain(coords, confs, geo, grid, pairs, 1.5)
    jax = jc._block_screen_mapped_compact(
        jnp.asarray(m1.atomcoords), jnp.asarray(m2.atomcoords),
        jnp.asarray(blk['tab1']), jnp.asarray(blk['tab2']),
        jnp.asarray(blk['tidx']), jnp.asarray(angles),
        jnp.asarray(jclash.cross_fragment_pair_mask((m1.n_atoms,
                                                     m2.n_atoms))),
        jnp.asarray(1.5), n_chunks=1)
    return te, blk, (coords, confs, pairs), plain, jax


@pytest.fixture(scope='module')
def tri4(tmp_path_factory):
    '''The trimolecular input with RIGID at 4 (one conformer of HCOOH):
    as da4, the JAX program _block_screen_multi on the port's block
    fields (directions adjusted by the port's chain).'''
    d = tmp_path_factory.mktemp('tri4')
    path = config_files('trimolecular_rigid', str(d), 4)
    te = set_up(Embedder, path, device='cpu')
    mols = te.objects
    blk = tc.trimol_rigid_blocks(mols, te.pairing_ok_fn())
    blk['dirs'], _ = tc.adjust_chain(*(blk[k] for k in tc._ADJUST),
                                     device='cpu')
    angles = np.asarray(te.systematic_angles, dtype=float)
    coords, grid, pairs, rows = tc.sweep_inputs(blk, mols, angles, CPU,
                                                torch.float64)
    confs, *geo = rows(0, len(blk['ids']))
    plain = tc.block_screen_plain(coords, confs, geo, grid, pairs, 1.5)
    jax = jc._block_screen_multi(
        *(jnp.asarray(m.atomcoords) for m in mols),
        *(jnp.asarray(blk['confs'][:, m]) for m in range(3)),
        *(jnp.asarray(blk[k]) for k in tc._GEOMETRY),
        jnp.asarray(angles),
        jnp.asarray(jclash.cross_fragment_pair_mask(
            tuple(m.n_atoms for m in mols))), 1.5)
    return te, blk, (coords, confs, pairs), plain, jax


# ------------------------------------------------------- (a) against JAX


@pytest.mark.parametrize('case', ['da4', 'tri4'])
def test_plain_twin_matches_the_jax_block_program(case, request):
    '''The twin on every block row (the CPU's route to block_screen):
    poses within 1e-9 A of the JAX program's, keep bits equal; the
    dedup drops some angles that passed the screen.'''
    _, blk, (coords, confs, pairs), (poses, keep), (jp, jk) = \
        request.getfixturevalue(case)
    assert poses.shape == (len(blk['ids']),) + tuple(jp.shape[1:])
    np.testing.assert_allclose(to_np(poses), np.asarray(jp), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(to_np(keep), np.asarray(jk))
    N = poses.shape[2]
    ok = clash_ok_plain(poses.reshape(-1, N, 3), pairs, 1.5)
    assert 0 < int(keep.sum()) < int(ok.sum())
    if case == 'tri4':
        assert (poses.shape[1], N, pairs.shape[0]) == (27, 15, 75)


@pytest.mark.parametrize('mesh', [None, 4])
@pytest.mark.parametrize('case', ['da4', 'tri4'])
def test_compacted_sweep_matches_the_jax_mask_compaction(case, mesh, request,
                                                         monkeypatch):
    '''The sweep's entries in the compacted form B1 gives on the card:
    block_screen on all block rows and screen_survivors in chunks of 10
    rows (unsharded, or on make_mesh(devices=['cpu'] * 4), the mesh
    forced) return the JAX program's keep mask exactly and its poses
    compacted by that mask, in order, within 1e-9 A (the twin's einsum
    sums round apart by an ulp), the same survivors as the twin's full
    poses compacted, bit for bit.'''
    te, blk, (coords, confs, pairs), (poses, keep), (jp, jk) = \
        request.getfixturevalue(case)
    want_keep = np.asarray(jk)
    want = np.asarray(jp)[want_keep]
    _, grid, _, rows = tc.sweep_inputs(blk, te.objects, te.systematic_angles,
                                       CPU, torch.float64)
    surv, keep1 = tc.block_screen(coords, confs, rows(0, len(blk['ids']))[1:],
                                  grid, pairs, 1.5)
    np.testing.assert_array_equal(to_np(keep1), want_keep)
    assert torch.equal(surv, poses[keep])
    if mesh:
        monkeypatch.setenv('TSCODE_MESH', '1')
    split = {}
    surv2, keep2 = tc.screen_survivors(
        blk, te.objects, te.systematic_angles, 1.5, device='cpu',
        dtype=torch.float64, block_chunk=10, split=split,
        mesh=make_mesh(devices=['cpu'] * mesh) if mesh else None)
    assert split['shards'] == (mesh or 1) and split['chunks'] > 1
    np.testing.assert_array_equal(keep2, want_keep)
    assert torch.equal(surv2, surv)
    assert surv.shape == (int(want_keep.sum()),) + want.shape[1:]
    np.testing.assert_allclose(to_np(surv), want, rtol=0, atol=1e-9)


# ----------------------------------------------- (b) the lazy dedup rule


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_lazy_rule_equals_the_greedy_keep_on_random_tables(seed):
    '''lazy_keep (torch_parity) on seeded (ok, similar) tables equals the
    full-matrix greedy keep (the native scan or its loop) and the device
    scan, and evaluates only pairs (t, kept t0): each pair it asks for
    has t0 kept and t0 < t, and no pair twice.'''
    rng = np.random.default_rng(seed)
    ok = rng.random((60, 40)) < 0.6
    sim = rng.random((60, 40, 40)) < (0.1, 0.3, 0.6)[seed]
    asked = []

    def gate(b, t, t0):
        asked.append((b, t, t0))
        return bool(sim[b, t, t0])
    keep, n = lazy_keep(ok, gate)
    want = tc.greedy_angular_keep(ok, sim)
    np.testing.assert_array_equal(keep, want)
    np.testing.assert_array_equal(keep, to_np(tc.greedy_keep_device(
        torch.as_tensor(ok), torch.as_tensor(sim))))
    assert n == len(asked) == len(set(asked))
    assert all(keep[b, t0] and t0 < t and ok[b, t] for b, t, t0 in asked)
    # an angle meets the kept angles before it in order, up to its
    # first hit
    met = {}
    for b, t, t0 in asked:
        met.setdefault((b, t), []).append(t0)
    for (b, t), t0s in met.items():
        assert t0s == sorted(t0s)
        assert not any(sim[b, t, s0] for s0 in t0s[:-1])
    assert 0 < keep.sum() < ok.sum()
    assert n < ok.sum() * ok.shape[1]


def tiled_keep(ok, gate, tile):
    '''B1's walk of a row in tiles of `tile` angles (1,024 on the card):
    a tile's live angles meet the angles kept in earlier tiles in order,
    then the lazy rule runs inside the tile. Returns (keep, the gate
    pairs asked for, in order).'''
    keep = np.zeros_like(ok)
    asked = []
    for b in range(ok.shape[0]):
        for base in range(0, ok.shape[1], tile):
            live = [t for t in range(base, min(ok.shape[1], base + tile))
                    if ok[b, t]]
            for t0 in np.flatnonzero(keep[b, :base]):
                asked += [(b, t, int(t0)) for t in live]
                live = [t for t in live if not gate(b, t, int(t0))]
            while live:
                t0 = live.pop(0)
                keep[b, t0] = True
                asked += [(b, t, t0) for t in live]
                live = [t for t in live if not gate(b, t, t0)]
    return keep, asked


@pytest.mark.parametrize('A, tile', [(1331, 64), (5329, 1024), (100, 32)])
def test_tiled_walk_asks_the_lazy_rules_pairs(A, tile):
    '''Past 1,024 angles B1 walks a row in tiles; on seeded tables of
    angle grids with near neighbours (a pose similar to those a few
    steps away) the tiled walk keeps what lazy_keep and the full-matrix
    greedy keep keep, and asks for the same gate pairs, angles kept in
    one tile dropping angles of later ones.'''
    rng = np.random.default_rng(A)
    rows = 2
    ok = rng.random((rows, A)) < 0.7
    coin = rng.random((rows, A, 41)) < 0.5

    def gate(b, t, t0):
        return 0 < t - t0 <= 40 and bool(coin[b, t, t - t0])
    want, n = lazy_keep(ok, gate)
    keep, asked = tiled_keep(ok, gate, tile)
    np.testing.assert_array_equal(keep, want)
    if A <= 1331:
        t = np.arange(A)
        d = t[:, None] - t[None, :]
        sim = (d > 0) & (d <= 40) & np.take_along_axis(
            coin, np.clip(d, 0, 40)[None].repeat(rows, 0), axis=2)
        np.testing.assert_array_equal(want, tc.greedy_angular_keep(ok, sim))
    assert len(asked) == n == len(set(asked))
    assert any(gate(b, t, t0) for b, t, t0 in asked
               if t // tile != t0 // tile)
    assert 10 < keep.sum() < ok.sum()


@pytest.mark.parametrize('case', ['da4', 'tri4'])
def test_lazy_rule_with_k3_gates_equals_the_twin_on_real_rows(case,
                                                              request):
    '''B1's rule on the real rows of (a), float64: the gates of the pairs
    (t, kept t0) alone, each with K3's pair arithmetic and its band
    shortcut (qcp.pair_list_hits at rmsd 1 A, maxdev 2 A), give the
    twin's keep, which gates the whole (A, A) matrix; and far fewer
    pairs than that matrix.'''
    _, _, (coords, confs, pairs), (poses, keep), _ = \
        request.getfixturevalue(case)
    rows, A, N = poses.shape[:3]
    ok = to_np(clash_ok_plain(poses.reshape(-1, N, 3), pairs,
                              1.5)).reshape(rows, A)

    def gate(b, t, t0):
        return bool(pair_list_hits(poses[b, t][None], poses[b, t0][None],
                                   tc.DEDUP_RMSD)[0])
    lazy, n = lazy_keep(ok, gate)
    np.testing.assert_array_equal(lazy, to_np(keep))
    assert 0 < n < rows * A * A // 20


# ------------------------------------------------- (c) the chunk rule


def test_card_chunk_bounds_the_poses_a_chunk_writes():
    '''B1 writes no pose but the survivors, so the card's chunk counts
    what a chunk holds a row (keep bytes, count, offset, conformer ids,
    block_geometry's tensors) within GATE_BYTES beside the screen's
    largest scratch: as many rows as fit, never fewer than one, never
    more than the sweep. da_cyclical_xl at 62 (46,128 rows of 36 angles)
    and multiembed at 41 (161,376 rows) are one chunk in float64 and
    float32, trimolecular RIGID (24,576 rows of 27, three molecules) one;
    the twin's rule _auto_chunk is unchanged.'''
    budget = tc.GATE_BYTES - b1.SCRATCH_BYTES
    for n_rows, A, M, itemsize in ((46128, 36, 2, 8), (161376, 36, 2, 8),
                                   (161376, 36, 2, 4), (24576, 27, 3, 8),
                                   (10 ** 7, 216, 3, 8),
                                   (10 ** 8, 5329, 2, 8)):
        rows = tc._card_chunk(n_rows, A, M, itemsize)
        per_row = A + 4 + 8 + 12 * M + 72 * M * itemsize
        assert 1 <= rows <= n_rows
        assert rows * per_row <= budget
        assert rows == n_rows or (rows + 1) * per_row > budget
    for n_rows, A, M in ((46128, 36, 2), (161376, 36, 2), (24576, 27, 3)):
        assert tc._card_chunk(n_rows, A, M, 8) == n_rows
    assert tc._card_chunk(10 ** 7, 216, 3, 8) < 10 ** 7
    assert tc._auto_chunk(46128, 36, 11, 8) == \
        tc.GATE_BYTES // (36 * 36 * 11 * 3 * 8)
    assert tc._auto_chunk(10, 216, 10 ** 5, 8) == 1


def test_launch_plan_keeps_four_rows_of_poses_in_shared_memory_that_fit():
    '''B1's screen holds a block's four rows of poses in shared memory up
    to the card's opt-in limit, each pose (3 N values and its squared
    norm) at an odd stride (3 N + 1, or 3 N + 2 where that is even: at N
    = 12 a stride of 36 gave the lanes' 8-byte reads 4-way bank
    conflicts), beside the staged pair list (up to 2,048
    pairs) and each warp's staged row (3 N + 18 M values); past it each
    warp of a bounded grid owns a slice (its staged row and its store) of
    a global scratch of at most SCRATCH_BYTES and shared memory holds the
    pair list alone, so any A and N run (N = 5,000 at A = 36, where a
    block's four staged rows alone would pass the opt-in limit). A lane screens its own pose's
    pairs unless a row has fewer than 8 angles and there are 64 pairs or
    more (the warp's screen). B1's first design keeps its own rule
    (row_launch_plan): A N <= 2,421 in float64, else the poses read back
    from its output, the warp's screen from 64 pairs.'''
    plan = b1.launch_plan(36, 11, 30, 8, M=2)
    rows = 36 * 35 + 33 + 36
    assert plan == {'form': 'smem', 'stride': 35,
                    'smem': 240 + 4 * (rows + rows % 2) * 8,
                    'slot_bytes': (rows + rows % 2) * 8,
                    'scratch_warps': b1.SCRATCH_WARPS, 'warp_clash': False}
    assert b1.launch_plan(36, 12, 36, 8)['stride'] == 37
    assert b1.launch_plan(27, 15, 75, 8)['stride'] == 47
    assert not b1.launch_plan(27, 15, 75, 8)['warp_clash']
    assert b1.launch_plan(27, 15, 75, 8, warp_clash=True)['warp_clash']
    assert b1.launch_plan(7, 15, 75, 8)['warp_clash']
    assert not b1.launch_plan(7, 15, 63, 8)['warp_clash']
    assert b1.launch_plan(36, 63, 64, 8)['form'] == 'smem'
    assert b1.launch_plan(36, 67, 64, 8)['form'] == 'scratch'
    big = b1.launch_plan(216, 60, 900, 8)
    assert big['form'] == 'scratch' and big['stride'] == 181
    assert big['smem'] == 7200
    assert big['slot_bytes'] == (216 * 181 + 180 + 54) * 8
    assert big['scratch_warps'] * big['slot_bytes'] <= b1.SCRATCH_BYTES
    # past 2,048 pairs the list stays in device memory
    assert b1.launch_plan(216, 100, 2500, 8)['smem'] == 0
    for itemsize in (8, 4):
        wide = b1.launch_plan(36, 5000, 40, itemsize, M=2)
        assert wide['form'] == 'scratch' and wide['smem'] == 320
        assert 4 * (3 * 5000 + 36) * itemsize > b1.SMEM_OPTIN_BYTES
        assert wide['scratch_warps'] * wide['slot_bytes'] <= \
            b1.SCRATCH_BYTES
        with pytest.raises(ValueError):
            b1.launch_plan(36, 5000, 40, itemsize, form='smem', M=2)
    deep = b1.launch_plan(5329, 6, 9, 8)
    assert deep['form'] == 'scratch' and deep['scratch_warps'] >= 1
    assert b1.launch_plan(36, 11, 30, 8, form='scratch')['form'] == 'scratch'
    with pytest.raises(ValueError):
        b1.launch_plan(216, 60, 900, 8, form='smem')
    assert b1.row_launch_plan(36, 11, 30, 8) == {
        'smem_poses': True, 'smem': 4 * 36 * 11 * 3 * 8, 'warp_clash': False}
    assert b1.row_launch_plan(36, 67, 64, 8)['smem_poses']
    assert not b1.row_launch_plan(36, 68, 64, 8)['smem_poses']
    assert b1.row_launch_plan(216, 11, 30, 8)['smem_poses']
    assert b1.row_launch_plan(216, 12, 30, 8) == {
        'smem_poses': False, 'smem': 0, 'warp_clash': False}
    assert b1.row_launch_plan(216, 22, 30, 4)['smem_poses']
    assert b1.row_launch_plan(27, 15, 75, 8)['warp_clash']


# --------------------------------------------- (d) a CUDA tensor's route


class OnCard(torch.Tensor):
    '''A CPU tensor that says it lies on the card: the routing tests'
    stand-in for a CUDA tensor.'''

    @property
    def is_cuda(self):
        return True


def test_cuda_tensor_raises_without_a_card_and_never_reaches_the_twin(
        da4, monkeypatch):
    '''block_screen, screen_chunk and the kernel module's entry given a
    grid that says it lies on the card raise (no card here), and neither
    the twin nor its parts run.'''
    te, blk, (coords, confs, pairs), _, _ = da4
    reached = []
    for name in ('block_screen_plain', 'block_poses', 'angular_dedup'):
        monkeypatch.setattr(tc, name,
                            lambda *a, _n=name, **k: reached.append(_n))
    _, grid, _, rows = tc.sweep_inputs(
        blk, te.objects, te.systematic_angles, CPU, torch.float64)
    grid = grid.as_subclass(OnCard)
    assert grid.is_cuda
    geo = rows(0, 8)[1:]
    with pytest.raises(ValueError, match='CUDA'):
        tc.block_screen(coords, [c[:8] for c in confs], geo, grid, pairs,
                        1.5)
    with pytest.raises(ValueError, match='CUDA'):
        tc.screen_chunk((coords, grid, pairs, rows), 0, 8, 1.5,
                        lambda: 0.0)
    with pytest.raises(ValueError, match='CUDA'):
        b1.block_screen(coords, [c[:8] for c in confs],
                        tc.block_geometry(*geo), b1.half_angles(grid), pairs,
                        1.5, (tc.DEDUP_RMSD, tc.DEDUP_MAXDEV))
    assert reached == []


# ------------------------------------------------------- (e) the mesh


def test_sweep_on_a_four_device_cpu_mesh_equals_the_unsharded(da4):
    '''screen_survivors on make_mesh(devices=['cpu'] * 4) (4,608
    candidates, over the mesh gate) against the unsharded sweep: the
    same survivors and keep mask; the split says the plain form ran.'''
    te, blk, _, _, _ = da4
    kw = dict(device='cpu', dtype=torch.float64, block_chunk=40)
    split, split4 = {}, {}
    surv, keep = tc.screen_survivors(blk, te.objects, te.systematic_angles,
                                     1.5, split=split, **kw)
    surv4, keep4 = tc.screen_survivors(
        blk, te.objects, te.systematic_angles, 1.5, split=split4,
        mesh=make_mesh(devices=['cpu'] * 4), **kw)
    assert split4['shards'] == 4 and split['shards'] == 1
    assert split['sweep_kernel'] == split4['sweep_kernel'] == 'plain'
    np.testing.assert_array_equal(keep4, keep)
    assert surv.shape == surv4.shape == (47, 11, 3)
    np.testing.assert_allclose(to_np(surv4), to_np(surv), rtol=0, atol=0)
    assert split['dedup_s'] > 0.0

