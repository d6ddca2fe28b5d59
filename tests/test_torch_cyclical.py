'''The rigid bimolecular cyclical route on the CPU, float64: the port
(tscode_tpu_torch) against the JAX package, module by module (linalg,
pair gates, block construction, one block-screen chunk, the greedy dedup,
the embed) and through the CLI, on bench_suite's da_cyclical input at 4
conformers (4,608 candidates -> 47 embedded -> 44 final).'''

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.embeds import cyclical as jc
from tscode_tpu.io_xyz import read_xyz
from tscode_tpu.ops import clash as jclash
from tscode_tpu.ops import linalg as jl
from tscode_tpu.ops import rmsd_prune as jr
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.embeds import cyclical as tc
from tscode_tpu_torch.errors import TriangleError
from tscode_tpu_torch.ops import linalg as tl
from tscode_tpu_torch.ops import rmsd_prune as tr
from tscode_tpu_torch.suite_inputs import config_files
from torch_parity import t64, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS_4 = (4608, 47, 44)    # candidates, embedded, final: JAX x64
BLOCKS_4 = 128


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
    '''da_cyclical at 4 conformers, set up by both packages:
    (input path, JAX Embedder, port Embedder).'''
    d = tmp_path_factory.mktemp('da4')
    path = config_files('da_cyclical', str(d), 4)
    return (path, set_up(JaxEmbedder, path),
            set_up(Embedder, path, device='cpu'))


# ---------------------------------------------------------------- linalg


def test_align_vec_pair_and_kabsch_match_jax():
    '''atol 1e-12 on the rotations, with and without the Gram seeds.'''
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(64, 2, 2, 3))
    tgt = rng.normal(size=(64, 2, 2, 3))
    np.testing.assert_allclose(
        to_np(tl.align_vec_pair(t64(ref), t64(tgt))),
        np.asarray(jl.align_vec_pair(jnp.asarray(ref), jnp.asarray(tgt))),
        rtol=0, atol=1e-12)
    S = rng.normal(size=(50, 3, 3))
    GA, GB = rng.uniform(5, 9, 50), rng.uniform(5, 9, 50)
    for args in ((S,), (S, GA, GB)):
        got = tl.kabsch_rotation_from_correlation(*map(t64, args))
        want = jl.kabsch_rotation_from_correlation(*map(jnp.asarray, args))
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                                   atol=1e-12)
    R = to_np(tl.align_vec_pair(t64(ref), t64(tgt)))
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)


@pytest.mark.parametrize('lengths', [[1.3, 2.7], [2.0, 2.0], [3.0, 4.0, 5.0],
                                     [2.2, 2.3, 2.9]])
def test_polygonize_exact(lengths):
    np.testing.assert_array_equal(tl.polygonize(lengths),
                                  jl.polygonize(lengths))


def test_polygonize_triangle_error_and_digons():
    with pytest.raises(TriangleError):
        tl.polygonize([1.0, 1.0, 3.0])
    L = np.random.default_rng(1).uniform(1, 4, size=(7, 2))
    got = to_np(tl.polygonize_digons(t64(L)))
    np.testing.assert_array_equal(got,
                                  np.asarray(jl.polygonize_digons(L)))
    np.testing.assert_array_equal(got[3], tl.polygonize(L[3]))


# ------------------------------------------------------------ pair gates


def test_pair_gate_matrices_match_jax():
    '''rmsd and maxdev within 1e-9 A off the diagonal, the dedup's gate
    bits equal, on seeded blocks with near-copies (rmsds on both sides
    of 1 A). A pose against itself is 0 up to rounding under the square
    root (msd ~1e-15 A^2 gives rmsd ~5e-8 A in either package), so the
    diagonal is held below 1e-6 A in both.'''
    rng = np.random.default_rng(2)
    base = rng.normal(size=(6, 1, 11, 3)) * 1.8
    P = base + rng.normal(size=(6, 20, 11, 3)) * \
        rng.choice([0.05, 0.3, 0.6, 1.2], size=(6, 20, 1, 1))
    rmsd, maxdev = tr.pair_gate_matrices(t64(P), 11)
    off = ~np.eye(20, dtype=bool)
    for b in range(len(P)):
        r_j, m_j = jr._pair_gate_matrices(jnp.asarray(P[b]), 11)
        for got, want in ((to_np(rmsd[b]), np.asarray(r_j)),
                          (to_np(maxdev[b]), np.asarray(m_j))):
            np.testing.assert_allclose(got[off], want[off], rtol=0,
                                       atol=1e-9)
            assert np.abs(np.diag(got)).max() < 1e-6
            assert np.abs(np.diag(want)).max() < 1e-6
        gate_t = (to_np(rmsd[b]) < 1.0) & (to_np(maxdev[b]) < 2.0)
        gate_j = (np.asarray(r_j) < 1.0) & (np.asarray(m_j) < 2.0)
        np.testing.assert_array_equal(gate_t, gate_j)
    gate = (to_np(rmsd) < 1.0) & (to_np(maxdev) < 2.0)
    assert 0.05 < gate.mean() < 0.95


def test_rmsd_matrix_and_maxdev_pairs_match_jax():
    rng = np.random.default_rng(3)
    P = rng.normal(size=(9, 7, 3))
    Q = P[rng.integers(0, 9, 12)] + rng.normal(size=(12, 7, 3)) * 0.3
    np.testing.assert_allclose(
        to_np(tr.rmsd_matrix_lambda_only(t64(P), t64(Q), 7)),
        np.asarray(jr._rmsd_matrix_lambda_only(jnp.asarray(P),
                                               jnp.asarray(Q), 7)),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        to_np(tr.maxdev_pairs(t64(P[:9]), t64(Q[:9]))),
        np.asarray(jr._maxdev_pairs(jnp.asarray(P[:9]), jnp.asarray(Q[:9]))),
        rtol=0, atol=1e-9)


# --------------------------------------------------------------- set-up


def test_cyclical_setup_matches_jax(da4):
    _, je, te = da4
    assert te.embed == je.embed == 'cyclical'
    np.testing.assert_array_equal(te.systematic_angles, je.systematic_angles)
    assert te.systematic_angles.shape == (36, 2)
    assert te.candidates == je.candidates == COUNTS_4[0]
    for mt, mj in zip(te.objects, je.objects):
        assert [len(p) for p in mt.pivots] == [len(p) for p in mj.pivots]
    off = te.objects[0].n_atoms
    for ids, want in (([[0, off + 0], [3, off + 4]], True),
                      ([[0, off + 4], [3, off + 0]], False)):
        assert te.pairing_ok_fn()(ids) is je.pairing_ok_fn()(ids) is want


# ---------------------------------------------------------------- blocks


def test_block_construction_matches_jax(da4):
    '''The fast form and the scalar loop equal the JAX fast form,
    ids and the compact tables included.'''
    _, je, te = da4
    want = jc._bimol_rigid_blocks_fast(*je.objects, 5, je.pairing_ok_fn())
    fast = tc.bimol_rigid_blocks_fast(*te.objects, 5, te.pairing_ok_fn())
    loop = tc.bimol_rigid_blocks_loop(*te.objects, 5, te.pairing_ok_fn())
    assert set(fast) == set(want) and len(want['c1']) == BLOCKS_4
    for k in want:
        np.testing.assert_array_equal(fast[k], want[k], err_msg=k)
        if k not in ('tab1', 'tab2', 'tidx'):
            np.testing.assert_array_equal(loop[k], want[k], err_msg=k)
    assert tc.bimol_rigid_blocks_fast(*te.objects, -1, None) is None


def test_one_block_screen_chunk_matches_jax(da4):
    '''Geometry, poses, clash screen, gates and dedup of 64 block rows:
    poses within 1e-9 A, keep bits equal.'''
    _, je, te = da4
    blk = tc.bimol_rigid_blocks(*te.objects, 5, te.pairing_ok_fn())
    m1, m2 = te.objects
    ti = blk['tidx'][:64]
    angles = np.asarray(te.systematic_angles, dtype=float)
    pm = jclash.cross_fragment_pair_mask((m1.n_atoms, m2.n_atoms))
    poses_j, keep_j = jc._block_screen_mapped_compact(
        jnp.asarray(m1.atomcoords), jnp.asarray(m2.atomcoords),
        jnp.asarray(blk['tab1']), jnp.asarray(blk['tab2']), jnp.asarray(ti),
        jnp.asarray(angles), jnp.asarray(pm), jnp.asarray(1.5), n_chunks=1)
    coords, grid, pairs, _ = tc.sweep_inputs(
        blk, (m1, m2), angles, torch.device('cpu'), torch.float64)
    confs, *geo = tc.compact_rows(t64(blk['tab1']), t64(blk['tab2']),
                                  torch.as_tensor(ti).long())
    poses_t, keep_t = tc.block_screen(coords, confs, geo, grid, pairs, 1.5)
    np.testing.assert_allclose(to_np(poses_t), np.asarray(poses_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(to_np(keep_t), np.asarray(keep_j))
    assert 0 < to_np(keep_t).sum() < keep_t.numel()


@pytest.mark.parametrize('seed', [0, 1])
def test_greedy_keep_device_matches_the_oracles(seed):
    rng = np.random.default_rng(seed)
    ok = rng.random((40, 36)) < 0.7
    sim = rng.random((40, 36, 36)) < 0.15
    sim = sim | sim.transpose(0, 2, 1)
    got = to_np(tc.greedy_keep_device(torch.as_tensor(ok),
                                      torch.as_tensor(sim)))
    np.testing.assert_array_equal(got, tc.greedy_angular_keep(ok, sim))
    np.testing.assert_array_equal(got, jc._greedy_angular_keep(ok, sim))
    np.testing.assert_array_equal(
        got, np.asarray(jc._greedy_keep_device(jnp.asarray(ok),
                                               jnp.asarray(sim))))
    assert 0 < got.sum() < ok.sum()


def test_auto_chunk_bounds_the_gate_intermediate():
    rows = tc._auto_chunk(46128, 36, 11, 8)
    assert rows * 36 * 36 * 11 * 3 * 8 <= tc.GATE_BYTES
    assert (rows + 1) * 36 * 36 * 11 * 3 * 8 > tc.GATE_BYTES
    assert tc._auto_chunk(10, 36, 11, 8) == 10
    assert tc._auto_chunk(10, 216, 10 ** 5, 8) == 1


# ----------------------------------------------------------------- embed


def test_cyclical_embed_matches_jax(da4):
    '''47 survivors, poses within 1e-6 A, identical constraint ids; the
    chunked sweep (3 chunks) and the expanded block form (the scalar
    loop's fields) give the same.'''
    _, je, te = da4
    kw = dict(clash_thresh=1.5, max_norm_delta=5, log=lambda *a: None)
    want_p, want_c = jc.cyclical_embed_bimol_rigid(
        *je.objects, je.systematic_angles,
        pairing_ok=je.pairing_ok_fn(), **kw)
    info = {}
    got_p, got_c = tc.cyclical_embed_bimol_rigid(
        *te.objects, te.systematic_angles, pairing_ok=te.pairing_ok_fn(),
        block_chunk=50, device='cpu', info=info, **kw)
    assert got_p.shape == (COUNTS_4[1], 11, 3) == want_p.shape
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_c, want_c)
    assert (info['candidates'], info['blocks'], info['survivors'],
            info['chunks']) == (COUNTS_4[0], BLOCKS_4, COUNTS_4[1], 3)

    blk = tc.bimol_rigid_blocks_loop(*te.objects, 5, te.pairing_ok_fn())
    surv, keep = tc.screen_survivors(
        blk, te.objects, te.systematic_angles, 1.5, device='cpu',
        dtype=torch.float64, block_chunk=100)
    np.testing.assert_allclose(to_np(surv), got_p, rtol=0, atol=1e-12)
    assert keep.shape == (BLOCKS_4, 36)


def test_cli_da_cyclical_matches_jax(da4, tmp_path):
    '''python -m tscode_tpu_torch input.txt --device cpu: 4,608 -> 47 ->
    44, the embedded and final frames within 1e-6 A of the JAX run's,
    and the sweep's split in the run report.'''
    path, _, _ = da4
    d = os.path.dirname(path)
    cwd = os.getcwd()
    try:
        JaxEmbedder(path, stamp='jax').run()
    finally:
        os.chdir(cwd)
    env = dict(os.environ, PYTHONPATH=REPO, TSCODE_EMBED_TRACE='1')
    r = subprocess.run([sys.executable, '-m', 'tscode_tpu_torch',
                        'input.txt', '--device', 'cpu', '-n', 'cli'],
                       cwd=d, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '[cyc trace] blocks' in r.stderr
    for tag, n in (('embedded', COUNTS_4[1]), ('unoptimized', COUNTS_4[2])):
        got = read_xyz(os.path.join(d, f'tscode_{tag}_cli.xyz')).atomcoords
        want = read_xyz(os.path.join(d, f'tscode_{tag}_jax.xyz')).atomcoords
        assert got.shape == want.shape == (n, 11, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with open(os.path.join(d, 'tscode_report_cli.json')) as f:
        rep = json.load(f)
    ce = rep['cyclical_embed']
    assert (ce['candidates'], ce['survivors']) == COUNTS_4[:2]
    assert all(k in ce for k in ('blocks_s', 'screen_s', 'dedup_s',
                                 'assemble_s'))
    assert [s['stage'] for s in rep['similarity']] == ['moi']
    assert rep['final_structures'] == COUNTS_4[2]
