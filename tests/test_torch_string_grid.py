'''The string grid G1's plain twins on the CPU, float64: embeds/string.
grid_screen's CPU path and ops/kernels/string_grid.string_grid_order_plain
(the kernel's order of operations) against the JAX package's jitted
_string_sweep_bcast in its XLA form (pallas_pairs=None), on bench_suite's
sn2_string molecules and the headline's workload at 4 conformers and 36
angles: the whole grid, c2 tiles, a tail tile and the headline's
heavy-atom form; the bounded write into a pool at an offset against
bench._pipeline_fused's compaction; the launch plan and the routing.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_suite
from tscode_tpu.embeds.string import _string_sweep_bcast
from tscode_tpu.graphs import get_quadruplets, get_sum_graph
from tscode_tpu.molecule import Molecule
from tscode_tpu_torch import pipeline as tp
from tscode_tpu_torch.embeds import string as ts
from tscode_tpu_torch.embeds.common import inputs_from_numpy
from tscode_tpu_torch.ops.kernels import string_grid as g1
from torch_parity import to_np

N_CONFS = 4
N_ANGLES = 36
ATOL = 1e-12


@pytest.fixture(scope='module')
def sn2_mols(tmp_path_factory):
    d = tmp_path_factory.mktemp('sn2_grid')
    n_confs = bench_suite.N_CONFS
    bench_suite.N_CONFS = N_CONFS
    try:
        bench_suite._config_files('sn2_string', str(d))
    finally:
        bench_suite.N_CONFS = n_confs
    mols = []
    for name in ('m1.xyz', 'm2.xyz'):
        mol = Molecule(str(d / name), reactive_indices=[0])
        mol.compute_orbitals()
        mols.append(mol)
    return mols


@pytest.fixture(scope='module')
def workloads(sn2_mols):
    return {'sn2': sn2_mols, 'headline': tp.build_workload(n_confs=N_CONFS)}


def jax_sweep(mols, c2_lo, c2_hi):
    '''_string_sweep_bcast, XLA form, on the rows of c2 values [c2_lo,
    c2_hi) as one tile: (poses, ok) as numpy.'''
    from tscode_tpu.embeds.common import stacked_lobes
    from tscode_tpu.ops.clash import cross_fragment_pair_mask
    m1, m2 = mols
    c1, v1 = stacked_lobes(m1)
    c2, v2 = stacked_lobes(m2)
    r1 = int(m1.reactive_indices[0])
    r2 = int(m2.reactive_indices[0]) + m1.n_atoms
    quads = get_quadruplets(get_sum_graph((m1.graph, m2.graph), [[r1, r2]]))
    angles = np.linspace(0.0, 360.0 - 360.0 / N_ANGLES, N_ANGLES)
    poses, ok, _ = _string_sweep_bcast(
        jnp.asarray(m1.atomcoords), jnp.asarray(m2.atomcoords),
        jnp.asarray(c1), jnp.asarray(v1), jnp.asarray(c2), jnp.asarray(v2),
        jnp.asarray(cross_fragment_pair_mask((m1.n_atoms, m2.n_atoms))),
        jnp.asarray(quads, dtype=jnp.int32), jnp.asarray(angles),
        jnp.asarray(1.5), jnp.asarray(c2_lo, jnp.int32),
        jnp.asarray(m2.n_confs, jnp.int32), n_tiles=1,
        c2_per_tile=c2_hi - c2_lo, pallas_pairs=None)
    return np.asarray(poses), np.asarray(ok)


def port_inputs(mols):
    inp = inputs_from_numpy(*mols, 'cpu', torch.float64)
    return inp, ts.spin_angles(N_ANGLES, torch.float64, 'cpu')


# (workload, c2_lo, c2_hi, heavy): the whole grid, a tile of 3 c2 values,
# the tail tile, the headline's heavy-atom form
CASES = [('sn2', 0, 4, False), ('sn2', 0, 3, False), ('sn2', 3, 4, False),
         ('headline', 0, 4, False), ('headline', 0, 4, True),
         ('headline', 1, 3, True)]


@pytest.mark.parametrize('name,c2_lo,c2_hi,heavy', CASES)
def test_grid_screen_and_order_twin_match_jax_sweep(workloads, name, c2_lo,
                                                    c2_hi, heavy):
    '''The same ok mask as the JAX sweep, and the same survivors (all
    atoms or the heavy ones) within 1e-12 A, from grid_screen's CPU path
    and from the kernel-order twin.'''
    mols = workloads[name]
    poses_j, ok_j = jax_sweep(mols, c2_lo, c2_hi)
    inp, angles = port_inputs(mols)
    want = poses_j[ok_j]
    if heavy:
        want = want[:, to_np(inp.heavy_idx)]
    B = c2_hi - c2_lo
    assert ok_j.shape == (B * inp.n_poses_per_c2 * N_ANGLES,)
    assert 0 < ok_j.sum() < ok_j.size
    for fn in (ts.grid_screen, g1.string_grid_order_plain):
        kept, ok = fn(inp, angles, c2_lo, c2_hi, 1.5, heavy=heavy)
        np.testing.assert_array_equal(to_np(ok), ok_j)
        assert kept.shape == want.shape and kept.dtype == torch.float64
        np.testing.assert_allclose(to_np(kept), want, rtol=0, atol=ATOL)


def test_order_twin_follows_the_broadcast_block(workloads):
    '''The kernel-order poses against bcast_poses' matmul form (1e-12 A)
    and the kernel-order clash test against K1's plain twin (the same
    mask: no pair of these grids lies within rounding of thr^2).'''
    inp, angles = port_inputs(workloads['sn2'])
    align, spin = g1.grid_tables(inp, angles, 0, N_CONFS)
    assert align.shape == (N_CONFS, N_CONFS, inp.centers2.shape[1],
                           inp.centers1.shape[1], 3, 3)
    assert spin.shape == (N_CONFS, inp.centers1.shape[1], N_ANGLES, 3, 3)
    poses = g1.order_poses(inp, align, spin, 0, N_CONFS)
    plain = ts.bcast_poses(inp, angles, 0, N_CONFS)
    torch.testing.assert_close(poses, plain, rtol=0, atol=ATOL)
    ok, want = ts.bcast_block(inp, angles, 0, N_CONFS, 1.5)
    assert torch.equal(g1.order_clash_ok(poses, inp.pairs, 1.5), want)


def jax_compaction(mols, s_pool):
    '''bench._pipeline_fused's compaction of the whole grid: the heavy
    atoms of jnp.nonzero(ok, size=s_pool, fill_value=B)'s rows, alive,
    n_ok.'''
    from test_torch_pipeline import jax_args
    poses, ok = bench._embed_clash_all(*jax_args(mols),
                                       n_angles=bench.N_ANGLES)
    B = poses.shape[0]
    idx = jnp.nonzero(ok, size=s_pool, fill_value=B)[0]
    heavy = np.flatnonzero(np.concatenate([m.atomnos for m in mols]) != 1)
    hs = poses[:, heavy][jnp.clip(idx, 0, B - 1)]
    return np.asarray(hs), np.asarray(idx < B), int(jnp.sum(ok))


@pytest.mark.parametrize('s_pool,base', [(2048, 0), (512, 0), (2048, 7),
                                         (300, 5)])
def test_bounded_write_matches_pipeline_fused_compaction(monkeypatch, s_pool,
                                                         base):
    '''string_grid_into's twin writes the survivors' heavy atoms from row
    `base` of the pool, drops the rows past it and counts them all:
    equal to the JAX compaction's rows (1e-12 A); the CPU form of
    clash_survivors_bounded (base 0) gives the same rows, alive and
    count.'''
    monkeypatch.setattr(bench, 'N_CONFS', N_CONFS)
    mols_j = bench.build_workload()
    mols = tp.build_workload(n_confs=N_CONFS)
    inp, angles = port_inputs(mols)
    hs_j, alive_j, n_j = jax_compaction(mols_j, s_pool)
    pool = torch.zeros((s_pool, inp.heavy_idx.numel(), 3),
                       dtype=torch.float64)
    ok, n_ok = g1.string_grid_into_plain(
        inp, angles, 0, N_CONFS, 1.5, pool, torch.tensor([base]))
    assert int(n_ok) == base + n_j and int(ok.sum()) == n_j
    n_in = min(n_j, s_pool - base)
    np.testing.assert_allclose(to_np(pool[base:base + n_in]), hs_j[:n_in],
                               rtol=0, atol=ATOL)
    assert not pool[:base].any() and not pool[base + n_in:].any()
    if base == 0:
        ok_b, hs_b, alive_b, n_b = tp.clash_survivors_bounded(
            inp, s_pool, angles)
        assert torch.equal(ok_b, ok)
        torch.testing.assert_close(hs_b, pool, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(to_np(alive_b), alive_j)
        assert int(n_b) == n_j


def test_launch_plan_follows_k1s_switch():
    '''The thread regime below 64 pairs (the headline: 96 threads for its
    72 rows a group), the warp regime from 64 (large_n_string: 8 warps,
    the pair list staged), the list left in device memory when it does
    not fit beside one warp's pose.'''
    p = g1.plan_for(6, 5, 30, 72, 8)
    assert p == {'regime': 'thread', 'threads': 96, 'stage_pairs': True,
                 'smem': 128 + (11 + 5 * 96) * 24}
    p = g1.plan_for(74, 74, 5476, 36, 8)
    assert (p['regime'], p['threads'], p['stage_pairs']) == ('warp', 256,
                                                             True)
    assert p['smem'] == 21904 + 8 * 3552
    p = g1.plan_for(3000, 3000, 60000, 36, 8)
    assert p['regime'] == 'warp' and not p['stage_pairs']
    assert p['smem'] <= g1.SMEM_OPTIN_BYTES
    assert g1.plan_for(6, 5, 30, 500, 4)['threads'] == 128


def test_packed_pairs_hold_both_indices():
    pairs = torch.tensor([[0, 6], [5, 10], [300, 65535]], dtype=torch.int32)
    got = g1.packed_pairs(pairs).numpy().view(np.uint32)
    assert (got >> 16).tolist() == [0, 5, 300]
    assert (got & 0xffff).tolist() == [6, 10, 65535]


class OnCard(torch.Tensor):
    '''A CPU tensor that says it lies on the card: the routing tests'
    stand-in for a CUDA tensor.'''

    @property
    def is_cuda(self):
        return True


def test_card_tensors_reach_the_kernel_and_never_the_twin(workloads,
                                                          monkeypatch):
    '''grid_screen, clash_survivors and clash_survivors_bounded given
    grid inputs that say they lie on the card go to G1's module, which
    raises here (no card), and the plain twins never run.'''
    inp, angles = port_inputs(workloads['headline'])
    reached = []
    for name in ('string_grid_plain', 'bcast_poses', 'bcast_block'):
        for mod in (g1, ts, tp):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                                    reached.append(_n))
    inp.coords1 = inp.coords1.as_subclass(OnCard)
    assert inp.coords1.is_cuda
    with pytest.raises(ValueError, match='CUDA'):
        ts.grid_screen(inp, angles, 0, N_CONFS, 1.5)
    with pytest.raises(ValueError, match='CUDA'):
        tp.clash_survivors(inp, angles)
    with pytest.raises(ValueError, match='CUDA'):
        tp.clash_survivors_bounded(inp, 64, angles)
    assert reached == []
