'''Card-only tests of the port: the CUDA kernels against their plain
PyTorch twins on the GPU, and the small slice on the card against the
CPU run. They skip without a GPU. This file imports no jax, so it runs
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
'''

import numpy as np
import pytest
import torch

from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
from tscode_tpu_torch.ops.kernels import clash, qcp
from tscode_tpu_torch.ops.linalg import rmsd_and_max
from tscode_tpu_torch.ops.rmsd_prune import (pass_chunks,
                                             prune_conformers_rmsd_device)
from tscode_tpu_torch.pipeline import build_workload, run_pipeline
from torch_parity import cuda_device, near_dup_blocks, near_dup_pool  # noqa: F401

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize('dtype', DTYPES)
def test_clash_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(11)
    pm = cross_fragment_pair_mask((6, 5))
    pairs = torch.as_tensor(clash.static_pairs(pm), device=cuda_device)
    poses = torch.as_tensor(rng.normal(size=(4099, 11, 3)) * 2.2,
                            dtype=dtype, device=cuda_device)
    P = poses.double()
    pl = pairs.long()
    d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
    keep = ~((d2 - 2.25).abs() < 1e-4).any(dim=1)     # no threshold ties
    before = clash.KERNEL.launches
    for mc in (0, 3):
        want = clash.clash_ok_plain(poses, pairs, 1.5, mc)
        got1 = clash.clash_ok(poses, pairs, 1.5, mc)
        got2 = clash.compenetration_mask_kernel(poses, pm, 1.5, mc)
        assert torch.equal(got1[keep], want[keep])
        assert torch.equal(got2[keep], want[keep])
    assert clash.KERNEL.launches == before + 4


def big_fragment_poses(rng, n_poses, n_atoms):
    '''Poses of two n_atoms-atom fragments, gaussian blobs (sigma 2 A)
    whose centers lie 5 to 16 A apart: from hundreds of cross clashes per
    pose down to none.'''
    f1 = rng.normal(size=(n_poses, n_atoms, 3)) * 2.0
    f2 = rng.normal(size=(n_poses, n_atoms, 3)) * 2.0
    f2[..., 0] += rng.uniform(5.0, 16.0, size=(n_poses, 1))
    return np.concatenate([f1, f2], axis=1)


@pytest.mark.parametrize('dtype', DTYPES)
def test_clash_kernel_any_size(cuda_device, dtype):
    '''Two 160-atom fragments: P = 25,600 pairs and N = 320 atoms, more
    than one block's shared memory holds. Before the kernel tiled its
    pair list, this launch failed.'''
    pm = cross_fragment_pair_mask((160, 160))
    pairs = torch.as_tensor(clash.static_pairs(pm), device=cuda_device)
    poses = torch.as_tensor(
        big_fragment_poses(np.random.default_rng(160), 2048, 160),
        dtype=dtype, device=cuda_device)
    P = poses.double()
    pl = pairs.long()
    d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
    keep = ~((d2 - 2.25).abs() < 1e-4).any(dim=1)     # no threshold ties
    counts = torch.sum(d2 < 2.25, dim=1)
    for mc in (0, 3, 100):
        want = torch.cat([clash.clash_ok_plain(poses[i:i + 256], pairs, 1.5,
                                               mc)
                          for i in range(0, poses.shape[0], 256)])
        got = clash.clash_ok(poses, pairs, 1.5, mc)
        assert torch.equal(got[keep], want[keep])
        assert 0 < int(want.sum()) < poses.shape[0]
        assert torch.equal(want[keep], (counts <= mc)[keep])


def triangle_pairs(n_atoms):
    '''Every pair i < j of one molecule: a pair list that is not a
    rectangle of two fragments.'''
    i, j = np.triu_indices(n_atoms, k=1)
    return np.stack([i, j], axis=1).astype(np.int32)


WARP_CASES = {
    # ragged B, P = 1,073 (not a multiple of 32)
    'ragged': (1000, lambda: clash.static_pairs(
        cross_fragment_pair_mask((37, 29))), 66),
    # 62,500 pairs: more than the shared memory holds, the tiled path
    'tiled': (300, lambda: clash.static_pairs(
        cross_fragment_pair_mask((250, 250))), 500),
    # 13 atoms: 156 B (f32) and 312 B (f64) poses, not multiples of 16
    'odd_pose_bytes': (2051, lambda: triangle_pairs(13), 13),
}


@pytest.mark.parametrize('case', sorted(WARP_CASES))
@pytest.mark.parametrize('dtype', DTYPES)
def test_clash_warp_regime_matches_plain(cuda_device, dtype, case):
    '''The warp-per-pose kernel against the plain twin away from
    threshold ties, for max_clashes 0, 3 and 100.'''
    B, make_pairs, N = WARP_CASES[case]
    pairs_np = make_pairs()
    assert clash.clash_regime(len(pairs_np), N, dtype.itemsize) == 'warp'
    rng = np.random.default_rng(B + N)
    x = rng.normal(size=(B, N, 3)) * 2.0
    x[:, N // 2:, 0] += rng.uniform(3.0, 12.0, size=(B, 1))
    poses = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    pairs = torch.as_tensor(pairs_np, device=cuda_device)
    P = poses.double()
    pl = pairs.long()
    d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
    keep = ~((d2 - 2.25).abs() < 1e-4).any(dim=1)     # no threshold ties
    counts = torch.sum(d2 < 2.25, dim=1)
    clash.KERNEL.reset_counts()
    for mc in (0, 3, 100):
        want = torch.cat([clash.clash_ok_plain(poses[i:i + 128], pairs, 1.5,
                                               mc)
                          for i in range(0, B, 128)])
        got = clash.clash_ok(poses, pairs, 1.5, mc)
        assert torch.equal(got[keep], want[keep])
        assert torch.equal(want[keep], (counts <= mc)[keep])
        if mc == 0:
            assert 0 < int(want.sum()) < B
    assert clash.launches_by_regime() == {'thread': 0, 'warp': 3}
    plan = clash.warp_plan()
    assert (plan['tile'] < len(pairs_np)) == (case == 'tiled')
    if case == 'odd_pose_bytes':
        assert plan['granule'] == (4 if dtype == torch.float32 else 8)


@pytest.mark.parametrize('dtype', DTYPES)
def test_qcp_kernel_planted_and_random_blocks(cuda_device, dtype):
    rng = np.random.default_rng(3)
    blocks = rng.normal(size=(4, 32, 8, 3)) * 2
    blocks[0, 10] = blocks[0, 3] + 1e-3
    blocks[2, 20] = blocks[2, 5] + 1e-3
    blocks[2, 25] = blocks[2, 5] + 2e-3
    got = qcp.qcp_kill_blocks(
        torch.as_tensor(blocks, dtype=dtype, device=cuda_device),
        torch.as_tensor([32, 20, 32, 5], device=cuda_device), 0.5)
    assert int(got.sum()) == 3

    if dtype == torch.float64:        # exact away from f32 ties
        for N in (4, 8):
            P, m_real = near_dup_blocks(np.random.default_rng(N), 64, 64, N)
            P = torch.as_tensor(P, dtype=dtype, device=cuda_device)
            m_real = torch.as_tensor(m_real, device=cuda_device)
            got = qcp.qcp_kill_blocks(P, m_real, 0.5).reshape(-1)
            act, end = qcp.blocks_as_pass(m_real, 64)
            want = qcp.qcp_kill_plain(P.reshape(-1, N, 3), act, end, 0.5)
            assert torch.equal(got, want) and 0 < int(got.sum()) < 4096


QCP_TIE = {torch.float32: 1e-4, torch.float64: 1e-9}   # A


def qcp_pass_case(case, N, dev):
    '''(hs float64 (n, N, 3), act, end) of one pass on the card.'''
    rng = np.random.default_rng(len(case) * 10 + N)
    if case == 'ragged':                  # M = 1,011 active, 13 chunks
        hs = near_dup_pool(rng, 1037, N, 150)
        mask = torch.ones(1037, dtype=torch.bool)
        mask[rng.choice(1037, 26, replace=False)] = False
        act, end = pass_chunks(mask, 1037, 13)
    elif case in ('last_candidate', 'no_hits'):
        hs = rng.normal(size=(600, N, 3)) * 3.0   # far apart
        act = torch.arange(600)
        end = torch.as_tensor(np.repeat([200, 400, 600], 200))
        if case == 'last_candidate':      # first hits at the chunk's end
            for p, q in ((0, 199), (1, 198), (200, 399), (450, 599)):
                hs[q] = hs[p] + rng.normal(size=(N, 3)) * 0.05
    else:                                 # one chunk of 3,000 rows
        hs = near_dup_pool(rng, 3000, N, 1500)
        act = torch.arange(3000)
        end = torch.full((3000,), 3000)
    return (torch.as_tensor(hs, device=dev), act.to(dev), end.to(dev))


def qcp_tie_rows(hs64, act, end, tol):
    '''(M,) bool: positions with a pass pair whose float64 rmsd lies
    within tol of 0.5 or maxdev within tol of 1.0.'''
    p, q = qcp.pass_pairs(end.long(), torch.arange(act.numel(),
                                                   device=act.device))
    rows = torch.zeros(act.numel(), dtype=torch.bool, device=act.device)
    for i in range(0, p.numel(), 1 << 20):
        pi, qi = p[i:i + (1 << 20)], q[i:i + (1 << 20)]
        rmsd, maxdev = rmsd_and_max(hs64[act[pi]], hs64[act[qi]])
        tie = ((rmsd - 0.5).abs() < tol) | ((maxdev - 1.0).abs() < tol)
        rows[pi[tie]] = True
    return rows


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('N', [4, 8])
@pytest.mark.parametrize('case', ['ragged', 'last_candidate', 'no_hits',
                                  'one_chunk_3000'])
def test_qcp_warp_kernel_every_plan_matches_plain(cuda_device, dtype, N,
                                                  case):
    '''Every lanes-per-row plan, phase-1 budget 0 (all in phase 2),
    8 steps and unbounded (all in phase 1), equals the plain twin off
    threshold ties, and the thread-per-row kernel.'''
    hs64, act, end = qcp_pass_case(case, N, cuda_device)
    hs = hs64.to(dtype)
    want = qcp.qcp_kill_plain(hs, act, end, 0.5)
    tie = qcp_tie_rows(hs64, act, end, QCP_TIE[dtype])
    assert torch.equal(qcp.qcp_kill_thread(hs, act, end, 0.5)[~tie],
                       want[~tie])
    plans = [None] + [(lanes, budget) for lanes in range(6)
                      for budget in (0, 8 << lanes, 1 << 30)]
    for plan in plans:
        got = qcp.qcp_kill(hs, act, end, 0.5, plan=plan)
        assert torch.equal(got[~tie], want[~tie]), plan
    n_kill = int(want.sum())
    if case == 'no_hits':
        assert n_kill == 0
    elif case == 'last_candidate':
        assert n_kill == 4 and bool(want[[0, 1, 200, 450]].all())
    else:
        assert 0 < n_kill < act.numel() and int(tie.sum()) < act.numel() // 10


def test_qcp_unaligned_pool_and_bad_plans(cuda_device):
    '''A pool whose base is not 16-byte aligned takes the scalar loads;
    plans outside (0..5, 0..2^30) raise.'''
    hs64, act, end = qcp_pass_case('ragged', 4, cuda_device)
    flat = torch.empty(hs64.numel() + 1, dtype=torch.float32,
                       device=cuda_device)
    hs = flat[1:].view(hs64.shape)
    hs.copy_(hs64)
    assert hs.data_ptr() % 16 != 0 and hs.is_contiguous()
    tie = qcp_tie_rows(hs64, act, end, QCP_TIE[torch.float32])
    want = qcp.qcp_kill_plain(hs, act, end, 0.5)
    assert torch.equal(qcp.qcp_kill(hs, act, end, 0.5)[~tie], want[~tie])
    for plan in ((6, 8), (-1, 8), (0, -1), (0, (1 << 30) + 1)):
        with pytest.raises(ValueError):
            qcp.qcp_kill(hs, act, end, 0.5, plan=plan)


def test_prune_kernel_matches_plain_f64(cuda_device):
    pool = near_dup_pool(np.random.default_rng(8), 2000, 8, 400)
    hs = torch.as_tensor(pool, device=cuda_device)
    keep = prune_conformers_rmsd_device(hs)
    want = prune_conformers_rmsd_device(hs, pair_kill=qcp.qcp_kill_plain)
    np.testing.assert_array_equal(keep, want)


def test_small_slice_on_card_matches_cpu(cuda_device):
    mols = build_workload(n_confs=6)
    before = (clash.KERNEL.launches, qcp.KERNEL.launches)
    gpu = run_pipeline(*mols, device=cuda_device, dtype=torch.float64,
                       return_masks=True)
    assert clash.KERNEL.launches > before[0]
    assert qcp.KERNEL.launches > before[1]
    cpu = run_pipeline(*mols, device='cpu', return_masks=True)
    assert gpu[2:4] == cpu[2:4] == (1362, 6)
    np.testing.assert_array_equal(gpu[4]['clash_ok'], cpu[4]['clash_ok'])
    np.testing.assert_array_equal(gpu[4]['keep'], cpu[4]['keep'])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    poses = torch.zeros((8, 4, 3), dtype=torch.float16, device=cuda_device)
    pairs = np.array([[0, 2]], dtype=np.int32)
    with pytest.raises(TypeError):
        clash.clash_ok(poses, pairs, 1.5)
    strided = torch.zeros((8, 3, 4), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        clash.clash_ok(strided, pairs, 1.5)
    hs = torch.zeros((6, 4, 3), device=cuda_device)
    with pytest.raises(ValueError):
        qcp.qcp_kill(hs, torch.arange(6), torch.arange(5), 0.5)
