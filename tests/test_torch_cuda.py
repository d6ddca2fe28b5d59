'''Card-only tests of the port: the CUDA kernels against their plain
PyTorch twins on the GPU, and the small slice on the card against the
CPU run. They skip without a GPU. This file imports no jax, so it runs
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
'''

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tscode_tpu_torch.embedder import Embedder, RunEmbedding
from tscode_tpu_torch.embeds import cyclical
from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
from tscode_tpu_torch.ops.kernels import clash, qcp, string_grid
from tscode_tpu_torch.ops.kernels import tfd as tfd_k
from tscode_tpu_torch.ops.linalg import rmsd_and_max, rotate_dihedral
from tscode_tpu_torch.ops.rmsd_prune import (pair_gate_matrices,
                                             pass_chunks,
                                             pass_chunks_fixed,
                                             prune_conformers_rmsd,
                                             prune_conformers_rmsd_device)
from tscode_tpu_torch.pipeline import build_workload, run_pipeline
from tscode_tpu_torch.suite_inputs import config_files
from torch_parity import (TFD_ENSEMBLES, TFD_PASS_CASES,  # noqa: F401
                          cuda_device, lazy_keep, near_dup_blocks,
                          near_dup_pool, tfd_pass_fps)

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


@pytest.mark.parametrize('dtype', DTYPES)
def test_device_entry_matches_qcp_kill(cuda_device, dtype):
    '''K3's device-count entry on random passes of M = 1 to 10^5 rows
    (buffers of 10^5 entries, the count on the card): its kill bits are
    qcp_kill's, bit for bit (one kernel), and the killed rows' alive
    bits are cleared; with the gate shut it writes nothing.'''
    n = 100_000
    hs = torch.as_tensor(near_dup_pool(np.random.default_rng(5), n, 4,
                                       30_000), dtype=dtype,
                         device=cuda_device)
    rng = np.random.default_rng(6)
    kills = 0
    for M, k in ((1, 1), (2, 1), (37, 1), (1000, 20), (5000, 200),
                 (33_000, 1000), (70_000, 2), (n, 4000)):
        mask = torch.zeros(n, dtype=torch.bool)
        mask[rng.choice(n, M, replace=False)] = True
        mask = mask.to(cuda_device)
        act, end, m = pass_chunks_fixed(mask, n, k)
        assert int(m) == M
        alive = mask.clone()
        kill = qcp.qcp_kill_dev(hs, act, end, m, k, 0.5, alive)
        want = qcp.qcp_kill(hs, act[:M], end[:M], 0.5)
        assert torch.equal(kill[:M], want), (M, k)
        expect = mask.clone()
        expect[act[:M].long()[want]] = False
        assert torch.equal(alive, expect), (M, k)
        kills += int(want.sum())
        if M >= 40:                            # k = M // 20 shuts the gate
            alive = mask.clone()
            kill = torch.ones(n, dtype=torch.bool, device=cuda_device)
            qcp.qcp_kill_dev(hs, act, end, m, M // 20, 0.5, alive, kill)
            assert torch.equal(alive, mask) and bool(kill.all())
    assert kills > 0


@pytest.mark.parametrize('dtype', DTYPES)
def test_captured_schedule_matches_host_loop(cuda_device, dtype,
                                             monkeypatch):
    '''warmup_prune_kernels captures the schedule of a 10^4-row pool;
    two prunes of it replay the graph (the host loop patched to raise)
    and equal the host loop's mask.'''
    from tscode_tpu_torch.ops import rmsd_prune as tprune
    monkeypatch.setattr(tprune, '_SCHEDULE_WARMED', set())
    hs = torch.as_tensor(near_dup_pool(np.random.default_rng(7), 10_000, 4,
                                       2_500), dtype=dtype, device=cuda_device)
    want = prune_conformers_rmsd_device(hs)
    qcp.KERNEL.reset_counts()
    tprune.warmup_prune_kernels(4, dtype, n_pool=10_000, n_real=10_000,
                                device=cuda_device)
    captured = qcp.KERNEL.launches
    assert captured > 0 and captured == sum(
        v for e, v in qcp.KERNEL.entry_launches.items() if '_dev_' in e)

    def host_loop(*args, **kwargs):
        raise AssertionError('the host loop ran')

    monkeypatch.setattr(tprune, 'host_schedule', host_loop)
    for _ in range(2):
        np.testing.assert_array_equal(prune_conformers_rmsd_device(hs), want)
    assert qcp.KERNEL.launches == captured          # replays, no launch
    assert 0 < want.sum() < 10_000


def test_pipeline_replay_makes_no_host_sync(cuda_device):
    '''The captured slice at 6 conformers, float64: a replay makes no
    host sync (set_sync_debug_mode('error')), and its stats, clash mask
    and keep mask are run_pipeline's and the CPU run's.'''
    from tscode_tpu_torch import pipeline as tp
    mols = build_workload(n_confs=6)
    gpu = run_pipeline(*mols, device=cuda_device, dtype=torch.float64,
                       return_masks=True)
    cpu = run_pipeline(*mols, device='cpu', return_masks=True)
    assert gpu[2:4] == cpu[2:4] == (1362, 6)
    inp = tp.inputs_from_numpy(*mols, cuda_device, torch.float64)
    angles = tp.spin_angles(tp.N_ANGLES, torch.float64, cuda_device)
    s_pool = tp.pool_size(1362)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        ok, keep, stats = tp.pipeline_call(inp, angles, s_pool, 1362)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert stats.tolist() == [6, 1362, 1]
    np.testing.assert_array_equal(ok.cpu().numpy(), cpu[4]['clash_ok'])
    np.testing.assert_array_equal(keep[:1362].cpu().numpy(), cpu[4]['keep'])
    assert not keep[1362:].any()


def test_small_slice_on_card_matches_cpu(cuda_device):
    mols = build_workload(n_confs=6)
    before = (string_grid.KERNEL.launches, qcp.KERNEL.launches,
              clash.KERNEL.launches)
    gpu = run_pipeline(*mols, device=cuda_device, dtype=torch.float64,
                       return_masks=True)
    assert string_grid.KERNEL.launches > before[0]   # the grid: G1
    assert qcp.KERNEL.launches > before[1]
    assert clash.KERNEL.launches == before[2]        # no K1 on the grid
    cpu = run_pipeline(*mols, device='cpu', return_masks=True)
    assert gpu[2:4] == cpu[2:4] == (1362, 6)
    np.testing.assert_array_equal(gpu[4]['clash_ok'], cpu[4]['clash_ok'])
    np.testing.assert_array_equal(gpu[4]['keep'], cpu[4]['keep'])


def test_cyclical_block_screen_with_k1_matches_plain(cuda_device, tmp_path):
    '''da_cyclical at 4 conformers, float64: the block screen of all 128
    block rows on the card with K1 equals the same screen with the plain
    clash twin and the CPU run, poses within 1e-9 A and keep bits equal.'''
    path = config_files('da_cyclical', str(tmp_path), 4)
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            emb = Embedder(path, stamp='card', device=cuda_device,
                           dtype=torch.float64)
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    m1, m2 = emb.objects
    blk = cyclical.bimol_rigid_blocks(m1, m2, 5, emb.pairing_ok_fn())
    out = {}
    for dev in (cuda_device, torch.device('cpu')):
        coords, grid, pairs, rows = cyclical.sweep_inputs(
            blk, (m1, m2), emb.systematic_angles, dev, torch.float64)
        confs, *geo = rows(0, len(blk['c1']))
        geometry = cyclical.block_geometry(*geo)
        for clash_fn in (clash.clash_ok, clash.clash_ok_plain):
            before = clash.KERNEL.launches
            poses, ok = cyclical.block_poses(coords, confs, *geometry, grid,
                                             pairs, 1.5, clash=clash_fn)
            launched = clash.KERNEL.launches - before
            assert launched == int(dev.type == 'cuda' and
                                   clash_fn is clash.clash_ok)
            out[dev.type, clash_fn.__name__] = (
                poses.cpu(), cyclical.angular_dedup(poses, ok).cpu())
    want_poses, want_keep = out['cpu', 'clash_ok_plain']
    for poses, keep in out.values():
        np.testing.assert_allclose(poses.numpy(), want_poses.numpy(), rtol=0,
                                   atol=1e-9)
        assert torch.equal(keep, want_keep)
    assert int(want_keep.sum()) == 47


def card_embedder(path, device, dtype=torch.float64):
    '''The port's Embedder set up on `path`, its log quiet and closed.'''
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            emb = Embedder(path, stamp='card', device=device, dtype=dtype)
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    return emb


def b1_twin(coords, confs, geometry, grid, pairs):
    '''B1's plain twin on the rows' geometry (block_screen_plain's parts:
    block_poses with K1's plain twin, angular_dedup's gate matrices and
    greedy scan), a chunk of rows at a time as the twin's rule cuts it:
    (poses, keep, ok, rmsd and maxdev of each row's pose pairs on the
    CPU).'''
    rows, A = confs[0].shape[0], grid.shape[0]
    N = sum(x.shape[1] for x in coords)
    out = []
    step = cyclical._auto_chunk(rows, A, N, grid.element_size())
    for s in range(0, rows, step):
        sl = slice(s, s + step)
        poses, ok = cyclical.block_poses(
            coords, [c[sl] for c in confs], *(g[sl] for g in geometry), grid,
            pairs, 1.5, clash=clash.clash_ok_plain)
        rmsd, maxdev = pair_gate_matrices(poses, N)
        keep = cyclical.greedy_keep_device(
            ok, (rmsd < cyclical.DEDUP_RMSD) & (maxdev < cyclical.DEDUP_MAXDEV))
        out.append((poses, keep, ok, rmsd.cpu(), maxdev.cpu()))
        del rmsd, maxdev
    return [torch.cat(parts) for parts in zip(*out)]


def b1_against_row_kernel(coords, confs, geometry, grid, pairs, forms=None):
    '''B1 (its screen, then its write) against B1's first design
    (launch_row) on the same card tensors: keep bits equal and the
    survivors the old kernel's poses compacted by its keep mask, bit for
    bit, in either dtype; one screen launch, one write launch when
    anything survives, no K1 launch. With `forms`, B1's screen also runs
    in each of them (launch_plan's keyword arguments: form='smem' or
    'scratch', warp_clash=True for the warp's clash screen), each giving
    the same bits. Returns the old
    kernel's (poses, keep).'''
    from tscode_tpu_torch.ops.kernels import block_screen as b1
    half = b1.half_angles(grid)
    gates = (cyclical.DEDUP_RMSD, cyclical.DEDUP_MAXDEV)
    b1.KERNEL.reset_counts()
    clash.KERNEL.reset_counts()
    surv, keep = b1.block_screen(coords, confs, geometry, half, pairs, 1.5,
                                 gates)
    assert b1.KERNEL.wrapper_launches == {
        'block_screen': 1, **({'block_survivors': 1} if keep.any() else {})}
    assert clash.KERNEL.launches == 0
    rows, A = keep.shape
    N = sum(x.shape[1] for x in coords)
    conf, packed = b1.pack_rows(confs, geometry)
    poses = torch.empty((rows, A, N, 3), dtype=grid.dtype, device=grid.device)
    old_keep = torch.empty_like(keep)
    b1.launch_row(coords, conf, packed, half, pairs, 1.5, gates, poses,
                  old_keep)
    assert torch.equal(keep, old_keep)
    assert surv.shape == (int(keep.sum()), N, 3)
    assert torch.equal(surv, poses[old_keep])
    for form in forms or ():
        plan = b1.launch_plan(A, N, pairs.shape[0], grid.element_size(),
                              M=len(coords), **form)
        s = b1.screen(coords, confs, geometry, half, pairs, 1.5, gates,
                      plan=plan)
        assert torch.equal(s.keep, keep), form
        assert torch.equal(s.counts, keep.sum(dim=1, dtype=torch.int32))
        assert torch.equal(b1.survivors(s), surv), form
    return poses, old_keep


def b1_against_twin(coords, confs, geometry, grid, pairs, tie=1e-9):
    '''B1 on card tensors against B1's first design (b1_against_row_kernel:
    the same bits), and B1's first design against its plain twin on the same
    tensors: poses within 1e-9 A (float64; 1e-4 A in float32), keep bits
    equal off the tied rows: a pose within `tie` A^2 of the clash
    threshold, or a gate pair that the dedup reads (lazy_keep on the
    twin's poses) within `tie` A of a gate. Returns the twin's (poses,
    keep) and its clash mask ok.'''
    poses, keep = b1_against_row_kernel(coords, confs, geometry, grid, pairs)
    want_poses, want_keep, ok, rmsd, maxdev = b1_twin(coords, confs,
                                                      geometry, grid, pairs)
    rows, A, N = poses.shape[:3]
    atol = 1e-9 if grid.dtype == torch.float64 else 1e-4
    assert poses.shape == want_poses.shape and keep.shape == (rows, A)
    assert float((poses - want_poses).abs().max()) <= atol
    flat = want_poses.reshape(-1, N, 3)
    pl = pairs.long()
    d2 = torch.sum((flat[:, pl[:, 0]] - flat[:, pl[:, 1]]).double() ** 2,
                   dim=-1)
    tied = ((d2 - 2.25).abs() < tie).any(dim=1).reshape(rows, A).any(
        dim=1).cpu()
    similar = ((rmsd < 1.0) & (maxdev < 2.0)).numpy()
    gap = torch.minimum((rmsd - 1.0).abs(), (maxdev - 2.0).abs())
    lazy, _ = lazy_keep(ok.cpu().numpy(), lambda b, t, t0: bool(
        tied.__setitem__(b, tied[b] | bool(gap[b, t, t0] < tie)) or
        similar[b, t, t0]))
    assert np.array_equal(lazy, want_keep.cpu().numpy())
    assert int(tied.sum()) <= rows // 2
    tied = tied.to(keep.device)
    assert torch.equal(keep[~tied], want_keep[~tied])
    return want_poses, want_keep, ok


def test_block_screen_kernel_matches_twin_two_molecules(cuda_device,
                                                        tmp_path):
    '''da_cyclical at 4 conformers, float64: B1 on all 128 block rows
    against B1's first design (bit for bit) and its twin (poses within 1e-9
    A, keep bits equal) and, through the sweep's entry, the CPU run, 47
    survivors.'''
    emb = card_embedder(config_files('da_cyclical', str(tmp_path), 4),
                        cuda_device)
    m1, m2 = emb.objects
    blk = cyclical.bimol_rigid_blocks(m1, m2, 5, emb.pairing_ok_fn())
    coords, grid, pairs, rows = cyclical.sweep_inputs(
        blk, (m1, m2), emb.systematic_angles, cuda_device, torch.float64)
    confs, *geo = rows(0, len(blk['c1']))
    geometry = cyclical.block_geometry(*geo)
    _, want_keep, _ = b1_against_twin(coords, confs, geometry, grid, pairs)
    surv, keep = cyclical.block_screen(coords, confs, geo, grid, pairs, 1.5)
    coords, grid, pairs, rows = cyclical.sweep_inputs(
        blk, (m1, m2), emb.systematic_angles, torch.device('cpu'),
        torch.float64)
    confs, *geo = rows(0, len(blk['c1']))
    cpu_surv, cpu_keep = cyclical.block_screen(coords, confs, geo, grid,
                                               pairs, 1.5)
    np.testing.assert_allclose(surv.cpu().numpy(), cpu_surv.numpy(),
                               rtol=0, atol=1e-9)
    assert torch.equal(keep.cpu(), cpu_keep) and int(keep.sum()) == 47
    assert torch.equal(want_keep.cpu(), cpu_keep)


def test_block_screen_kernel_matches_twin_three_molecules(cuda_device,
                                                          tmp_path):
    '''trimolecular RIGID at 3 conformers of HCOOH, float64: B1 on the 54
    block rows (not a multiple of the 4 rows a block; 75 pairs, the warp
    screen) against its twin, 54 survivors as on the CPU.'''
    from tscode_tpu_torch.ops.kernels import block_screen as b1
    emb = card_embedder(config_files('trimolecular_rigid', str(tmp_path),
                                     12), cuda_device)
    blk = cyclical.trimol_rigid_blocks(emb.objects, emb.pairing_ok_fn())
    blk['dirs'], _ = cyclical.adjust_chain(
        *(blk[k] for k in cyclical._ADJUST), device=cuda_device)
    coords, grid, pairs, rows = cyclical.sweep_inputs(
        blk, emb.objects, emb.systematic_angles, cuda_device, torch.float64)
    confs, *geo = rows(0, len(blk['ids']))
    geometry = cyclical.block_geometry(*geo)
    assert pairs.shape[0] == 75 and grid.shape == (27, 3)
    assert b1.row_launch_plan(27, 15, 75, 8)['warp_clash']
    assert not b1.launch_plan(27, 15, 75, 8, M=3)['warp_clash']
    _, want_keep, _ = b1_against_twin(coords, confs, geometry, grid, pairs)
    assert int(want_keep.sum()) == 54


def test_sweep_launches_b1_once_a_chunk_a_shard(cuda_device, tmp_path):
    '''da_cyclical at 4 conformers, float64: screen_survivors on the card
    launches B1's screen once a chunk (3 chunks of 50 rows) and its write
    once a chunk with survivors, no K1, and once a chunk a shard on a
    cuda:0 x 4 mesh (4 slices of 32 rows, chunks of 13: 12 screens);
    survivors and keep equal the CPU sweep's.'''
    from tscode_tpu_torch.ops.kernels import block_screen as b1
    emb = card_embedder(config_files('da_cyclical', str(tmp_path), 4),
                        cuda_device)
    blk = cyclical.bimol_rigid_blocks(*emb.objects, 5, emb.pairing_ok_fn())
    cpu_surv, cpu_keep = cyclical.screen_survivors(
        blk, emb.objects, emb.systematic_angles, 1.5, device='cpu',
        dtype=torch.float64, block_chunk=50)
    for mesh, launches in ((None, 3), (card_mesh(), 12)):
        split = {}
        b1.KERNEL.reset_counts()
        clash.KERNEL.reset_counts()
        surv, keep = cyclical.screen_survivors(
            blk, emb.objects, emb.systematic_angles, 1.5, device=cuda_device,
            dtype=torch.float64, block_chunk=50, split=split, mesh=mesh)
        assert b1.KERNEL.wrapper_launches['block_screen'] == \
            split['chunks'] == launches
        assert 0 < b1.KERNEL.wrapper_launches['block_survivors'] <= launches
        assert clash.KERNEL.launches == 0
        assert split['sweep_kernel'] == 'B1' and split['dedup_s'] == 0.0
        np.testing.assert_array_equal(keep, cpu_keep)
        np.testing.assert_allclose(surv.cpu().numpy(), cpu_surv.numpy(),
                                   rtol=0, atol=1e-9)


def synthetic_sweep(rng, n_atoms, A, rows, device, dtype, n_confs=3,
                    product=False, n_pairs=None):
    '''Seeded block rows of len(n_atoms) blob molecules (n_confs
    conformers each): random alignments and axes, molecule m placed 4.5 m
    A along x so that some poses clash, and A angle tuples of small steps
    (12 a molecule, cycled), so neighbouring poses pass the dedup gates
    and far ones do not; with `product`, the embedder's grid instead:
    every tuple of steps + 1 angles from -45 to 45 degrees a molecule,
    A = (steps + 1)^M; with `n_pairs`, that many seeded pairs across
    each two neighbouring molecules instead of every cross-fragment pair.
    Returns block_screen's arguments but thresh.'''
    M = len(n_atoms)
    coords = [torch.as_tensor(rng.normal(size=(n_confs, n, 3)) * 1.3,
                              dtype=dtype, device=device) for n in n_atoms]
    confs = [torch.as_tensor(rng.integers(0, n_confs, rows), device=device)
             for _ in n_atoms]
    q, _ = np.linalg.qr(rng.normal(size=(rows, M, 3, 3)))
    R_align = q * np.sign(np.linalg.det(q))[..., None, None]
    axis = rng.normal(size=(rows, M, 3))
    cor = rng.normal(size=(rows, M, 3)) * 0.3
    pos0 = rng.normal(size=(rows, M, 3)) * 0.5
    pos0[..., 0] += 4.5 * np.arange(M)
    if product:
        k = round(A ** (1 / M))
        assert k ** M == A
        grid = np.stack(np.meshgrid(*[np.linspace(-45.0, 45.0, k)] * M,
                                    indexing='ij'), axis=-1).reshape(A, M)
    else:
        steps = np.linspace(0.0, 66.0, 12)
        grid = np.stack([steps[(np.arange(A) // 12 ** m) % 12]
                         for m in range(M)], axis=1)
    geometry = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in (R_align, axis, cor, pos0))
    if n_pairs is None:
        pl = clash.static_pairs(cross_fragment_pair_mask(tuple(n_atoms)))
    else:
        s = np.cumsum([0, *n_atoms])
        pl = np.concatenate([np.stack(
            [s[m] + rng.integers(0, n_atoms[m], n_pairs),
             s[m + 1] + rng.integers(0, n_atoms[m + 1], n_pairs)], axis=1)
            for m in range(M - 1)]).astype(np.int32)
    pairs = torch.as_tensor(pl, device=device)
    return (coords, confs, geometry, torch.as_tensor(grid, dtype=dtype,
                                                     device=device), pairs)


B1_CASES = {
    # (atoms a molecule, A, rows), then whether the poses sit in shared
    # memory in float32 and float64 (B1's smem form, else its scratch
    # form; B1's first design: else read back from its output), and whether
    # there are 64 pairs or more (the first design's warp clash screen; B1
    # screens a lane's own pose at these A, its warp screen is forced in
    # test_block_screen_equals_its_first_design_in_every_form)
    # A = 216 of 60-atom poses: no block's shared memory holds 4 rows
    'global_warp': ((30, 30), 216, 7, (False, False), True),
    'global_thread': ((59, 1), 216, 5, (False, False), False),
    'smem_thread': ((6, 5), 36, 9, (True, True), False),
    # N = 12: 3 N even, the store padded to 37
    'smem_thread_even': ((6, 6), 36, 9, (True, True), False),
    'smem_warp': ((8, 8), 36, 9, (True, True), True),
    # three molecules, 12 + 5 + 5 atoms, 145 pairs
    'three': ((12, 5, 5), 144, 6, (True, False), True),
    # three molecules on the trimolecular route's grid, 27 angles
    'three_27': ((5, 5, 5), 27, 7, (True, True), True),
    # past one tile of 1,024 angles, on the embedder's product grid:
    # STEPS=10 on three molecules (11^3) and DEEP's 72 steps on two (73^2)
    'steps10_three': ((6, 6, 6), 1331, 5, (False, False), True),
    'deep_two': ((3, 3), 5329, 3, (False, False), False),
}
# DEEP's grid is held against the twin in float64 only: at 1.25-degree
# steps each row reads thousands of gate pairs near the 1 A / 2 A gates,
# and in float32 most rows hold one within the tie of 1e-4 A (2 of the 3
# rows here); against B1's first design it is held bit for bit in both
B1_RUNS = [(dtype, case) for case in sorted(B1_CASES) for dtype in DTYPES
           if (dtype, case) != (torch.float32, 'deep_two')]


def b1_case(case, dtype, device):
    '''The seeded rows of a B1_CASES case, with its plans checked.'''
    from tscode_tpu_torch.ops.kernels import block_screen as b1
    n_atoms, A, rows, smem, warp = B1_CASES[case]
    P = len(clash.static_pairs(cross_fragment_pair_mask(n_atoms)))
    itemsize = poses_itemsize(dtype)
    plan = b1.launch_plan(A, sum(n_atoms), P, itemsize, M=len(n_atoms))
    assert plan['form'] == ('smem' if smem[dtype == torch.float64]
                            else 'scratch')
    assert not plan['warp_clash'] and plan['stride'] % 2 == 1
    row = b1.row_launch_plan(A, sum(n_atoms), P, itemsize)
    assert row['smem_poses'] == smem[dtype == torch.float64]
    assert row['warp_clash'] == warp
    return plan, synthetic_sweep(np.random.default_rng(216 + A), n_atoms, A,
                                 rows, device, dtype, product=A > 1024)


@pytest.mark.parametrize('dtype, case', B1_RUNS)
def test_block_screen_kernel_any_size(cuda_device, dtype, case):
    '''B1 against B1's first design and its twin on seeded rows (row counts
    not a multiple of the 4 rows a block) in each of its forms, float32
    and float64; the dedup drops some angles that passed the screen and
    keeps some, past 1,024 angles also in the later tiles.'''
    _, args = b1_case(case, dtype, cuda_device)
    rows, A = B1_CASES[case][2], B1_CASES[case][1]
    _, keep, ok = b1_against_twin(
        *args, tie=1e-9 if dtype == torch.float64 else 1e-4)
    assert 0 < int(keep.sum()) < int(ok.sum()) < rows * A
    if A > 1024:
        late = slice(1024, None)
        assert 0 < int(keep[:, late].sum()) < int(ok[:, late].sum())


@pytest.mark.parametrize('case', sorted(B1_CASES))
@pytest.mark.parametrize('dtype', DTYPES)
def test_block_screen_equals_its_first_design_in_every_form(cuda_device,
                                                            dtype, case):
    '''B1's screen and write against B1's first design, bit for bit (keep
    bits, and the survivors its poses compacted), float32 and float64,
    two and three molecules, A = 27 to 5,329, N up to 60: in the plan's
    form, in the scratch form, with the warp's clash screen, and where the
    shapes allow it in the shared-memory form.'''
    plan, args = b1_case(case, dtype, cuda_device)
    forms = [{'form': 'scratch'}, {'warp_clash': True},
             {'form': 'scratch', 'warp_clash': True}]
    if plan['form'] == 'smem':
        forms += [{'form': 'smem'}]
    poses, keep = b1_against_row_kernel(*args, forms=forms)
    assert 0 < int(keep.sum()) < keep.numel()


@pytest.mark.parametrize('n_atoms', [(2500, 2500), (2000, 1500, 1500)])
@pytest.mark.parametrize('dtype', DTYPES)
def test_block_screen_runs_past_a_blocks_shared_memory(cuda_device, dtype,
                                                       n_atoms):
    '''N = 5,000 at A = 36, two and three molecules, float32 and float64:
    a block's four staged rows alone (3 N + 18 M values each) pass the
    shared-memory opt-in limit, so B1 runs in the scratch form with only
    the pair list in shared memory, and gives B1's first design's keep
    bits and poses bit for bit (40 seeded pairs across each two
    neighbouring molecules, so that some poses pass the screen).'''
    from tscode_tpu_torch.ops.kernels import block_screen as b1
    N, A, rows = sum(n_atoms), 36, 5
    args = synthetic_sweep(np.random.default_rng(5000), n_atoms, A, rows,
                           cuda_device, dtype, n_pairs=40)
    itemsize = poses_itemsize(dtype)
    assert 4 * (3 * N + 18 * len(n_atoms)) * itemsize > \
        b1.SMEM_OPTIN_BYTES
    plan = b1.launch_plan(A, N, args[4].shape[0], itemsize, M=len(n_atoms))
    assert plan['form'] == 'scratch' and plan['smem'] <= b1.SMEM_OPTIN_BYTES
    poses, keep = b1_against_row_kernel(*args,
                                        forms=[{'warp_clash': True}])
    assert 0 < int(keep.sum()) < keep.numel()


@pytest.mark.parametrize('dtype', DTYPES)
def test_clash_kernel_on_three_fragments(cuda_device, dtype):
    '''K1 on the cross-fragment pair list of three 5-atom fragments (75
    pairs of 15 atoms, the three-molecule embed's: the warp regime) with
    max_clashes 0 and 2, against plain off threshold ties.'''
    rng = np.random.default_rng(15)
    pm = cross_fragment_pair_mask((5, 5, 5))
    pairs = torch.as_tensor(clash.static_pairs(pm), device=cuda_device)
    assert pairs.shape == (75, 2)
    assert clash.clash_regime(75, 15, poses_itemsize(dtype)) == 'warp'
    frag = rng.normal(size=(5000, 3, 5, 3)) * 0.9
    frag += rng.normal(size=(5000, 3, 1, 3)) * 2.5
    poses = torch.as_tensor(frag.reshape(5000, 15, 3), dtype=dtype,
                            device=cuda_device)
    P = poses.double()
    pl = pairs.long()
    d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
    keep = ~((d2 - 2.25).abs() < 1e-4).any(dim=1)     # no threshold ties
    clash.KERNEL.reset_counts()
    for mc in (0, 2):
        want = clash.clash_ok_plain(poses, pairs, 1.5, mc)
        got = clash.clash_ok(poses, pairs, 1.5, mc)
        assert torch.equal(got[keep], want[keep])
        assert 0 < int(want.sum()) < poses.shape[0]
    assert clash.launches_by_regime() == {'thread': 0, 'warp': 2}
    assert clash.launches_by_entry() == {'clash_ok': 2,
                                         'compenetration_mask_kernel': 0,
                                         'torsion_clash_ok': 0,
                                         'torsion_backoff': 0}


def poses_itemsize(dtype):
    return torch.empty(0, dtype=dtype).element_size()


def test_compenetration_refining_from_numpy_reaches_k2(cuda_device, tmp_path):
    '''The chelotropic route at 4 conformers with device='cuda': the
    compenetration stage moves the run's numpy ensemble to the card and
    launches K2 once, with the run's CLASHES count; the mask equals the
    CPU stage's on structures pushed into clashes.'''
    path = config_files('chelotropic', str(tmp_path), 4)
    with open(path) as f:
        text = f.read()
    with open(path, 'w') as f:
        f.write(text.replace('NOOPT', 'NOOPT CLASHES(num=2,dist=1.5)'))
    runs = {}
    for dev in ('cuda', 'cpu'):
        cwd = os.getcwd()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                emb = Embedder(path, stamp=dev, device=dev,
                               dtype=torch.float64)
                run = RunEmbedding(emb)
                run.generate_candidates()
        finally:
            os.chdir(cwd)
        assert run.embed == 'chelotropic' and run.options.max_clashes == 2
        # pull the second fragment toward the first, so that some
        # structures clash at 0, 1 to 2 and more pairs
        n1 = run.objects[0].n_atoms
        s = run.structures.copy()
        shift = s[:, :n1].mean(axis=1) - s[:, n1:].mean(axis=1)
        s[:, n1:] += shift[:, None] * np.linspace(0, 0.6, len(s))[:, None,
                                                                   None]
        run.structures = s
        clash.KERNEL.reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            run.compenetration_refining()
        run.logfile.close()
        assert clash.launches_by_entry()['compenetration_mask_kernel'] == \
            int(dev == 'cuda')
        runs[dev] = run.structures
    assert runs['cuda'].shape == runs['cpu'].shape
    np.testing.assert_allclose(runs['cuda'], runs['cpu'], rtol=0, atol=1e-9)
    assert 0 < len(runs['cpu']) < 128


def test_prune_conformers_rmsd_from_numpy_reaches_k3(cuda_device):
    '''A numpy ensemble with device='cuda' is moved to the card and pruned
    by K3; the keep mask equals the CPU run's.'''
    pool = near_dup_pool(np.random.default_rng(9), 3000, 6, 700)
    atomnos = np.array([6, 6, 1, 8, 6, 1])
    before = qcp.KERNEL.launches
    pruned, keep = prune_conformers_rmsd(pool, atomnos, device='cuda',
                                         dtype=torch.float64)
    assert qcp.KERNEL.launches > before
    assert pruned.device.type == 'cuda' and pruned.shape[0] == keep.sum()
    _, want = prune_conformers_rmsd(pool, atomnos, device='cpu')
    np.testing.assert_array_equal(keep, want)
    assert 0 < keep.sum() < len(pool)


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


# ----------------------------------------------------- bending routes


def hcoooh():
    from tscode_tpu_torch.molecule import Molecule
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    from tscode_tpu_torch.pivots import set_pivots
    mol = Molecule(os.path.join(FIXTURE_DIR, 'HCOOOH.xyz'), [0, 4])
    mol.compute_orbitals()
    set_pivots(mol)
    return mol


def test_ff_energy_and_gradient_on_card_match_cpu(cuda_device):
    '''The force field (C2H4 with its E/Z dihedral, so all four terms)
    on 2,000 jittered structures, float64: card within 1e-9 relative of
    the CPU; float32 on the card within 1e-4.'''
    from tscode_tpu_torch import ff
    from tscode_tpu_torch.molecule import Molecule
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    mol = Molecule(os.path.join(FIXTURE_DIR, 'C2H4.xyz'))
    params = ff.build_ff_params(mol.atomcoords[0], mol.atomnos, mol.graph,
                                protect_double_bonds=True)
    assert len(params.dihedrals) == 1
    rng = np.random.default_rng(41)
    X = mol.atomcoords[0] + rng.normal(size=(2000, 6, 3)) * 0.2
    out = {}
    for device, dtype in (('cpu', torch.float64), (cuda_device, torch.float64),
                          (cuda_device, torch.float32)):
        x = torch.as_tensor(X, dtype=dtype, device=device).requires_grad_(True)
        e = ff.ff_energy(x, ff.params_to_device(params, device, dtype))
        g, = torch.autograd.grad(e.sum(), x)
        out[str(device), dtype] = (e.detach().cpu().double(), g.cpu().double())
    e0, g0 = out['cpu', torch.float64]
    for (device, dtype), (e, g) in out.items():
        tol = 1e-9 if dtype == torch.float64 else 1e-4
        assert float((e - e0).abs().max() / e0.abs().max()) <= tol
        assert float((g - g0).abs().max() / g0.abs().max()) <= tol


def test_fire_minimize_batch_on_card_matches_cpu(cuda_device):
    '''1,024 jittered HCOOOH structures relaxed for 150 steps, float64:
    the card (one launch of the force field's FIRE kernel) within 1e-6 A
    of the CPU with the same rows stopped; the op-by-op loop and the
    step replayed from a CUDA graph on the card too, a second graph run
    of the same shapes replaying the kept graph.'''
    from tscode_tpu_torch import capture, ff, optimizers
    from tscode_tpu_torch.ops.kernels import ff_fire
    mol = hcoooh()
    params = ff.build_ff_params(mol.atomcoords[0], mol.atomnos, mol.graph)
    rng = np.random.default_rng(42)
    X = mol.atomcoords[0] + rng.normal(size=(1024, 6, 3)) * 0.15
    freeze = np.zeros(6, dtype=bool)
    freeze[0] = True
    runs = {}
    launches = ff_fire.KERNEL.launches
    for device in ('cpu', cuda_device):
        p = ff.params_to_device(params, device, torch.float64)
        x = torch.as_tensor(X, device=device)
        runs[str(device)] = optimizers.fire_minimize_batch(
            x, ff.ff_energy, n_steps=150, freeze_mask=freeze,
            energy_args=(p,))
        e0 = ff.ff_energy(x, p)
        assert bool((runs[str(device)][1] <= e0 + 1e-9).all())
    assert ff_fire.KERNEL.launches == launches + 1
    c_cpu, e_cpu, done_cpu = runs['cpu']
    c, e, done = runs[str(cuda_device)]
    assert c.is_cuda and float((c.cpu() - c_cpu).abs().max()) <= 1e-6
    assert torch.equal(done.cpu(), done_cpu) and 0 < int(done.sum())
    assert torch.equal(c[:, 0].cpu(), torch.as_tensor(X[:, 0]))
    p = ff.params_to_device(params, cuda_device, torch.float64)
    x = torch.as_tensor(X, device=cuda_device)
    args = (x, ff.ff_energy, 150, 0.05, 0.05,
            torch.as_tensor(freeze, device=cuda_device), (p,))
    eager = optimizers.fire_run_eager(*args)
    graph = optimizers.fire_run_graph(*args)
    graphs = len(capture._graphs)
    again = optimizers.fire_run_graph(*args)
    assert len(capture._graphs) == graphs
    for a, b, r in zip(eager, graph, again):
        assert float((a.double() - b.double()).abs().max()) <= 1e-9
        assert torch.equal(b, r)
    assert float((graph[0] - c).abs().max()) <= 1e-6 and \
        torch.equal(graph[5], done)


def fire_kernel_case(device, shape, dtype):
    '''(coords, FireTerms, the energy and its args) of a FIRE kernel
    test: C2H4 with its E/Z dihedral under the bend's energy (bonds at
    2,000, a spring on 0-4 with k a device tensor), one structure, three
    or a batch of 2,000, jittered by 0.2 A.'''
    from tscode_tpu_torch import bending, ff
    from tscode_tpu_torch.molecule import Molecule
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    mol = Molecule(os.path.join(FIXTURE_DIR, 'C2H4.xyz'))
    params = ff.params_to_device(ff.build_ff_params(
        mol.atomcoords[0], mol.atomnos, mol.graph,
        protect_double_bonds=True), device, dtype)
    B = FIRE_ROWS[shape]
    rng = np.random.default_rng(43)
    x = torch.as_tensor(mol.atomcoords[0] + rng.normal(size=(B, 6, 3)) * 0.2,
                        dtype=dtype, device=device)
    args = (params, torch.as_tensor([[0, 4]], device=device),
            torch.as_tensor([2.0], dtype=dtype, device=device),
            torch.tensor(80.0, dtype=dtype, device=device))
    return x, bending._bend_energy.fire_terms(*args), \
        bending._bend_energy, args


FIRE_ROWS = {'one': 1, 'three': 3, 'batch': 2000}
FIRE_FREEZE = {'none': None, 'atoms': np.arange(6) == 1,
               'rows': np.random.default_rng(7).random((2000, 6)) < 0.2}


def fire_forms_hold(x, terms, n_steps, mask, ref, energy=None):
    '''Every form of the force field's FIRE kernel (ff_fire.launch,
    regime=...) on one call: two launches give the same bits; float64
    within 1e-6 A of the plain twin's result `ref` (coords, done, steps)
    with the same stop flags and force evaluations; float32 as phase 13
    holds it (finite, no energy rises under `energy`, the stopped rows'
    force under the float64 terms `ref` below fmax but for float32's
    rounding of the bend's stiff bonds: 2 k d eps32 ~ 4e-4 a term);
    frozen atoms in place. Returns {form: coords}.'''
    from tscode_tpu_torch.ops.kernels import ff_fire
    got = {}
    for form in ff_fire.FORMS:
        c, done, steps = ff_fire.launch(x, terms, n_steps, freeze_mask=mask,
                                        regime=form)
        c2, done2, steps2 = ff_fire.launch(x, terms, n_steps,
                                           freeze_mask=mask, regime=form)
        assert torch.equal(c, c2) and torch.equal(done, done2) and \
            torch.equal(steps, steps2), form
        assert c.is_cuda and bool(torch.isfinite(c).all()), form
        if mask is not None:
            frozen = torch.as_tensor(
                np.broadcast_to(mask, x.shape[:2]).copy(), device=x.device)
            assert torch.equal(c[frozen], x[frozen]), form
        if x.dtype == torch.float64:
            cp, dp, sp = ref
            assert float((c - cp).abs().max()) <= 1e-6, form
            assert torch.equal(done, dp) and torch.equal(steps, sp), form
        else:
            e0, e1 = energy(x), energy(c)
            assert bool((e1 <= e0 + 1e-4 * (1 + e0.abs())).all()), form
            f = ff_fire.ff_forces_plain(c.double(), ref, mask)
            fmax = torch.linalg.norm(f, dim=-1).amax(dim=-1)
            assert bool((fmax[done] < 0.05 + 1e-3).all()), \
                (form, float(fmax[done].max()))
        got[form] = c
    return got


@pytest.mark.parametrize('freeze', list(FIRE_FREEZE))
@pytest.mark.parametrize('shape', list(FIRE_ROWS))
@pytest.mark.parametrize('dtype', DTYPES)
def test_ff_fire_kernel_matches_plain(cuda_device, dtype, shape, freeze):
    '''The force field's FIRE kernel against its plain twin on the card,
    300 steps, in every form (fire_forms_hold): float64 within 1e-6 A
    with the same rows stopped and the same force evaluations; float32
    as phase 13 holds it. The entry (ff_fire.ff_fire) launches once a
    call, in the form plan_for picks.'''
    from tscode_tpu_torch.ops.kernels import ff_fire
    x, terms, energy, args = fire_kernel_case(cuda_device, shape, dtype)
    mask = FIRE_FREEZE[freeze]
    if mask is not None and mask.ndim == 2:
        mask = mask[:len(x)]
    before = ff_fire.KERNEL.launches
    c, done, steps = ff_fire.ff_fire(x, terms, 300, freeze_mask=mask)
    assert ff_fire.KERNEL.launches == before + 1
    if dtype == torch.float64:
        plain = ff_fire.ff_fire_plain(x, terms, 300, freeze_mask=mask)
        assert shape != 'batch' or int(plain[1].sum()) > 0
    else:
        _, plain, _, _ = fire_kernel_case(cuda_device, shape, torch.float64)
    got = fire_forms_hold(x, terms, 300, mask, plain,
                          lambda y: energy(y, *args))
    assert torch.equal(c, got[ff_fire.plan_for(x, terms).form])


@pytest.mark.parametrize('dtype', DTYPES)
def test_ff_fire_forms_hold_springs_and_half_springs(cuda_device, dtype):
    '''adjust_spacings_batch's energy on the three-molecule fixture
    (springs and half-springs, their constants device tensors) in every
    form against the plain twin, 300 steps, three structures.'''
    from tscode_tpu_torch import ff, optimization
    from tscode_tpu_torch.molecule import Molecule
    from tscode_tpu_torch.ops.kernels import ff_fire
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    mols = [Molecule(os.path.join(FIXTURE_DIR, n))
            for n in ('CH3Cl.xyz', 'HCOOH.xyz', 'C2H4.xyz')]
    parts = [ff.build_ff_params(m.atomcoords[0], m.atomnos, m.graph)
             for m in mols]
    params = ff.merge_ff_params(parts, np.array([0, 5, 10]))
    coords = np.concatenate([m.atomcoords[0] + 3.0 * k
                             for k, m in enumerate(mols)])
    rng = np.random.default_rng(44)
    terms = {}
    for t in (torch.float64, dtype):
        p = ff.params_to_device(params, cuda_device, t)
        args = (p, torch.as_tensor([[0, 15], [1, 14]], device=cuda_device),
                torch.as_tensor([2.2, 3.1], dtype=t, device=cuda_device),
                torch.as_tensor([[0, 14], [2, 15]], device=cuda_device),
                torch.tensor(50.0, dtype=t, device=cuda_device),
                torch.tensor(500.0, dtype=t, device=cuda_device))
        terms[t] = (optimization._spacing_energy.fire_terms(*args), args)
    t_x, args = terms[dtype]
    assert t_x.spring_pairs.shape[0] and t_x.half_pairs.shape[0]
    x = torch.as_tensor(coords + rng.normal(size=(3,) + coords.shape) * 0.1,
                        dtype=dtype, device=cuda_device)
    plain = ff_fire.ff_fire_plain(x, t_x, 300) if dtype == torch.float64 \
        else terms[torch.float64][0]
    fire_forms_hold(x, t_x, 300, None, plain,
                    lambda y: optimization._spacing_energy(y, *args))


@pytest.mark.parametrize('rows', ['one', 'batch'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_ff_fire_forms_hold_a_74_atom_chain(cuda_device, dtype, rows):
    '''A 74-atom chain (suite_inputs.chain_ff: large_n's length, past the
    one-warp atom sums of N <= 32), one structure and a batch of
    BATCH_MIN_ROWS, 100 steps, in every form against the plain twin
    (fire_forms_hold: float64 within 1e-6 A, the same stops and force
    evaluations, two launches the same bits); ff_fire.ff_fire launches
    the form plan_for picks.'''
    from tscode_tpu_torch import ff
    from tscode_tpu_torch.ops.kernels import ff_fire
    from tscode_tpu_torch.suite_inputs import chain_ff
    B = 1 if rows == 'one' else ff_fire.BATCH_MIN_ROWS
    X, params = chain_ff(74, B, seed=74)
    p = {t: ff.params_to_device(params, cuda_device, t)
         for t in (torch.float64, dtype)}
    terms = ff.FireTerms(p[dtype])
    x = torch.as_tensor(X, dtype=dtype, device=cuda_device)
    plain = ff_fire.ff_fire_plain(x, terms, 100) \
        if dtype == torch.float64 else ff.FireTerms(p[torch.float64])
    got = fire_forms_hold(x, terms, 100, None, plain,
                          lambda y: ff.ff_energy(y, p[dtype]))
    if dtype == torch.float64:
        assert int(plain[2].max()) > 10
    c, _, _ = ff_fire.ff_fire(x, terms, 100)
    assert torch.equal(c, got[ff_fire.plan_for(x, terms).form])


FIRE_OPT_IN = """
import sys
import torch
from tscode_tpu_torch import ff
from tscode_tpu_torch.ops.kernels import ff_fire
from tscode_tpu_torch.suite_inputs import chain_ff
for n, B in ((32, 8), (74, 1)):
    X, params = chain_ff(n, B, seed=n)
    terms = ff.FireTerms(ff.params_to_device(params, sys.argv[1],
                                             torch.float64))
    x = torch.as_tensor(X, device=sys.argv[1])
    c, done, steps = ff_fire.launch(x, terms, 10, regime='warp')
    print(n, ff_fire.launch_plan(B, n, tuple(
        t.shape[0] for t in terms.tables()[0::2]),
        ff.incidence(terms.params, n)[1].numel(), 8, 'warp').smem,
        int(steps.max()))
"""


def test_ff_fire_kernels_opt_in_their_own_shared_memory(cuda_device):
    '''In a fresh process, the warp form at 32 atoms (its N <= 32
    kernel: 8 structures in ~208 KB of shared memory) and then at 74
    atoms (its N > 32 kernel: one structure in ~140 KB): each kernel
    raises its own shared-memory limit, so the second launch runs.'''
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, '-c', FIRE_OPT_IN, str(cuda_device)],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [line.split() for line in r.stdout.splitlines()]
    assert [int(n) for n, _, _ in rows] == [32, 74]
    assert int(rows[0][1]) > int(rows[1][1]) > 48 * 1024
    assert all(int(steps) == 10 for _, _, steps in rows)


def test_ff_fire_runs_a_2500_atom_structure(cuda_device):
    '''A 2,500-atom chain (3.1M repulsion pairs), float64, 5 steps:
    launch_plan takes the large form (a cluster a structure), which
    matches the plain twin within 1e-6 A with the same force evaluations
    and gives the same bits twice, and so does its variant with the
    coordinates in device memory; the block form's shared memory does
    not hold the structure (its launch raised before the large form).'''
    from tscode_tpu_torch import ff
    from tscode_tpu_torch.ops.kernels import ff_fire
    from tscode_tpu_torch.suite_inputs import chain_ff
    X, params = chain_ff(2500, 2, seed=5)
    p = ff.params_to_device(params, cuda_device, torch.float64)
    terms = ff.FireTerms(p)
    x = torch.as_tensor(X, device=cuda_device)
    kinds = tuple(t.shape[0] for t in terms.tables()[0::2])
    _, codes, _ = ff.incidence(p, 2500)
    assert ff_fire.launch_plan(2, 2500, kinds, codes.numel(),
                               8).form == 'large'
    with pytest.raises(ValueError):
        ff_fire.launch_plan(2, 2500, kinds, codes.numel(), 8, 'block')
    c, done, steps = ff_fire.ff_fire(x, terms, 5)
    c2, _, _ = ff_fire.ff_fire(x, terms, 5)
    cp, dp, sp = ff_fire.ff_fire_plain(x, terms, 5)
    assert torch.equal(c, c2)
    assert float((c - cp).abs().max()) <= 1e-6
    assert torch.equal(done, dp) and torch.equal(steps, sp)
    assert float((c - x).abs().max()) > 1e-3
    # the large form past its blocks' copies of the coordinates (they
    # stay in device memory): the same sums in the same order
    plan = ff_fire.launch_plan(2, 2500, kinds, codes.numel(), 8)
    assert plan.staged
    c3, done3, steps3 = ff_fire.launch(
        x, terms, 5, plan=plan._replace(staged=False, smem=0))
    assert torch.equal(c3, c) and torch.equal(done3, done) and \
        torch.equal(steps3, steps)


@pytest.mark.parametrize('shape', ['one', 'batch'])
def test_ff_fire_kernel_matches_the_graph_path(cuda_device, shape):
    '''fire_minimize_batch of the bend's energy on the card (the kernel,
    one launch) against the same call's captured graph (fire_run_graph,
    autograd forces), float64, 300 steps: within 1e-6 A, the same rows
    stopped.'''
    from tscode_tpu_torch import optimizers
    from tscode_tpu_torch.ops.kernels import ff_fire
    x, _, energy, args = fire_kernel_case(cuda_device, shape, torch.float64)
    before = ff_fire.KERNEL.launches
    c, e, done = optimizers.fire_minimize_batch(x, energy, n_steps=300,
                                                energy_args=args)
    assert ff_fire.KERNEL.launches == before + 1
    state = optimizers.fire_run_graph(x, energy, 300, 0.05, 0.05, None, args)
    assert float((state[0] - c).abs().max()) <= 1e-6
    assert torch.equal(state[5], done)
    assert float((energy(state[0], *args) - e).abs().max()) <= 1e-6


def test_bend_molecule_on_card_matches_cpu(cuda_device):
    '''One bend of HCOOOH (10 relaxations, ends stuck) on the card and
    on the CPU: the bent conformer within 1e-6 A, the same pivots and
    relaxation count, float64 whatever the device.'''
    from tscode_tpu_torch.bending import bend_molecule
    out = {}
    for device in ('cpu', cuda_device):
        mol = hcoooh()
        pivot = mol.pivots[0][0]
        stats = {}
        bent = bend_molecule(mol, 0, pivot,
                             float(np.linalg.norm(pivot.pivot)) - 0.3,
                             stats=stats, device=device)
        assert bent is not mol and bent.atomcoords.dtype == np.float64
        out[str(device)] = (bent, stats)
    (cpu, s_cpu), (card, s_card) = out['cpu'], out[str(cuda_device)]
    assert s_cpu == s_card and s_card['relaxations'] > 1
    np.testing.assert_allclose(card.atomcoords, cpu.atomcoords, rtol=0,
                               atol=1e-6)
    assert [p.index for p in card.pivots[0]] == \
        [p.index for p in cpu.pivots[0]]
    assert np.abs(card.atomcoords[0] - hcoooh().atomcoords[0]).max() > 0.05


def chain_backoff_batch(device, n=729, scale=0.85):
    """The C8 chain's six rotors, every angle set, from jittered and
    shrunk starting points (so retreats happen), in float64 on `device`:
    (coords, torsions, graph, angle sets)."""
    from tscode_tpu_torch import torsions as tt
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.suite_inputs import chloroalkane
    base, nos = chloroalkane(8)
    graph = graphize(base, nos)
    tors = tt.get_torsions(graph, [], tt.get_double_bonds_indices(base, nos))
    for t in tors:
        t.sort_torsion(graph, np.array([]))
    angles = tt.cartesian_product(*[np.array(t.get_angles()) for t in tors])
    rng = np.random.default_rng(6)
    coords = (base + rng.normal(size=(len(angles),) + base.shape) * 0.05) \
        * scale
    return (torch.as_tensor(coords, dtype=torch.float64, device=device),
            tors, graph, angles)


def test_torsion_clash_ok_matches_plain(cuda_device):
    """K1's back-off entry against its plain twin on the chain's rotated
    candidates, off threshold ties; its launches are counted under its
    own name."""
    from tscode_tpu_torch import torsions as tt
    coords, tors, graph, angles = chain_backoff_batch(cuda_device)
    clash.KERNEL.reset_counts()
    checked = 0
    for t, torsion in enumerate(tors):
        move = tt.get_rotation_mask(graph, torsion.torsion)
        other = ~move
        other[list(torsion.torsion[1:3])] = False
        poses = rotate_dihedral(coords, torsion.torsion, torch.as_tensor(
            angles[:, t], dtype=torch.float64, device=cuda_device), move)
        pairs = clash.torsion_pairs(move, other, cuda_device)
        pl = pairs.long()
        d2 = torch.sum((poses[:, pl[:, 0]] - poses[:, pl[:, 1]]) ** 2, -1)
        keep = ~((d2 - 2.25).abs() < 1e-4).any(dim=1)
        got = clash.torsion_clash_ok(poses, move, other)
        want = clash.pair_clash_ok_plain(poses, pairs, 1.5)
        assert torch.equal(got[keep], want[keep])
        checked += int(keep.sum())
    assert checked > 0
    assert clash.launches_by_entry() == {'clash_ok': 0,
                                         'compenetration_mask_kernel': 0,
                                         'torsion_clash_ok': len(tors),
                                         'torsion_backoff': 0}


def test_backoff_on_card_matches_cpu(cuda_device):
    """The whole back-off of the chain's six torsions on the card (one
    torsion_backoff launch a torsion, no torsion_clash_ok) against the
    CPU (the pending rows only), float64: coordinates within 1e-9 A,
    rotation counts equal."""
    from tscode_tpu_torch import torsions as tt
    coords, tors, graph, angles = chain_backoff_batch(cuda_device)
    clash.KERNEL.reset_counts()
    got, got_n = tt.apply_torsion_group(coords, tors, graph, angles)
    want, want_n = tt.apply_torsion_group(coords.cpu(), tors, graph, angles)
    assert clash.launches_by_entry() == {'clash_ok': 0,
                                         'compenetration_mask_kernel': 0,
                                         'torsion_clash_ok': 0,
                                         'torsion_backoff': len(tors)}
    assert torch.equal(got_n.cpu(), want_n)
    assert float((got.cpu() - want).abs().max()) <= 1e-9
    assert 0 < int((want_n < len(tors)).sum()) < len(angles)


def backoff_ties(coords, quad, move, angles, other, steps):
    """Candidates with a pair within 1e-4 A^2 of 1.5^2 at any retreat step
    they evaluate (the kernel's pair scan may contract into FMAs)."""
    pairs = clash.torsion_pairs(move, other, coords.device)
    pl = pairs.long()
    retreat = clash.backoff_retreat(coords, clash.backoff_terms(coords, quad),
                                    move, angles, pairs)
    tie = torch.zeros(len(coords), dtype=torch.bool, device=coords.device)
    found = torch.zeros_like(tie)
    for s in range(steps + 1):
        cand, ok = retreat(s)
        d = cand[:, pl[:, 0]] - cand[:, pl[:, 1]]
        live = ~found & (angles - 5.0 * s >= 0)
        tie |= live & ((torch.sum(d * d, -1) - 2.25).abs() < 1e-4).any(1)
        found |= ok
    return tie


def test_torsion_backoff_matches_plain_bit_for_bit(cuda_device):
    """torsion_backoff (one launch a torsion) against its plain twin (the
    whole-batch loop on the card) on the chain's candidates, angle-0 rows
    and angles beyond max_steps included, as they are and shrunk so that
    rows find no clash-free step: frames and flags bit-equal off tie
    candidates; float32 raises."""
    from tscode_tpu_torch import torsions as tt
    checked = never = 0
    for scale in (0.85, 0.6):
        coords, tors, graph, angles = chain_backoff_batch(cuda_device,
                                                          scale=scale)
        for t, torsion in enumerate(tors):
            move, other = masks_of(tt, graph, torsion)
            a = torch.as_tensor(angles[:, t], dtype=torch.float64,
                                device=cuda_device)
            a[:3] = torch.as_tensor([0.0, 0.0, 355.0])
            for steps in (int(angles[:, t].max() // 5), 72):
                call = (coords, torsion.torsion, move, a, other, steps)
                got, got_rot = clash.torsion_backoff(*call)
                want, want_rot = clash.torsion_backoff_plain(*call)
                off = ~backoff_ties(*call)
                assert torch.equal(got_rot[off], want_rot[off])
                assert torch.equal(got[off], want[off])
                assert not bool(got_rot[a == 0].any())
                checked += int(off.sum())
                never += int(((a > 0) & ~want_rot).sum())
    assert checked > 0 and never > 0
    with pytest.raises(TypeError):
        clash.torsion_backoff(coords.float(), torsion.torsion, move, a.float(),
                              other, 8)


def masks_of(tt, graph, torsion):
    move = tt.get_rotation_mask(graph, torsion.torsion)
    other = ~move
    other[list(torsion.torsion[1:3])] = False
    return move, other


def test_search_launches_one_backoff_a_torsion(cuda_device):
    """A csearch on the card launches torsion_backoff once per torsion
    and torsion_clash_ok never; its conformers equal the CPU's."""
    from tscode_tpu_torch import torsions as tt
    from tscode_tpu_torch.suite_inputs import chloroalkane
    coords, nos = chloroalkane(8)
    out = {}
    for dev in (cuda_device, 'cpu'):
        clash.KERNEL.reset_counts()
        rec = {}
        out[str(dev)] = tt.csearch(coords, nos, n_out=50, stats=rec,
                                   rng=np.random.RandomState(0), device=dev,
                                   logfunction=lambda *a, **k: None)
        if dev != 'cpu':
            assert clash.launches_by_entry() == {
                'clash_ok': 0, 'compenetration_mask_kernel': 0,
                'torsion_clash_ok': 0, 'torsion_backoff': rec['torsions']}
    card, cpu = out[str(cuda_device)], out['cpu']
    assert card.shape == cpu.shape and np.abs(card - cpu).max() <= 1e-9


K1_BATCHES = (1, 15, 16, 17, 4099, 415872)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('N', [8, 11, 12, 15])
def test_clash_ring_kernel_matches_plain(cuda_device, dtype, N):
    """K1's thread regime (the ring kernel) and the v1 kernel against
    plain off ties at every batch size of phase 3, max_clashes 0 and 3,
    on an aligned batch and on the slice poses[1:] (its base off the
    16-byte grid for N = 11 and 15): bulk tiles for the aligned batch,
    granule tiles for the slice."""
    pm = cross_fragment_pair_mask((N // 2, N - N // 2))
    pairs = torch.as_tensor(clash.static_pairs(pm), device=cuda_device)
    rng = np.random.default_rng(N)
    full = torch.as_tensor(rng.normal(size=(max(K1_BATCHES) + 1, N, 3))
                           * 2.2, dtype=dtype, device=cuda_device)
    for B in K1_BATCHES:
        for where, poses in (('aligned', full[:B]), ('offset', full[1:B + 1])):
            P = poses.double()
            pl = pairs.long()
            d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
            keep = ~((d2 - 2.25).abs() < 1e-4).any(dim=1)
            for mc in (0, 3):
                want = clash.clash_ok_plain(poses, pairs, 1.5, mc)
                clash.reset_tile_paths()
                got = clash.launch(poses, pairs, 1.5, mc, 'thread')
                paths = clash.tile_paths()
                v1 = clash.launch(poses, pairs, 1.5, mc, 'v1')
                assert torch.equal(got[keep], want[keep])
                assert torch.equal(v1[keep], want[keep])
                if where == 'aligned' and B % clash.THREAD_TILE == 0:
                    assert paths['granule'] == 0
                if poses.data_ptr() % 16:
                    assert paths['bulk'] == 0
                assert sum(paths.values()) == -(-B // clash.THREAD_TILE)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('frags', [(2500, 2500), (10, 4990)])
def test_clash_large_poses_match_plain(cuda_device, dtype, frags):
    """5,000-atom poses, too large for the ring kernel, with P < 64 (a
    fragment pair of 6 x 9 atoms inside a screen of two large fragments,
    listed by hand) and with P >= 64 where two warp-regime slots do not
    fit in float64: the thread regime launches the v1 kernel, equal off
    ties to the plain direct differences of the pair list (the matmul
    form would need the 5,000 x 5,000 distance matrices)."""
    N = sum(frags)
    rng = np.random.default_rng(N + frags[0])
    if frags[0] == 2500:
        pairs_np = np.array([(i, 2500 + j) for i in range(6)
                             for j in range(9)], dtype=np.int32)
        spread = 2.2
    else:
        pairs_np = clash.static_pairs(cross_fragment_pair_mask(frags))
        spread = 26.4     # about one clash a pose over 49,900 pairs
    pairs = torch.as_tensor(pairs_np, device=cuda_device)
    poses = torch.as_tensor(rng.normal(size=(67, N, 3)) * spread,
                            dtype=dtype, device=cuda_device)
    if frags[0] == 2500 or dtype == torch.float64:
        assert clash.clash_regime(len(pairs_np), N,
                                  poses.element_size()) == 'thread'
    P = poses.double()
    pl = pairs.long()
    d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
    keep = ~((d2 - 2.25).abs() < 1e-4).any(dim=1)
    for mc in (0, 3):
        clash.KERNEL.reset_counts()
        got = clash.clash_ok(poses, pairs, 1.5, mc)
        want = clash.pair_clash_ok_plain(poses, pairs, 1.5, mc)
        assert torch.equal(got[keep], want[keep])
        assert 0 < int(want.sum()) < len(want) or mc
        if clash.clash_regime(len(pairs_np), N,
                              poses.element_size()) == 'thread':
            sym = 'clash_ok_v1_f64' if dtype == torch.float64 \
                else 'clash_ok_v1_f32'
            assert clash.KERNEL.entry_launches[sym] == 1


def formic_conformers(n=5, seed=2):
    '''HCOOH with its O-H turned about the C-O bond from 0 to 180
    degrees in n steps, each jittered by 0.05 A, and its atomic numbers.'''
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    from tscode_tpu_torch.rot_rmsd import _rotate
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    mask = np.zeros(5, dtype=bool)
    mask[4] = True
    rng = np.random.default_rng(seed)
    confs = np.array([_rotate(mol.atomcoords[0], (1, 0, 3, 4), a, mask)
                      for a in np.linspace(0, 180, n)])
    return confs + rng.normal(size=confs.shape) * 0.05, mol.atomnos


def test_dimer_on_card_matches_cpu(cuda_device):
    '''The dimer's 300 steps in one launch of D1 (ops/kernels/dimer, every
    step inside) on a jittered HCOOH, against the CPU's op by op run,
    float64: coordinates within 1e-6 A, energy within 1e-6 kcal/mol, the
    same flag; one launch a structure on the card, no graph captured.'''
    from tscode_tpu_torch import capture
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.ops.kernels import dimer
    from tscode_tpu_torch.saddle import saddle_refine_structure
    confs, nos = formic_conformers()
    out = {}
    graphs, launches = len(capture._graphs), dimer.KERNEL.launches
    for key, x in (('first', confs[1]), ('second', confs[3])):
        for device in ('cpu', cuda_device):
            out[key, str(device)] = saddle_refine_structure(
                x, nos, graphize(confs[0], nos), device=device)
    assert len(capture._graphs) == graphs
    assert dimer.KERNEL.launches == launches + 2
    for key in ('first', 'second'):
        (c, e, done), (cc, ce, cdone) = out[key, 'cpu'], \
            out[key, str(cuda_device)]
        assert np.abs(cc - c).max() <= 1e-6 and abs(ce - e) <= 1e-6
        assert cdone == done


def dimer_card_case(device, name, B, dtype=torch.float64):
    '''(x (B, N, 3) on `device`, ff.FireTerms of one topology) for D1:
    'hcooh' jittered HCOOH (seed 2, which latches `done` at step 25) and,
    for B = 3, the twin's frames after 10 and 20 of its steps (latching
    at 11 and 4 more); 'ring' the SADDLE scan's sub-peak guess 0 on the
    nine-carbon ring and, for B = 3, guess 1 and guess 0 jittered by 0.02
    A, on guess 0's tables.'''
    from tscode_tpu_torch import ff
    from tscode_tpu_torch.ops.kernels import dimer
    from torch_parity import dimer_case
    x, params = dimer_case(name, 2 if name == 'hcooh' else 0)
    terms = ff.FireTerms(ff.params_to_device(params, 'cpu', torch.float64))
    frames = [torch.as_tensor(x)[None]]
    if B == 3 and name == 'hcooh':
        frames += [dimer.dimer_plain(frames[0], terms, n_steps=k)[0]
                   for k in (10, 20)]
    elif B == 3:
        frames += [torch.as_tensor(dimer_case('ring', 1)[0])[None],
                   frames[0] + torch.as_tensor(np.random.default_rng(
                       3).normal(size=x.shape) * 0.02)]
    terms = ff.FireTerms(ff.params_to_device(params, device, dtype))
    return torch.cat(frames).to(device, dtype), terms


@pytest.mark.parametrize('B', [1, 3])
@pytest.mark.parametrize('name, n_steps', [('hcooh', 300), ('ring', 100)])
def test_dimer_kernel_matches_plain(cuda_device, name, n_steps, B):
    '''D1 against its plain twin (dimer_plain), float64: coordinates
    within 1e-6 A, the same done flags and steps taken; one launch a
    call (the lone form); two launches the same bits, and every form on
    one block (lone at every width, large on a cluster of one, staged)
    the same bits as the plan's: the same sums in the same order. (On a cluster of more blocks the large form adds the blocks'
    sums in rank order: test_dimer_every_form_on_the_cases.)'''
    from tscode_tpu_torch.ops.kernels import dimer
    x, terms = dimer_card_case(cuda_device, name, B)
    assert dimer.plan_for(x, terms).form == 'lone'
    before = dimer.KERNEL.launches
    c, done, steps = dimer.dimer(x, terms, n_steps)
    assert dimer.KERNEL.launches == before + 1
    pc, pdone, psteps = dimer.dimer_plain(x, terms, n_steps)
    assert float((c - pc).abs().max()) <= 1e-6
    assert torch.equal(done, pdone) and torch.equal(steps, psteps)
    assert float((c - x).abs().max()) > 1e-4
    if name == 'hcooh':
        assert bool(done.all()) and int(steps.max()) < n_steps
    plans = [dimer.plan_for(x, terms, form) for form in dimer.FORMS
             if form != 'large']
    plans += [dimer.plan_for(x, terms, 'lone', warps=w)
              for w in dimer.LONE_WIDTHS]
    plans.append(dimer.plan_for(x, terms, 'large', cluster=1))
    for plan in plans:
        got = dimer.launch(x, terms, n_steps, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(got, (c, done, steps)))


def test_dimer_kernel_matches_the_graph_path(cuda_device):
    '''D1 against the captured dimer step replayed 300 times
    (saddle._dimer_step under capture.graph_loop, torch.autograd forces)
    on the ring's sub-peak guess, float64: coordinates within 1e-6 A, the
    same flag.'''
    from tscode_tpu_torch import capture, ff, saddle
    from tscode_tpu_torch.ops.kernels import dimer
    x, terms = dimer_card_case(cuda_device, 'ring', 1)
    body = saddle._dimer_step(ff.ff_energy, 12, 1e-3, 0.02, 0.05)
    state = (x[0], saddle.dimer_start(x[0]),
             torch.zeros((), dtype=torch.bool, device=cuda_device))
    gc, _, gdone = capture.graph_loop(body, state, (terms.params,), 300)
    c, done, steps = dimer.dimer(x, terms, 300)
    assert float((c[0] - gc).abs().max()) <= 1e-6
    assert bool(done[0]) == bool(gdone)


def test_dimer_kernel_any_size(cuda_device):
    '''A 2,500-atom chain (~3.1M repulsion pairs), 10 steps, float64: the
    large form (a cluster of 16 blocks, the copies in each block's shared
    memory) and the large form past shared memory (a cluster of 2: the
    copies in device memory) each within 1e-6 A of the plain twin, the
    same flags and steps; two launches the same bits.'''
    from tscode_tpu_torch import ff
    from tscode_tpu_torch.ops.kernels import dimer
    from tscode_tpu_torch.suite_inputs import chain_ff
    X, ffp = chain_ff(2500, 1, seed=13)
    terms = ff.FireTerms(ff.params_to_device(ffp, cuda_device,
                                             torch.float64))
    x = torch.as_tensor(X, device=cuda_device)
    plan = dimer.plan_for(x, terms)
    assert (plan.form, plan.cluster, plan.shared) == ('large', 16, True)
    pc, pdone, psteps = dimer.dimer_plain(x, terms, 10)
    for plan in (plan, dimer.plan_for(x, terms, 'large', cluster=2)):
        c, done, steps = dimer.launch(x, terms, 10, plan=plan)
        c2, _, _ = dimer.launch(x, terms, 10, plan=plan)
        assert torch.equal(c, c2)
        assert float((c - pc).abs().max()) <= 1e-6
        assert torch.equal(done, pdone) and torch.equal(steps, psteps)
        assert float((c - x).abs().max()) > 1e-4


def dimer_form_case(device, name):
    '''(x (1, N, 3) float64, ff.FireTerms, steps) on `device`: saddle>'s
    C2F2H4 (the monomolecular input's first conformer, 8 atoms, 300
    steps), the SADDLE scan's sub-peak guess (27 atoms, 100 steps), a
    150-atom suite_inputs.chain_ff chain (30 steps).'''
    import tempfile
    from tscode_tpu_torch import ff
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.suite_inputs import chain_ff
    if name == 'ring':
        x, terms = dimer_card_case(device, 'ring', 1)
        return x, terms, 100
    if name == 'c2f2h4':
        with tempfile.TemporaryDirectory() as tmp:
            ens = read_xyz(os.path.join(os.path.dirname(
                config_files('monomolecular', tmp, 2)), 'm1.xyz'))
        X, nos = np.asarray(ens.atomcoords)[0], np.asarray(ens.atomnos)
        params, n = ff.build_ff_params(X, nos, graphize(X, nos)), 300
    else:
        X, params = chain_ff(150, 1, seed=13)
        X, n = X[0], 30
    terms = ff.FireTerms(ff.params_to_device(params, device, torch.float64))
    return torch.as_tensor(X, device=device)[None], terms, n


@pytest.mark.parametrize('name', ['c2f2h4', 'ring', 'chain150'])
def test_dimer_every_form_on_the_cases(cuda_device, name):
    '''Every form of D1 that fits, the lone form at each width and the
    large form on each cluster of 1, 2, 4, 8 and 16, on saddle>'s
    C2F2H4, the scan's guess and a 150-atom chain, float64: within 1e-6 A
    of the plain twin, the same flags and steps, two launches the same
    bits.'''
    from tscode_tpu_torch.ops.kernels import dimer
    x, terms, n = dimer_form_case(cuda_device, name)
    plans = [dimer.plan_for(x, terms, 'large', cluster=c)
             for c in (1, 2, 4, 8, 16)]
    for form in dimer.FORMS:
        for w in dimer.LONE_WIDTHS if form == 'lone' else (None,):
            try:
                plans.append(dimer.plan_for(
                    x, terms, form, **({'warps': w} if w else {})))
            except ValueError:
                assert form in ('lone', 'staged') and name == 'chain150'
    pc, pdone, psteps = dimer.dimer_plain(x, terms, n)
    for plan in plans:
        c, done, steps = dimer.launch(x, terms, n, plan=plan)
        again = dimer.launch(x, terms, n, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(again, (c, done, steps)))
        assert float((c - pc).abs().max()) <= 1e-6, plan
        assert torch.equal(done, pdone) and torch.equal(steps, psteps)


@pytest.mark.parametrize('name', ['hcooh', 'ring'])
def test_dimer_kernel_float32(cuda_device, name):
    '''D1 in float32, 10 steps: finite, two launches the same bits, no
    atom moved past the step clip (0.1 A a step). On HCOOH also within
    1e-3 A of the float32 twin and of the float64 kernel; on the ring's
    guess float32's rounding picks another soft mode within a few steps
    (0.07 A from float64 after 10 steps in the twin), so there no
    agreement is asked.'''
    from tscode_tpu_torch.ops.kernels import dimer
    x, terms = dimer_card_case(cuda_device, name, 3, torch.float32)
    c, done, steps = dimer.dimer(x, terms, 10)
    again = dimer.dimer(x, terms, 10)
    assert c.dtype == torch.float32 and bool(torch.isfinite(c).all())
    assert all(torch.equal(a, b) for a, b in zip(again, (c, done, steps)))
    assert float(torch.linalg.norm(c - x, dim=-1).max()) <= 1.0 + 1e-4
    if name == 'hcooh':
        pc = dimer.dimer_plain(x, terms, 10)[0]
        x64, terms64 = dimer_card_case(cuda_device, name, 3)
        c64 = dimer.dimer(x64, terms64, 10)[0]
        assert float((c - pc).abs().max()) <= 1e-3
        assert float((c.double() - c64).abs().max()) <= 1e-3


def test_neb_on_card_matches_cpu(cuda_device):
    '''run_neb between two HCOOH conformers (IDPP band of 7 images, 400
    plain then 400 climbing steps) against the CPU run, float64: band
    within 1e-6 A, energies within 1e-6 kcal/mol, the same TS image. On
    the card the IDPP band is one launch of I1 and each band phase one
    launch of N1, no graph captured. A second run, after the memory the
    first one let go has been refilled with NaN, must agree as well.'''
    import torch
    from tscode_tpu_torch import capture, ff
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.neb import run_neb
    from tscode_tpu_torch.ops.kernels import idpp
    from tscode_tpu_torch.ops.kernels import neb as kn
    confs, nos = formic_conformers()
    params = ff.build_ff_params(confs[0], nos, graphize(confs[0], nos))

    def neb(device):
        return run_neb(confs[0], confs[-1], ff.ff_energy, device=device,
                       energy_args=(ff.params_to_device(params, device,
                                                        torch.float64),))
    want = neb('cpu')
    graphs = len(capture._graphs)
    n1, i1 = kn.KERNEL.launches, idpp.KERNEL.launches
    first = neb(cuda_device)
    junk = [torch.full((n,), float('nan'), dtype=torch.float64,
                       device=cuda_device) for n in range(1, 2000)]
    second = neb(cuda_device)
    del junk
    assert len(capture._graphs) == graphs
    assert kn.KERNEL.launches == n1 + 4 and idpp.KERNEL.launches == i1 + 2
    c, e, ts = want
    for cc, ce, cts in (first, second):
        assert np.abs(cc - c).max() <= 1e-6
        assert np.abs(ce - e).max() <= 1e-6 and cts == ts


def ff_energy_no_terms(c, params):
    '''ff.ff_energy without its `fire_terms`: an energy N1 does not
    take, so that run_neb replays its band step from a CUDA graph.'''
    from tscode_tpu_torch import ff
    return ff.ff_energy(c, params)


def test_neb_graph_route_on_card_matches_cpu(cuda_device):
    '''run_neb between two HCOOH conformers on an energy without
    `fire_terms` (each band phase one captured band step replayed,
    graph_loop) against the CPU run, float64: band within 1e-6 A,
    energies within 1e-6 kcal/mol, the same TS image; no N1 launch, the
    IDPP band one launch of I1. A second run of the same shapes, after
    the memory the first one let go has been refilled with NaN, replays
    the cached graphs and must agree as well.'''
    import torch
    from tscode_tpu_torch import capture, ff
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.neb import run_neb
    from tscode_tpu_torch.ops.kernels import idpp
    from tscode_tpu_torch.ops.kernels import neb as kn
    confs, nos = formic_conformers()
    params = ff.build_ff_params(confs[0], nos, graphize(confs[0], nos))

    def neb(device):
        return run_neb(confs[0], confs[-1], ff_energy_no_terms,
                       device=device,
                       energy_args=(ff.params_to_device(params, device,
                                                        torch.float64),))
    want = neb('cpu')
    n1, i1 = kn.KERNEL.launches, idpp.KERNEL.launches
    first = neb(cuda_device)
    graphs = set(capture._graphs)
    junk = [torch.full((n,), float('nan'), dtype=torch.float64,
                       device=cuda_device) for n in range(1, 2000)]
    second = neb(cuda_device)
    del junk
    assert set(capture._graphs) == graphs
    assert kn.KERNEL.launches == n1 and idpp.KERNEL.launches == i1 + 2
    c, e, ts = want
    for cc, ce, cts in (first, second):
        assert np.abs(cc - c).max() <= 1e-6
        assert np.abs(ce - e).max() <= 1e-6 and cts == ts


def neb_card_band(device, name):
    '''(band (7, N, 3) float64, ff.FireTerms, steps) on `device`: the IDPP
    band (the CPU's) between HCOOH's O-H rotor ends (400 steps), between
    the SADDLE scan's sub-peak guesses 0 and 1 of the nine-carbon ring
    (400 steps), between two conformers of a 150-atom chain_ff chain (30
    steps), and between C2H4 and a copy with its hydrogens jittered by
    0.2 A (seed 2) on its tables with the E/Z dihedral, a spring and a
    half-spring (every term kind; 200 steps).'''
    from tscode_tpu_torch import ff, neb
    from tscode_tpu_torch.graphs import graphize
    from torch_parity import dimer_case
    springs = {}
    if name == 'c2h4':
        from tscode_tpu_torch.io_xyz import read_xyz
        from tscode_tpu_torch.pipeline import FIXTURE_DIR
        mol = read_xyz(os.path.join(FIXTURE_DIR, 'C2H4.xyz'))
        a, nos = mol.atomcoords[0], mol.atomnos
        b = a + (nos != 6)[:, None] * np.random.default_rng(2).normal(
            size=a.shape) * 0.2
        params, n = ff.build_ff_params(a, nos, graphize(a, nos),
                                       protect_double_bonds=True), 200
        assert len(params.dihedrals)
        springs = dict(
            spring_pairs=torch.tensor([[0, 3]], device=device),
            spring_targets=torch.tensor([2.3], dtype=torch.float64,
                                        device=device),
            spring_k=5.0, half_pairs=torch.tensor([[2, 5]], device=device),
            half_k=3.0)
    elif name == 'hcooh':
        confs, nos = formic_conformers()
        a, b = confs[0], confs[-1]
        params, n = ff.build_ff_params(a, nos, graphize(a, nos)), 400
    elif name == 'ring':
        a, params = dimer_case('ring', 0)
        b, n = dimer_case('ring', 1)[0], 400
    else:
        from tscode_tpu_torch.suite_inputs import chain_ff
        X, params = chain_ff(150, 2, seed=13)
        a, b, n = X[0], X[1], 30
    band = neb.idpp_interpolate(a, b, 7, device='cpu')
    terms = ff.FireTerms(ff.params_to_device(params, device, torch.float64),
                         **springs)
    return torch.as_tensor(band, device=device), terms, n


@pytest.mark.parametrize('climbing', [False, True])
@pytest.mark.parametrize('name', ['hcooh', 'ring', 'chain150', 'c2h4'])
def test_neb_kernel_matches_plain(cuda_device, name, climbing):
    '''N1 against its plain twin (neb_relax_plain), float64: the band
    within 1e-6 A, the same done flag and steps taken, in the rule's
    plan, the lone form, the large form on each cluster of 1 to 5 blocks
    and the grid form on the card's resident blocks, on 3 and on 1 (the
    band algebra of several images a block); every plan the bits of the
    lone form; one launch a call; two launches the same bits. The twin's
    near ties are counted and none is allowed.'''
    from tscode_tpu_torch.ops.kernels import neb as kn
    x, terms, n = neb_card_band(cuda_device, name)
    pc, pdone, psteps, ties = kn.neb_relax_plain(x, terms, n,
                                                 climbing=climbing)
    assert ties == 0
    before = kn.KERNEL.launches
    got = kn.neb_band(x, terms, n, climbing=climbing)
    assert kn.KERNEL.launches == before + 1
    plans = [kn.plan_for(x, terms, 'lone')]
    plans += [kn.plan_for(x, terms, 'large', cl) for cl in range(1, 6)]
    plans += [kn.plan_for(x, terms, 'grid', cl) for cl in (None, 3, 1)]
    first = None
    for plan in plans:
        c, done, steps = kn.launch(x, terms, n, climbing=climbing, plan=plan)
        again = kn.launch(x, terms, n, climbing=climbing, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(again, (c, done, steps)))
        first = c if first is None else first
        assert torch.equal(c, first), plan
        assert float((c - pc).abs().max()) <= 1e-6, plan
        assert bool(done) == bool(pdone) and int(steps) == int(psteps)
    assert float((got[0] - pc).abs().max()) <= 1e-6
    assert float((got[0] - x).abs().max()) > 1e-4


def test_neb_kernel_any_size(cuda_device):
    '''A band of 7 images of a 2,500-atom chain (~3.1M repulsion pairs
    an image), 10 climbing steps, float64: the large form (the interior
    images' arrays in device memory, past shared memory) on 5 and 2
    blocks, and on a 1,000-atom chain (its arrays in shared memory, 5
    blocks), and the grid form on the card's resident blocks on both,
    each within 1e-6 A of the plain twin, the same flag and steps; two
    launches the same bits; the forms the same bits.'''
    from tscode_tpu_torch import ff, neb
    from tscode_tpu_torch.ops.kernels import neb as kn
    from tscode_tpu_torch.suite_inputs import chain_ff
    for n_atoms, shared in ((2500, False), (1000, True)):
        X, ffp = chain_ff(n_atoms, 2, seed=13)
        terms = ff.FireTerms(ff.params_to_device(ffp, cuda_device,
                                                 torch.float64))
        x = torch.as_tensor(neb.interpolate_chain(X[0], X[1], 7),
                            device=cuda_device)
        assert kn.plan_for(x, terms).form == 'grid'
        plan = kn.plan_for(x, terms, 'large')
        assert (plan.form, plan.cluster, plan.shared) == ('large', 5, shared)
        pc, pdone, psteps, _ = kn.neb_relax_plain(x, terms, 10,
                                                  climbing=True)
        plans = [plan, kn.plan_for(x, terms, 'grid')] + (
            [kn.plan_for(x, terms, 'large', 2)] if n_atoms == 2500 else [])
        first = None
        for plan in plans:
            c, done, steps = kn.launch(x, terms, 10, climbing=True, plan=plan)
            c2 = kn.launch(x, terms, 10, climbing=True, plan=plan)[0]
            assert torch.equal(c, c2)
            first = c if first is None else first
            assert torch.equal(c, first), plan
            assert float((c - pc).abs().max()) <= 1e-6
            assert bool(done) == bool(pdone) and int(steps) == int(psteps)
            assert float((c - x).abs().max()) > 1e-4


@pytest.mark.parametrize('name', ['hcooh', 'ring', 'chain150'])
def test_idpp_kernel_matches_plain(cuda_device, name):
    '''I1 against its plain twin (idpp_fire_plain), float64, on the
    linear band of neb_card_band's ends: within 1e-6 A, the same per-image
    stops and steps; one launch a call; two launches the same bits; and
    idpp_interpolate on the card one launch of I1, within 1e-6 A of the
    CPU's.'''
    from tscode_tpu_torch import neb
    from tscode_tpu_torch.ops.kernels import idpp
    band, _, _ = neb_card_band('cpu', name)
    a, b = band[0].numpy(), band[-1].numpy()
    chain = neb.interpolate_chain(a, b, 7)
    x = torch.as_tensor(chain, device=cuda_device)
    tables = [torch.as_tensor(t, device=cuda_device)
              for t in neb.idpp_tables(chain)]
    fmax = 0.0 if name == 'chain150' else 0.05
    n = 10 if name == 'chain150' else 300
    pc, pdone, psteps = idpp.idpp_fire_plain(x, *tables, n, fmax=fmax)
    before = idpp.KERNEL.launches
    c, done, steps = idpp.launch(x, *tables, n, fmax=fmax)
    again = idpp.launch(x, *tables, n, fmax=fmax)
    assert idpp.KERNEL.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(again, (c, done, steps)))
    assert float((c - pc).abs().max()) <= 1e-6
    assert torch.equal(done, pdone) and torch.equal(steps, psteps)
    assert int(steps.max()) > 1
    got = neb.idpp_interpolate(a, b, 7, device=cuda_device)
    assert idpp.KERNEL.launches == before + 3
    assert np.abs(got - neb.idpp_interpolate(a, b, 7, device='cpu')).max() \
        <= 1e-6


def neb_v1_case(device, name):
    '''(band, terms, steps) of neb_card_band, or the 2,500-atom chain's
    linear 7-image band (10 steps).'''
    if name != 'chain2500':
        return neb_card_band(device, name)
    from tscode_tpu_torch import ff, neb
    from tscode_tpu_torch.suite_inputs import chain_ff
    X, ffp = chain_ff(2500, 2, seed=13)
    terms = ff.FireTerms(ff.params_to_device(ffp, device, torch.float64))
    x = torch.as_tensor(neb.interpolate_chain(X[0], X[1], 7), device=device)
    return x, terms, 10


@pytest.mark.parametrize('name', ['hcooh', 'ring', 'chain150', 'c2h4',
                                  'chain2500'])
def test_neb_redesign_matches_first_design(cuda_device, name):
    '''N1 in every form of the redesign (the lone form where it fits, the
    large form on 1, 2 and 5 blocks, the grid form on the card's resident
    blocks and on 3) against N1's first design (PR 22's kernel,
    launch_v1, in its rule's plan), float64, plain then climbing: the
    same bits, the same done flag and steps; within 1e-6 A of the twin
    (not at 2,500 atoms: the twin takes minutes there).'''
    from tscode_tpu_torch.ops.kernels import neb as kn
    x, terms, n = neb_v1_case(cuda_device, name)
    big = x.shape[1] > 1000
    plans = [kn.plan_for(x, terms, 'grid'), kn.plan_for(x, terms, 'large')]
    if not big:
        plans += [kn.plan_for(x, terms, 'large', cl) for cl in (1, 2)]
        plans += [kn.plan_for(x, terms, 'grid', 3)]
        try:
            plans.append(kn.plan_for(x, terms, 'lone'))
        except ValueError:
            pass
    for climbing in (False, True):
        want = kn.launch_v1(x, terms, n, climbing=climbing)
        if not big:
            pc = kn.neb_relax_plain(x, terms, n, climbing=climbing)[0]
            assert float((want[0] - pc).abs().max()) <= 1e-6
        before = kn.V1_KERNEL.launches
        for plan in plans:
            got = kn.launch(x, terms, n, climbing=climbing, plan=plan)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), plan
        assert kn.V1_KERNEL.launches == before
        x = want[0]


def test_neb_layout_matches_the_kernels(cuda_device):
    '''ops/kernels/neb.layout (shared bytes, device values, groups,
    warps a group) equals csrc/neb_band.cu make_layout (its neb_layout
    entry) for every form on the four bands of neb_v1_case, the large
    form on 1 to 5 blocks in each of its memory placements.'''
    import ctypes
    from tscode_tpu_torch.ff import incidence
    from tscode_tpu_torch.ops.kernels import neb as kn
    lib = kn.KERNEL.build()
    fn = lib.neb_layout
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ('hcooh', 'ring', 'chain150', 'chain2500'):
        x, terms, _ = neb_v1_case(cuda_device, name)
        I, N = x.shape[0], x.shape[1]
        kinds = kn.term_kinds(terms)
        E = incidence(terms.params, N)[1].numel()
        plans = [kn.plan_for(x, terms, 'grid'),
                 kn.plan_for(x, terms, 'grid', 3)]
        for cl in range(1, 6):
            for shared, staged in ((True, True), (True, False),
                                   (False, False)):
                p = kn.plan_for(x, terms, 'large', cl)
                plans.append(p._replace(shared=shared, staged=staged))
        for staged in (True, False):
            plans.append(kn.Plan('lone', 512, 0, 1, True, staged,
                                 kn.energy_slots(kinds)))
        for plan in plans:
            out = (ctypes.c_longlong * 4)()
            assert fn(plan.args(), I, N, *kinds[:4], E, out) == 0
            want = kn.layout(plan.form, plan.threads, I, N, kinds, E,
                             plan.cluster, plan.shared, plan.staged)
            assert tuple(out) == want, (name, plan)


def test_entry_forces_on_card_match_ff_forces_plain(cuda_device):
    '''N1's entry layout on the card: entry_forces_plain (each term once,
    its vectors term-major, each atom's entries added in incidence order)
    gives ff_forces_plain's bits on the C2H4 band (every term kind) and
    the 150-atom chain's.'''
    from tscode_tpu_torch.ops.kernels import ff_fire
    from tscode_tpu_torch.ops.kernels import neb as kn
    for name in ('c2h4', 'chain150'):
        x, terms, _ = neb_card_band(cuda_device, name)
        bare = type(terms)(terms.params)
        assert torch.equal(kn.entry_forces_plain(x, bare),
                           ff_fire.ff_forces_plain(x, bare))


@pytest.mark.parametrize('name', ['hcooh', 'ring', 'chain150',
                                  'chain2500'])
def test_idpp_redesign_matches_first_design(cuda_device, name):
    '''I1 in each form of the redesign that takes the image (the lone
    form up to 32 atoms, the cluster form on 1, 2, 4 and 16 blocks and
    the rule's) against I1's first design (PR 22's kernel, launch_v1),
    float64, on the linear band of the case's ends (300 steps; the chains
    10 at fmax 0): the same bits, stops and steps.'''
    from tscode_tpu_torch import neb
    from tscode_tpu_torch.ops.kernels import idpp
    if name == 'chain2500':
        from tscode_tpu_torch.suite_inputs import chain_ff
        X, _ = chain_ff(2500, 2, seed=13)
        a, b = X[0], X[1]
    else:
        band, _, _ = neb_card_band('cpu', name)
        a, b = band[0].numpy(), band[-1].numpy()
    chain = neb.interpolate_chain(a, b, 7)
    x = torch.as_tensor(chain, device=cuda_device)
    tables = [torch.as_tensor(t, device=cuda_device)
              for t in neb.idpp_tables(chain)]
    fmax, n = (0.0, 10) if name.startswith('chain') else (0.05, 300)
    want = idpp.launch_v1(x, *tables, n, fmax=fmax)
    N = x.shape[1]
    plans = [idpp.launch_plan(N)] + [
        idpp.launch_plan(N, 'cluster', cl) for cl in (1, 2, 4, 16)
        if -(-N // cl) <= idpp.MAX_THREADS]
    if N <= idpp.LONE_ATOMS:
        plans.append(idpp.launch_plan(N, 'lone'))
    before = idpp.V1_KERNEL.launches
    for plan in plans:
        got = idpp.launch(x, *tables, n, fmax=fmax, plan=plan)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), plan
    assert idpp.V1_KERNEL.launches == before
    assert int(want[2].max()) > 1


def test_idpp_refuses_asymmetric_tables(cuda_device):
    '''The wrapper refuses tables that are not symmetric to the bit
    (ValueError) before any launch.'''
    from tscode_tpu_torch import neb
    from tscode_tpu_torch.ops.kernels import idpp
    band, _, _ = neb_card_band('cpu', 'hcooh')
    chain = neb.interpolate_chain(band[0].numpy(), band[-1].numpy(), 5)
    x = torch.as_tensor(chain, device=cuda_device)
    tg, w = (torch.as_tensor(t, device=cuda_device)
             for t in neb.idpp_tables(chain))
    w[2, 0, 1] += 1e-12
    before = idpp.KERNEL.launches
    with pytest.raises(ValueError, match='symmetric'):
        idpp.launch(x, tg, w, 10)
    assert idpp.KERNEL.launches == before


def test_hessian_on_card_matches_cpu(cuda_device):
    '''Force-field frequencies (torch.func.hessian, Eckart projection,
    eigvalsh) of one jittered HCOOH and of a batch of five, on the card
    against the CPU, float64: within 1e-9 relative, the same imaginary
    modes.'''
    import torch
    from tscode_tpu_torch import ff, vibrations
    from tscode_tpu_torch.graphs import graphize
    confs, nos = formic_conformers()
    params = ff.build_ff_params(confs[0], nos, graphize(confs[0], nos))
    out = {}
    for device in ('cpu', cuda_device):
        p = ff.params_to_device(params, device, torch.float64)

        def energy(c, p=p):
            return ff.ff_energy(c, p)
        out[str(device)] = (
            vibrations.frequencies(confs[2], nos, energy, device=device),
            vibrations.frequencies_batch(confs, nos, energy, device=device))
    (one, batch), (cone, cbatch) = out['cpu'], out[str(cuda_device)]
    np.testing.assert_allclose(cone[0], one[0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(cbatch[0], batch[0], rtol=1e-9, atol=1e-9)
    assert cone[1] == one[1]
    np.testing.assert_array_equal(cbatch[1], batch[1])


def test_ring_scan_on_card_matches_cpu(cuda_device, tmp_path):
    '''chip_smoke.py phase 18's route on the six-carbon ring (SADDLE
    dihedral scan through the Embedder: sweeps, peaks, the dimer, K3 on
    the maxima, frequencies) on the card against the CPU, float64: every
    count equal, frames and energies within 1e-6.'''
    from test_torch_suite_counts import ff_counts, same_ff_records
    for d in ('cpu', 'card'):
        (tmp_path / d).mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        want = ff_counts('port', 'dihedral_scan', 6, str(tmp_path / 'cpu'))
        got = ff_counts('port', 'dihedral_scan', 6, str(tmp_path / 'card'),
                        device=cuda_device)
    assert want['maxima'] >= 1
    same_ff_records(got, want)


def spacing_embedders(tmp_path, devices):
    '''Embedders of the adjust_spacings_batch case (C2H4 and CH3Cl,
    DIST(a=2.8)) on each device, and three poses 6 A apart.'''
    import shutil
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    for name in ('C2H4.xyz', 'CH3Cl.xyz'):
        shutil.copy(os.path.join(FIXTURE_DIR, name), tmp_path)
    inp = tmp_path / 'input.txt'
    inp.write_text('NOOPT DIST(a=2.8)\nC2H4.xyz 0a\nCH3Cl.xyz 0a\n')
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            embs = [Embedder(str(inp), stamp=f's{i}', device=d)
                    for i, d in enumerate(devices)]
    finally:
        os.chdir(cwd)
    e = embs[0]
    rng = np.random.default_rng(5)
    poses = np.stack([np.concatenate([
        e.objects[0].atomcoords[0],
        e.objects[1].atomcoords[0] + np.array([6.0, 0, 0])
        + rng.normal(size=3)]) for _ in range(3)])
    return embs, poses, np.concatenate([e.objects[0].atomnos,
                                        e.objects[1].atomnos])


def test_adjust_spacings_on_card_matches_cpu(cuda_device, tmp_path):
    '''adjust_spacings_batch (two FIRE phases of 500 and 200 steps over
    the batch, each one captured step replayed) on the card against the
    CPU, float64: structures within 1e-6 A, energies within 1e-6
    kcal/mol, the same success flags.'''
    from tscode_tpu_torch.optimization import adjust_spacings_batch
    (cpu, card), poses, nos = spacing_embedders(tmp_path, ('cpu',
                                                           cuda_device))
    want = adjust_spacings_batch(cpu, poses, nos)
    got = adjust_spacings_batch(card, poses, nos)
    assert np.abs(got[0] - want[0]).max() <= 1e-6
    assert np.abs(got[1] - want[1]).max() <= 1e-6
    np.testing.assert_array_equal(got[2], want[2])
    assert want[2].all()


def test_saddle_refining_on_card_matches_cpu(cuda_device, tmp_path):
    '''The SADDLE stage on the internal force field (no calculator):
    the dimer of the first 2 candidates of sn2_string at 4 conformers,
    float64 on the card (one launch of D1 a structure, on tables merged
    over the two molecules) against the CPU: structures within 1e-6 A,
    energies within 1e-6 kcal/mol, the same flags.'''
    from tscode_tpu_torch.ops.kernels import dimer
    out = {}
    cwd = os.getcwd()
    for device in ('cpu', cuda_device):
        d = tmp_path / str(device).replace(':', '')
        d.mkdir()
        inp = config_files('sn2_string', str(d), 4)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                run = Embedder(inp, stamp='s', device=device,
                               dtype=torch.float64).run()
                run.logfile = io.StringIO()
                run.apply_mask(run.MASKABLE,
                               np.arange(len(run.structures)) < 2)
                run.options.calculator = None
                before = dimer.KERNEL.launches
                run.saddle_refining()
                launches = dimer.KERNEL.launches - before
        finally:
            os.chdir(cwd)
        out[str(device)] = run
    want, got = out['cpu'], out[str(cuda_device)]
    assert np.abs(got.structures - want.structures).max() <= 1e-6
    assert np.abs(got.energies - want.energies).max() <= 1e-6
    np.testing.assert_array_equal(got.exit_status, want.exit_status)
    assert launches == 2


def test_optimisation_route_on_card_matches_cpu(cuda_device, tmp_path):
    '''sn2_string without NOOPT at 4 conformers (the calculators chosen
    by keyword, every calculator call answered in process by the
    stand-in xtb of tests/torch_standin, a test double), float64 on the
    card against the CPU: every count, stage energy, exit status and
    final frame (opt_records.same_records), the RMSD prunes on K3.'''
    from tscode_tpu_torch import opt_records
    recs = {}
    for device in ('cpu', cuda_device):
        d = tmp_path / str(device).replace(':', '')
        d.mkdir()
        before = qcp.KERNEL.launches
        with contextlib.redirect_stdout(io.StringIO()):
            recs[str(device)] = opt_records.record(
                opt_records.port_package(device), 'sn2_string_opt', 4,
                str(d), keywords='RMSD=0.02')
        launches = qcp.KERNEL.launches - before
    want, got = recs['cpu'], recs[str(cuda_device)]
    assert not opt_records.energy_ties(want)
    opt_records.same_records(got, want)
    assert launches > 0 and want['final'] > 0


# ------------------------------------------------------- multi-device


def test_kernels_launch_on_their_tensors_card(cuda_device):
    '''K1, K2 and K3 on tensors placed on cuda:1 while cuda:0 is the
    current device, against their plain twins; FIRE's captured graph, the
    force field's FIRE kernel, N1, I1, G1 and V1 too. It needs two cards:
    the one-card machine that runs chip_smoke.py skips it, so it is not
    verified there.'''
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two GPUs: the kernels must launch on the card '
                    'of their tensors, not on the current device')
    from tscode_tpu_torch.embeds.string import spin_angles
    from tscode_tpu_torch.ops.kernels import string_grid as g1
    from tscode_tpu_torch.ops.kernels import tfd_novelty as v1
    from tscode_tpu_torch.optimizers import fire_minimize_batch
    dev1 = torch.device('cuda', 1)
    rng = np.random.default_rng(21)
    pm = cross_fragment_pair_mask((6, 5))
    with torch.cuda.device(0):
        for n_atoms, sigma in ((11, 2.2), (160, 2.0)):     # thread, warp
            if n_atoms == 11:
                poses = torch.as_tensor(rng.normal(size=(4099, 11, 3))
                                        * sigma, device=dev1)
                mask = pm
            else:
                poses = torch.as_tensor(big_fragment_poses(rng, 512, 80),
                                        device=dev1)
                mask = cross_fragment_pair_mask((80, 80))
            pairs = torch.as_tensor(clash.static_pairs(mask), device=dev1)
            want = clash.clash_ok_plain(poses, pairs, 1.5)
            assert torch.equal(clash.clash_ok(poses, pairs, 1.5), want)
            assert torch.equal(
                clash.compenetration_mask_kernel(poses, mask, 1.5), want)
        hs = torch.as_tensor(near_dup_pool(rng, 3000, 4, 700), device=dev1)
        act, end = pass_chunks(torch.ones(3000, dtype=torch.bool,
                                          device=dev1), 3000, 10)
        assert torch.equal(qcp.qcp_kill(hs, act, end, 0.5),
                           qcp.qcp_kill_plain(hs, act, end, 0.5))
        x = torch.as_tensor(rng.normal(size=(7, 6, 3)), device=dev1)
        center = torch.as_tensor(rng.normal(size=(6, 3)), device=dev1)

        def energy(c, center):
            return torch.sum((c - center) ** 2, dim=(-2, -1))
        got = fire_minimize_batch(x, energy, n_steps=50,
                                  energy_args=(center,))
        want = fire_minimize_batch(x.cpu(), energy, n_steps=50,
                                   energy_args=(center.cpu(),))
        assert got[0].device == dev1
        assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-9
        # the force field's FIRE kernel
        from tscode_tpu_torch.ops.kernels import ff_fire
        x, terms, _, _ = fire_kernel_case(dev1, 'batch', torch.float64)
        got = ff_fire.ff_fire(x, terms, 100)
        want = ff_fire.ff_fire_plain(x, terms, 100)
        assert got[0].device == dev1
        assert float((got[0] - want[0]).abs().max()) <= 1e-6
        assert torch.equal(got[1], want[1])
        # the NEB band and IDPP kernels
        from tscode_tpu_torch.neb import idpp_tables
        from tscode_tpu_torch.ops.kernels import idpp
        from tscode_tpu_torch.ops.kernels import neb as kn
        band, terms, _ = neb_card_band(dev1, 'hcooh')
        got = kn.neb_band(band, terms, 100, climbing=True)
        want = kn.neb_relax_plain(band, terms, 100, climbing=True)
        assert got[0].device == dev1
        assert float((got[0] - want[0]).abs().max()) <= 1e-6
        want_band = want[0]
        tables = [torch.as_tensor(t, device=dev1)
                  for t in idpp_tables(band.cpu().numpy())]
        got = idpp.idpp_fire(band, *tables, 50)
        want = idpp.idpp_fire_plain(band, *tables, 50)
        assert got[0].device == dev1
        assert float((got[0] - want[0]).abs().max()) <= 1e-6
        # every form of both, and their first designs, on cuda:1
        for form in kn.FORMS:
            got = kn.launch(band, terms, 100, climbing=True, form=form)
            assert got[0].device == dev1
            assert float((got[0] - want_band).abs().max()) <= 1e-6
        got = kn.launch_v1(band, terms, 100, climbing=True)
        assert float((got[0] - want_band).abs().max()) <= 1e-6
        for plan in (idpp.launch_plan(5), idpp.launch_plan(5, 'cluster')):
            got = idpp.launch(band, *tables, 50, plan=plan)
            assert got[0].device == dev1
            assert float((got[0] - want[0]).abs().max()) <= 1e-6
        got = idpp.launch_v1(band, *tables, 50)
        assert float((got[0] - want[0]).abs().max()) <= 1e-6
        # G1, the string grid, in both regimes, and V1, the novelty filter
        for N1, N2 in ((6, 5), (40, 40)):
            inp = grid_inputs(rng, 3, 4, N1, N2, 2, 1, torch.float64, dev1)
            angles = spin_angles(36, torch.float64, dev1)
            got, ok = g1.string_grid(inp, angles, 0, 4, 1.5, heavy=True)
            want, want_ok = g1.string_grid_order_plain(inp, angles, 0, 4,
                                                       1.5, heavy=True)
            assert got.device == dev1
            assert torch.equal(ok, want_ok) and torch.equal(got, want)
        fps = torch.as_tensor(novelty_fps(rng, 20000, 8, 200, 0.5),
                              device=dev1)
        novel, state = v1.tfd_novelty(fps)
        plain, p_ok, n, _ = v1.novelty_plain(fps)
        assert novel.device == dev1 and p_ok
        assert torch.equal(novel, plain) and state.tolist() == [n, 1]
        torch.cuda.synchronize(dev1)


def test_device_guard_switches_only_to_another_card(cuda_device):
    '''A launch on the current card sets no device; on another card it
    enters that card and restores the current one afterwards.'''
    from tscode_tpu_torch.ops.kernels._build import device_guard
    here = torch.device('cuda', torch.cuda.current_device())
    assert isinstance(device_guard(here), contextlib.nullcontext)
    if torch.cuda.device_count() > 1:
        with torch.cuda.device(0):
            with device_guard(torch.device('cuda', 1)):
                assert torch.cuda.current_device() == 1
            assert torch.cuda.current_device() == 0


def card_mesh():
    from tscode_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(devices=['cuda:0'] * 4)


@pytest.mark.parametrize('dtype', DTYPES)
def test_sharded_ops_on_a_card_mesh_match_unsharded(cuda_device, dtype):
    '''K2 per shard, the TFD first-successor and moments sharded, and
    the RMSD prune with every pass split over four slices (K3 per
    slice), on a mesh naming cuda:0 four times, against one device.'''
    from tscode_tpu_torch.ops.tfd import _first_similar_successor
    from tscode_tpu_torch.parallel import prune as pp
    from tscode_tpu_torch.parallel import sharding as sh
    mesh = card_mesh()
    rng = np.random.default_rng(23)
    pm = cross_fragment_pair_mask((6, 5))
    poses = torch.as_tensor(rng.normal(size=(4099, 11, 3)) * 2.2,
                            dtype=dtype, device=cuda_device)
    clash.KERNEL.reset_counts()
    got = sh.sharded_compenetration_mask(poses, pm, mesh, 1.5)
    assert clash.launches_by_entry()['compenetration_mask_kernel'] == 4
    assert np.array_equal(
        got, clash.compenetration_mask_kernel(poses, pm, 1.5).cpu().numpy())

    tf = torch.as_tensor(rng.uniform(-180, 180, size=(5, 6))[
        rng.integers(0, 5, 3000)] + rng.normal(size=(3000, 6)) * 3,
        dtype=torch.float32, device=cuda_device)
    tfd_k.KERNEL.reset_counts()
    assert np.array_equal(sh.sharded_first_similar_successor(tf, 10.0, mesh),
                          _first_similar_successor(tf, 10.0))
    assert tfd_k.KERNEL.launches == 4

    hs = torch.as_tensor(near_dup_pool(rng, 6000, 4, 1500), dtype=dtype,
                         device=cuda_device)
    want = prune_conformers_rmsd_device(hs, pair_kill=qcp.qcp_kill_plain)
    qcp.KERNEL.reset_counts()
    got = pp.sharded_prune_rmsd(hs, mesh)
    assert np.array_equal(got, want)
    assert qcp.KERNEL.launches >= 4 * 2


def test_sharded_routes_on_a_card_mesh_match_unsharded(cuda_device,
                                                       tmp_path,
                                                       monkeypatch):
    '''The string sweep, the sharded FIRE and adjust_spacings_batch under
    a cuda:0 x 4 mesh, float64, against the unsharded runs: the same
    survivors, geometry within 1e-9 A.'''
    from tscode_tpu_torch.embeds.string import string_embed
    from tscode_tpu_torch.optimization import adjust_spacings_batch
    from tscode_tpu_torch.optimizers import (fire_minimize_batch,
                                             fire_minimize_batch_sharded)
    from tscode_tpu_torch.parallel.sharding import default_mesh
    mesh = card_mesh()
    d = tmp_path / 'sn2'
    d.mkdir()
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            sn2 = Embedder(config_files('sn2_string', str(d), 8),
                           stamp='sn2', device=cuda_device)
    finally:
        os.chdir(cwd)
    from tscode_tpu_torch.embeds import string
    monkeypatch.setattr(string, 'TILE_ROWS', 2400)   # 4 tiles of 2 c2
    kw = dict(log=lambda *a: None, device=cuda_device, dtype=torch.float64)
    want = string_embed(*sn2.objects, sn2.systematic_angles, **kw)[0]
    clash.KERNEL.reset_counts()
    string_grid.KERNEL.reset_counts()
    got = string_embed(*sn2.objects, sn2.systematic_angles, mesh=mesh,
                       **kw)[0]
    # G1 a tile a shard, and no K1 on the grid
    assert string_grid.KERNEL.wrapper_launches['string_keep'] == 4
    assert clash.launches_by_entry()['clash_ok'] == 0
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-9

    (card,), poses, nos = spacing_embedders(tmp_path, (cuda_device,))
    m1, m2 = card.objects

    x = torch.as_tensor(np.concatenate([poses] * 7), device=cuda_device)
    from tscode_tpu_torch.ff import (build_ff_params, ff_energy,
                                     merge_ff_params, params_to_device)
    params = params_to_device(merge_ff_params(
        [build_ff_params(m.atomcoords[0], m.atomnos, m.graph)
         for m in (m1, m2)], np.array([0, m1.n_atoms])), cuda_device,
        torch.float64)
    want = fire_minimize_batch(x, ff_energy, n_steps=100,
                               energy_args=(params,))
    got = fire_minimize_batch_sharded(x, ff_energy, mesh, n_steps=100,
                                      energy_args=(params,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
    assert float((got[0] - want[0]).abs().max()) <= 1e-9
    assert torch.equal(got[2], want[2])

    want = adjust_spacings_batch(card, poses, nos)
    os.environ['TSCODE_MESH'] = '1'
    try:
        with default_mesh(mesh):
            got = adjust_spacings_batch(card, poses, nos)
    finally:
        del os.environ['TSCODE_MESH']
    assert np.abs(got[0] - want[0]).max() <= 1e-9
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize('name', sorted(TFD_ENSEMBLES))
def test_tfd_first_matches_twin_on_every_pass(cuda_device, monkeypatch,
                                              name):
    '''T1 in the TFD prune on the card: one launch a pass, each pass's
    first array equal to the CPU twin's bit for bit (and to the old tile
    loop and T1's first design on the same card tensor), the mask equal to
    the CPU run's.'''
    from tscode_tpu_torch.ops import tfd
    fps = TFD_ENSEMBLES[name]()
    passes = []
    entry = tfd.first_successor_pass

    def spy(tf, d, k, num_active, thresh, rows=None):
        out = entry(tf, d, k, num_active, thresh, rows)
        passes.append((tf, d, k, num_active, out.cpu().numpy()))
        return out
    monkeypatch.setattr(tfd, 'first_successor_pass', spy)
    dummy = np.zeros((len(fps), 1, 3))
    quads = np.zeros((fps.shape[1], 4), dtype=int)
    _, want = tfd.prune_conformers_tfd(dummy, quads, tf_mat=fps,
                                       device='cpu')
    on_cpu, passes[:] = list(passes), []
    tfd_k.KERNEL.reset_counts()
    _, got = tfd.prune_conformers_tfd(dummy, quads, tf_mat=fps,
                                      device=cuda_device)
    assert tfd_k.KERNEL.launches == len(passes) == len(on_cpu) >= 5
    assert np.array_equal(got, want)
    for (_, d, k, m, first), (tf, *_, card_first) in zip(on_cpu, passes):
        assert tf.is_cuda
        np.testing.assert_array_equal(card_first, first)
        old = tfd_k.first_successor_pass_plain(tf, d, k, m, 10.0)
        np.testing.assert_array_equal(old.cpu().numpy(), first)
        warp = tfd_k.first_successor_pass_warp(tf, d, k, m, 10.0)
        np.testing.assert_array_equal(warp.cpu().numpy(), first)
    assert any((f < 0).any() and (f >= 0).any() for *_, f in on_cpu)


@pytest.mark.parametrize('case', TFD_PASS_CASES)
def test_tfd_first_matches_twin_on_hand_made_passes(cuda_device, case):
    '''T1 against its twin on the passes at the reference's quirks (n
    not a multiple of 32, empty and one-row chunks, chunks past
    num_active, Q = 1 to 40), whole and in row slices; the wrapper
    refuses what the kernel does not take.'''
    n, d, k, num_active, q = case
    fps = tfd_pass_fps(n, q)
    want = tfd_k.first_successor_pass(torch.as_tensor(fps), d, k,
                                      num_active, 10.0).numpy()
    tf = torch.as_tensor(fps, device=cuda_device)
    tfd_k.KERNEL.reset_counts()
    got = tfd_k.first_successor_pass(tf, d, k, num_active, 10.0)
    assert got.is_cuda and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    for r0, r1 in ((0, n // 3), (n // 3, n - 1), (n - 1, n)):
        part = tfd_k.first_successor_pass(tf, d, k, num_active, 10.0,
                                          rows=(r0, r1))
        np.testing.assert_array_equal(part.cpu().numpy(), want[r0:r1])
        warp = tfd_k.first_successor_pass_warp(tf, d, k, num_active, 10.0,
                                               rows=(r0, r1))
        np.testing.assert_array_equal(warp.cpu().numpy(), want[r0:r1])
    assert tfd_k.KERNEL.launches == 4
    assert (want < 0).any()
    with pytest.raises(TypeError):
        tfd_k.first_successor_pass(tf.double(), d, k, num_active, 10.0)
    with pytest.raises(ValueError):
        tfd_k.first_successor_pass(tf, d, k, n + 1, 10.0)


@pytest.mark.parametrize('q', [1, 8, 33, 200])
def test_tfd_first_equals_its_first_design_on_every_plan(cuda_device, q):
    '''T1 against T1's first design (first_successor_pass_warp) bit for bit
    at Q = 1, 8, 33 and 200, on passes of seeded clustered fingerprints
    (k = 1 to 7, num_active below n, 3,001 rows: not a multiple of a
    block), whole and in the four row slices of a cuda:0 x 4 mesh, on the
    plan's tile and windows and on each other plan (tiles of 32 and the
    unstaged walk; one window or windows of two steps, which meet in an
    atomicMin).'''
    from tscode_tpu_torch.parallel import sharding as sh
    n = 3001
    tf = torch.as_tensor(tfd_pass_fps(n, q), device=cuda_device)
    plans = [None] + [tfd_k.launch_plan(q, t, seg) for t in (32, 0)
                      for seg in (0, 2 * (t or 1024))]
    mesh = card_mesh()
    hits = 0
    for k in (1, 2, 7):
        d = n // k
        for num_active in (n, d * (k - 1) + (n - d * (k - 1)) // 2):
            want = tfd_k.first_successor_pass_warp(tf, d, k, num_active,
                                                   10.0).cpu().numpy()
            hits += int((want >= 0).sum())
            for plan in plans:
                got = tfd_k.first_successor_pass(tf, d, k, num_active, 10.0,
                                                 plan=plan)
                np.testing.assert_array_equal(got.cpu().numpy(), want)
            for _, r0, r1 in sh.shard_slices(n, mesh):
                part = tfd_k.first_successor_pass(tf, d, k, num_active,
                                                  10.0, rows=(r0, r1))
                np.testing.assert_array_equal(part.cpu().numpy(),
                                              want[r0:r1])
            got = sh.sharded_first_similar_successor(
                tf, 10.0, mesh, d=d, k=k, num_active=num_active)
            np.testing.assert_array_equal(got, want)
    assert hits > 0


def grid_inputs(rng, n1c, n2c, N1, N2, k1, k2, dtype, device, spread=1.5):
    '''GridInputs of two random fragments of N1 and N2 atoms (n1c and n2c
    conformers, k1 and k2 lobes): lobe centers near each fragment's edge,
    orbital vectors of random direction; pairs close enough that some
    poses clash and some do not.'''
    from tscode_tpu_torch.embeds.common import GridInputs
    from tscode_tpu_torch.ops.clash import static_pairs

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    c1 = rng.normal(size=(n1c, N1, 3)) * spread
    c2 = rng.normal(size=(n2c, N2, 3)) * spread
    pm = cross_fragment_pair_mask((N1, N2))
    heavy = np.arange(0, N1 + N2, 2)
    return GridInputs(
        coords1=t(c1), coords2=t(c2),
        centers1=t(rng.normal(size=(n1c, k1, 3)) + [spread * 2.5, 0, 0]),
        vecs1=t(rng.normal(size=(n1c, k1, 3))),
        centers2=t(rng.normal(size=(n2c, k2, 3)) - [spread * 2.5, 0, 0]),
        vecs2=t(rng.normal(size=(n2c, k2, 3))),
        pair_mask=torch.as_tensor(pm, device=device),
        pairs=torch.as_tensor(static_pairs(pm), device=device),
        heavy_idx=torch.as_tensor(heavy, device=device))


# (n1c, n2c, N1, N2, k1, k2, A): the thread regime (P = 30, the
# headline's shape; P = 6 with 3 x 2 lobes and 37 angles), the warp
# regime (P = 1,600; P = 5,476, large_n_string's)
G1_CASES = [(5, 4, 6, 5, 2, 1, 36), (3, 7, 2, 3, 3, 2, 37),
            (4, 3, 40, 40, 1, 2, 12), (2, 3, 74, 74, 1, 1, 36)]


@pytest.mark.parametrize('case', G1_CASES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_string_grid_kernel_matches_its_twins(cuda_device, case, dtype):
    '''G1 on the whole grid and on c2 tiles: the kernel-order twin's mask
    and kept rows bit for bit (all atoms and the heavy ones), the same
    bits twice; the broadcast block with K1's plain twin the same mask
    off pairs within 1e-9 A^2 of thr^2, the kept rows within 1e-12 A
    (float64) or 1e-4 A (float32).'''
    from tscode_tpu_torch.embeds.string import bcast_poses, spin_angles
    from tscode_tpu_torch.ops.kernels import string_grid as g1
    n1c, n2c, N1, N2, k1, k2, A = case
    rng = np.random.default_rng(sum(case))
    inp = grid_inputs(rng, n1c, n2c, N1, N2, k1, k2, dtype, cuda_device)
    angles = spin_angles(A, dtype, cuda_device)
    for lo, hi in ((0, n2c), (0, 1), (1, n2c)):
        for heavy in (False, True):
            got, ok = g1.string_grid(inp, angles, lo, hi, 1.5, heavy)
            again, ok2 = g1.string_grid(inp, angles, lo, hi, 1.5, heavy)
            want, want_ok = g1.string_grid_order_plain(inp, angles, lo, hi,
                                                       1.5, heavy)
            assert torch.equal(ok, want_ok) and torch.equal(got, want)
            assert torch.equal(got, again) and torch.equal(ok, ok2)
        assert 0 < int(ok.sum()) < ok.numel()
        poses = bcast_poses(inp, angles, lo, hi)
        plain = clash.clash_ok_plain(poses, inp.pairs, 1.5)
        P = poses.double()
        pl = inp.pairs.long()
        d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
        tie = ((d2 - 2.25).abs() < 1e-9).any(dim=1)
        assert torch.equal(ok[~tie], plain[~tie])
        both = ok & plain
        got, _ = g1.string_grid(inp, angles, lo, hi, 1.5)
        tol = 1e-12 if dtype == torch.float64 else 1e-4
        assert float((got[both[ok]] - poses[both]).abs().max()) <= tol
    plan = g1.plan_for(N1, N2, N1 * N2, k1 * k2 * A, angles.element_size())
    assert plan['regime'] == ('warp' if N1 * N2 >= 64 else 'thread')


@pytest.mark.parametrize('dtype', DTYPES)
def test_string_grid_writes_into_a_pool_at_a_device_offset(cuda_device,
                                                           dtype):
    '''string_grid_into: the heavy atoms from row n_ok[0] of the pool, the
    rows past it dropped and counted, no host read (the sync debug mode
    raises on one); equal to its twin bit for bit; the pipeline's
    bounded compaction equal to the CPU run's (1e-12 A in float64).'''
    from tscode_tpu_torch.embeds.string import spin_angles
    from tscode_tpu_torch.ops.kernels import string_grid as g1
    from tscode_tpu_torch.pipeline import (clash_survivors_bounded,
                                           inputs_from_numpy)
    rng = np.random.default_rng(5)
    inp = grid_inputs(rng, 6, 5, 6, 5, 2, 1, dtype, cuda_device)
    angles = spin_angles(36, dtype, cuda_device)
    n_kept = int(g1.string_grid(inp, angles, 0, 5, 1.5)[1].sum())
    for s_pool, base in ((2 * n_kept, 0), (n_kept // 2, 7), (n_kept, 3)):
        H = inp.heavy_idx.numel()
        pool = torch.zeros((s_pool, H, 3), dtype=dtype, device=cuda_device)
        n0 = torch.tensor([base], device=cuda_device)
        torch.cuda.set_sync_debug_mode('error')
        try:
            ok, n = g1.string_grid_into(inp, angles, 0, 5, 1.5, pool, n0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = torch.zeros_like(pool)
        ok_w, n_w = g1.string_grid_into_plain(inp, angles, 0, 5, 1.5, want,
                                              n0)
        assert torch.equal(ok, ok_w) and int(n) == int(n_w) == base + n_kept
        assert torch.equal(pool, want)
    mols = build_workload(n_confs=6)
    card = inputs_from_numpy(*mols, cuda_device, torch.float64)
    cpu = inputs_from_numpy(*mols, 'cpu', torch.float64)
    got = clash_survivors_bounded(card, 1024, 36)
    want = clash_survivors_bounded(cpu, 1024, 36)
    assert torch.equal(got[0].cpu(), want[0])
    assert float((got[1].cpu() - want[1]).abs().max()) <= 1e-12
    assert torch.equal(got[2].cpu(), want[2]) and int(got[3]) == int(want[3])


def novelty_fps(rng, B, Q, n_clusters, spread):
    centers = rng.uniform(-180, 180, size=(n_clusters, Q))
    fps = centers[rng.integers(0, n_clusters, B)] + \
        rng.normal(size=(B, Q)) * spread
    return ((fps + 180) % 360 - 180).astype(np.float32)


# (B, Q, clusters, spread, block, cache_cap, accept probability): a
# typical string route (few novel rows, heavy duplication), chains inside
# blocks, small blocks, a cache past shared memory (Q = 30) with many
# undecided rows in later tiles, overflow, a block past a tile's 4,096
# rows with chains, one tile overflowing at once (large_n_string's shape)
NOVELTY_CASES = [(50000, 10, 300, 0.5, 4096, 1024, 1.0),
                 (20000, 7, 100, 3.0, 4096, 1024, 0.7),
                 (5000, 6, 60, 3.0, 16, 1024, 1.0),
                 (8000, 30, 1500, 0.5, 4096, 4000, 1.0),
                 (9000, 12, 400, 0.2, 4096, 40, 1.0),
                 (30000, 9, 2000, 2.0, 16384, 4096, 0.9),
                 (1704, 46, 1704, 0.5, 4096, 1024, 1.0)]


@pytest.mark.parametrize('case', NOVELTY_CASES)
def test_novelty_kernel_matches_the_host_replay(cuda_device, case):
    '''V1 against the native host replay (is_new_structure_lru) and its
    plain twin, exactly, the same bits twice; past cache_cap ok is False
    and tfd_novelty_device reports the host lane; one launch and at most
    two host reads.'''
    from tscode_tpu_torch.ops.kernels import tfd_novelty as v1
    from tscode_tpu_torch.ops.tfd import (is_new_structure_lru,
                                          tfd_novelty_device)
    B, Q, ncl, spread, block, cap, accept_p = case
    rng = np.random.default_rng(B + Q)
    fps = novelty_fps(rng, B, Q, ncl, spread)
    accept = rng.random(B) < accept_p
    want = is_new_structure_lru(fps, accept, thresh=10)
    t = torch.as_tensor(fps, device=cuda_device)
    acc = torch.as_tensor(accept, device=cuda_device)
    v1.KERNEL.reset_counts()
    stats = {}
    got, ok = tfd_novelty_device(t, accept, thresh=10, block=block,
                                 cache_cap=cap, stats=stats)
    assert v1.KERNEL.launches == 1 and stats['kernel'] == 'V1'
    assert stats['host_syncs'] <= 2
    assert ok == (want.sum() <= cap)
    n1, s1 = v1.tfd_novelty(t, acc, 10.0, block, cap)
    n2, s2 = v1.tfd_novelty(t, acc, 10.0, block, cap)
    assert torch.equal(n1, n2) and torch.equal(s1, s2)
    plain, p_ok, p_n, _ = v1.novelty_plain(t, acc, 10.0, block, cap)
    assert s1.tolist() == [p_n, int(p_ok)]
    if ok:
        np.testing.assert_array_equal(got, want)
        assert torch.equal(n1, plain)
