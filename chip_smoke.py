#!/usr/bin/env python3
'''
Smoke run of the PyTorch + CUDA port (tscode_tpu_torch) on one NVIDIA
GPU: builds the hand-written kernels from csrc/, holds each against its
plain PyTorch twin on the card, drives the headline slice (415,872-pose
string-embed grid -> clash screen -> exact bucketed RMSD prune) in
float64 and float32 and checks its counts, then runs the production
string route through the port's CLI (input file -> Embedder -> string
embed -> TFD novelty -> TFD and MOI prunes -> .xyz) on bench_suite's
sn2_string input at 76 conformers (831,744 candidates), in float64
(exact counts) and float32, and the large-molecule route on
large_n_string (148-atom poses, the clash kernel's warp regime): the CLI
at 16 conformers, the exact novelty replay without the collinear
torsion quadruplet, and the 207,936-pose grid at 76 conformers.

    python3 chip_smoke.py

Exits nonzero, with no result line, when CUDA is not available or any
phase fails. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel with its launches on the main path,
its agreement with the plain version and both times.
'''

import json
import subprocess
import sys
import time

import numpy as np

THR = 0.5                    # RMSD prune threshold (A)
CLASH = 1.5                  # clash threshold (A)
N_POSES = 415872             # 76 * 76 * 2 * 36 grid poses
F64_COUNTS = (202362, 26)    # clash-ok, final: the x64 reference counts
F32_OK = (202330, 202380)    # f32 clash-ok bracket (ties at 1.5 A)
F32_FINAL = (22, 30)
CLASH_TIE = 1e-4             # A^2: |d2 - thr^2| below this is a tie
QCP_TIE = {'float32': 1e-4, 'float64': 1e-9}   # A, on rmsd and maxdev
DEV = 'cuda'

# the string route (phase 6): bench_suite's sn2_string at 76 conformers
STRING_CONFS = 76
STRING_F64 = (831744, 371822, 355, 290)   # candidates, clash-ok, novel,
#                                           final: the x64 reference counts
TFD_THRESH = 10.0                          # degrees, the novelty threshold
STRING_TFD_TIE = 1e-2      # degrees: |sum - 10| below this is a near tie
# f32 novel and final counts may lie this fraction of the f64 counts away:
# hundreds of survivors sit exactly 10.0 degrees (one spin step) from an
# accepted fingerprint in f64, and f32 fingerprints turn those exact ties
# into coin flips of the leader rule, which then cascade
STRING_F32_SLACK = 0.10
LIST_MAX = 20              # tie rows listed by index

# the large-molecule route (phase 7): bench_suite's large_n_string, two
# C24H49Cl chains, 148-atom poses, P = 5,476 cross pairs
LARGE_CONFS = 16
LARGE_F64 = (9216, 1704, 1113, 1113)   # candidates, clash-ok, novel, final:
#                                        the JAX x64 CLI run's counts
# novel and final may lie this fraction away: the torsion quadruplet
# LARGE_COLLINEAR has both end bonds on the reactive bond's axis, so its
# dihedral is rounding noise and so are the counts that rest on it
LARGE_SLACK = 0.10
LARGE_COLLINEAR = [[1, 0, 74, 75]]     # Cl-C0...C74-Cl
COLLINEAR_SINE = 1e-8      # an end-angle sine at or below it: collinear
LARGE_DROPPED_NOVEL = 244  # JAX x64 novelty replay of the 1,704 survivors
#                            without the collinear quadruplet
LARGE_GRID_CONFS = 76      # 207,936 grid poses
LARGE_GRID_OK = 43764      # their JAX x64 clash-ok count
LARGE_PLAIN_CHUNK = 16384  # poses per plain-twin call (B x N x N tensors)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_env():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this '
              'script needs an NVIDIA GPU', file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    try:
        import networkx
    except ImportError as e:
        raise SmokeFailure(f'networkx is missing ({e}); the molecule '
                           f'graph code of tscode_tpu needs it') from e
    print(f'[1 env] device {torch.cuda.get_device_name(0)} | nvidia-smi: '
          f'{card} | torch {torch.__version__} | cuda {torch.version.cuda} '
          f'| networkx {networkx.__version__} | python '
          f'{sys.version.split()[0]}')
    return card


def phase_build():
    from tscode_tpu_torch.ops.kernels import clash, qcp
    for k in (clash.KERNEL, qcp.KERNEL):
        k.build()
        regs = [ln.strip() for ln in k.build_log().splitlines()
                if 'registers' in ln]
        print(f'[2 build] {k.name}: {k.build_seconds:.2f} s '
              f'({k.library}) {" / ".join(regs)}')


def cuda_ms(fn, reps=10):
    '''Mean milliseconds per call on the device after one warm-up call
    (CUDA events around `reps` calls).'''
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def clash_ties(poses, pairs, thresh):
    '''(B,) bool: poses with a listed pair within CLASH_TIE of thr^2
    (exact float64 difference form).'''
    import torch
    P = poses.double()
    pl = pairs.long()
    d = P[:, pl[:, 0]] - P[:, pl[:, 1]]
    d2 = torch.sum(d * d, dim=-1)
    return ((d2 - thresh * thresh).abs() < CLASH_TIE).any(dim=1)


def pass_pairs(end, positions):
    '''All (p, q) position pairs of a pass with q in (p, end[p]), for the
    given positions p.'''
    import torch
    lens = torch.clamp(end[positions] - positions - 1, min=0)
    p = positions.repeat_interleave(lens)
    first = torch.cumsum(lens, 0) - lens
    off = torch.arange(p.numel(), device=p.device) - \
        first.repeat_interleave(lens)
    return p, p + 1 + off


def qcp_tie_rows(hs, act, end, positions, tol, chunk=1 << 20):
    '''(len(positions),) bool: positions with a pass pair whose float64
    rmsd lies within tol of thr, or maxdev within tol of 2*thr.'''
    import torch
    from tscode_tpu_torch.ops.linalg import rmsd_and_max
    hs64 = hs.double()
    p, q = pass_pairs(end, positions)
    tie = torch.zeros(p.numel(), dtype=torch.bool, device=hs.device)
    for i in range(0, p.numel(), chunk):
        a = hs64[act[p[i:i + chunk]]]
        b = hs64[act[q[i:i + chunk]]]
        rmsd, maxdev = rmsd_and_max(a, b)
        tie[i:i + chunk] = ((rmsd - THR).abs() < tol) | \
            ((maxdev - 2 * THR).abs() < tol)
    rows = torch.zeros(end.numel(), dtype=torch.bool, device=hs.device)
    rows[p[tie]] = True
    return rows[positions]


def compare_bits(got, want, tie, what):
    '''Exact agreement outside the tie rows; every disagreement must be
    a tie. Returns (max |got - want| outside ties, number of tie rows).'''
    diff = got != want
    check(not bool((diff & ~tie).any()),
          f'{what}: {int((diff & ~tie).sum())} rows disagree away from '
          f'any threshold tie')
    return int(diff[~tie].sum() > 0), int(tie.sum())


def big_fragment_poses(rng, n_poses, n_atoms):
    '''Poses of two n_atoms-atom fragments, gaussian blobs (sigma 2 A)
    whose centers lie 5 to 16 A apart: from hundreds of cross clashes per
    pose down to none.'''
    f1 = rng.normal(size=(n_poses, n_atoms, 3)) * 2.0
    f2 = rng.normal(size=(n_poses, n_atoms, 3)) * 2.0
    f2[..., 0] += rng.uniform(5.0, 16.0, size=(n_poses, 1))
    return np.concatenate([f1, f2], axis=1)


def near_dup_blocks(rng, B, L, N):
    '''Blocks of noisy copies of a few base structures, with noise
    levels that put pair rmsds on both sides of 0.5 A (and, for N = 8,
    inside the sqrt(N) band where the maxdev gate decides).'''
    base = rng.normal(size=(B, 4, N, 3)) * 1.5
    which = rng.integers(0, 4, size=(B, L))
    sigma = rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=(B, L))
    P = base[np.arange(B)[:, None], which] + \
        rng.normal(size=(B, L, N, 3)) * sigma[..., None, None]
    return P, rng.integers(1, L + 1, size=B)


def phase_kernels():
    import torch
    from tscode_tpu_torch.ops.kernels import clash, qcp
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.ops.rmsd_prune import (
        prune_conformers_rmsd_device)
    dev = torch.device(DEV)
    errs = {'clash': 0, 'qcp_kill': 0}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split('.')[-1]
        clash.KERNEL.reset_counts()
        qcp.KERNEL.reset_counts()

        # clash, both entries, B not a multiple of 2048
        rng = np.random.default_rng(11)
        pm = cross_fragment_pair_mask((6, 5))
        pairs = torch.as_tensor(clash.static_pairs(pm), device=dev)
        poses = torch.as_tensor(rng.normal(size=(4099, 11, 3)) * 2.2,
                                dtype=dtype, device=dev)
        tie = clash_ties(poses, pairs, CLASH)
        for mc in (0, 3):
            want = clash.clash_ok_plain(poses, pairs, CLASH, mc)
            for got in (clash.clash_ok(poses, pairs, CLASH, mc),
                        clash.compenetration_mask_kernel(poses, pm, CLASH,
                                                         mc)):
                e, _ = compare_bits(got, want, tie, f'clash {name} mc={mc}')
                errs['clash'] = max(errs['clash'], e)
        print(f'[3 kernels] clash {name}: B=4099 max_clashes 0 and 3, '
              f'K1 and K2 entries equal to plain on '
              f'{int((~tie).sum())} poses ({int(tie.sum())} tie poses '
              f'excluded)')

        # clash at any size: two 160-atom fragments, P = 25,600 pairs and
        # N = 320 atoms, more than one block's shared memory holds
        pm = cross_fragment_pair_mask((160, 160))
        pairs = torch.as_tensor(clash.static_pairs(pm), device=dev)
        poses = torch.as_tensor(
            big_fragment_poses(np.random.default_rng(160), 2048, 160),
            dtype=dtype, device=dev)
        tie = clash_ties(poses, pairs, CLASH)
        for mc in (0, 3, 100):
            want = torch.cat([
                clash.clash_ok_plain(poses[i:i + 256], pairs, CLASH, mc)
                for i in range(0, poses.shape[0], 256)])
            got = clash.clash_ok(poses, pairs, CLASH, mc)
            e, _ = compare_bits(got, want, tie, f'clash {name} 160+160 '
                                f'atoms mc={mc}')
            errs['clash'] = max(errs['clash'], e)
            check(0 < int(want.sum()) < poses.shape[0],
                  f'clash {name} 160+160 atoms mc={mc}: degenerate case')
        print(f'[3 kernels] clash {name}: 2048 poses of 160+160 atoms '
              f'(P=25600, N=320), max_clashes 0, 3 and 100, equal to plain '
              f'on {int((~tie).sum())} poses ({int(tie.sum())} tie poses '
              f'excluded)')

        # qcp: planted duplicates -> exactly 3 kills
        rng = np.random.default_rng(3)
        blocks = rng.normal(size=(4, 32, 8, 3)) * 2
        blocks[0, 10] = blocks[0, 3] + 1e-3
        blocks[2, 20] = blocks[2, 5] + 1e-3
        blocks[2, 25] = blocks[2, 5] + 2e-3
        P = torch.as_tensor(blocks, dtype=dtype, device=dev)
        m_real = torch.as_tensor([32, 20, 32, 5], device=dev)
        got = qcp.qcp_kill_blocks(P, m_real, THR)
        act, end = qcp.blocks_as_pass(m_real, 32)
        want = qcp.qcp_kill_plain(P.reshape(-1, 8, 3), act, end, THR)
        check(torch.equal(got.reshape(-1), want),
              f'qcp planted {name}: kernel != plain')
        check(int(got.sum()) == 3, f'qcp planted {name}: '
              f'{int(got.sum())} kills, expected 3')

        # qcp: random near-duplicate blocks at N = 4 and N = 8
        for N in (4, 8):
            Pn, m_real = near_dup_blocks(np.random.default_rng(N), 64, 64, N)
            P = torch.as_tensor(Pn, dtype=dtype, device=dev)
            m_real = torch.as_tensor(m_real, device=dev)
            got = qcp.qcp_kill_blocks(P, m_real, THR).reshape(-1)
            act, end = qcp.blocks_as_pass(m_real, 64)
            hs = P.reshape(-1, N, 3)
            want = qcp.qcp_kill_plain(hs, act, end, THR)
            pos = torch.arange(act.numel(), device=dev)
            tie = qcp_tie_rows(hs, act, end, pos, QCP_TIE[name])
            e, n_tie = compare_bits(got, want, tie, f'qcp blocks {name} '
                                    f'N={N}')
            errs['qcp_kill'] = max(errs['qcp_kill'], e)
            print(f'[3 kernels] qcp_kill_blocks {name} N={N}: 64x64 blocks, '
                  f'{int(want.sum())} kills, equal to plain '
                  f'({n_tie} tie rows excluded)')

        # the prune, pair kernel vs plain, on a 4096-row N = 8 pool
        # without threshold ties (rows of tie pairs are dropped first)
        rng = np.random.default_rng(8)
        base = rng.normal(size=(600, 8, 3)) * 1.5
        pool = base[rng.integers(0, 600, size=4096)] + \
            rng.normal(size=(4096, 8, 3)) * \
            rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=4096)[:, None, None]
        hs = torch.as_tensor(pool, dtype=dtype, device=dev)
        n = hs.shape[0]
        act = torch.arange(n, device=dev)
        tie = qcp_tie_rows(hs, act, torch.full_like(act, n), act,
                           QCP_TIE[name])
        hs = hs[~tie].contiguous()
        keep_k = prune_conformers_rmsd_device(hs, THR)
        keep_p = prune_conformers_rmsd_device(
            hs, THR, pair_kill=qcp.qcp_kill_plain)
        check(np.array_equal(keep_k, keep_p),
              f'prune {name}: kernel keeps {keep_k.sum()}, plain '
              f'{keep_p.sum()}, masks differ')
        print(f'[3 kernels] prune {name}: {hs.shape[0]}-row N=8 pool '
              f'({int(tie.sum())} tie rows dropped) -> {int(keep_k.sum())} '
              f'kept, kernel mask == plain mask')
        check(clash.KERNEL.launches > 0 and qcp.KERNEL.launches > 0,
              f'kernel launch counters stayed 0 ({name})')
    return errs


def phase_main_f64(card, mols):
    import torch
    from tscode_tpu_torch.ops.kernels import clash, qcp
    from tscode_tpu_torch.pipeline import (embed_clash_all,
                                           inputs_from_numpy, run_pipeline)
    clash.KERNEL.reset_counts()
    qcp.KERNEL.reset_counts()
    n_poses, secs, n_ok, n_final, info = run_pipeline(
        *mols, device=DEV, dtype=torch.float64, return_masks=True)
    launches = {'clash': clash.KERNEL.launches,
                'qcp_kill': qcp.KERNEL.launches}
    check(all(v > 0 for v in launches.values()),
          f'main path f64 did not launch every kernel: {launches}')
    print(f'[4 main f64] {n_poses} poses -> {n_ok} clash-ok -> {n_final} '
          f'final in {secs:.4f} s, kernel launches {launches}, clash by '
          f'regime {clash.launches_by_regime()} [{card}]')
    check(n_poses == N_POSES, f'{n_poses} poses, expected {N_POSES}')
    check((n_ok, n_final) == F64_COUNTS,
          f'f64 counts {(n_ok, n_final)} != {F64_COUNTS}')

    inp = inputs_from_numpy(*mols, DEV, torch.float64)
    poses, ok = embed_clash_all(inp)
    check(bool(torch.isfinite(poses).all()), 'non-finite f64 poses')
    check(np.array_equal(ok.cpu().numpy(), info['clash_ok']),
          'f64 clash mask differs between two runs')
    P = poses.double()
    pl = inp.pairs.long()
    d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
    near = torch.nonzero(((d2 - CLASH * CLASH).abs() < 1e-9).any(dim=1))
    for i in near.squeeze(1).tolist():
        print(f'[4 main f64] pose {i} within 1e-9 A^2 of the clash threshold')
    print(f'[4 main f64] {near.numel()} poses within 1e-9 A^2 of thr^2')


def phase_small_parity():
    '''The 2,592-pose grid on the card in f64 against the CPU run of the
    port (plain twins): identical masks and counts.'''
    import torch
    from tscode_tpu_torch.pipeline import build_workload, run_pipeline
    mols = build_workload(n_confs=6)
    gpu = run_pipeline(*mols, device=DEV, dtype=torch.float64,
                       return_masks=True)
    cpu = run_pipeline(*mols, device='cpu', dtype=torch.float64,
                       return_masks=True)
    check(gpu[2:4] == cpu[2:4] == (1362, 6),
          f'small grid counts gpu {gpu[2:4]} cpu {cpu[2:4]}, expected '
          f'(1362, 6)')
    check(np.array_equal(gpu[4]['clash_ok'], cpu[4]['clash_ok'])
          and np.array_equal(gpu[4]['keep'], cpu[4]['keep']),
          'small grid masks differ between card and CPU')
    print('[4 main f64] 2592-pose grid: card == CPU plain twins, '
          '1362 clash-ok -> 6 final')


def phase_main_f32(card, mols):
    import torch
    from tscode_tpu_torch.ops.kernels import clash, qcp
    from tscode_tpu_torch.ops.rmsd_prune import (
        pass_chunks, prune_conformers_rmsd_device)
    from tscode_tpu_torch.pipeline import (clash_survivors, embed_clash_all,
                                           inputs_from_numpy, run_pipeline)
    clash.KERNEL.reset_counts()
    qcp.KERNEL.reset_counts()
    n_poses, secs, n_ok, n_final = run_pipeline(
        *mols, device=DEV, dtype=torch.float32)
    launches = {'clash': clash.KERNEL.launches,
                'qcp_kill': qcp.KERNEL.launches}
    check(all(v > 0 for v in launches.values()),
          f'main path f32 did not launch every kernel: {launches}')
    print(f'[5 main f32] warm-up: {n_poses} poses -> {n_ok} clash-ok -> '
          f'{n_final} final in {secs:.4f} s, kernel launches {launches}, '
          f'clash by regime {clash.launches_by_regime()} [{card}]')
    check(F32_OK[0] <= n_ok <= F32_OK[1],
          f'f32 clash-ok {n_ok} outside {F32_OK}')
    check(F32_FINAL[0] <= n_final <= F32_FINAL[1],
          f'f32 final {n_final} outside {F32_FINAL}')

    best = None
    for _ in range(3):
        r = run_pipeline(*mols, device=DEV, dtype=torch.float32,
                         return_masks=True)
        check(r[2:4] == (n_ok, n_final), f'f32 rep counts {r[2:4]} differ '
              f'from warm-up {(n_ok, n_final)}')
        if best is None or r[1] < best[1]:
            best = r
    info = best[4]
    print(f'[5 main f32] best of 3: {best[1]:.4f} s, '
          f'{n_poses / best[1]:.0f} poses/s (embed+clash '
          f'{info["embed_clash_s"]:.4f} s, prune {info["prune_s"]:.4f} s) '
          f'[{card}]')

    # kernel vs plain at the slice's shapes: the grid's poses for the
    # clash, the clash survivors' heavy atoms for the prune
    inp = inputs_from_numpy(*mols, DEV, torch.float32)
    poses, _ = embed_clash_all(inp)
    pairs = inp.pairs
    got = clash.clash_ok(poses, pairs, CLASH)
    want = clash.clash_ok_plain(poses, pairs, CLASH)
    err_clash, n_tie = compare_bits(got, want,
                                    clash_ties(poses, pairs, CLASH),
                                    'clash f32 main grid')
    ms_clash = cuda_ms(lambda: clash.clash_ok(poses, pairs, CLASH))
    ms_clash_plain = cuda_ms(lambda: clash.clash_ok_plain(poses, pairs,
                                                          CLASH))
    print(f'[5 main f32] clash {tuple(poses.shape)}: kernel '
          f'{ms_clash:.4f} ms, plain {ms_clash_plain:.4f} ms, equal '
          f'({n_tie} tie poses) [{card}]')

    _, hs = clash_survivors(inp)
    mask = torch.ones(hs.shape[0], dtype=torch.bool, device=hs.device)
    act, end = pass_chunks(mask, hs.shape[0], 10000)
    got = qcp.qcp_kill(hs, act, end, THR)
    want = qcp.qcp_kill_plain(hs, act, end, THR)
    diff = torch.nonzero(got != want).squeeze(1)
    tie = torch.zeros_like(got)
    if diff.numel():
        tie[diff] = qcp_tie_rows(hs, act, end, diff, QCP_TIE['float32'])
    err_qcp, _ = compare_bits(got, want, tie, 'qcp f32 first pass')
    ms_pass = cuda_ms(lambda: qcp.qcp_kill(hs, act, end, THR))
    ms_pass_plain = cuda_ms(lambda: qcp.qcp_kill_plain(hs, act, end, THR),
                            reps=2)
    print(f'[5 main f32] qcp_kill first pass (k=10000, {act.numel()} '
          f'active, N={hs.shape[1]}): kernel {ms_pass:.4f} ms, plain '
          f'{ms_pass_plain:.4f} ms, {int(got.sum())} kills, '
          f'{diff.numel()} tie rows differ [{card}]')

    def prune(engine):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = prune_conformers_rmsd_device(hs, THR, pair_kill=engine)
        return (time.perf_counter() - t0) * 1e3, keep

    ms_prune, keep_k = min((prune(qcp.qcp_kill) for _ in range(3)),
                           key=lambda r: r[0])
    ms_prune_plain, keep_p = prune(qcp.qcp_kill_plain)
    print(f'[5 main f32] whole prune of {hs.shape[0]} survivors: kernel '
          f'{ms_prune:.3f} ms, plain {ms_prune_plain:.3f} ms, '
          f'{int(keep_k.sum())} vs {int(keep_p.sum())} kept [{card}]')
    return [
        {'name': 'clash_ok', 'route': 'cuda',
         'source': 'tscode_tpu_torch/csrc/clash.cu',
         'replaces': 'tscode_tpu/ops/pallas/clash.py:119',
         'launches': launches['clash'], 'max_abs_err': err_clash,
         'ms': ms_clash, 'plain_ms': ms_clash_plain},
        {'name': 'qcp_kill', 'route': 'cuda',
         'source': 'tscode_tpu_torch/csrc/qcp_kill.cu',
         'replaces': 'tscode_tpu/ops/pallas/qcp.py:240',
         'launches': launches['qcp_kill'], 'max_abs_err': err_qcp,
         'ms': ms_pass, 'plain_ms': ms_pass_plain},
    ]


def run_string_cli(tmp, inp, dtype):
    '''One run of the port's CLI on `inp` in `dtype`, its stdout kept in
    a file; the working directory is restored afterwards. Returns
    (report, frames (F, N, 3), clash launches per regime, seconds).'''
    import contextlib
    import os
    from tscode_tpu.io_xyz import read_xyz
    from tscode_tpu_torch.__main__ import main as cli
    from tscode_tpu_torch.ops.kernels import clash
    stamp = f'smoke_{dtype}'
    cwd = os.getcwd()
    clash.KERNEL.reset_counts()
    t0 = time.perf_counter()
    try:
        with open(os.path.join(tmp, f'{stamp}.out'), 'w') as out, \
                contextlib.redirect_stdout(out):
            rc = cli([inp, '--device', DEV, '--dtype', dtype, '-n', stamp])
    finally:
        os.chdir(cwd)
    secs = time.perf_counter() - t0
    launches = clash.launches_by_regime()
    check(rc == 0, f'string route {dtype}: CLI exit code {rc}')
    with open(os.path.join(tmp, f'tscode_report_{stamp}.json')) as f:
        report = json.load(f)
    frames = read_xyz(os.path.join(
        tmp, f'tscode_unoptimized_{stamp}.xyz')).atomcoords
    return report, np.asarray(frames), launches, secs


def string_setup(inp, dtype):
    '''The set-up of a string-route input through the port's Embedder
    (its log kept quiet): (grid inputs on the card, spin angles, torsion
    quadruplets) in `dtype`.'''
    import contextlib
    import io
    import os
    from tscode_tpu.graphs import get_quadruplets, get_sum_graph
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.embeds.common import inputs_from_numpy
    from tscode_tpu_torch.embeds.string import spin_angles
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            emb = Embedder(inp, stamp='smoke_setup', device=DEV, dtype=dtype)
        emb.logfile.close()
    finally:
        os.chdir(cwd)
    m1, m2 = emb.objects
    r1 = int(m1.reactive_indices[0])
    r2 = int(m2.reactive_indices[0]) + m1.n_atoms
    quads = get_quadruplets(get_sum_graph((m1.graph, m2.graph), [[r1, r2]]))
    return (inputs_from_numpy(m1, m2, DEV, dtype),
            spin_angles(emb.systematic_angles, dtype, DEV), quads)


def suite_input(name, tmp, n_confs):
    '''bench_suite's `name` input at n_confs conformers, written into
    tmp; returns the input file's path.'''
    import bench_suite
    saved = bench_suite.N_CONFS
    bench_suite.N_CONFS = n_confs
    try:
        return bench_suite._config_files(name, tmp)
    finally:
        bench_suite.N_CONFS = saved


def clash_offsets(poses, pairs):
    '''(B,) float64: each pose's smallest |d^2 - thr^2| over the listed
    pairs (exact float64 difference form).'''
    import torch
    pl = pairs.long()
    step = max(1, (1 << 25) // max(1, pl.shape[0]))   # ~0.8 GB a chunk
    out = []
    for lo in range(0, poses.shape[0], step):
        P = poses[lo:lo + step].double()
        d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, -1)
        out.append((d2 - CLASH * CLASH).abs().amin(dim=1))
    return torch.cat(out)


def novelty_ties(fps, novel):
    '''Rows of `fps` whose wrapped-L1 distance to an accepted (novel)
    fingerprint lies within 1e-9 degrees of the novelty threshold
    (listed), and how many lie within STRING_TFD_TIE (counted).'''
    import torch
    from tscode_tpu_torch.ops.tfd import wrapped_l1
    acc = fps[torch.as_tensor(novel, device=fps.device)]
    near, n_tie = [], 0
    for c0 in range(0, fps.shape[0], 1 << 16):
        s = (wrapped_l1(fps[c0:c0 + (1 << 16)], acc) - TFD_THRESH).abs() \
            .amin(dim=1)
        near += (c0 + torch.nonzero(s < 1e-9).squeeze(1)).tolist()
        n_tie += int((s < STRING_TFD_TIE).sum())
    return near, n_tie


def string_ties(tmp, inp):
    '''Threshold ties of the string route in float64 on the card: the
    grid poses with a cross pair within 1e-9 A^2 (listed) and within
    CLASH_TIE (counted) of the clash threshold, and the clash
    survivors with a wrapped-L1 distance to an accepted (novel)
    fingerprint within 1e-9 degrees (listed) and STRING_TFD_TIE
    (counted) of the novelty threshold.'''
    import torch
    from tscode_tpu_torch.embeds.string import bcast_tiles
    from tscode_tpu_torch.ops.tfd import (tfd_novelty_device,
                                          torsion_fingerprints)
    grid, angles, quads = string_setup(inp, torch.float64)
    near, n_tie, lo, fps = [], 0, 0, []
    for poses, ok in bcast_tiles(grid, angles, CLASH):
        off = clash_offsets(poses, grid.pairs)
        near += (lo + torch.nonzero(off < 1e-9).squeeze(1)).tolist()
        n_tie += int((off < CLASH_TIE).sum())
        lo += poses.shape[0]
        fps.append(torsion_fingerprints(poses[ok], quads))
    fps = torch.cat(fps)
    novel, ok = tfd_novelty_device(fps, thresh=TFD_THRESH)
    check(ok, 'string ties: novelty cache overflow')
    tfd_near, n_tfd_tie = novelty_ties(fps, novel)
    return near, n_tie, tfd_near, n_tfd_tie, int(novel.sum())


def phase_string_route(card):
    '''Phase 6: the production string route through the CLI, float64
    (exact reference counts) then float32 (brackets).'''
    import os
    import tempfile
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    launches = 0
    with tempfile.TemporaryDirectory(prefix='smoke_string_') as tmp:
        inp = suite_input('sn2_string', tmp, STRING_CONFS)
        counts = {}
        for dtype in ('float64', 'float32'):
            report, frames, regimes, secs = run_string_cli(tmp, inp, dtype)
            n_launch = sum(regimes.values())
            se = report['string_embed']
            counts[dtype] = (se['candidates'], se['clash_ok'], se['novel'],
                             report['final_structures'])
            launches += n_launch
            check(n_launch > 0, f'string route {dtype}: clash kernel not '
                  f'launched')
            check(se['tfd_lane'] == 'device', f'string route {dtype}: '
                  f'novelty lane {se["tfd_lane"]}, expected device')
            n_final = counts[dtype][3]
            check(frames.shape == (n_final, 11, 3)
                  and bool(np.isfinite(frames).all()),
                  f'string route {dtype}: .xyz holds {frames.shape}, '
                  f'expected ({n_final}, 11, 3) finite')
            stages = ', '.join(f'{s["stage"]} {s["seconds"]:.3f} s '
                               f'({s["structures_in"]} -> '
                               f'{s["structures_out"]})'
                               for s in report['stages'])
            print(f'[6 string {dtype}] {" -> ".join(map(str, counts[dtype]))}'
                  f' (candidates -> clash-ok -> novel -> final) in '
                  f'{secs:.3f} s, clash launches {regimes}, novelty lane '
                  f'{se["tfd_lane"]} {se["novelty_stats"]} [{card}]')
            print(f'[6 string {dtype}] stages: {stages}; report total '
                  f'{report["total_seconds"]} s [{card}]')
            print(f'[6 string {dtype}] embed split: sweep '
                  f'{se["sweep_s"]:.4f} s, compaction {se["compaction_s"]:.4f}'
                  f' s, novelty {se["novelty_s"]:.4f} s, pull '
                  f'{se["pull_s"]:.4f} s [{card}]')
        near, n_tie, tfd_near, n_tfd_tie, n_novel = string_ties(tmp, inp)

    # the listed ties, first LIST_MAX of each (spin steps of 10 degrees
    # put many fingerprint distances at exactly 10.0, which `<` rejects
    # alike on every lane)
    for i in near[:LIST_MAX]:
        print(f'[6 string float64] pose {i} within 1e-9 A^2 of the clash '
              f'threshold')
    for i in tfd_near[:LIST_MAX]:
        print(f'[6 string float64] survivor {i} within 1e-9 degrees of the '
              f'novelty threshold')
    print(f'[6 string float64] {len(near)} poses within 1e-9 A^2 of thr^2, '
          f'{len(tfd_near)} survivors within 1e-9 deg of {TFD_THRESH}; '
          f'{n_tie} poses within {CLASH_TIE} A^2, {n_tfd_tie} '
          f'survivors within {STRING_TFD_TIE} deg')
    check(counts['float64'] == STRING_F64,
          f'string route f64 counts {counts["float64"]} != {STRING_F64}')
    check(n_novel == STRING_F64[2], f'string ties: {n_novel} novel rows, '
          f'expected {STRING_F64[2]}')

    c32, c64 = counts['float32'], counts['float64']
    check(c32[0] == c64[0], f'f32 candidates {c32[0]} != {c64[0]}')
    check(abs(c32[1] - c64[1]) <= n_tie, f'f32 clash-ok {c32[1]} outside '
          f'{c64[1]} +- {n_tie} (poses within {CLASH_TIE} A^2)')
    for k, what in ((2, 'novel'), (3, 'final')):
        lo = round(c64[k] * (1 - STRING_F32_SLACK))
        hi = round(c64[k] * (1 + STRING_F32_SLACK))
        check(lo <= c32[k] <= hi, f'f32 {what} {c32[k]} outside {(lo, hi)}')
    print(f'[6 string float32] inside the brackets: clash-ok {c64[1]} +- '
          f'{n_tie}, novel and final within {STRING_F32_SLACK:.0%} of '
          f'{c64[2]} and {c64[3]}')
    return launches


def bracket(ref, slack):
    return round(ref * (1 - slack)), round(ref * (1 + slack))


def phase_large_route(card):
    '''Phase 7, the CLI part: bench_suite's large_n_string (two C24H49Cl
    chains, 148-atom poses, P = 5,476 cross pairs, so K1's warp regime)
    at 16 conformers, float64 then float32, and the exact gate: the
    novelty replay of the float64 clash survivors on the card without
    the collinear quadruplet. Returns the clash launches per regime.'''
    import tempfile
    import torch
    from tscode_tpu_torch.embeds.string import bcast_tiles
    from tscode_tpu_torch.ops.tfd import (tfd_novelty_device,
                                          torsion_end_sines,
                                          torsion_fingerprints)
    launches = {'thread': 0, 'warp': 0}
    counts = {}
    with tempfile.TemporaryDirectory(prefix='smoke_large_') as tmp:
        inp = suite_input('large_n_string', tmp, LARGE_CONFS)
        for dtype in ('float64', 'float32'):
            report, frames, regimes, secs = run_string_cli(tmp, inp, dtype)
            se = report['string_embed']
            counts[dtype] = c = (se['candidates'], se['clash_ok'],
                                 se['novel'], report['final_structures'])
            for k in launches:
                launches[k] += regimes[k]
            check(regimes['warp'] > 0, f'large_n {dtype}: the warp kernel '
                  f'was not launched ({regimes})')
            check(frames.shape == (c[3], 148, 3)
                  and bool(np.isfinite(frames).all()),
                  f'large_n {dtype}: .xyz holds {frames.shape}, expected '
                  f'({c[3]}, 148, 3) finite')
            stages = ', '.join(f'{s["stage"]} {s["seconds"]:.3f} s'
                               for s in report['stages'])
            print(f'[7 large_n {dtype}] {" -> ".join(map(str, c))} '
                  f'(candidates -> clash-ok -> novel -> final) in {secs:.3f}'
                  f' s, clash launches {regimes}, novelty lane '
                  f'{se["tfd_lane"]} {se["novelty_stats"]}; {stages}; embed '
                  f'split: sweep {se["sweep_s"]:.4f} s, compaction '
                  f'{se["compaction_s"]:.4f} s, novelty {se["novelty_s"]:.4f}'
                  f' s [{card}]')

        # the float64 grid on the card: clash ties, survivors, and the
        # novelty replay without the collinear quadruplets
        grid, angles, quads = string_setup(inp, torch.float64)
        tiles = list(bcast_tiles(grid, angles, CLASH))
        poses = torch.cat([p for p, _ in tiles])
        ok = torch.cat([o for _, o in tiles])
        del tiles
    off = clash_offsets(poses, grid.pairs)
    near = torch.nonzero(off < 1e-9).squeeze(1).tolist()
    n_tie = int((off < CLASH_TIE).sum())
    survivors = poses[ok]
    fps = torsion_fingerprints(survivors, quads)
    col = (torsion_end_sines(survivors, quads) <= COLLINEAR_SINE) \
        .any(dim=0).cpu().numpy()
    check(np.asarray(quads)[col].tolist() == LARGE_COLLINEAR,
          f'large_n: collinear quadruplets {np.asarray(quads)[col].tolist()}'
          f', expected {LARGE_COLLINEAR}')
    fps = fps[:, torch.as_tensor(~col, device=fps.device)].contiguous()
    novel, lane_ok = tfd_novelty_device(fps, thresh=TFD_THRESH,
                                        cache_cap=fps.shape[0])
    check(lane_ok, 'large_n replay: the device novelty lane refused')
    tfd_near, n_tfd_tie = novelty_ties(fps, novel)
    n_novel = int(novel.sum())

    for i in near[:LIST_MAX]:
        print(f'[7 large_n float64] pose {i} within 1e-9 A^2 of the clash '
              f'threshold')
    for i in tfd_near[:LIST_MAX]:
        print(f'[7 large_n float64] survivor {i} within 1e-9 degrees of the '
              f'novelty threshold (collinear quadruplet dropped)')
    print(f'[7 large_n float64] {len(near)} poses within 1e-9 A^2 of thr^2, '
          f'{n_tie} within {CLASH_TIE} A^2; replay without the collinear '
          f'quadruplet {LARGE_COLLINEAR[0]} on the card: {n_novel} novel of '
          f'{fps.shape[0]} ({len(tfd_near)} survivors within 1e-9 deg of '
          f'{TFD_THRESH}, {n_tfd_tie} within {STRING_TFD_TIE} deg)')
    c64, c32 = counts['float64'], counts['float32']
    check(c64[0] == c32[0] == LARGE_F64[0], f'large_n candidates '
          f'{c64[0]}, {c32[0]} != {LARGE_F64[0]}')
    check(abs(c64[1] - LARGE_F64[1]) <= len(near), f'large_n f64 clash-ok '
          f'{c64[1]} != {LARGE_F64[1]} beyond {len(near)} poses within '
          f'1e-9 A^2 of thr^2')
    check(abs(c32[1] - c64[1]) <= n_tie, f'large_n f32 clash-ok {c32[1]} '
          f'outside {c64[1]} +- {n_tie}')
    for dtype, c in counts.items():
        for k, what in ((2, 'novel'), (3, 'final')):
            lo, hi = bracket(LARGE_F64[k], LARGE_SLACK)
            check(lo <= c[k] <= hi, f'large_n {dtype} {what} {c[k]} outside '
                  f'{(lo, hi)}')
    check(n_novel == LARGE_DROPPED_NOVEL, f'large_n replay without the '
          f'collinear quadruplet: {n_novel} novel, JAX x64 gives '
          f'{LARGE_DROPPED_NOVEL}')
    print(f'[7 large_n] gates held: candidates {LARGE_F64[0]}, f64 clash-ok '
          f'{c64[1]} (JAX {LARGE_F64[1]}), f32 clash-ok {c32[1]}, novel and '
          f'final within {LARGE_SLACK:.0%} of {LARGE_F64[2]} and '
          f'{LARGE_F64[3]}, replay {n_novel} == {LARGE_DROPPED_NOVEL}')
    return launches


def phase_large_grid(card):
    '''Phase 7, the grid part: large_n_string at 76 conformers (207,936
    poses of 148 atoms) through the string embed's tiles, float64 (the
    JAX x64 clash-ok count) and float32; K1 against its plain twin on
    the grid, both timed. Returns (clash launches per regime, the
    largest disagreement outside ties).'''
    import tempfile
    import torch
    from tscode_tpu_torch.embeds.string import bcast_tiles
    from tscode_tpu_torch.ops.kernels import clash
    launches = {'thread': 0, 'warp': 0}
    err = 0
    with tempfile.TemporaryDirectory(prefix='smoke_large76_') as tmp:
        inp = suite_input('large_n_string', tmp, LARGE_GRID_CONFS)
        setups = {dtype: string_setup(inp, dtype)
                  for dtype in (torch.float64, torch.float32)}
    for dtype, (grid, angles, _) in setups.items():
        name = str(dtype).split('.')[-1]
        clash.KERNEL.reset_counts()
        tiles = list(bcast_tiles(grid, angles, CLASH))
        regimes = clash.launches_by_regime()
        for k in launches:
            launches[k] += regimes[k]
        check(regimes['warp'] > 0, f'large_n grid {name}: the warp kernel '
              f'was not launched ({regimes})')
        poses = torch.cat([p for p, _ in tiles])
        ok = torch.cat([o for _, o in tiles])
        del tiles
        pairs = grid.pairs
        off = clash_offsets(poses, pairs)
        tie, n_near = off < CLASH_TIE, int((off < 1e-9).sum())
        n_ok = int(ok.sum())
        if dtype == torch.float64:
            check(abs(n_ok - LARGE_GRID_OK) <= n_near, f'large_n grid f64 '
                  f'clash-ok {n_ok} != {LARGE_GRID_OK} beyond {n_near} poses '
                  f'within 1e-9 A^2 of thr^2')

        def plain():
            return torch.cat([
                clash.clash_ok_plain(poses[i:i + LARGE_PLAIN_CHUNK], pairs,
                                     CLASH)
                for i in range(0, poses.shape[0], LARGE_PLAIN_CHUNK)])

        got = clash.clash_ok(poses, pairs, CLASH)
        check(torch.equal(got, ok), f'large_n grid {name}: two launches '
              f'differ')
        e, n_tie = compare_bits(got, plain(), tie, f'clash {name} large_n '
                                f'grid')
        err = max(err, e)
        ms = cuda_ms(lambda: clash.clash_ok(poses, pairs, CLASH))
        ms_plain = cuda_ms(plain, reps=2)
        print(f'[7 large_n grid {name}] (c) {poses.shape[0]} poses x '
              f'{poses.shape[1]} atoms, P = {pairs.shape[0]}: K1 {ms:.4f} ms'
              f', plain {ms_plain:.4f} ms (chunks of {LARGE_PLAIN_CHUNK} '
              f'poses); clash-ok {n_ok}, equal to plain off {n_tie} tie '
              f'poses, {n_near} within 1e-9 A^2; launches {regimes}, plan '
              f'{clash.warp_plan()} [{card}]')
        del poses, ok, got
        torch.cuda.empty_cache()
    return launches, err


def main():
    t0 = time.perf_counter()
    card = phase_env()
    import torch
    from tscode_tpu_torch.pipeline import build_workload
    phase_build()
    errs = phase_kernels()
    mols = build_workload()
    phase_main_f64(card, mols)
    phase_small_parity()
    kernels = phase_main_f32(card, mols)
    kernels[0]['launches'] += phase_string_route(card)
    route = phase_large_route(card)
    grid, errs['clash7'] = phase_large_grid(card)
    kernels[0]['launches'] += sum(route.values()) + sum(grid.values())
    print(f'[7 large_n] clash launches by regime: CLI runs {route}, '
          f'76-conformer grids {grid}')
    errs['clash'] = max(errs['clash'], errs.pop('clash7'))
    for k, key in zip(kernels, ('clash', 'qcp_kill')):
        k['max_abs_err'] = max(k['max_abs_err'], errs[key])
    check('jax' not in sys.modules, 'jax was imported')
    print(f'[done] {time.perf_counter() - t0:.1f} s')
    print(f'nvidia-smi: {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'chip_smoke FAILED: {e}', file=sys.stderr)
        sys.exit(1)
