'''
QCP two-gate pair kill: the hand-written CUDA kernel `csrc/qcp_kill.cu`
and its plain PyTorch twin.

Replaces the Pallas TPU kernel tscode_tpu/ops/pallas/qcp.py
`qcp_kill_blocks_pallas` (`pl.pallas_call` at :240, def :219, body
`_one_block`), whose semantics are the prune's pair math
(tscode_tpu/ops/rmsd_prune._pair_kill_core and _gathered_kill_blocks):
row p dies when a later row q of its chunk has Kabsch rmsd < thr AND
maxdev < 2*thr.

Interface of one prune pass: the pool hs (n, N, 3), the active rows
act (M,) in pool order, and end (M,), the exclusive chunk end of each
position (a position in act). `qcp_kill` evaluates the whole pass in one
launch, with the lanes-per-row plan of `launch_plan`; `qcp_kill_blocks`
keeps K3's block contract on top of it. On a CPU tensor both run the
plain twin; on a CUDA tensor they launch the kernel or raise.

`qcp_kill_thread` launches the thread-per-row design
(`csrc/qcp_kill_thread.cu`, one thread walks a row), kept only as the
yardstick the kernel is timed against; `walk_lengths` counts, with plain
PyTorch, the pairs each row's walk needs.
'''

import ctypes
import math

import torch

from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of
from tscode_tpu_torch.ops.linalg import _qcp_lambda_max, rotation_from_key

_HEAD = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int)
_PLAN = (ctypes.c_int, ctypes.c_int)         # lanes_log2, budget
_TAIL = (ctypes.c_void_p, ctypes.c_void_p)

KERNEL = CudaKernel('qcp_kill', {
    'qcp_kill_f32': _HEAD + (ctypes.c_float,) + _PLAN + _TAIL,
    'qcp_kill_f64': _HEAD + (ctypes.c_double,) + _PLAN + _TAIL,
})
THREAD_KERNEL = CudaKernel('qcp_kill_thread', {
    'qcp_kill_f32': _HEAD + (ctypes.c_float,) + _TAIL,
    'qcp_kill_f64': _HEAD + (ctypes.c_double,) + _TAIL,
})

_SYMBOL = {torch.float32: ('qcp_kill_f32', ctypes.c_float),
           torch.float64: ('qcp_kill_f64', ctypes.c_double)}

# launch plan, from the plan sweep of chip_smoke.py --qcp-plans on an
# H100 (PERF.md): lanes per row grow while the pass still fills this
# many warps (132 SMs x 32), and phase 1 walks one step of those lanes
# before the rows still undecided go to whole warps
PLAN_WARPS = 132 * 32
BUDGET_STEPS = 1
_MAX_BUDGET = 1 << 30

# pair tile of the plain twin: 256 x 2048 pairs bound its memory
_ROW_TILE = 256
_COL_BLOCK = 2048
# pairs per chunk of the walk-length helper
_PAIR_CHUNK = 1 << 20


# ------------------------------------------------------------ plain twin


def _two_gates(S, GA, GB, N, thr, valid, poses_of):
    '''Both gates from the correlations S (..., 3, 3) and squared norms:
    rmsd < thr, then for N > 4 in the band sqrt(N)*rmsd >= 2*thr the
    maxdev gate on the rotated poses that poses_of(index tuple) gives.'''
    lam = _qcp_lambda_max(S, GA, GB)
    msd = (GA + GB - 2.0 * lam) / N
    rmsd = torch.sqrt(torch.clamp(msd, min=0.0))

    gate1 = (rmsd < thr) & valid
    if N <= 4:
        return gate1
    ambiguous = gate1 & (math.sqrt(N) * rmsd >= 2.0 * thr)
    hits = gate1 & ~ambiguous
    idx = torch.nonzero(ambiguous, as_tuple=True)
    if idx[0].numel():
        P, Q = poses_of(idx)
        R = rotation_from_key(S[idx], lam[idx])
        diff = torch.einsum('kij,knj->kni', R, P) - Q
        maxdev = torch.sqrt(torch.amax(torch.sum(diff * diff, dim=-1),
                                       dim=-1))
        hits[idx] = maxdev < 2.0 * thr
    return hits


def pair_gate_hits(Pr, Qc, valid, thr):
    '''Two-gate hits over a rectangular pair tile: rows Pr (T, N, 3),
    columns Qc (C, N, 3), valid (T, C) bool -> (T, C) bool. The
    operation sequence of _pair_kill_rect / _pair_kill_core, with the
    eigenvector path only for the ambiguous band when N > 4.'''
    S = torch.einsum('pni,qnk->pqik', Pr, Qc)
    GA = torch.sum(Pr * Pr, dim=(-2, -1))[:, None]
    GB = torch.sum(Qc * Qc, dim=(-2, -1))[None, :]
    return _two_gates(S, GA, GB, Pr.shape[1], thr, valid,
                      lambda idx: (Pr[idx[0]], Qc[idx[1]]))


def pair_list_hits(P, Q, thr):
    '''Two-gate hits of aligned pairs: P, Q (K, N, 3) -> (K,) bool, the
    same operations as pair_gate_hits pair by pair.'''
    S = torch.einsum('kni,knj->kij', P, Q)
    GA = torch.sum(P * P, dim=(-2, -1))
    GB = torch.sum(Q * Q, dim=(-2, -1))
    valid = torch.ones(P.shape[0], dtype=torch.bool, device=P.device)
    return _two_gates(S, GA, GB, P.shape[1], thr, valid,
                      lambda idx: (P[idx], Q[idx]))


def qcp_kill_plain(hs, act, end, thr):
    '''Plain PyTorch twin of `qcp_kill`, in (_ROW_TILE x _COL_BLOCK)
    pair tiles so memory stays bounded for any chunk length.'''
    M = act.numel()
    kill = torch.zeros(M, dtype=torch.bool, device=hs.device)
    if M < 2:
        return kill
    rows = hs[act.long()]
    end = end.long()
    end_host = end.cpu()
    pos = torch.arange(M, device=hs.device)
    for r0 in range(0, M, _ROW_TILE):
        r1 = min(M, r0 + _ROW_TILE)
        e = int(end_host[r0:r1].max())
        for c0 in range(r0 + 1, e, _COL_BLOCK):
            c1 = min(e, c0 + _COL_BLOCK)
            valid = (pos[None, c0:c1] > pos[r0:r1, None]) & \
                (pos[None, c0:c1] < end[r0:r1, None])
            hits = pair_gate_hits(rows[r0:r1], rows[c0:c1], valid, thr)
            kill[r0:r1] |= hits.any(dim=1)
    return kill


def pass_pairs(end, positions):
    '''All (p, q) position pairs of a pass with q in (p, end[p]), for the
    given positions p, in (p, q) order.'''
    lens = torch.clamp(end[positions] - positions - 1, min=0)
    p = positions.repeat_interleave(lens)
    first = torch.cumsum(lens, 0) - lens
    off = torch.arange(p.numel(), device=p.device) - \
        first.repeat_interleave(lens)
    return p, p + 1 + off


def walk_lengths(hs, act, end, thr):
    '''(M,) int64: the pairs each position's walk evaluates, up to and
    including its first hit, or all of (p, end[p]) when it has none.
    Plain PyTorch over every pair of the pass, in chunks.'''
    act, end = act.long(), end.long()
    M = act.numel()
    pos = torch.arange(M, device=hs.device)
    walk = torch.clamp(end - pos - 1, min=0)
    p, q = pass_pairs(end, pos)
    for i in range(0, p.numel(), _PAIR_CHUNK):
        pi, qi = p[i:i + _PAIR_CHUNK], q[i:i + _PAIR_CHUNK]
        h = pair_list_hits(hs[act[pi]], hs[act[qi]], thr)
        walk.scatter_reduce_(0, pi[h], (qi - pi)[h], 'amin')
    return walk


# ---------------------------------------------------------------- kernel


def launch_plan(M):
    '''(lanes_log2, budget) of a pass over M active rows: 2^lanes_log2
    lanes per row, the most (up to 32) that keep the pass at PLAN_WARPS
    warps or fewer, and a phase-1 budget of BUDGET_STEPS steps of them;
    rows undecided after it are walked by whole warps.'''
    lanes_log2 = 0
    while lanes_log2 < 5 and \
            -(-M * (2 << lanes_log2) // 32) <= PLAN_WARPS:
        lanes_log2 += 1
    return lanes_log2, BUDGET_STEPS << lanes_log2


def _checked(hs, act, end):
    '''The kernel's arguments, checked: (act, end) as contiguous int32 on
    hs's device; raises on what the kernels do not take.'''
    if hs.dtype not in _SYMBOL:
        raise TypeError(f'qcp kernel takes float32/float64, got {hs.dtype}')
    if hs.dim() != 3 or hs.shape[2] != 3 or not hs.is_contiguous():
        raise ValueError(f'hs must be a contiguous (n, N, 3) tensor, got '
                         f'{tuple(hs.shape)}')
    if hs.shape[0] >= 2 ** 31 or act.numel() >= 2 ** 31:
        raise ValueError('pool too large for int32 row indices')
    act = act.to(device=hs.device, dtype=torch.int32).contiguous()
    end = end.to(device=hs.device, dtype=torch.int32).contiguous()
    if act.dim() != 1 or act.shape != end.shape:
        raise ValueError('act and end must be matching (M,) vectors')
    return act, end


def qcp_kill(hs, act, end, thr, plan=None):
    '''Kill bits of one prune pass: position p of `act` dies when some
    q in (p, end[p]) passes rmsd < thr and maxdev < 2*thr.
    hs (n, N, 3) float32/float64; act, end (M,) integer. -> (M,) bool.
    plan: (lanes_log2, budget), default launch_plan(M).'''
    if hs.device.type == 'cpu':
        return qcp_kill_plain(hs, act, end, thr)
    act, end = _checked(hs, act, end)
    M = act.numel()
    lanes_log2, budget = plan or launch_plan(M)
    if not (0 <= lanes_log2 <= 5 and 0 <= budget <= _MAX_BUDGET):
        raise ValueError(f'bad launch plan {(lanes_log2, budget)}')
    kill = torch.empty(M, dtype=torch.bool, device=hs.device)
    symbol, c_thr = _SYMBOL[hs.dtype]
    KERNEL.launch(symbol, ptr(hs), hs.shape[1], ptr(act), ptr(end), M,
                  c_thr(float(thr)), lanes_log2, budget, ptr(kill),
                  stream_of(hs))
    return kill


def qcp_kill_thread(hs, act, end, thr):
    '''The same kill bits from the thread-per-row kernel (one thread
    walks a row): the yardstick qcp_kill is timed against, CUDA only.'''
    if hs.device.type != 'cuda':
        raise ValueError('qcp_kill_thread runs on CUDA tensors only')
    act, end = _checked(hs, act, end)
    M = act.numel()
    kill = torch.empty(M, dtype=torch.bool, device=hs.device)
    symbol, c_thr = _SYMBOL[hs.dtype]
    THREAD_KERNEL.launch(symbol, ptr(hs), hs.shape[1], ptr(act), ptr(end),
                         M, c_thr(float(thr)), ptr(kill), stream_of(hs))
    return kill


def blocks_as_pass(m_real, L):
    '''(act, end) that evaluate B blocks of L rows as one pass: block b
    holds rows b*L .. b*L+L-1 of the flattened pool, of which the first
    m_real[b] are live.'''
    m_real = torch.as_tensor(m_real).long()
    B = m_real.numel()
    act = torch.arange(B * L, device=m_real.device)
    end = (torch.arange(B, device=m_real.device) * L
           + m_real).repeat_interleave(L)
    return act, end


def qcp_kill_blocks(P_blocks, m_real, thr):
    '''K3's block contract: P_blocks (B, L, N, 3), m_real (B,) live rows
    per block -> (B, L) bool; row p of block b dies when some q in
    (p, m_real[b]) passes both gates.'''
    B, L = P_blocks.shape[0], P_blocks.shape[1]
    hs = P_blocks.reshape(B * L, P_blocks.shape[2], 3).contiguous()
    act, end = blocks_as_pass(torch.as_tensor(m_real, device=hs.device), L)
    return qcp_kill(hs, act, end, thr).reshape(B, L)
