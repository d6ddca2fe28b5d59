'''
Clash screen: the hand-written CUDA kernels of `csrc/clash.cu` and their
plain PyTorch twin.

Replaces the Pallas TPU kernels of tscode_tpu/ops/pallas/clash.py:
K1 `clash_ok_traced` (:119, the production screen) and K2
`compenetration_mask_pallas` (:55, same math with a pair mask). K1 has
two more entries for the conformer search: `torsion_clash_ok`, the clash
test between the two sides of a rotated bond (the counterpart of
tscode_tpu/ops/clash.py:168), and `torsion_backoff`, the search's whole
5-degree retreat of one torsion in one launch (the counterpart of
tscode_tpu/torsions._rotate_batch_with_backoff). The screen entries
launch one of two regimes, chosen by `clash_regime` from the pair count
and the pose size: one warp per pose (pair list resident in shared
memory, poses double-buffered with cp.async) for large pair lists, one
thread per pose for small ones. The thread regime's kernel is the ring
(persistent blocks, a ring of shared-memory stages filled by bulk
copies, launch plan from `thread_plan`), or the v1 thread kernel for
poses too large for the ring; the v1 kernel is also the yardstick the
ring is timed against (`launch(..., 'v1')`).
The kernels' note says what bounds each regime on the card.

Pair lists hold each (i, j) pair once, as `static_pairs` makes them:
the kernels count a listed pair each time it is listed, the plain twin's
pair mask only once, so the plain twin raises on a repeated pair.

On a CPU tensor each entry runs the plain version (the matmul form of
tscode_tpu/ops/clash.compenetration_mask; for the search's entries the
direct differences of the kernels and of the JAX package's back-off);
on a CUDA tensor it launches a kernel or raises.
'''

import ctypes
import functools

import numpy as np
import torch

from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of
from tscode_tpu_torch.ops.linalg import normalize

_ENTRY = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_int)
_TAIL = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
# the ring kernel's launch plan: tile, stages, blocks, shared memory
# bytes, and the tile-path counters
_RING = (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p)
_P = ctypes.c_void_p
_BACKOFF = (_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P,
            ctypes.c_int, _P, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong)

KERNEL = CudaKernel('clash', {
    'clash_ok_f32': _ENTRY + (ctypes.c_float,) + _TAIL + _RING,
    'clash_ok_f64': _ENTRY + (ctypes.c_double,) + _TAIL + _RING,
    'clash_ok_v1_f32': _ENTRY + (ctypes.c_float,) + _TAIL,
    'clash_ok_v1_f64': _ENTRY + (ctypes.c_double,) + _TAIL,
    'clash_ok_warp_f32': _ENTRY + (ctypes.c_float,) + _TAIL,
    'clash_ok_warp_f64': _ENTRY + (ctypes.c_double,) + _TAIL,
    'torsion_backoff_f64': _BACKOFF,
})

_SYMBOL = {('thread', torch.float32): ('clash_ok_f32', ctypes.c_float),
           ('thread', torch.float64): ('clash_ok_f64', ctypes.c_double),
           ('v1', torch.float32): ('clash_ok_v1_f32', ctypes.c_float),
           ('v1', torch.float64): ('clash_ok_v1_f64', ctypes.c_double),
           ('warp', torch.float32): ('clash_ok_warp_f32', ctypes.c_float),
           ('warp', torch.float64): ('clash_ok_warp_f64', ctypes.c_double)}

# The warp regime takes pair lists of at least this many pairs, as long
# as two pose slots and one 128-pair step fit in a block's shared memory
# (the card's opt-in limit). From the crossover sweep of chip_smoke.py
# phase 3 (NVIDIA H100 80GB HBM3, 700 W, 415,872 random poses, ring /
# warp ms): float32 P = 56 0.0431 / 0.0866, P = 64 (N = 16) 0.1227 /
# 0.0817, P = 144 0.1538 / 0.1007; float64 P = 56 0.0731 / 0.0910,
# P = 64 (N = 16) 0.2189 / 0.0854, P = 144 0.3973 / 0.1126. Both types
# cross between 56 and 64 pairs. At P = 75 (N = 15) the ring leads on
# 415,872 poses (f32 0.0545 / 0.0953, f64 0.0929 / 0.1003) but not on
# small batches (81 to 972 poses, f64: 0.0096 against 0.0034 ms), so the
# warp regime starts at 64 in both (PERF.md section 6).
CLASH_WARP_MIN_PAIRS = 64
SMEM_OPTIN_BYTES = 232448
# the thread regime's launch plan (thread_plan): poses per tile (= threads
# per block), shared-memory stages in the ring, the smallest tile (one
# full warp) below which the poses go to the v1 kernel, the SM's shared
# memory and what the card keeps of it per block, the card's SMs where
# no card is asked (the CPU tests)
THREAD_TILE = 128
THREAD_STAGES = 2
THREAD_MIN_TILE = 32
SM_SMEM_BYTES = 233472
SMEM_BLOCK_RESERVED = 1024
SM_THREADS = 2048
SM_BLOCKS = 32
SM_COUNT = 132
RING_BAR_BYTES = 32            # csrc/clash.cu: four mbarriers
RING_MAX_STAGES = 4


def _align16(n):
    return -(-n // 16) * 16


def clash_regime(n_pairs, n_atoms, itemsize):
    '''"thread" (one thread per pose) or "warp" (one warp per pose): the
    regime the entries launch for P = n_pairs pairs on poses of n_atoms
    atoms of `itemsize`-byte values. The thread regime launches the ring
    kernel where thread_plan fits it, else the v1 kernel, which takes
    any N and P (pair list in tiles, poses read through L1).'''
    slot = _align16(n_atoms * 3 * itemsize)
    if n_pairs >= CLASH_WARP_MIN_PAIRS and \
            2 * slot + 4 * 128 <= SMEM_OPTIN_BYTES:
        return 'warp'
    return 'thread'


def thread_plan(B, N, P, itemsize, n_sm=SM_COUNT, tile=THREAD_TILE,
                stages=THREAD_STAGES):
    '''The thread regime's launch plan for B poses of N atoms of
    `itemsize`-byte values and P pairs: `tile` poses (and threads) per
    block, `stages` ring stages of `stage_bytes` each, shared memory
    `smem` bytes (barriers, the resident pair list, the ring), `blocks`
    persistent blocks (as many as fit on n_sm SMs at once, no more than
    the tiles). Fewer stages, then smaller tiles, when the ring does not
    fit under the opt-in limit; raises ValueError when a ring of two
    THREAD_MIN_TILE-pose stages does not (the thread regime then
    launches the v1 kernel).'''
    if not 2 <= stages <= RING_MAX_STAGES:
        raise ValueError(f'stages must lie in 2..{RING_MAX_STAGES}')
    pair_bytes = _align16(4 * P)
    while True:
        stage_bytes = _align16(tile * N * 3 * itemsize)
        smem = RING_BAR_BYTES + pair_bytes + stages * stage_bytes
        if smem <= SMEM_OPTIN_BYTES:
            break
        if stages > 2:
            stages -= 1
        elif tile > THREAD_MIN_TILE:
            tile //= 2
        else:
            raise ValueError(f'ring kernel: {N}-atom poses and {P} pairs '
                             f'do not fit in a block\'s shared memory')
    per_sm = min(SM_THREADS // tile, SM_BLOCKS,
                 SM_SMEM_BYTES // (smem + SMEM_BLOCK_RESERVED))
    n_tiles = -(-B // tile)
    return {'tile': tile, 'stages': stages, 'stage_bytes': stage_bytes,
            'smem': smem, 'blocks_per_sm': per_sm, 'tiles': n_tiles,
            'blocks': min(n_tiles, n_sm * per_sm)}


def thread_walk(plan, B, block):
    '''The (first pose, poses) of each tile persistent block `block`
    scans, in order, as the ring kernel walks them.'''
    t, step = plan['tile'], plan['blocks']
    return [(k * t, min(t, B - k * t))
            for k in range(block, plan['tiles'], step)]


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# the ring kernel's tile counters per card: tiles loaded by one bulk copy
# (TMA) and by cp.async granules (a base or a ragged tail off the 16-byte
# grid)
_TILE_PATHS = {}


def _tile_counter(device):
    key = str(device)
    if key not in _TILE_PATHS:
        _TILE_PATHS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _TILE_PATHS[key]


def tile_paths():
    '''{'bulk': n, 'granule': n}: tiles the ring kernel loaded each way
    since the last reset_tile_paths(), over every card (synchronises).'''
    n = sum((c.cpu() for c in _TILE_PATHS.values()),
            torch.zeros(2, dtype=torch.int64))
    return {'bulk': int(n[0]), 'granule': int(n[1])}


def reset_tile_paths():
    for c in _TILE_PATHS.values():
        c.zero_()


def launches_by_entry():
    '''Kernel launches since the last KERNEL.reset_counts(), per entry
    point of this module: K1 `clash_ok`, `torsion_clash_ok` and
    `torsion_backoff`, K2 `compenetration_mask_kernel`.'''
    n = KERNEL.wrapper_launches
    return {k: n.get(k, 0) for k in ('clash_ok', 'compenetration_mask_kernel',
                                     'torsion_clash_ok', 'torsion_backoff')}


def launches_by_regime():
    '''Screen launches since the last KERNEL.reset_counts(), per regime:
    one thread a pose (the ring and the v1 kernel) or one warp a pose.'''
    n = KERNEL.entry_launches
    return {'thread': sum(n[f'clash_ok{v}_f{b}'] for v in ('', '_v1')
                          for b in (32, 64)),
            'warp': n['clash_ok_warp_f32'] + n['clash_ok_warp_f64']}


def warp_plan():
    '''The launch plan of the last warp-regime launch in this process:
    warps per block, pose slots per warp, blocks per SM, pairs per
    shared-memory tile, blocks, cp.async granule bytes, shared memory
    bytes per block.'''
    fn = KERNEL.build().clash_warp_last_plan
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    fn(ctypes.cast(out, ctypes.c_void_p))
    keys = ('warps', 'nbuf', 'blocks_per_sm', 'tile', 'blocks', 'granule',
            'smem')
    return dict(zip(keys, list(out)))


def static_pairs(pair_mask):
    '''(P, 2) int32 array of the (i, j) pairs set in a host pair mask,
    row-major order, each pair once (the JAX package's static pair tuple
    as an array).'''
    mask = pair_mask.cpu().numpy() if torch.is_tensor(pair_mask) \
        else np.asarray(pair_mask)
    return np.stack(np.nonzero(mask), axis=1).astype(np.int32).reshape(-1, 2)


def thresh_squared(thresh, dtype):
    '''thr^2 rounded in the working dtype, as the kernels compare it.'''
    return float(torch.tensor(float(thresh), dtype=dtype) ** 2)


# ------------------------------------------------------------ plain twin


def pairwise_dist2(A, B):
    '''Squared distance matrix in matmul form, batched: A (..., N, 3),
    B (..., M, 3) -> (..., N, M), clamped at 0.'''
    a2 = torch.sum(A * A, dim=-1)
    b2 = torch.sum(B * B, dim=-1)
    ab = torch.einsum('...ni,...mi->...nm', A, B)
    return torch.clamp(a2[..., :, None] + b2[..., None, :] - 2.0 * ab,
                       min=0.0)


def clash_counts_plain(poses, pair_mask, thresh):
    '''Per-pose count of masked atom pairs closer than `thresh`:
    poses (B, N, 3), pair_mask (N, N) bool -> (B,) int32.'''
    d2 = pairwise_dist2(poses, poses)
    hit = (d2 < thresh_squared(thresh, poses.dtype)) & pair_mask
    return torch.sum(hit, dim=(-2, -1)).to(torch.int32)


def pair_mask_from_pairs(pairs, n_atoms, device):
    '''(N, N) bool mask of a pair list; raises ValueError when a pair is
    listed twice (the kernels would count it twice).'''
    mask = torch.zeros((n_atoms, n_atoms), dtype=torch.bool, device=device)
    pairs = torch.as_tensor(pairs, device=device).long().reshape(-1, 2)
    mask[pairs[:, 0], pairs[:, 1]] = True
    if int(mask.sum()) != pairs.shape[0]:
        raise ValueError('the pair list holds a pair more than once')
    return mask


def clash_ok_plain(poses, pairs, thresh, max_clashes=0):
    '''Plain PyTorch twin of `clash_ok`.'''
    mask = pair_mask_from_pairs(pairs, poses.shape[1], poses.device)
    return clash_counts_plain(poses, mask, thresh) <= max_clashes


def pair_clash_ok_plain(poses, pairs, thresh, max_clashes=0):
    '''Plain PyTorch twin of `torsion_clash_ok` on its pair list: the
    listed pairs' squared distances as direct differences, the kernels'
    form, against thr^2 in the working dtype.'''
    pl = torch.as_tensor(pairs, device=poses.device).long()
    d = poses[:, pl[:, 0]] - poses[:, pl[:, 1]]
    hit = torch.sum(d * d, dim=-1) < thresh_squared(thresh, poses.dtype)
    return torch.sum(hit, dim=1) <= max_clashes


# --------------------------------------------------------------- kernels


def launch(poses, pairs, thresh, max_clashes, regime, plan=None,
           wrapper='clash_ok'):
    '''One screen launch of `regime`'s kernel ('thread', 'warp' or 'v1',
    the first thread kernel) on card tensors, pairs a contiguous int32
    (P, 2) tensor; the thread regime with `plan` (by default
    thread_plan's for these shapes, or the v1 kernel where the ring does
    not fit). The entries launch
    clash_regime's choice through it; the crossover sweep, the yardstick
    and the plan sweep a regime or a plan of their own. Returns (B,)
    bool.'''
    if poses.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'clash kernel takes float32/float64, '
                        f'got {poses.dtype}')
    if poses.dim() != 3 or poses.shape[2] != 3:
        raise ValueError(f'poses must be (B, N, 3), got {tuple(poses.shape)}')
    if not poses.is_contiguous():
        raise ValueError('poses must be contiguous')
    if not (pairs.device == poses.device and pairs.dtype == torch.int32
            and pairs.dim() == 2 and pairs.shape[1] == 2
            and pairs.is_contiguous()):
        raise ValueError('pairs must be a contiguous int32 (P, 2) tensor '
                         'on the poses device')
    B, N, P = poses.shape[0], poses.shape[1], pairs.shape[0]
    out = torch.empty(B, dtype=torch.bool, device=poses.device)
    if regime == 'thread' and plan is None:
        try:
            plan = thread_plan(B, N, P, poses.element_size(),
                               n_sm=_sm_count(poses.device))
        except ValueError:   # poses too large for the ring
            regime = 'v1'
    symbol, c_thr = _SYMBOL[regime, poses.dtype]
    args = (ptr(poses), B, N, ptr(pairs), P,
            c_thr(thresh_squared(thresh, poses.dtype)), int(max_clashes),
            ptr(out), stream_of(poses))
    if regime == 'thread':
        args += (plan['tile'], plan['stages'], plan['blocks'], plan['smem'],
                 ptr(_tile_counter(poses.device)))
    KERNEL.launch(symbol, *args, device=poses.device, wrapper=wrapper)
    return out


def _entry(poses, pairs, thresh, max_clashes, wrapper):
    return launch(poses, pairs, thresh, max_clashes,
                  clash_regime(pairs.shape[0], poses.shape[1],
                               poses.element_size()), wrapper=wrapper)


def clash_ok(poses, pairs, thresh, max_clashes=0):
    '''K1: accept mask of a pose batch. poses (B, N, 3) float32/float64;
    pairs (P, 2) int32 distinct atom index pairs (tensor or array); a
    pose passes when at most `max_clashes` pairs are closer than
    `thresh`. Returns (B,) bool on the poses' device.'''
    if poses.device.type == 'cpu':
        return clash_ok_plain(poses, pairs, thresh, max_clashes)
    pairs = torch.as_tensor(pairs, dtype=torch.int32,
                            device=poses.device).contiguous()
    return _entry(poses, pairs, thresh, max_clashes, 'clash_ok')


# K2's pair lists on the device, one per (mask, device): a run screens
# every batch against the same mask, so the list is built and copied once
_PAIRS_OF_MASK = {}


def pairs_of_mask(pair_mask, device):
    '''The (P, 2) int32 pair list of an (N, N) bool pair mask as a tensor
    on `device`, built at the first call with that mask and kept.'''
    mask = pair_mask.cpu().numpy() if torch.is_tensor(pair_mask) \
        else np.asarray(pair_mask)
    mask = np.ascontiguousarray(mask, dtype=bool)
    key = (mask.shape, mask.tobytes(), str(device))
    pairs = _PAIRS_OF_MASK.get(key)
    if pairs is None:
        if len(_PAIRS_OF_MASK) >= 16:
            _PAIRS_OF_MASK.clear()
        pairs = _PAIRS_OF_MASK[key] = torch.as_tensor(static_pairs(mask),
                                                      device=device)
    return pairs


def compenetration_mask_kernel(poses, pair_mask, thresh=1.5, max_clashes=0):
    '''K2: the same screen from an (N, N) bool pair mask (counterpart of
    compenetration_mask_pallas, without its 2048-pose restriction).'''
    if poses.device.type == 'cpu':
        mask = torch.as_tensor(pair_mask, dtype=torch.bool)
        return clash_counts_plain(poses, mask, thresh) <= max_clashes
    return _entry(poses, pairs_of_mask(pair_mask, poses.device), thresh,
                  max_clashes, 'compenetration_mask_kernel')


def torsion_pairs(move_mask, other_mask, device):
    """The (P, 2) int32 device pair list `other x move` of a torsion's
    two sides (host (N,) bool masks), built once per torsion and kept."""
    other = np.asarray(other_mask, dtype=bool)
    return pairs_of_mask(other[:, None] & np.asarray(move_mask, dtype=bool)
                         [None, :], device)


def torsion_clash_ok(poses, move_mask, other_mask, thresh=1.5, max_clashes=0):
    """K1 for the conformer search's back-off: accept mask of poses
    (B, N, 3) whose moved atoms (move_mask) come closer than `thresh` to
    at most `max_clashes` of the other atoms (other_mask, the bond's two
    atoms already left out by the caller). Returns (B,) bool."""
    pairs = torsion_pairs(move_mask, other_mask, poses.device)
    if poses.device.type == 'cpu':
        return pair_clash_ok_plain(poses, pairs, thresh, max_clashes)
    if pairs.shape[0] == 0:
        return torch.ones(poses.shape[0], dtype=torch.bool,
                          device=poses.device)
    return _entry(poses, pairs, thresh, max_clashes, 'torsion_clash_ok')


# ------------------------------------------------ the search's back-off

BACKOFF_STEP = 5.0
BACKOFF_WARPS = 4      # candidates (one a warp) per block


def backoff_terms(coords, quad):
    """The Rodrigues terms of a torsion about the bond quad[1]-quad[2],
    fixed for every retreat step: (fixed, across, turned), each
    (B, N, 3), so that an atom turned by `rad` lies at
    fixed + across cos(rad) + turned sin(rad)."""
    i2, i3 = int(quad[1]), int(quad[2])
    center = coords[:, i3:i3 + 1]
    axis = normalize(coords[:, i2:i2 + 1] - center)
    v = coords - center
    along = axis * torch.sum(axis * v, dim=-1, keepdim=True)
    across = v - along
    turned = torch.linalg.cross(axis.expand_as(v), v, dim=-1)
    return center + along, across, turned


def backoff_retreat(coords, terms, move_mask, angles, pairs, thresh=1.5,
                    max_clashes=0):
    """retreat(s, rows=all) -> (candidates, ok): the rows' poses at
    retreat step s (the moved atoms turned by angle - 5 s degrees), and
    whether each is clash-free on the `other x move` pair list `pairs`
    (pair_clash_ok_plain) with angle - 5 s >= 0."""
    fixed, across, turned = terms
    move = torch.as_tensor(move_mask, device=coords.device)[:, None]

    def retreat(s, rows=slice(None)):
        eff = angles[rows] - s * BACKOFF_STEP
        rad = torch.deg2rad(eff)[:, None, None]
        cand = torch.where(move, fixed[rows] + across[rows] * torch.cos(rad)
                           + turned[rows] * torch.sin(rad), coords[rows])
        return cand, pair_clash_ok_plain(cand, pairs, thresh, max_clashes) \
            & (eff >= 0.0)
    return retreat


def whole_batch(retreat, coords, max_steps):
    """The back-off's loop with every step on the whole batch and no
    host sync: returns (first clash-free pose, found) per row."""
    best = coords
    found = torch.zeros(len(coords), dtype=torch.bool, device=coords.device)
    for s in range(max_steps + 1):
        cand, ok = retreat(s)
        best = torch.where((ok & ~found)[:, None, None], cand, best)
        found = found | ok
    return best, found


def torsion_backoff_plain(coords, quad, move_mask, angles, other_mask,
                          max_steps, thresh=1.5, max_clashes=0):
    """Plain PyTorch twin of `torsion_backoff`: whole_batch over
    backoff_retreat, the screen on torsion_pairs by direct differences."""
    retreat = backoff_retreat(
        coords, backoff_terms(coords, quad), move_mask, angles,
        torsion_pairs(move_mask, other_mask, coords.device), thresh,
        max_clashes)
    best, found = whole_batch(retreat, coords, max_steps)
    rotated = found & (angles != 0.0)
    return torch.where(rotated[:, None, None], best, coords), rotated


def backoff_plan(B, N, P, M, warps=BACKOFF_WARPS):
    """(warps per block, blocks, shared memory bytes) of the back-off
    kernel: the packed pair list and the moved atoms' indices, then one
    float64 pose a warp; fewer warps when they do not fit, ValueError
    when one does not."""
    fixed = _align16(4 * P) + _align16(4 * M)
    while fixed + warps * N * 3 * 8 > SMEM_OPTIN_BYTES:
        if warps == 1:
            raise ValueError(f'back-off kernel: {N}-atom poses and {P} '
                             f'pairs do not fit in a block\'s shared memory')
        warps //= 2
    return warps, -(-B // warps), fixed + warps * N * 3 * 8


_MOVE_INDEX = {}


def move_index(move_mask, device):
    """The int32 indices of the moved atoms on `device`, kept per mask."""
    mask = np.ascontiguousarray(move_mask, dtype=bool)
    key = (mask.tobytes(), str(device))
    idx = _MOVE_INDEX.get(key)
    if idx is None:
        if len(_MOVE_INDEX) >= 16:
            _MOVE_INDEX.clear()
        idx = _MOVE_INDEX[key] = torch.as_tensor(
            np.flatnonzero(mask).astype(np.int32), device=device)
    return idx


def torsion_backoff(coords, quad, move_mask, angles, other_mask, max_steps,
                    thresh=1.5, max_clashes=0):
    """K1's back-off entry: one torsion's 5-degree clash back-off for a
    batch of candidates in one launch. coords (B, N, 3) float64; quad
    the torsion's four atoms; move_mask and other_mask (N,) host bool
    arrays (other_mask leaves out the bond's two atoms); angles (B,)
    float64 degrees; max_steps the retreat steps to try. From the full
    rotation, each candidate retreats 5 degrees a step until its moved
    atoms come within `thresh` of at most `max_clashes` other atoms, or
    the rotation would pass zero. Returns (coords with the first
    clash-free rotation where one was found and the angle is not 0,
    rotated flags (B,) bool). The Rodrigues terms are computed here in
    PyTorch, once per torsion; the kernel rounds each step's arithmetic
    as the plain twin's separate operations do."""
    if coords.device.type == 'cpu':
        return torsion_backoff_plain(coords, quad, move_mask, angles,
                                     other_mask, max_steps, thresh,
                                     max_clashes)
    if coords.dtype != torch.float64 or angles.dtype != torch.float64:
        raise TypeError(f'the back-off kernel takes float64, got '
                        f'{coords.dtype} poses and {angles.dtype} angles')
    if coords.dim() != 3 or coords.shape[2] != 3 or \
            not coords.is_contiguous():
        raise ValueError(f'coords must be a contiguous (B, N, 3) tensor, got '
                         f'{tuple(coords.shape)}')
    B, N = coords.shape[0], coords.shape[1]
    if angles.shape != (B,) or angles.device != coords.device:
        raise ValueError(f'angles must be ({B},) on {coords.device}')
    if len(move_mask) != N or len(other_mask) != N:
        raise ValueError(f'masks must have {N} entries')
    return backoff_launch(coords, backoff_terms(coords, quad), move_mask,
                          angles, other_mask, max_steps, thresh, max_clashes)


def backoff_launch(coords, terms, move_mask, angles, other_mask, max_steps,
                   thresh=1.5, max_clashes=0):
    """The back-off kernel's launch on the torsion's terms (what
    `torsion_backoff` does after backoff_terms, and all a timing of the
    kernel alone should run)."""
    B, N = coords.shape[0], coords.shape[1]
    pairs = torsion_pairs(move_mask, other_mask, coords.device)
    move = move_index(move_mask, coords.device)
    fixed, across, turned = (t.contiguous() for t in terms)
    angles = angles.contiguous()
    out = torch.empty_like(coords)
    rotated = torch.empty(B, dtype=torch.bool, device=coords.device)
    warps, blocks, smem = backoff_plan(B, N, pairs.shape[0], move.numel())
    KERNEL.launch('torsion_backoff_f64', ptr(coords), ptr(fixed),
                  ptr(across), ptr(turned), ptr(angles), B, N, ptr(move),
                  move.numel(), ptr(pairs), pairs.shape[0],
                  thresh_squared(thresh, torch.float64), int(max_clashes),
                  int(max_steps), ptr(out), ptr(rotated), stream_of(coords),
                  warps, blocks, smem, device=coords.device,
                  wrapper='torsion_backoff')
    return out, rotated
