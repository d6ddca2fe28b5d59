'''
Clash screen: the hand-written CUDA kernels of `csrc/clash.cu` and their
plain PyTorch twin.

Replaces the Pallas TPU kernels of tscode_tpu/ops/pallas/clash.py:
K1 `clash_ok_traced` (:119, the production screen) and K2
`compenetration_mask_pallas` (:55, same math with a pair mask). K1 has a
second entry, `torsion_clash_ok`, the conformer search's clash test
between the two sides of a rotated bond (the counterpart of
tscode_tpu/ops/clash.py:168). Every entry below launches one of two
CUDA kernels, chosen by `clash_regime`
from the pair count: one thread per pose for small pair lists, one warp
per pose (pair list resident in shared memory, poses double-buffered
with cp.async) for large ones. Any batch size, atom count and pair
count is taken. The kernels' note says what bounds each regime on the
card.

Pair lists hold each (i, j) pair once, as `static_pairs` makes them:
the kernels count a listed pair each time it is listed, the plain twin's
pair mask only once, so the plain twin raises on a repeated pair.

On a CPU tensor each entry runs the plain version (the matmul form of
tscode_tpu/ops/clash.compenetration_mask; for `torsion_clash_ok` the
direct differences of the kernels and of the JAX package's back-off);
on a CUDA tensor it launches a kernel or raises.
'''

import ctypes

import numpy as np
import torch

from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of

_ENTRY = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_int)
_TAIL = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)

KERNEL = CudaKernel('clash', {
    'clash_ok_f32': _ENTRY + (ctypes.c_float,) + _TAIL,
    'clash_ok_f64': _ENTRY + (ctypes.c_double,) + _TAIL,
    'clash_ok_warp_f32': _ENTRY + (ctypes.c_float,) + _TAIL,
    'clash_ok_warp_f64': _ENTRY + (ctypes.c_double,) + _TAIL,
})

_SYMBOL = {('thread', torch.float32): ('clash_ok_f32', ctypes.c_float),
           ('thread', torch.float64): ('clash_ok_f64', ctypes.c_double),
           ('warp', torch.float32): ('clash_ok_warp_f32', ctypes.c_float),
           ('warp', torch.float64): ('clash_ok_warp_f64', ctypes.c_double)}

# The warp regime takes pair lists of at least this many pairs, as long
# as two pose slots and one 128-pair step fit in a block's shared memory
# (the card's opt-in limit). The crossover, measured on an NVIDIA H100
# 80GB HBM3 at 700 W with 415,872 f32 poses: thread 0.066 ms against
# warp 0.083 ms at P = 30, even from P = 49 to 56, warp 0.086 ms against
# thread 0.269 ms at P = 64 (PERF.md section 6 has the sweep).
CLASH_WARP_MIN_PAIRS = 64
SMEM_OPTIN_BYTES = 232448


def clash_regime(n_pairs, n_atoms, itemsize):
    '''"thread" (one thread per pose) or "warp" (one warp per pose): the
    kernel the entries launch for P = n_pairs pairs on poses of n_atoms
    atoms of `itemsize`-byte values.'''
    slot = -(-n_atoms * 3 * itemsize // 16) * 16
    if n_pairs >= CLASH_WARP_MIN_PAIRS and \
            2 * slot + 4 * 128 <= SMEM_OPTIN_BYTES:
        return 'warp'
    return 'thread'


def launches_by_entry():
    '''Kernel launches since the last KERNEL.reset_counts(), per entry
    point of this module: K1 `clash_ok` and `torsion_clash_ok`, K2
    `compenetration_mask_kernel`.'''
    n = KERNEL.wrapper_launches
    return {k: n.get(k, 0) for k in ('clash_ok', 'compenetration_mask_kernel',
                                     'torsion_clash_ok')}


def launches_by_regime():
    '''Kernel launches since the last KERNEL.reset_counts(), per regime.'''
    n = KERNEL.entry_launches
    return {r: sum(v for k, v in n.items() if ('warp' in k) == (r == 'warp'))
            for r in ('thread', 'warp')}


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


def _launch(poses, pairs, thresh, max_clashes, wrapper):
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
    B, N = poses.shape[0], poses.shape[1]
    regime = clash_regime(pairs.shape[0], N, poses.element_size())
    out = torch.empty(B, dtype=torch.bool, device=poses.device)
    symbol, c_thr = _SYMBOL[regime, poses.dtype]
    KERNEL.launch(symbol, ptr(poses), B, N, ptr(pairs), pairs.shape[0],
                  c_thr(thresh_squared(thresh, poses.dtype)),
                  int(max_clashes), ptr(out), stream_of(poses),
                  device=poses.device, wrapper=wrapper)
    return out


def clash_ok(poses, pairs, thresh, max_clashes=0):
    '''K1: accept mask of a pose batch. poses (B, N, 3) float32/float64;
    pairs (P, 2) int32 distinct atom index pairs (tensor or array); a
    pose passes when at most `max_clashes` pairs are closer than
    `thresh`. Returns (B,) bool on the poses' device.'''
    if poses.device.type == 'cpu':
        return clash_ok_plain(poses, pairs, thresh, max_clashes)
    pairs = torch.as_tensor(pairs, dtype=torch.int32,
                            device=poses.device).contiguous()
    return _launch(poses, pairs, thresh, max_clashes, 'clash_ok')


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
    return _launch(poses, pairs_of_mask(pair_mask, poses.device), thresh,
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
    return _launch(poses, pairs, thresh, max_clashes, 'torsion_clash_ok')
