'''
Clash screen: the hand-written CUDA kernel `csrc/clash.cu` and its plain
PyTorch twin.

Replaces the Pallas TPU kernels of tscode_tpu/ops/pallas/clash.py:
K1 `clash_ok_traced` (:99, the production screen) and K2
`compenetration_mask_pallas` (:70, same math with a pair mask). Both
entries below launch the one CUDA kernel: one thread per pose, the pair
list passed through shared memory in tiles, any batch size, atom count
and pair count. The kernel's note says what bounds it on the card.

On a CPU tensor each entry runs the plain version (the matmul form of
tscode_tpu/ops/clash.compenetration_mask); on a CUDA tensor it launches
the kernel or raises.
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
})

_SYMBOL = {torch.float32: ('clash_ok_f32', ctypes.c_float),
           torch.float64: ('clash_ok_f64', ctypes.c_double)}


def static_pairs(pair_mask):
    '''(P, 2) int32 array of the (i, j) pairs set in a host pair mask,
    row-major order (the JAX package's static pair tuple as an array).'''
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
    mask = torch.zeros((n_atoms, n_atoms), dtype=torch.bool, device=device)
    pairs = torch.as_tensor(pairs, device=device).long()
    mask[pairs[:, 0], pairs[:, 1]] = True
    return mask


def clash_ok_plain(poses, pairs, thresh, max_clashes=0):
    '''Plain PyTorch twin of `clash_ok`.'''
    mask = pair_mask_from_pairs(pairs, poses.shape[1], poses.device)
    return clash_counts_plain(poses, mask, thresh) <= max_clashes


# ---------------------------------------------------------------- kernel


def _launch(poses, pairs, thresh, max_clashes):
    if poses.dtype not in _SYMBOL:
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
    out = torch.empty(B, dtype=torch.bool, device=poses.device)
    symbol, c_thr = _SYMBOL[poses.dtype]
    KERNEL.launch(symbol, ptr(poses), B, N, ptr(pairs), pairs.shape[0],
                  c_thr(thresh_squared(thresh, poses.dtype)),
                  int(max_clashes), ptr(out), stream_of(poses))
    return out


def clash_ok(poses, pairs, thresh, max_clashes=0):
    '''K1: accept mask of a pose batch. poses (B, N, 3) float32/float64;
    pairs (P, 2) int32 atom index pairs (tensor or array); a pose passes
    when at most `max_clashes` pairs are closer than `thresh`.
    Returns (B,) bool on the poses' device.'''
    if poses.device.type == 'cpu':
        return clash_ok_plain(poses, pairs, thresh, max_clashes)
    pairs = torch.as_tensor(pairs, dtype=torch.int32,
                            device=poses.device).contiguous()
    return _launch(poses, pairs, thresh, max_clashes)


def compenetration_mask_kernel(poses, pair_mask, thresh=1.5, max_clashes=0):
    '''K2: the same screen from an (N, N) bool pair mask (counterpart of
    compenetration_mask_pallas, without its 2048-pose restriction).'''
    if poses.device.type == 'cpu':
        mask = torch.as_tensor(pair_mask, dtype=torch.bool)
        return clash_counts_plain(poses, mask, thresh) <= max_clashes
    pairs = torch.as_tensor(static_pairs(pair_mask), device=poses.device)
    return _launch(poses, pairs, thresh, max_clashes)
