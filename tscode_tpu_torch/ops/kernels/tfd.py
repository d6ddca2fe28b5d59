'''
First similar successor of a TFD prune pass: the hand-written CUDA
kernel `csrc/tfd_first.cu` (T1) and its plain PyTorch twin.

Replaces no Pallas kernel: the JAX package's jitted tile program
tscode_tpu/ops/tfd.py `_tfd_sim_tile` (:75) and the host tile loop
`_first_similar_successor` (:87) that prune_conformers_tfd runs once a
chunk. Here one call decides every chunk of one pass of the K schedule:
the fingerprints tf (n, Q), n the original ensemble size, and the pass
(d = n // k, k, num_active) give the chunks (`pass_chunks`); the result
first (rows,) int32 holds, for each row, the chunk-relative index of its
first similar successor in its chunk, or -1. No chunk's search reads the
prune's mask, so a pass's chunks are independent.

On a CPU tensor `first_successor_pass` runs the twin, which runs the
tile loop of ops/tfd._first_similar_successor per chunk (so the CPU's
numbers are those of the tile loop); on a CUDA tensor it launches the
kernel or raises.
'''

import ctypes

import numpy as np
import torch

from tscode_tpu_torch.backend import traced
from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of

KERNEL = CudaKernel('tfd_first', {
    # tf, Q, d, k, num_active, thresh, row0, rows, first, stream
    'tfd_first_successor': (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p),
})

# warps (rows) a block of csrc/tfd_first.cu, and the shared memory a
# block may hold: Q doubles a warp
_BLOCK_WARPS = 8
_MAX_SMEM = 227 * 1024


def pass_chunks(d, k, num_active, r0=0, r1=None):
    '''(lo, hi) of each chunk of a pass that holds two rows or more, in
    step order (the reference's cut: the last step ends at num_active,
    the others at d * (step + 1)); with [r0, r1) given, only the chunks
    that meet those rows.'''
    d, k, num_active = int(d), int(k), int(num_active)
    first_step = min(r0 // d, k - 1)
    last_step = k - 1 if r1 is None else min(max(r1 - 1, 0) // d, k - 1)
    for step in range(first_step, last_step + 1):
        lo = d * step
        hi = num_active if step == k - 1 else d * (step + 1)
        if hi - lo > 1 and (r1 is None or (lo < r1 and hi > r0)):
            yield lo, hi


def pass_rows(d, k, num_active):
    '''Rows [0, pass_rows) lie in some chunk of the pass; the rest give
    -1.'''
    return max(int(num_active), int(d) * (int(k) - 1))


@traced
def first_successor_pass_plain(tf, d, k, num_active, thresh, rows=None):
    '''Plain PyTorch twin of `first_successor_pass`: the tile loop of
    ops/tfd._first_similar_successor on each chunk of the pass that
    meets `rows` (default all n rows), with its host reads. Returns
    (rows,) int32 on tf's device.'''
    from tscode_tpu_torch.ops import tfd
    r0, r1 = (0, tf.shape[0]) if rows is None else map(int, rows)
    first = torch.full((r1 - r0,), -1, dtype=torch.int32)
    for lo, hi in pass_chunks(d, k, num_active, r0, r1):
        a, b = max(lo, r0), min(hi, r1)
        first[a - r0:b - r0] = torch.from_numpy(tfd._first_similar_successor(
            tf[lo:hi], thresh, a - lo, b - lo))
    return first.to(tf.device)


def _checked(tf, d, k, num_active, rows):
    '''The kernel's arguments, checked: (Q, d, k, num_active, r0, r1);
    raises on what the kernel does not take.'''
    if tf.device.type != 'cuda':
        raise ValueError(f'the tfd_first kernel takes a CUDA tensor, got '
                         f'one on {tf.device}')
    if tf.dtype != torch.float32:
        raise TypeError(f'tfd_first takes float32 fingerprints, got '
                        f'{tf.dtype}')
    if tf.dim() != 2 or not tf.is_contiguous() or tf.shape[1] < 1:
        raise ValueError(f'tf must be a contiguous (n, Q) tensor with Q >= '
                         f'1, got {tuple(tf.shape)}')
    n, Q = tf.shape
    if _BLOCK_WARPS * Q * 8 > _MAX_SMEM:
        raise ValueError(f'{Q} torsions: a block of tfd_first holds at most '
                         f'{_MAX_SMEM // (8 * _BLOCK_WARPS)}')
    d, k, num_active = int(d), int(k), int(num_active)
    if not (d >= 1 and k >= 1 and d * (k - 1) <= n and
            0 <= num_active <= n):
        raise ValueError(f'pass d = {d}, k = {k}, num_active = {num_active} '
                         f'does not fit {n} rows')
    r0, r1 = (0, n) if rows is None else map(int, rows)
    if not 0 <= r0 <= r1 <= n or r1 - r0 >= 2 ** 31:
        raise ValueError(f'rows [{r0}, {r1}) outside [0, {n})')
    return Q, d, k, num_active, r0, r1


@traced
def first_successor_pass(tf, d, k, num_active, thresh, rows=None):
    '''One pass of the TFD prune's search: for each row i of tf (n, Q)
    float32 in `rows` = (r0, r1) (default all n), the chunk-relative
    index of the smallest j > i in i's chunk of the pass (d, k,
    num_active; pass_chunks) with wrapped-L1 distance < thresh, or -1.
    Returns (r1 - r0,) int32 on tf's device. One launch of T1 on a CUDA
    tensor (none for an empty row range); the plain twin on a CPU
    tensor.'''
    if not tf.is_cuda:
        if tf.device.type != 'cpu':
            raise ValueError(f'first_successor_pass: unsupported device '
                             f'{tf.device}')
        return first_successor_pass_plain(tf, d, k, num_active, thresh, rows)
    Q, d, k, num_active, r0, r1 = _checked(tf, d, k, num_active, rows)
    first = torch.empty(r1 - r0, dtype=torch.int32, device=tf.device)
    if r1 > r0:
        KERNEL.launch('tfd_first_successor', ptr(tf), Q, d, k, num_active,
                      ctypes.c_double(float(thresh)), r0, r1 - r0,
                      ptr(first), stream_of(tf), device=tf.device)
    return first


def walked_pairs(first, d, k, num_active, r0=0):
    '''Pairs the kernel evaluates for a pass's result `first` (a numpy
    array over rows r0, ...): for each row in a chunk of two rows or
    more, the pairs up to and including its first hit, or all of its
    chunk after it when it has none. The data-dependent work of the
    bound.'''
    first = np.asarray(first)
    total = 0
    for lo, hi in pass_chunks(d, k, num_active, r0, r0 + len(first)):
        a, b = max(lo, r0), min(hi, r0 + len(first))
        i = np.arange(a, b)
        f = first[a - r0:b - r0].astype(np.int64)
        walk = np.where(f >= 0, f + lo - i, hi - 1 - i)
        total += int(walk.sum())
    return total
