'''
The string embed's TFD novelty filter on the card: the hand-written CUDA
kernel `csrc/tfd_novelty.cu` (V1), and its plain twin.

Replaces no Pallas kernel: the JAX package's jitted scan
tscode_tpu/ops/tfd.py `_tfd_novelty_scan` (:230, called from
`tfd_novelty_device`, :302). The rule is sequential: in row order, a row
is novel iff it passes the accept mask and its wrapped-L1 distance to
every earlier novel row is at least `thresh`, summed in float64 torsion
by torsion (the float32 fingerprints widened), as the native replay
(native/tfd_lru.cpp) sums it. V1 runs the whole rule in one launch: a
cooperative grid of the card's resident blocks walks the rows in tiles
of at most 4,096 rows, compares each tile with the cache of accepted
fingerprints in parallel, pairs the tile's undecided rows with each
other in parallel into a bit matrix, resolves them in order on one warp
by bit tests, and appends the accepted ones to the cache (cache_cap
rows; past it the launch stops with ok False, and the caller runs the
host replay, the JAX package's contract).

This module takes CUDA tensors only; ops/tfd.tfd_novelty_device is the
entry (one launch on the card, its per-block loop on the CPU).
`novelty_plain` is the plain twin: the same rule on tensors, which also
counts the comparisons the rule walks and the terms their sums add (the
bound's operations).
'''

import ctypes
from collections import namedtuple

import numpy as np
import torch

from tscode_tpu_torch.ops.kernels._build import (CudaKernel, device_guard,
                                                 ptr, stream_of)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = CudaKernel('tfd_novelty', {
    # fps, accept, B, Q, thresh, block, cache_cap, staged, cache, novel,
    # state, bits, smem, stream
    'tfd_novelty_f64': (_P, _P, _L, _I, ctypes.c_double, _I, _I, _I, _P, _P,
                        _P, _P, _L, _P),
})

# threads a block (csrc/tfd_novelty.cu NOV_THREADS), the rows of a tile
# at most (NOV_TILE), and the shared bytes a block gives the staged cache
# and its warps' rows at most: the default cache of 1,024 entries is
# staged whole up to 11 torsions, and two blocks stay resident on an SM
THREADS = 256
TILE = 4096
STAGE_BYTES = 100 * 1024


def launch_plan(Q, cache_cap, block=TILE):
    '''{staged: the cache entries a block holds in shared memory, tile:
    the rows a tile (min(block, TILE)), smem: the block's dynamic shared
    bytes (those entries at an odd stride of Q | 1 values, one row of Q
    values a warp, a list of a tile's rows in 16 bits and its rejected
    set in 32-bit words), bits: the int32 words of the launch's scratch
    (the bit masks of two tiles, and a tile's bit matrix)}.'''
    rows = THREADS // 32 * Q * 8
    staged = max(0, min(cache_cap, (STAGE_BYTES - rows) // ((Q | 1) * 8)))
    tile = min(int(block), TILE)
    words = -(-tile // 32)
    return {'staged': staged, 'tile': tile,
            'smem': staged * (Q | 1) * 8 + rows + 2 * (tile + tile % 2) +
            4 * words,
            'bits': 2 * (TILE // 32) + tile * words}


def tfd_novelty(fps, accept=None, thresh=10.0, block=4096, cache_cap=1024):
    '''One launch of V1 on fingerprints fps (B, Q) float32 on the card and
    an optional accept mask (B,) bool: returns (novel (B,) bool, state (2,)
    int32: the accepted rows, cache_cap + 1 after an overflow, and ok),
    both on the card, read by nobody here (the kernel's counters of a
    tile's undecided rows, state[2:], are cut off). The rule's result
    does not depend on `block`; the kernel walks tiles of min(block,
    TILE) rows.'''
    if fps.device.type != 'cuda':
        raise ValueError(f'the tfd_novelty kernel takes CUDA tensors, got '
                         f'one on {fps.device}')
    if fps.dtype != torch.float32 or fps.dim() != 2:
        raise TypeError(f'fps must be a (B, Q) float32 tensor, got '
                        f'{tuple(fps.shape)} {fps.dtype}')
    B, Q = fps.shape
    if Q == 0:
        raise ValueError('fps has no torsions')
    fps = fps.contiguous()
    dev = fps.device
    if accept is not None:
        accept = torch.as_tensor(accept, device=dev).to(torch.bool) \
            .contiguous()
        if accept.shape != (B,):
            raise ValueError(f'accept must be ({B},)')
    if block <= 0:
        raise ValueError(f'block must be positive, got {block}')
    plan = launch_plan(Q, cache_cap, block)
    cache = torch.empty((max(1, cache_cap), Q), dtype=torch.float64,
                        device=dev)
    novel = torch.zeros(B, dtype=torch.bool, device=dev)
    state = torch.zeros(4, dtype=torch.int32, device=dev)
    state[1] = 1
    bits = torch.zeros(plan['bits'], dtype=torch.int32, device=dev)
    if B:
        KERNEL.launch('tfd_novelty_f64', ptr(fps),
                      None if accept is None else ptr(accept), B, Q,
                      float(thresh), int(block), int(cache_cap),
                      plan['staged'], ptr(cache), ptr(novel), ptr(state),
                      ptr(bits), plan['smem'], stream_of(fps), device=dev,
                      wrapper='tfd_novelty')
    return novel, state[:2]


def kernel_info(Q, cache_cap, device, block=TILE):
    '''{registers, local_bytes, blocks_per_sm, resident_blocks} of V1 at
    launch_plan(Q, cache_cap, block)'s shared bytes on `device`: a
    launch's grid is the resident blocks (blocks_per_sm times the SMs),
    or fewer when a tile needs fewer warps.'''
    lib = KERNEL.build()
    fn = lib.tfd_novelty_info
    fn.argtypes, fn.restype = [_L, _P], _I
    out = (ctypes.c_int * 3)()
    with device_guard(device):
        code = fn(launch_plan(Q, cache_cap, block)['smem'],
                  ctypes.cast(out, _P))
    if code:
        raise RuntimeError(f'tfd_novelty_info failed: cudaError {code}')
    info = dict(zip(('registers', 'local_bytes', 'blocks_per_sm'),
                    list(out)))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dict(info, resident_blocks=info['blocks_per_sm'] * sms)


# the work the sequential rule does: the (row, accepted row) comparisons
# it walks, each row's up to its first hit, and the terms their sums add,
# each sum up to the torsion where it reaches thresh (all Q for a
# similar pair)
Walked = namedtuple('Walked', 'comparisons terms')


def _first_hits(sim):
    '''(R, C) bool -> (R,) int64: each row's first True column, C where
    none.'''
    C = sim.shape[1]
    idx = torch.arange(C, device=sim.device)
    return torch.where(sim, idx, C).amin(dim=1) if C else \
        torch.zeros(sim.shape[0], dtype=torch.int64, device=sim.device)


def _distances(A, B, thresh):
    '''(R, Q) x (C, Q) float64 -> ((R, C) wrapped-L1 distance summed in
    torsion order, as ops/tfd.wrapped_l1 sums it; (R, C) int64 the terms
    that V1's sum adds before it stops, the torsions up to the one where
    the partial sum reaches thresh).'''
    acc = torch.zeros((A.shape[0], B.shape[0]), dtype=torch.float64,
                      device=A.device)
    terms = torch.zeros(acc.shape, dtype=torch.int64, device=A.device)
    for q in range(A.shape[1]):
        terms += acc < thresh
        d = torch.abs(A[:, q, None] - B[None, :, q])
        acc += torch.minimum(d, torch.abs(d - 360.0))
    return acc, terms


def novelty_plain(fps, accept=None, thresh=10.0, block=4096, cache_cap=1024):
    '''Plain twin of tfd_novelty: the sequential rule on tensors, in blocks
    of `block` rows as V1 walks them: the block's rows against the cache
    of earlier accepted rows (float64 sums, ops/tfd.wrapped_l1's), then
    its undecided rows in order against the rows accepted earlier in the
    block. Returns (novel (B,) bool, ok, the accepted rows (cache_cap + 1
    after an overflow), Walked: the comparisons the rule makes, each
    row's up to its first hit, and the terms their sums add).'''
    B = fps.shape[0]
    dev = fps.device
    f64 = fps.to(torch.float32).double()
    live = torch.ones(B, dtype=torch.bool, device=dev) if accept is None \
        else torch.as_tensor(accept, device=dev).to(torch.bool)
    novel = torch.zeros(B, dtype=torch.bool, device=dev)
    cache = f64[:0]
    walked = terms = 0
    for lo in range(0, B, block):
        f = f64[lo:lo + block]
        und = live[lo:lo + block].clone()
        if cache.shape[0]:
            dist, n = _distances(f[und], cache, thresh)
            first = _first_hits(dist < thresh)
            walked += int(torch.clamp(first + 1, max=cache.shape[0]).sum())
            upto = torch.arange(cache.shape[0], device=dev) <= first[:, None]
            terms += int((n * upto).sum())
            und[und.clone()] = first == cache.shape[0]
        rows = torch.nonzero(und).squeeze(1)
        if rows.numel() == 0:
            continue
        dist, n = _distances(f[rows], f[rows], thresh)
        sim, n = (dist < thresh).cpu().numpy(), n.cpu().numpy()
        acc = []
        for i in range(rows.numel()):
            hits = np.flatnonzero(sim[i, acc]) if acc else ()
            k = (int(hits[0]) + 1) if len(hits) else len(acc)
            walked += k
            terms += int(n[i, acc[:k]].sum())
            if len(hits):
                continue
            if cache.shape[0] + len(acc) == cache_cap:
                return novel, False, cache_cap + 1, Walked(walked, terms)
            acc.append(i)
        idx = rows[torch.as_tensor(acc, dtype=torch.long, device=dev)]
        novel[lo + idx] = True
        cache = torch.cat([cache, f[idx]])
    return novel, True, cache.shape[0], Walked(walked, terms)
