'''
The string embed's pose grid with its clash screen on the card: the
hand-written CUDA kernel `csrc/string_grid.cu` (G1), and its plain twins.

Replaces no Pallas kernel: the JAX package's jitted string grid
(tscode_tpu/embeds/string.py `_string_sweep_bcast`, :134, its block
`_string_bcast_block`, :76; bench.py `_embed_clash_all`, :117, and
`_embed_clash_all_mapped`, :190): every pose of the (c2, c1, l2, l1, ai)
grid, K1's clash screen and the compaction of the survivors by the mask.
G1 writes no pose but a survivor. Two launches: `keep` (an ok byte a row
and a kept count a (c2, c1) group; no pose written) and `write` (the
kept poses, or only their heavy atoms, at offsets from a scan of the
counts, optionally past a base count held on the device and bounded by
a pool's size). The rotation tables `align` and `spin` are built here
in PyTorch (`grid_tables`) with the same functions as the broadcast
block (embeds/string.bcast_poses), so the antiparallel branch and the
clamps keep their bits.

This module takes CUDA tensors only, as ops/kernels/block_screen.py
does; the grid's entry, embeds/string.grid_screen, runs the plain twin
`string_grid_plain` on a CPU tensor. `string_grid_order_plain` computes
the kernel's arithmetic in the kernel's order with elementwise tensor
ops, each rounded on its own, so that on the card G1 is held to it bit
for bit.
'''

import ctypes
from collections import namedtuple

import torch

from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of
from tscode_tpu_torch.ops.kernels.clash import (CLASH_WARP_MIN_PAIRS,
                                                SMEM_OPTIN_BYTES,
                                                clash_ok_plain,
                                                thresh_squared)
from tscode_tpu_torch.ops.linalg import (rot_mat_from_pointer,
                                         rotation_matrix_from_vectors)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# coords1, coords2, centers1, centers2, align, spin, N1, N2, n1c, g, k1,
# k2, A
_GRID = (_P,) * 6 + (_I,) * 7
# pairs, P, thr^2, ok, counts, regime, threads, stage_pairs, stream
_KEEP = _GRID + (_P, _I, ctypes.c_double, _P, _P, _I, _I, _I, _P)
# ok, offsets, base, bound, heavy, H, out, stream
_WRITE = _GRID + (_P, _P, _P, _L, _P, _I, _P, _P)
KERNEL = CudaKernel('string_grid', {
    'string_keep_f32': _KEEP, 'string_keep_f64': _KEEP,
    'string_write_f32': _WRITE, 'string_write_f64': _WRITE,
})
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}
_REGIME = {'thread': 0, 'warp': 1}

# the thread regime: at most this many rows (threads) a block; the warp
# regime: at most this many warps a block
THREAD_ROWS = 128
WARP_ROWS = 8
NO_BOUND = (1 << 63) - 1


def _align16(n):
    return -(-n // 16) * 16


def plan_for(N1, N2, P, rows, itemsize):
    '''How G1's keep launch runs on (c2, c1) groups of `rows` grid rows of
    N1 + N2 atoms and P pairs: regime ('thread': a thread a row, below
    CLASH_WARP_MIN_PAIRS pairs, K1's switch; 'warp': a warp a row),
    threads a block (the group's rows, in whole warps, at most
    THREAD_ROWS; in the warp regime at most WARP_ROWS warps), stage_pairs
    (the packed pair list in shared memory, else read from device
    memory) and smem (the block's dynamic shared bytes;
    csrc/string_grid.cu keep_smem computes the same). Fewer threads
    when a block's shared memory does not fit; ValueError when one warp
    does not.'''
    regime = 'warp' if P >= CLASH_WARP_MIN_PAIRS else 'thread'
    pair_bytes = _align16(4 * P)
    slot = _align16((N1 + N2) * 3 * itemsize)

    def smem(threads, staged):
        fixed = pair_bytes if staged else 0
        if regime == 'warp':
            return fixed + threads // 32 * slot
        return fixed + (N1 + N2 + N2 * threads) * 3 * itemsize

    if regime == 'warp':
        threads = 32 * max(1, min(WARP_ROWS, rows))
    else:
        threads = 32 * max(1, min(THREAD_ROWS // 32, -(-rows // 32)))
    for staged in (True, False):
        t = threads
        while t > 32 and smem(t, staged) > SMEM_OPTIN_BYTES:
            t -= 32
        if smem(t, staged) <= SMEM_OPTIN_BYTES:
            return {'regime': regime, 'threads': t, 'stage_pairs': staged,
                    'smem': smem(t, staged)}
    raise ValueError(f'G1: {N1 + N2}-atom poses do not fit a block\'s '
                     f'shared memory in the {regime} regime')


def grid_tables(inp, angles, c2_lo, c2_hi):
    '''The grid's rotation tables for the c2 values [c2_lo, c2_hi):
    align (g, n1c, k2, k1, 3, 3), the turn of molecule 2's lobe onto
    molecule 1's (rotation_matrix_from_vectors(vecs2, -vecs1)), and spin
    (n1c, k1, A, 3, 3), the turn about molecule 1's orbital by each
    angle (rot_mat_from_pointer): the broadcast block's functions on
    the same values, so the same bits.'''
    n1c, k1 = inp.centers1.shape[:2]
    A = angles.shape[0]
    ref_vec = inp.vecs1[None, :, None, :]                # (1, n1c, 1, k1, 3)
    mol_vec = inp.vecs2[c2_lo:c2_hi, None, :, None]      # (g, 1, k2, 1, 3)
    align = rotation_matrix_from_vectors(mol_vec, -ref_vec)
    spin = rot_mat_from_pointer(
        inp.vecs1[:, :, None].expand(n1c, k1, A, 3),
        angles.expand(n1c, k1, A))
    return align.contiguous(), spin.contiguous()


def packed_pairs(pairs):
    '''The (P, 2) pair list as the kernel reads it: one int32 word a pair,
    (i << 16) | j.'''
    pl = pairs.to(torch.int64)
    return ((pl[:, 0] << 16) | pl[:, 1]).to(torch.int32).contiguous()


# one keep launch: the grid's inputs (tensors and shape), ok (B,) bool and
# counts (groups,) int32, the kept rows not yet written, and the launch's
# packed pairs, thr^2 and plan
Kept = namedtuple('Kept', 'grid ok counts pairs thr2 plan')


def _grid_args(inp, align, spin, c2_lo, c2_hi):
    c2 = slice(c2_lo, c2_hi)
    tensors = (inp.coords1.contiguous(), inp.coords2[c2].contiguous(),
               inp.centers1.contiguous(), inp.centers2[c2].contiguous(),
               align, spin)
    n1c, k1 = inp.centers1.shape[:2]
    shape = (inp.coords1.shape[1], inp.coords2.shape[1], n1c, c2_hi - c2_lo,
             k1, inp.centers2.shape[1], spin.shape[2])
    return tensors, shape


def _checked(inp, angles, c2_lo, c2_hi):
    dev, dtype = inp.coords1.device, inp.coords1.dtype
    if dev.type != 'cuda':
        raise ValueError(f'the string_grid kernel takes CUDA tensors, got '
                         f'one on {dev}')
    if dtype not in _SUFFIX:
        raise TypeError(f'string_grid takes float32/float64, got {dtype}')
    for t in (inp.coords2, inp.centers1, inp.vecs1, inp.centers2, inp.vecs2,
              angles):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f'every grid input must be {dtype} on {dev}')
    if not 0 <= c2_lo <= c2_hi <= inp.coords2.shape[0]:
        raise ValueError(f'c2 range [{c2_lo}, {c2_hi}) outside the '
                         f'{inp.coords2.shape[0]} conformers')
    if inp.n_atoms > 65535:
        raise ValueError('G1 packs atom indices in 16 bits')


def keep(inp, angles, c2_lo, c2_hi, clash_thresh):
    '''The first launch of G1 on the grid rows of c2 values [c2_lo, c2_hi):
    returns a Kept whose ok (B,) bool says which rows pass the clash
    screen and whose counts (groups,) int32 hold each (c2, c1) group's
    kept rows. Queues the launch and reads nothing back. Raises on a
    tensor that is not on the card.'''
    _checked(inp, angles, c2_lo, c2_hi)
    align, spin = grid_tables(inp, angles, c2_lo, c2_hi)
    tensors, shape = _grid_args(inp, align, spin, c2_lo, c2_hi)
    N1, N2, n1c, g, k1, k2, A = shape
    rows = k2 * k1 * A
    dev, dtype = inp.coords1.device, inp.coords1.dtype
    ok = torch.empty(g * n1c * rows, dtype=torch.bool, device=dev)
    counts = torch.empty(g * n1c, dtype=torch.int32, device=dev)
    pairs = packed_pairs(inp.pairs)
    k = Kept((tensors, shape), ok, counts, pairs,
             thresh_squared(clash_thresh, dtype),
             plan_for(N1, N2, pairs.shape[0], rows,
                      inp.coords1.element_size()))
    launch_keep(k)
    return k


def launch_keep(k):
    '''The keep kernel's launch on a Kept's inputs, into its ok and
    counts (what keep does after building the tables, and all a timing
    of the kernel alone should run).'''
    tensors, shape = k.grid
    if k.ok.numel():
        KERNEL.launch(f'string_keep_{_SUFFIX[tensors[0].dtype]}',
                      *(ptr(t) for t in tensors), *shape, ptr(k.pairs),
                      k.pairs.shape[0], k.thr2, ptr(k.ok), ptr(k.counts),
                      _REGIME[k.plan['regime']], k.plan['threads'],
                      int(k.plan['stage_pairs']), stream_of(k.ok),
                      device=k.ok.device, wrapper='string_keep')


def write(k, out, heavy_idx=None, base=None, bound=None):
    '''The second launch of G1: the kept rows of a Kept into out (rows, H,
    3) in grid order, from row base[0] (an int64 device tensor; 0 when
    None), each row's atoms heavy_idx (all atoms when None); rows at or
    past `bound` are not written. Each pose is bit for bit the pose the
    keep launch screened.'''
    tensors, shape = k.grid
    ends = torch.cumsum(k.counts, 0, dtype=torch.int64)
    offsets = ends - k.counts
    heavy = None if heavy_idx is None else heavy_idx.to(torch.int32) \
        .contiguous()
    H = shape[0] + shape[1] if heavy is None else heavy.numel()
    if out.shape[1:] != (H, 3) or not out.is_contiguous() or \
            out.dtype != tensors[0].dtype:
        raise ValueError(f'out must be a contiguous (rows, {H}, 3) '
                         f'{tensors[0].dtype} tensor')
    if base is not None and (base.dtype != torch.int64 or
                             base.device != out.device):
        raise ValueError('base must be an int64 tensor on the card')
    if k.counts.numel() and H:
        KERNEL.launch(f'string_write_{_SUFFIX[out.dtype]}',
                      *(ptr(t) for t in tensors), *shape, ptr(k.ok),
                      ptr(offsets), None if base is None else ptr(base),
                      NO_BOUND if bound is None else int(bound),
                      None if heavy is None else ptr(heavy), H, ptr(out),
                      stream_of(out), device=out.device,
                      wrapper='string_write')
    return out


def survivors(k, heavy_idx=None):
    '''The kept rows of a Kept, (S, N, 3) or (S, H, 3) with heavy_idx, in
    grid order: one host read (the total S) sizes them, then the write
    launch (none when nothing survived).'''
    tensors, shape = k.grid
    total = int(k.counts.sum()) if k.counts.numel() else 0
    H = shape[0] + shape[1] if heavy_idx is None else heavy_idx.numel()
    out = torch.empty((total, H, 3), dtype=tensors[0].dtype,
                      device=tensors[0].device)
    if total:
        write(k, out, heavy_idx)
    return out


def string_grid(inp, angles, c2_lo, c2_hi, clash_thresh, heavy=False):
    '''G1's two launches on the rows of c2 values [c2_lo, c2_hi): returns
    (kept (S, N, 3), or (S, H, 3) of inp.heavy_idx with heavy=True, in
    grid order; ok (B,) bool), with one host read between them.'''
    k = keep(inp, angles, c2_lo, c2_hi, clash_thresh)
    return survivors(k, inp.heavy_idx if heavy else None), k.ok


def string_grid_into(inp, angles, c2_lo, c2_hi, clash_thresh, pool, n_ok):
    '''G1's two launches with no host read: the kept rows' heavy atoms
    written into pool (s_pool, H, 3) from row n_ok[0] (int64, on the
    card), rows past the pool dropped. Returns (ok (B,) bool, the count
    after them: n_ok + the kept rows, on the card).'''
    k = keep(inp, angles, c2_lo, c2_hi, clash_thresh)
    write(k, pool, inp.heavy_idx, base=n_ok, bound=pool.shape[0])
    return k.ok, n_ok + k.counts.sum(dtype=torch.int64)


# ------------------------------------------------------------ plain twins


def _compacted(poses, ok, heavy_idx):
    kept = poses[ok]
    return kept[:, heavy_idx] if heavy_idx is not None else kept


def string_grid_plain(inp, angles, c2_lo, c2_hi, clash_thresh, heavy=False):
    '''Plain twin of string_grid: the broadcast block's poses
    (embeds/string.bcast_poses), K1's plain twin clash_ok_plain, the
    survivors compacted by the mask. -> (kept, ok).'''
    from tscode_tpu_torch.embeds.string import bcast_poses
    poses = bcast_poses(inp, angles, c2_lo, c2_hi)
    ok = clash_ok_plain(poses, inp.pairs, clash_thresh)
    return _compacted(poses, ok, inp.heavy_idx if heavy else None), ok


def order_poses(inp, align, spin, c2_lo, c2_hi):
    '''The grid's poses (B, N, 3) of c2 values [c2_lo, c2_hi) in G1's
    order of operations, each product and sum a separate elementwise
    op: R_ij = (s_i0 a_0j + s_i1 a_1j) + s_i2 a_2j, t = p1 - ((R_i0 p2_0
    + R_i1 p2_1) + R_i2 p2_2), a moved atom ((R_i0 x + R_i1 y) + R_i2 z)
    + t_i.'''
    n1c, k1 = inp.centers1.shape[:2]
    k2 = inp.centers2.shape[1]
    g, A = c2_hi - c2_lo, spin.shape[2]
    s = spin[None, :, None]                     # (1, n1c, 1, k1, A, 3, 3)
    a = align[:, :, :, :, None]                 # (g, n1c, k2, k1, 1, 3, 3)
    R = (s[..., :, 0, None] * a[..., None, 0, :]
         + s[..., :, 1, None] * a[..., None, 1, :]) \
        + s[..., :, 2, None] * a[..., None, 2, :]
    p1 = inp.centers1[None, :, None, :, None]   # (1, n1c, 1, k1, 1, 3)
    p2 = inp.centers2[c2_lo:c2_hi, None, :, None, None]
    t = p1 - ((R[..., 0] * p2[..., 0, None] + R[..., 1] * p2[..., 1, None])
              + R[..., 2] * p2[..., 2, None])
    c = inp.coords2[c2_lo:c2_hi, None, None, None, None]   # (..., N2, 3)
    Rn, tn = R[..., None, :, :], t[..., None, :]
    f2 = ((Rn[..., 0] * c[..., 0, None] + Rn[..., 1] * c[..., 1, None])
          + Rn[..., 2] * c[..., 2, None]) + tn
    shape5 = (g, n1c, k2, k1, A)
    f1 = inp.coords1[None, :, None, None, None].expand(
        shape5 + inp.coords1.shape[1:])
    return torch.cat([f1, f2.expand(shape5 + f2.shape[-2:])],
                     dim=-2).reshape(-1, inp.n_atoms, 3)


def order_clash_ok(poses, pairs, clash_thresh, chunk=1 << 24):
    '''(B,) bool: no listed pair closer than clash_thresh, the squared
    distance in difference form rounded as G1 rounds it, ((dx dx + dy
    dy) + dz dz), against thr^2 in the working dtype; in chunks of
    poses of about `chunk` pair coordinates.'''
    pl = pairs.long()
    thr2 = thresh_squared(clash_thresh, poses.dtype)
    step = max(1, chunk // max(1, 3 * pl.shape[0]))
    out = []
    for lo in range(0, poses.shape[0], step):
        x = poses[lo:lo + step]
        d = x[:, pl[:, 0]] - x[:, pl[:, 1]]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        out.append(~torch.any(d2 < thr2, dim=1))
    return torch.cat(out) if out else \
        torch.ones(0, dtype=torch.bool, device=poses.device)


def string_grid_order_plain(inp, angles, c2_lo, c2_hi, clash_thresh,
                            heavy=False):
    '''Twin of string_grid in G1's order of operations (grid_tables,
    order_poses, order_clash_ok, then the mask's compaction): on the
    card the kernel gives its bits. -> (kept, ok).'''
    align, spin = grid_tables(inp, angles, c2_lo, c2_hi)
    poses = order_poses(inp, align, spin, c2_lo, c2_hi)
    ok = order_clash_ok(poses, inp.pairs, clash_thresh)
    return _compacted(poses, ok, inp.heavy_idx if heavy else None), ok


def into_pool(kept, pool, n_ok):
    '''The rows kept (S, H, 3) written into pool from row n_ok[0] (read on
    the host), the rows past the pool dropped: returns n_ok + S (the
    plain form of string_grid_into's write).'''
    base = int(n_ok.reshape(-1)[0])
    n = max(0, min(kept.shape[0], pool.shape[0] - base))
    pool[base:base + n] = kept[:n]
    return n_ok + kept.shape[0]


def string_grid_into_plain(inp, angles, c2_lo, c2_hi, clash_thresh, pool,
                           n_ok):
    '''Plain twin of string_grid_into (in the kernel's order): the
    survivors' heavy atoms written into pool by into_pool. -> (ok, n_ok
    + the kept rows).'''
    kept, ok = string_grid_order_plain(inp, angles, c2_lo, c2_hi,
                                       clash_thresh, heavy=True)
    return ok, into_pool(kept, pool, n_ok)


def kernel_info(dtype, regime, device):
    '''{keep_registers, keep_local_bytes, write_registers,
    write_local_bytes} of G1's keep kernel of `regime` and its write
    kernel in `dtype` on `device`.'''
    from tscode_tpu_torch.ops.kernels._build import device_guard
    lib = KERNEL.build()
    fn = lib.string_grid_info
    fn.argtypes, fn.restype = [_I, _I, _P], _I
    out = (ctypes.c_int * 4)()
    with device_guard(device):
        code = fn(int(dtype == torch.float64), _REGIME[regime],
                  ctypes.cast(out, _P))
    if code:
        raise RuntimeError(f'string_grid_info failed: cudaError {code}')
    return dict(zip(('keep_registers', 'keep_local_bytes', 'write_registers',
                     'write_local_bytes'), list(out)))
