'''
The cyclical block sweep of one chunk of block rows on the card: the
hand-written CUDA kernel `csrc/block_screen.cu` (B1).

Replaces no Pallas kernel: the JAX package's jitted block programs
tscode_tpu/embeds/cyclical.py `_block_screen` (:255) and
`_block_screen_multi` (:350), the poses of every block row over the
angle grid, their clash screen, the block-local rmsd and maxdev gates
and the greedy angular dedup. Given a chunk's conformers, its rows'
geometry (embeds/cyclical.block_geometry, in PyTorch), the grid's half
angles and the dedup's gates, `block_screen` returns (poses (rows, A, N,
3), keep (rows, A)).

This module takes CUDA tensors only. The sweep's one entry is
embeds/cyclical.block_screen: on a CUDA tensor it launches B1 here, on a
CPU tensor it runs the plain twin embeds/cyclical.block_screen_plain
(block_poses, then angular_dedup: the full (rows, A, A) gate matrices
and the greedy scan).
'''

import ctypes

import torch

from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of
from tscode_tpu_torch.ops.kernels.clash import (CLASH_WARP_MIN_PAIRS,
                                                SMEM_OPTIN_BYTES,
                                                thresh_squared)
from tscode_tpu_torch.ops.linalg import normalize

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _I)
_TAIL = (ctypes.c_longlong, _P, _P, _I, _I, _P)
KERNEL = CudaKernel('block_screen', {
    # coords x3, N_m x3, M, confs, geo, half angles, A, pairs, P, thr^2,
    # gates, rows, poses, keep, smem_poses, warp_clash, stream
    'block_screen_f32': _ARGS + (ctypes.c_float,) * 3 + _TAIL,
    'block_screen_f64': _ARGS + (ctypes.c_double,) * 3 + _TAIL,
})
_SYMBOL = {torch.float32: ('block_screen_f32', ctypes.c_float),
           torch.float64: ('block_screen_f64', ctypes.c_double)}

# block rows (warps) a block of csrc/block_screen.cu
BLOCK_WARPS = 4


def launch_plan(A, N, P, itemsize):
    '''How B1 runs on A angles of N-atom poses and P pairs: smem_poses
    (a block's BLOCK_WARPS rows of poses fit in shared memory, else the
    poses are read back from the output), smem (its bytes) and
    warp_clash (the warp screens a pose's pairs together from
    CLASH_WARP_MIN_PAIRS pairs, K1's crossover).'''
    smem = BLOCK_WARPS * A * N * 3 * itemsize
    fits = smem <= SMEM_OPTIN_BYTES
    return {'smem_poses': fits, 'smem': smem if fits else 0,
            'warp_clash': P >= CLASH_WARP_MIN_PAIRS}


def half_angles(grid):
    '''The grid's (A, M) step angles in degrees as the kernel takes
    them, once a sweep: (A, M, 2), the sine and cosine of half of each
    angle, as rot_mat_from_pointer takes them.'''
    half = torch.deg2rad(grid) / 2.0
    return torch.stack([torch.sin(half), torch.cos(half)],
                       dim=-1).contiguous()


def pack_rows(confs, geometry):
    '''The kernel's row inputs from the chunk's: confs (rows, M) int32;
    geo (rows, M, 18): R_align, the unit axis (normalised as
    rot_mat_from_pointer does), cor, pos0.'''
    R_align, axis, cor, pos0 = geometry
    rows, M = axis.shape[:2]
    conf = torch.stack([c.to(torch.int32) for c in confs], dim=1)
    geo = torch.cat([R_align.reshape(rows, M, 9), normalize(axis), cor,
                     pos0], dim=-1)
    return conf.contiguous(), geo.contiguous()


def _checked(coords, confs, geometry, half, pairs):
    '''Raises on what the kernel does not take; returns (rows, A, N).'''
    dev, dtype = half.device, half.dtype
    if dev.type != 'cuda':
        raise ValueError(f'the block_screen kernel takes CUDA tensors, got '
                         f'one on {dev}')
    if dtype not in _SYMBOL:
        raise TypeError(f'block_screen takes float32/float64, got {dtype}')
    M = len(coords)
    if M not in (2, 3) or len(confs) != M:
        raise ValueError(f'block_screen takes 2 or 3 molecules, got '
                         f'{M} coordinate sets and {len(confs)} id columns')
    for x in coords:
        if not (x.device == dev and x.dtype == dtype and x.dim() == 3 and
                x.shape[2] == 3 and x.shape[1] >= 1 and x.is_contiguous()):
            raise ValueError(f'coords must be contiguous (n, N_m, 3) '
                             f'{dtype} tensors on {dev}, got '
                             f'{tuple(x.shape)} {x.dtype} on {x.device}')
    rows = confs[0].shape[0]
    for t in (*confs, *geometry):
        if t.device != dev or t.shape[0] != rows:
            raise ValueError(f'every row input must be on {dev} with '
                             f'{rows} rows')
    if any(g.dtype != dtype for g in geometry):
        raise TypeError(f'the geometry must be {dtype}')
    A = half.shape[0]
    if not (half.dim() == 3 and half.shape[1:] == (M, 2) and A >= 1 and
            half.is_contiguous()):
        raise ValueError(f'the half angles must be a contiguous (A, {M}, '
                         f'2) tensor with A >= 1, got {tuple(half.shape)}')
    if not (pairs.device == dev and pairs.dtype == torch.int32 and
            pairs.dim() == 2 and pairs.shape[1] == 2 and
            pairs.is_contiguous() and pairs.data_ptr() % 8 == 0):
        raise ValueError('pairs must be a contiguous, 8-byte aligned int32 '
                         '(P, 2) tensor on the poses device')
    return rows, A, sum(x.shape[1] for x in coords)


def block_screen(coords, confs, geometry, half, pairs, thresh, gates):
    '''One chunk of the block sweep, one launch of B1: coords, the M = 2
    or 3 molecules' conformers (n_m, N_m, 3); confs, each molecule's
    conformer id per block row (rows,); geometry, block_geometry's
    (R_align (rows, M, 3, 3), axis, cor, pos0 (rows, M, 3)); half,
    half_angles of the (A, M) grid; pairs (P, 2) int32 cross-fragment
    pairs; thresh the clash threshold; gates (rmsd, maxdev) of the
    dedup. Returns (poses (rows, A, N, 3), keep (rows, A) bool): a pose
    is kept when it passes the clash screen and no pose kept before it
    in its row lies within both gates. Raises on a tensor that is not
    on the card.'''
    rows, A, N = _checked(coords, confs, geometry, half, pairs)
    poses = torch.empty((rows, A, N, 3), dtype=half.dtype,
                        device=half.device)
    keep = torch.empty((rows, A), dtype=torch.bool, device=half.device)
    if rows:
        launch(coords, *pack_rows(confs, geometry), half, pairs, thresh,
               gates, poses, keep)
    return poses, keep


def launch(coords, conf, geo, half, pairs, thresh, gates, poses, keep):
    '''One launch of B1 on the inputs pack_rows and half_angles give,
    into poses (rows, A, N, 3) and keep (rows, A) bool, on the launch
    plan of these shapes; block_screen checks what it is given first.'''
    rows, A, N = poses.shape[:3]
    plan = launch_plan(A, N, pairs.shape[0], poses.element_size())
    symbol, c_t = _SYMBOL[poses.dtype]
    xs = [ptr(x) for x in coords] + [None] * (3 - len(coords))
    ns = [x.shape[1] for x in coords] + [0] * (3 - len(coords))
    KERNEL.launch(symbol, *xs, *ns, len(coords), ptr(conf), ptr(geo),
                  ptr(half), A, ptr(pairs), pairs.shape[0],
                  c_t(thresh_squared(thresh, poses.dtype)), c_t(gates[0]),
                  c_t(gates[1]), rows, ptr(poses), ptr(keep),
                  int(plan['smem_poses']), int(plan['warp_clash']),
                  stream_of(poses), device=poses.device,
                  wrapper='block_screen')
