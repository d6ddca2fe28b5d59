'''
The cyclical block sweep of one chunk of block rows on the card: the
hand-written CUDA kernel `csrc/block_screen.cu` (B1), and its first
design `csrc/block_screen_row.cu`, kept as the yardstick.

Replaces no Pallas kernel: the JAX package's jitted block programs
tscode_tpu/embeds/cyclical.py `_block_screen` (:255) and
`_block_screen_multi` (:350), the poses of every block row over the
angle grid, their clash screen, the block-local rmsd and maxdev gates
and the greedy angular dedup, and the mask compaction after them
(`_block_screen_mapped_compact`, :304). Given a chunk's conformers, its
rows' geometry (embeds/cyclical.block_geometry, in PyTorch), the grid's
half angles and the dedup's gates, `block_screen` returns (survivors
(S, N, 3), keep (rows, A)): two launches, the screen (keep bits and a
kept count a row, no pose written) and the write of the kept poses at
offsets from a scan of the counts, with one host read of the total
between them.

This module takes CUDA tensors only. The sweep's one entry is
embeds/cyclical.block_screen: on a CUDA tensor it launches B1 here, on a
CPU tensor it runs the plain twin embeds/cyclical.block_screen_plain
(block_poses, then angular_dedup: the full (rows, A, A) gate matrices
and the greedy scan) and compacts its poses by the keep mask.
'''

import ctypes
from collections import namedtuple

import torch

from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of
from tscode_tpu_torch.ops.kernels.clash import (CLASH_WARP_MIN_PAIRS,
                                                SMEM_OPTIN_BYTES,
                                                thresh_squared)
from tscode_tpu_torch.ops.linalg import normalize

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# coords x3, N_m x3, M, confs, geo, half angles, A
_ROWS = (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I)


def _keep_args(c_t):
    # pairs, P, thr^2, gates, rows, stride, scratch, slots, keep, counts,
    # warp_clash, stream
    return _ROWS + (_P, _I) + (c_t,) * 3 + (_L, _I, _P, _L, _P, _P, _I, _P)


def _row_args(c_t):
    # pairs, P, thr^2, gates, rows, poses, keep, smem_poses, warp_clash,
    # stream
    return _ROWS + (_P, _I) + (c_t,) * 3 + (_L, _P, _P, _I, _I, _P)


# rows, keep, offsets, survivors, stream
_WRITE_ARGS = _ROWS + (_L, _P, _P, _P, _P)
KERNEL = CudaKernel('block_screen', {
    'block_keep_f32': _keep_args(ctypes.c_float),
    'block_keep_f64': _keep_args(ctypes.c_double),
    'block_write_f32': _WRITE_ARGS,
    'block_write_f64': _WRITE_ARGS,
})
# B1's first design, every pose written: the yardstick, launched only by
# launch_row (chip_smoke.py and the card tests)
ROW_KERNEL = CudaKernel('block_screen_row', {
    'block_screen_row_f32': _row_args(ctypes.c_float),
    'block_screen_row_f64': _row_args(ctypes.c_double),
})
_C_TYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}

# block rows (warps) a block of both kernels
BLOCK_WARPS = 4
# the scratch form's store: at most this many bytes, and this many warps
SCRATCH_BYTES = 256 << 20
SCRATCH_WARPS = 4096
# the screen stages the pair list in shared memory up to this many pairs
# (csrc/block_screen.cu kStagePairs)
STAGE_PAIRS = 2048
# the warp's clash screen (K1's warp regime) only below this many angles
# a row: with more, a lane walking its own pose's pairs keeps the lanes
# busy (on the three-molecule route's 27 angles and 75 pairs the warp's
# screen made B1's screen ~37% slower, chip_smoke.py --sweep)
WARP_CLASH_MAX_ANGLES = 8


def launch_plan(A, N, P, itemsize, form=None, warp_clash=None, M=3):
    '''How B1's screen runs on A angles of N-atom poses (of M molecules)
    and P pairs: stride (values from one pose of the store to the next:
    its 3 N coordinates and its squared norm, made odd so the lanes'
    reads of their own poses meet no bank conflict), form ('smem' where a
    block's BLOCK_WARPS slices fit in shared memory, else 'scratch': each
    warp's slice in a global scratch of at most SCRATCH_BYTES), smem (the
    block's bytes: the staged pair list, and in the smem form the
    slices), slot_bytes (a warp's slice: the row's staged values, 3 N +
    18 M, and its store of A poses), scratch_warps (the scratch form's
    warps; rows are walked that many apart) and warp_clash (the warp
    screens a pose's pairs together: from CLASH_WARP_MIN_PAIRS pairs,
    K1's crossover, below WARP_CLASH_MAX_ANGLES angles). `form` and
    `warp_clash` force a form where the shapes allow it.'''
    stride = 3 * N + 1 | 1
    vals = A * stride + 3 * N + 18 * M
    slot = -(-vals // 2) * 2 * itemsize
    pairs = -(-P * 8 // 16) * 16 if P <= STAGE_PAIRS else 0

    def block_bytes(smem_form):
        return pairs + (BLOCK_WARPS * slot if smem_form else 0)
    fits = block_bytes(True) <= SMEM_OPTIN_BYTES
    if form is None:
        form = 'smem' if fits else 'scratch'
    if form not in ('smem', 'scratch') or (form == 'smem' and not fits) or \
            block_bytes(form == 'smem') > SMEM_OPTIN_BYTES:
        raise ValueError(f'B1 form {form!r} does not run A = {A}, N = {N}')
    if warp_clash is None:
        warp_clash = P >= CLASH_WARP_MIN_PAIRS and A < WARP_CLASH_MAX_ANGLES
    return {'form': form, 'stride': stride,
            'smem': block_bytes(form == 'smem'), 'slot_bytes': slot,
            'scratch_warps': max(1, min(SCRATCH_WARPS,
                                        SCRATCH_BYTES // slot)),
            'warp_clash': bool(warp_clash)}


def row_launch_plan(A, N, P, itemsize):
    '''How B1's first design (launch_row) runs: smem_poses (a block's
    BLOCK_WARPS rows of poses fit in shared memory, else the poses are
    read back from the output), smem (its bytes) and warp_clash.'''
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
    if dtype not in _C_TYPE:
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


# one chunk screened: its packed inputs, keep (rows, A) bool and counts
# (rows,) int32, the kept poses not yet written
Screened = namedtuple('Screened', 'coords conf geo half keep counts')


def screen(coords, confs, geometry, half, pairs, thresh, gates, plan=None):
    '''The first launch of B1 on one chunk: coords, the M = 2 or 3
    molecules' conformers (n_m, N_m, 3); confs, each molecule's conformer
    id per block row (rows,); geometry, block_geometry's (R_align (rows,
    M, 3, 3), axis, cor, pos0 (rows, M, 3)); half, half_angles of the (A,
    M) grid; pairs (P, 2) int32 cross-fragment pairs; thresh the clash
    threshold; gates (rmsd, maxdev) of the dedup. Returns a Screened
    whose keep says which poses survive: a pose is kept when it passes
    the clash screen and no pose kept before it in its row lies within
    both gates. Queues the launch and reads nothing back. Raises on a
    tensor that is not on the card.'''
    rows, A, N = _checked(coords, confs, geometry, half, pairs)
    conf, geo = pack_rows(confs, geometry)
    keep = torch.empty((rows, A), dtype=torch.bool, device=half.device)
    counts = torch.empty(rows, dtype=torch.int32, device=half.device)
    if rows:
        launch(coords, conf, geo, half, pairs, thresh, gates, keep, counts,
               plan)
    return Screened(coords, conf, geo, half, keep, counts)


def survivors(s):
    '''The second launch of B1: the kept poses of a Screened, (S, N, 3)
    in generation order (row by row, angle by angle), each bit for bit
    the pose the screen built. One host read (the total S) sizes them;
    no launch when nothing survived.'''
    ends = torch.cumsum(s.counts, 0)
    total = int(ends[-1]) if ends.numel() else 0
    N = sum(x.shape[1] for x in s.coords)
    out = torch.empty((total, N, 3), dtype=s.half.dtype,
                      device=s.half.device)
    if total:
        launch_write(s.coords, s.conf, s.geo, s.half, s.keep, ends - s.counts,
                     out)
    return out


def block_screen(coords, confs, geometry, half, pairs, thresh, gates):
    '''One chunk of the block sweep, the two launches of B1 (screen's
    arguments): returns (survivors (S, N, 3), keep (rows, A) bool).'''
    s = screen(coords, confs, geometry, half, pairs, thresh, gates)
    return survivors(s), s.keep


def _rows_args(coords, conf, geo, half):
    xs = [ptr(x) for x in coords] + [None] * (3 - len(coords))
    ns = [x.shape[1] for x in coords] + [0] * (3 - len(coords))
    return (*xs, *ns, len(coords), ptr(conf), ptr(geo), ptr(half),
            half.shape[0])


def launch(coords, conf, geo, half, pairs, thresh, gates, keep, counts,
           plan=None):
    '''One launch of B1's screen on the inputs pack_rows and half_angles
    give, into keep (rows, A) bool and counts (rows,) int32, on `plan`
    (default launch_plan of these shapes; its scratch allocated here);
    screen checks what it is given first.'''
    rows, A = keep.shape
    N = sum(x.shape[1] for x in coords)
    if plan is None:
        plan = launch_plan(A, N, pairs.shape[0], half.element_size(),
                           M=len(coords))
    scratch, slots = None, rows
    if plan['form'] == 'scratch':
        slots = max(1, min(rows, plan['scratch_warps']))
        scratch = torch.empty(slots * plan['slot_bytes'] //
                              half.element_size(), dtype=half.dtype,
                              device=half.device)
    c_t = _C_TYPE[half.dtype]
    KERNEL.launch(f'block_keep_{_SUFFIX[half.dtype]}',
                  *_rows_args(coords, conf, geo, half), ptr(pairs),
                  pairs.shape[0], c_t(thresh_squared(thresh, half.dtype)),
                  c_t(gates[0]), c_t(gates[1]), rows, plan['stride'],
                  None if scratch is None else ptr(scratch), slots,
                  ptr(keep), ptr(counts), int(plan['warp_clash']),
                  stream_of(keep), device=keep.device, wrapper='block_screen')


def launch_write(coords, conf, geo, half, keep, offsets, out):
    '''One launch of B1's write: the kept poses of keep (rows, A) into
    out (S, N, 3), row r's at offsets[r] (int64, the exclusive scan of
    the counts), ...'''
    KERNEL.launch(f'block_write_{_SUFFIX[half.dtype]}',
                  *_rows_args(coords, conf, geo, half), keep.shape[0],
                  ptr(keep), ptr(offsets.contiguous()), ptr(out),
                  stream_of(out), device=out.device,
                  wrapper='block_survivors')


def launch_row(coords, conf, geo, half, pairs, thresh, gates, poses, keep):
    '''One launch of B1's first design (block_screen_row.cu), the
    yardstick: every pose into poses (rows, A, N, 3), keep (rows, A)
    bool, on row_launch_plan of these shapes.'''
    rows, A, N = poses.shape[:3]
    plan = row_launch_plan(A, N, pairs.shape[0], poses.element_size())
    c_t = _C_TYPE[poses.dtype]
    ROW_KERNEL.launch(f'block_screen_row_{_SUFFIX[poses.dtype]}',
                      *_rows_args(coords, conf, geo, half), ptr(pairs),
                      pairs.shape[0],
                      c_t(thresh_squared(thresh, poses.dtype)),
                      c_t(gates[0]), c_t(gates[1]), rows, ptr(poses),
                      ptr(keep), int(plan['smem_poses']),
                      int(plan['warp_clash']), stream_of(poses),
                      device=poses.device, wrapper='block_screen_row')
