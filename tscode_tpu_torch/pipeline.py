'''
The headline slice end to end: string-embed pose grid -> cross-fragment
clash screen -> survivor compaction (heavy atoms) -> exact bucketed RMSD
prune. Counterpart of bench.run_device_pipeline and its device programs
(bench._embed_clash_all, _embed_clash_all_mapped, _pipeline_fused).

run_pipeline runs the slice as one program, as bench does: a warm-up run
fixes the clash survivor count and the pool size; then pipeline_call
runs the grid with its clash screen and a size-bounded compaction
(clash_survivors_bounded: G1 on CUDA) and the whole prune schedule
(ops/rmsd_prune.device_schedule) with no
host sync, captured once as a CUDA graph on a CUDA device and replayed
(eagerly on the CPU), and the host reads one stats tensor per run.
clash_survivors and prune_conformers_rmsd_device keep the host-driven
form of the same slice.

The grid is the cartesian product over (c2, c1, l2, l1, ai): conformer
of molecule 2, conformer of molecule 1, lobe of 2, lobe of 1, spin
angle. Its C-order flattening is the generation order, and the prune's
chunk boundaries follow it, so the order is part of the semantics.
The grid, its clash screen and the compaction go a c2 tile at a time
through embeds/string.grid_screen (grid_screen_into for the bounded
pool): on CUDA the hand-written kernel G1 (ops/kernels/string_grid: no
pose is written but a survivor's heavy atoms), on the CPU its plain
twin (the broadcast block's poses with K1's plain twin, compacted by
the mask). The prune's pair math is the hand-written kernel K3 on CUDA (its plain twin
on the CPU).
'''

import dataclasses
import os
import time

import numpy as np
import torch

from tscode_tpu_torch.backend import (default_dtype, get_device, synchronize,
                                      traced)
from tscode_tpu_torch.capture import graph_loop
from tscode_tpu_torch.embeds.common import GridInputs, inputs_from_numpy
from tscode_tpu_torch.embeds.string import (bcast_block, bcast_tiles,
                                            grid_screen, grid_screen_into,
                                            spin_angles)
from tscode_tpu_torch.ops.rmsd_prune import device_schedule

N_CONFS = 76          # noisy conformers per molecule in the headline
N_ANGLES = 36
NOISE = 0.35          # A of per-conformer jitter
SEED = 2026
FIXTURES = ('C2H4.xyz', 'CH3Cl.xyz')
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tests', 'fixtures')

# above this many poses the grid is built in tiles of whole c2 values,
# each about _GRID_TILE poses, compacting survivors tile by tile so live
# memory stays at one tile's intermediates
WHOLE_GRID_MAX = 1 << 21
_GRID_TILE = 1 << 18
# timed runs of run_pipeline, the best reported (bench's best of 3)
TIMED_RUNS = 3


def build_workload(n_confs=N_CONFS):
    '''Two fixture molecules, each tiled to `n_confs` noisy conformers
    (seed 2026, 0.35 A noise): the same rng calls as
    bench.build_workload, so the molecules are bit for bit the same.
    76 conformers give the 76*76*2*36 = 415,872-pose headline grid.'''
    from tscode_tpu_torch.molecule import Molecule

    rng = np.random.default_rng(SEED)
    mols = []
    for name in FIXTURES:
        mol = Molecule(os.path.join(FIXTURE_DIR, name), reactive_indices=[0])
        base = mol.atomcoords[0]
        mol.atomcoords = base[None] + rng.normal(
            size=(n_confs,) + base.shape) * NOISE
        mol.compute_orbitals()
        mols.append(mol)
    return mols


def _angles(inp, n_angles):
    '''The spin angles: n_angles itself when it is a tensor (a captured
    program must not copy them from the host), else spin_angles'.'''
    if torch.is_tensor(n_angles):
        return n_angles
    return spin_angles(n_angles, inp.coords1.dtype, inp.coords1.device)


def embed_clash_all(inp, n_angles=N_ANGLES, clash_thresh=1.5):
    '''Whole-grid embed + clash screen: (poses (B, N, 3), ok (B,)), the
    broadcast block with K1 (the CPU form of the grid and, on the card,
    the yardstick G1 is timed against). n_angles: a count, or the spin
    angles as a tensor on the device.'''
    return bcast_block(inp, _angles(inp, n_angles), 0, inp.coords2.shape[0],
                       clash_thresh)


def embed_clash_tiles(inp, n_angles=N_ANGLES, clash_thresh=1.5,
                      c2_per_tile=None):
    '''The grid in tiles of `c2_per_tile` whole c2 values (default: about
    _GRID_TILE poses a tile), in grid order: yields (poses, ok) per tile
    (the c2-tiled form of the grid). n_angles as embed_clash_all's.'''
    angles = _angles(inp, n_angles)
    g = c2_per_tile or max(1, _GRID_TILE // (inp.n_poses_per_c2 *
                                             angles.shape[0]))
    return bcast_tiles(inp, angles, clash_thresh, g)


def c2_tiles(inp, angles):
    '''The grid's c2 ranges [lo, hi) in grid order: the whole grid as one
    tile up to WHOLE_GRID_MAX poses, tiles of about _GRID_TILE poses (at
    least one c2 value) past it.'''
    n2c = inp.coords2.shape[0]
    per_c2 = inp.n_poses_per_c2 * angles.shape[0]
    if per_c2 * n2c <= WHOLE_GRID_MAX:
        return [(0, n2c)]
    g = max(1, _GRID_TILE // per_c2)
    return [(lo, min(n2c, lo + g)) for lo in range(0, n2c, g)]


def grid_tiles(inp, n_angles=N_ANGLES, clash_thresh=1.5):
    '''The grid's (poses, ok) over c2_tiles, the broadcast block with K1
    a tile (the yardstick of the screened tiles). n_angles as
    embed_clash_all's.'''
    angles = _angles(inp, n_angles)
    return (bcast_block(inp, angles, lo, hi, clash_thresh)
            for lo, hi in c2_tiles(inp, angles))


@traced
def clash_survivors(inp, n_angles=N_ANGLES, clash_thresh=1.5):
    '''Embed + clash + compaction: (ok (B,) bool, hs (S, H, 3)), the
    heavy atoms of the clash survivors in grid order, screened a c2 tile
    at a time by embeds/string.grid_screen: G1 on a CUDA device (no pose
    written but a survivor's heavy atoms, one host read of a tile's
    total), its plain twin on the CPU.'''
    angles = _angles(inp, n_angles)
    tiles = [grid_screen(inp, angles, lo, hi, clash_thresh, heavy=True)
             for lo, hi in c2_tiles(inp, angles)]
    return torch.cat([ok for _, ok in tiles]), \
        torch.cat([hs for hs, _ in tiles]).contiguous()


@traced
def clash_survivors_bounded(inp, s_pool, n_angles=N_ANGLES,
                            clash_thresh=1.5):
    '''clash_survivors with no host sync on a CUDA device, into a pool of
    s_pool rows (counterpart of bench's jnp.nonzero(ok, size=s_pool,
    fill_value=B) and the gather behind it): (ok (B,) bool, hs (s_pool,
    H, 3) with the survivors' heavy atoms in grid order in its first
    rows and zeros after them, alive (s_pool,) bool marking those rows,
    n_ok (1,) int64, the survivor count, on the device). Survivors past
    s_pool are dropped, and n_ok still counts them. Each c2 tile through
    embeds/string.grid_screen_into, from the count of the tiles before
    it: on a CUDA device G1's two launches write the heavy atoms
    straight into the pool at that count, held on the device.'''
    dev, H = inp.coords1.device, inp.heavy_idx.numel()
    angles = _angles(inp, n_angles)
    hs = torch.zeros((s_pool, H, 3), dtype=inp.coords1.dtype, device=dev)
    n_ok = torch.zeros(1, dtype=torch.long, device=dev)
    oks = []
    for lo, hi in c2_tiles(inp, angles):
        ok, n_ok = grid_screen_into(inp, angles, lo, hi, clash_thresh, hs,
                                    n_ok)
        oks.append(ok)
    return torch.cat(oks), hs, torch.arange(s_pool, device=dev) < n_ok, \
        n_ok


def pool_size(n_ok):
    '''Rows of the compacted pool for n_ok survivors: the power of two
    at or above n_ok, at least 2 (bench's pool_pad).'''
    return 1 << max(1, (n_ok - 1).bit_length())


def pipeline_program(inp, angles, s_pool, n_ok, clash_thresh=1.5,
                     rmsd_thr=0.5):
    '''The whole slice with no host sync (bench._pipeline_fused): the
    grid with its clash screen and the size-bounded compaction into
    s_pool rows (G1 on CUDA) and the whole
    schedule over its first n_ok rows. n_ok, the survivor count of a
    warm-up run, fixes the schedule's chunk bounds. -> (ok (B,), keep
    (s_pool,), stats (3,) int64: n_final, this run's n_ok, finished).'''
    ok, hs, alive, n_dev = clash_survivors_bounded(inp, s_pool, angles,
                                                   clash_thresh)
    keep, n_final, finished = device_schedule(hs, alive, rmsd_thr, n_ok)
    return ok, keep, torch.cat([n_final.reshape(1), n_dev,
                                finished.reshape(1).long()])


def pipeline_call(inp, angles, s_pool, n_ok, clash_thresh=1.5,
                  rmsd_thr=0.5):
    '''pipeline_program as one call: on a CUDA device one replay of its
    CUDA graph (graph_loop captures it at the first call for these
    constants, shapes, dtype and device, outside any clock of the
    caller's, and keeps it), eagerly on the CPU. The outputs stay on
    the device.'''
    if inp.coords1.device.type != 'cuda':
        return pipeline_program(inp, angles, s_pool, n_ok, clash_thresh,
                                rmsd_thr)

    def body(state, args):
        return pipeline_program(GridInputs(*args[0]), args[1], s_pool, n_ok,
                                clash_thresh, rmsd_thr)

    dev = inp.coords1.device
    B = inp.n_poses_per_c2 * angles.shape[0] * inp.coords2.shape[0]
    state = (torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(s_pool, dtype=torch.bool, device=dev),
             torch.zeros(3, dtype=torch.long, device=dev))
    fields = tuple(getattr(inp, f.name) for f in dataclasses.fields(inp))
    return graph_loop(body, state, (fields, angles), 1)


def run_pipeline(mol1, mol2, *, device, dtype=None, n_angles=N_ANGLES,
                 clash_thresh=1.5, rmsd_thr=0.5, return_masks=False):
    '''Embed + clash + RMSD prune on `device` as one program (mirrors
    bench.run_device_pipeline). Inputs go to the device before any
    clock starts. A warm-up run (the host-driven compaction, then
    device_schedule) fixes the survivor count n_ok and the pool size;
    pipeline_call is called once (on a CUDA device that captures its
    graph); then TIMED_RUNS timed runs, each a pipeline_call and one
    read of its stats tensor, the clock stopped after the read. A run
    whose survivor count is not the warm-up's, or whose schedule did not
    finish, raises. Returns (n_poses, seconds, n_clash_ok, n_final),
    seconds the best of the timed runs; with return_masks=True a fifth
    element, a dict with the clash accept mask `clash_ok` (B,) and the
    keep mask `keep` over the clash survivors (S,) of the last run, the
    stage times of the warm-up run, `embed_clash_s` and `prune_s`, and
    every timed run's seconds, `run_s`.'''
    dev = get_device(device)
    dtype = dtype or default_dtype(dev)
    inp = inputs_from_numpy(mol1, mol2, dev, dtype)
    angles = spin_angles(n_angles, dtype, dev)

    synchronize(dev)
    t0 = time.perf_counter()
    _, hs = clash_survivors(inp, angles, clash_thresh)
    synchronize(dev)
    t1 = time.perf_counter()
    n_ok = hs.shape[0]
    s_pool = pool_size(n_ok)
    pool = torch.zeros((s_pool,) + hs.shape[1:], dtype=dtype, device=dev)
    pool[:n_ok] = hs
    device_schedule(pool, torch.arange(s_pool, device=dev) < n_ok, rmsd_thr,
                    n_ok)
    synchronize(dev)
    t2 = time.perf_counter()

    if dev.type == 'cuda':        # the capture, outside the clock
        pipeline_call(inp, angles, s_pool, n_ok, clash_thresh, rmsd_thr)
    run_s = []
    for _ in range(TIMED_RUNS):
        synchronize(dev)
        t = time.perf_counter()
        ok, keep, stats = pipeline_call(inp, angles, s_pool, n_ok,
                                        clash_thresh, rmsd_thr)
        n_final, n_ok_run, finished = stats.tolist()    # the host read
        run_s.append(time.perf_counter() - t)
        if n_ok_run != n_ok or not finished:
            raise RuntimeError(
                f'the captured pipeline counted {n_ok_run} clash survivors '
                f'(the warm-up {n_ok}), finished {bool(finished)}')

    n_poses = ok.shape[0]
    if not return_masks:
        return n_poses, min(run_s), n_ok, n_final
    return n_poses, min(run_s), n_ok, n_final, {
        'clash_ok': ok.cpu().numpy(), 'keep': keep[:n_ok].cpu().numpy(),
        'embed_clash_s': t1 - t0, 'prune_s': t2 - t1, 'run_s': run_s}
