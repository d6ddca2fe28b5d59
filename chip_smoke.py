#!/usr/bin/env python3
'''
Smoke run of the PyTorch + CUDA port (tscode_tpu_torch) on one NVIDIA
GPU: builds the hand-written kernels from csrc/, holds each against its
plain PyTorch twin on the card, drives the headline slice (415,872-pose
string-embed grid -> clash screen -> exact bucketed RMSD prune) in
float64 and float32 as one captured program (phases 4 and 5: a CUDA
graph of the grid, the clash kernel, a size-bounded compaction and every
prune pass, gated on the card, replayed with one host read a run; its
keep mask held to the host loop's, its time to the host-driven slice's,
its device busy share and kernels a replay from the profiler; the pair
kill's device-count entry held to the host entry on every pass) and
checks its counts, then runs the production
string route through the port's CLI (input file -> Embedder -> string
embed -> TFD novelty -> TFD and MOI prunes -> .xyz) on bench_suite's
sn2_string input at 76 conformers (831,744 candidates), in float64
(exact counts) and float32, and the large-molecule route on
large_n_string (148-atom poses, the clash kernel's warp regime): the CLI
at 16 conformers, the exact novelty replay without the collinear
torsion quadruplet, and the 207,936-pose grid at 76 conformers. Phase 8
runs the rigid cyclical route through the CLI on da_cyclical_xl at 62
conformers (1,660,608 candidates: the block sweep, each chunk's poses,
clash screen and angular dedup one screen launch of the block-sweep
kernel B1, csrc/block_screen.cu, that writes keep bits and no pose, and
one launch that writes only the kept poses; the prunes), float64 exact
and float32 within brackets from its near ties, B1 held bit for bit
against B1's first design (csrc/block_screen_row.cu, every pose written)
and that kernel against the plain twin on every chunk of the sweep (keep
bits off the tied blocks, poses within 1e-9 A), B1 timed beside its
first design, its twin, its bound and the first design's full-write
bound; phase 9 runs
REFINE through the CLI (the
RMSD prune with the pair-kill kernel, the symmetry-corrected prune) on
phase 8's float64 output and on phase 7's, in float64 and in float32
(the CLI's default on the card), the float32 runs held by the float64
pairs near a threshold. Phases 10 to 12 run the routes built on the
block sweep through the CLI, float64 (the JAX x64 counts at every stage)
and float32 (phase 8's near-tie rule): bench_suite's multiembed at 41
conformers (12 arrangements in one sweep of 5,809,536 candidates; the
compenetration stage launches the mask entry K2 of the clash kernel,
held against its plain version on the tensor the stage gave it), the
chelotropic input at 62 conformers, and the trimolecular input with
RIGID at 64 conformers of HCOOH (the chained direction adjustment, the
clash kernel on the pair list of three fragments). Phases 13 to 15 run
the bending routes: the force field's energy and gradient and batched
FIRE on the card against the CPU (one launch of the force field's FIRE
kernel, csrc/ff_fire.cu, held in each of its forms against its plain
twin and the graph path, timed and bounded at the whole batch and at one
structure; the forms' sweeps over the batch size and over chains of 24
to 200 atoms behind the plan rule; a 2,500-atom structure in the large
form; the graph path's step seconds,
launches and the device's busy share, replayed and queued op by op);
bench_suite's trimolecular input as written (non-rigid: molecules are
bent where their pivots close no triangle) through the CLI, float64 (the
JAX x64 counts and bends; bent coordinates against the CPU) and float32;
the non-rigid chelotropic input and the monomolecular embed, card
against CPU. Phases 16 and 17 run the conformer search (csearch>: the
torsions' clash back-off with K1's entry torsion_clash_ok, the TFD
prune, the diverse selection) through the CLI, its random draws seeded
as the JAX reference runs were: bench_suite's torsion_drive (the search
on C2F2H4, then the monomolecular embed; float64 and float32, card
against CPU) and csearch_string (6,561 candidates of a C10H21Cl chain
searched, 1,000 kept, then the string embed against C2H4), the searched
conformers held against the JAX package's, frame for frame; the
search's TFD prune runs each pass of its K schedule as one launch of T1
(csrc/tfd_first.cu, blocks of rows over shared-memory tiles of
candidates) and one host read, 10 of each, checked, and T1 is held
against its plain twin (the old tile loop on the same card tensor) and
T1's first design (csrc/tfd_first_warp.cu) on every pass of the prune's own
input, identical, each pass timed beside T1's first design and bounded,
the prune's seconds split (fingerprints, T1, reads, networkx
bookkeeping) beside the old tile loop's. Phases 18
and 19 run the operators on the internal force field, float64 on the
card, held to the JAX x64 records and to the port's CPU run: the
atropisomer route (SADDLE + scan> of a ring torsion of a nine-carbon
chlorocycloalkane: coarse sweeps, accurate re-scans, the dimer on each
sub-peak, the RMSD prune of the maxima with K3, frequencies of each
refined maximum; the dimer step, the band step and a Hessian timed),
then neb>, saddle> and a distance scan on the same ring; every dimer on
the force field runs as one launch of D1 (csrc/dimer.cu, every step
inside; DimerCalls), which phase 18 holds against its plain twin and
the captured graph path on the scan's sub-peak guess (timed beside
both, bounded, with a latency figure), for repeated bits and in
float32, and runs in every form that fits (the rule's lone or large
form, the staged form, the first design) on the guess, saddle>'s
C2F2H4 and 150- and 2,500-atom chains, each against its twin and
timed; every neb> on the force field runs its IDPP band as one launch of
I1 (csrc/idpp_fire.cu) and each of its two band phases as one launch of
N1 (csrc/neb_band.cu, every step inside; NebCalls), and phase 19b holds
both kernels against their plain twins and their first designs
(csrc/neb_band_v1.cu, csrc/idpp_fire_v1.cu: the same bits) in every form
on phase 19's band, HCOOH and 150- and 2,500-atom chains, timed beside
the first designs (in turns), the twins and the graph route before
them, bounded, with neb>'s seconds by both routes and the chain size
from which the graph route takes the shorter step.
Phase 20 runs
the optimisation route: sn2_string at 76 conformers without NOOPT (the
calculators chosen by keyword), its 290 candidates through the
force-field and the calculator's stages, every xtb call answered by the
stand-in xtb of tests/torch_standin (a test double) first on PATH, each
stage followed by the prunes (K3 on every RMSD pool), float64 held to
the JAX x64 record taken with the same stand-in, and float32 within
brackets. Phase 21 runs the sharded paths on a mesh that names the card
four times (one process): sn2_string, da_cyclical_xl and REFINE on its
output, multiembed, trimolecular RIGID and csearch_string through the
CLI in float64 with every mesh call site forced, each against its
unsharded run (every count equal, frames within 1e-6 A; T1 once a
pass a shard); K1, K2 and K3 against their plain twins on the shard-shaped tensors those runs gave
them; sharded_embed_screen_step; the sharded FIRE on phase 12's
survivors. Four views of one card show the sharding's overhead, not a
speed-up. Phase 22 runs the CLI with --trace (torch.profiler) in float64
on short routes of the earlier phases (sn2_string, the non-rigid
chelotropic input, REFINE on da_cyclical_xl's output), each against its
untraced run (the same counts and frames): every launch of K1, K2 and K3
is found in the trace, under its kernel's name and inside its launch
span, and each stage is a span; then a bend's FIRE call, one ff_fire
launch found the same way, one saddle> dimer's D1 launch found the
same way, one neb>'s I1 launch and two N1 launches found the same way,
and a dimer graph captured and replayed under the same trace,
its capture and replay loop spans of their own, and a TFD prune's T1
launches, each found the same way. Every
FIRE call of the force field's energies on the card launches ff_fire
once (FireCalls), in every phase that runs one.

    python3 chip_smoke.py
    python3 chip_smoke.py --fire OUT.json   # phase 13 alone: the force
                                  # field and FIRE measurements
    python3 chip_smoke.py --search   # phases 16 and 17 alone: the
                                  # conformer search's routes
    python3 chip_smoke.py --scans    # phases 18 and 19 alone: the
                                  # force-field operators
    python3 chip_smoke.py --dimer OUT.json   # D1's widths behind its
                                  # plan rule (lone warps, large
                                  # clusters) on phase 18's inputs
    python3 chip_smoke.py --neb OUT.json   # phase 19b alone: N1 and I1
                                  # in every form against their twins,
                                  # timed, neb>'s seconds, and where
                                  # the graph route's step is shorter
    python3 chip_smoke.py --opt      # phase 20 alone: the optimisation
                                  # route
    python3 chip_smoke.py --sweep    # phases 8, 10 to 12 and 14 alone:
                                  # the block sweeps, B1 against its
                                  # first design and its twin
    python3 chip_smoke.py --mesh     # phase 21 alone: the sharded paths
    python3 chip_smoke.py --trace    # phase 22 alone: the CLI's --trace
    python3 chip_smoke.py --qcp-plans OUT.json   # K3's launch-plan sweep
    python3 chip_smoke.py --k1 OUT.json   # K1's thread regime: phase 3's
                                  # checks and the ring's launch plans
    python3 chip_smoke.py --profile-cyclical OUT.json   # the cyclical
                                  # route's float32 run under the profiler

Exits nonzero, with no result line, when CUDA is not available or any
phase fails. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel with its launches on the main path,
its agreement with the plain version and both times.
'''

import importlib.metadata
import json
import os
import subprocess
import sys
import time

import numpy as np

THR = 0.5                    # RMSD prune threshold (A)
CLASH = 1.5                  # clash threshold (A)
N_POSES = 415872             # 76 * 76 * 2 * 36 grid poses
F64_COUNTS = (202362, 26)    # clash-ok, final: the x64 reference counts
F32_OK = (202330, 202380)    # f32 clash-ok bracket (ties at 1.5 A)
F32_FINAL = (22, 30)
CLASH_TIE = 1e-4             # A^2: |d2 - thr^2| below this is a tie
QCP_TIE = {'float32': 1e-4, 'float64': 1e-9}   # A, on rmsd and maxdev
DEV = 'cuda'

# bounds: NVIDIA H100 SXM data sheet rates (memory; float32 and float64
# outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'float64': 34e12}
NEWTON_STEPS = {'float32': 12, 'float64': 30}
# device_ms holds the card this long (~5 ms) while the host queues calls
SLEEP_CYCLES = 10 ** 7
# K3 on long chunks: one chunk (k = 1) of this many rows, sparse copies
LONG_ROWS = 4096
LONG_BASES = 8192

# the string route (phase 6): bench_suite's sn2_string at 76 conformers
STRING_CONFS = 76
STRING_F64 = (831744, 371822, 355, 290)   # candidates, clash-ok, novel,
#                                           final: the x64 reference counts
TFD_THRESH = 10.0                          # degrees, the novelty threshold
STRING_TFD_TIE = 1e-2      # degrees: |sum - 10| below this is a near tie
# f32 novel and final counts may lie this fraction of the f64 counts away:
# hundreds of survivors sit exactly 10.0 degrees (one spin step) from an
# accepted fingerprint in f64, and f32 fingerprints turn those exact ties
# into coin flips of the leader rule, which then cascade
STRING_F32_SLACK = 0.10
LIST_MAX = 20              # tie rows listed by index

# the large-molecule route (phase 7): bench_suite's large_n_string, two
# C24H49Cl chains, 148-atom poses, P = 5,476 cross pairs
LARGE_CONFS = 16
LARGE_F64 = (9216, 1704, 1113, 1113)   # candidates, clash-ok, novel, final:
#                                        the JAX x64 CLI run's counts
# novel and final may lie this fraction away: the torsion quadruplet
# LARGE_COLLINEAR has both end bonds on the reactive bond's axis, so its
# dihedral is rounding noise and so are the counts that rest on it
LARGE_SLACK = 0.10
LARGE_COLLINEAR = [[1, 0, 74, 75]]     # Cl-C0...C74-Cl
COLLINEAR_SINE = 1e-8      # an end-angle sine at or below it: collinear
LARGE_DROPPED_NOVEL = 244  # JAX x64 novelty replay of the 1,704 survivors
#                            without the collinear quadruplet
LARGE_GRID_CONFS = 76      # 207,936 grid poses
LARGE_GRID_OK = 43764      # their JAX x64 clash-ok count
LARGE_PLAIN_CHUNK = 16384  # poses per plain-twin call (B x N x N tensors)

# the rigid cyclical route (phase 8): bench_suite's da_cyclical_xl at 62
# conformers, C2H4 + CH3Cl docked on two pairings, 46,128 blocks x 36
# angle pairs
CYC_CONFS = 62
CYC_F64 = (1660608, 19562, 19562)    # candidates, embedded, final: the JAX
#   x64 run of `TSCODE_SUITE_XL_CONFS=62 JAX_PLATFORMS=cpu python
#   bench_suite.py da_cyclical_xl` (x64 on the CPU)
# A: |rmsd - 1| or |maxdev - 2| below it is a near tie of the angular
# dedup's gates. Float32 poses lie ~1e-6 A from the float64 ones
# (coordinates of a few A, rotated twice) and the gates' Kabsch sums of
# ~100 A^2 round at ~1e-5 A^2, so a float32 gate value lies ~1e-6 A from
# the float64 one; ten times that is marked
GATE_TIE = 1e-5
# A: B1's float64 poses against its plain twin's (the einsum's sums may
# round apart by an ulp)
B1_POSE_ATOL = 1e-9
# the refine route (phase 9): REFINE on phase 8's float64 output (the
# first 10,000 frames, the write truncation) and on phase 7's float64
# large_n_string output
MOI_THRESH = 1e-2          # the MOI prune's relative moment threshold
MOI_TIE = 1e-6             # a relative deviation this close to it is marked
REFINE_XL_F64 = (10000, 10000, 2)    # structures, after compenetration,
#   final: the JAX x64 CLI run (`python -m tscode_tpu input.txt`, input
#   "NOOPT REFINE" + "ens.xyz") on the JAX run's own 10,000-frame output
#   of da_cyclical_xl at 62 conformers


# the multi-arrangement route (phase 10): bench_suite's multiembed, HCOOH
# (reactive atoms 0 1 3) + C2H4 (0 1), RIGID, 12 arrangements, at 41
# conformers (at 40 the suite's jitter leaves a reactive hydrogen of C2H4
# without a bonded neighbour and neither package sets the input up)
ME_CONFS = 41
ME_BLOCKS = 13448          # block rows of each arrangement, x 36 angles
# per arrangement, the JAX x64 run on the CPU (`JAX_PLATFORMS=cpu python
# tests/test_torch_suite_counts.py multiembed 41`): the sweep's
# survivors, and the structures after the arrangement's stages
ME_SURVIVORS = (0, 144, 0, 21, 4648, 277, 0, 4677, 0, 277, 146, 21)
ME_STRUCTURES = (0, 139, 0, 21, 4648, 267, 0, 4677, 0, 268, 142, 21)
ME_PARENT = (10183, 10183, 10183)    # in -> after compenetration -> final
# the chelotropic route (phase 11): the port's chelotropic input (C2H4 on
# the two lobes of HCOOOH's peroxy oxygen, RIGID) at 62 conformers
CHEL_CONFS = 62
CHEL_F64 = (1107072, 30808, 30808, 30808)   # candidates, embedded, after
#   compenetration, final: the JAX x64 run on the CPU (`JAX_PLATFORMS=cpu
#   python tests/test_torch_suite_counts.py chelotropic 62`)
# the rigid three-molecule route (phase 12): bench_suite's trimolecular
# with RIGID, CH3Cl + 64 conformers of HCOOH twice (TRI_CONFS // 4)
TRI_CONFS = 256
TRI_F64 = (24576, 663552, 24417)     # blocks, candidates, embedded: the JAX
#   x64 run on the CPU (`JAX_PLATFORMS=cpu python
#   tests/test_torch_suite_counts.py trimolecular_rigid 256`)
# the force field and FIRE (phase 13): the three molecules of the
# trimolecular input as one topology; FF_STRUCTS jittered structures for
# the energy and gradient, phase 12's survivors for FIRE
FF_STRUCTS = 4096
FF_JITTER = 0.1            # A
FF_RTOL = 1e-9             # card against CPU, float64, relative to the largest
FIRE_STEPS = 200
FIRE_TIMED_STEPS = 40      # steps per timing of the FIRE step
FIRE_CPU_ROWS = 512        # rows also relaxed on the CPU, float64
FIRE_ATOL = 1e-6           # A, card float64 against CPU float64
# the FIRE kernel's sweep behind ff_fire.launch_plan's rule: the first B
# of phase 12's survivors, each form, both types
FIRE_SWEEP_ROWS = (1, 8, 64, 512, 1024, 2048, 4096, 8192, 24417)
FIRE_SWEEP_STEPS = 100
# and past the 15-atom topology: (atoms, structures) of chains of
# suite_inputs.chain_ff (24: the warp form's eight a block in ~half an
# SM's shared memory in float64; 32: the conformer search's; 74:
# large_n's; 200: past the lone form's shared memory)
FIRE_SIZE_CASES = ((24, 1), (24, 1024), (24, 8192), (32, 1), (32, 1024),
                   (32, 8192), (74, 1), (74, 1024), (200, 1), (200, 1024))
FIRE_AB_SLACK = 1.02       # the chosen form against the block form's time
# a structure past the block form's shared memory (~2,410 atoms in
# float64): the chain of suite_inputs.chain_ff, relaxed for a few steps
FIRE_LARGE_N = 2500
FIRE_LARGE_STEPS = 10
# the non-rigid three-molecule route (phase 14): bench_suite's
# trimolecular as written at its default of 16, CH3Cl + 4 conformers of
# HCOOH twice
BEND_TRI_CONFS = 16
BEND_TRI_F64 = {'bends': 5, 'bend_reverts': 0, 'bend_hits': 0,
                'embedded': 135}
#   the JAX x64 run on the CPU (`JAX_PLATFORMS=cpu python
#   tests/test_torch_suite_counts.py trimolecular 16`)
BEND_ATOL = 1e-6           # A, bent coordinates, card against CPU
# the small bending routes (phase 15): conformers of each molecule
CHEL_BEND_CONFS = 6        # at 7 to 9 the jitter breaks a bond of HCOOOH
MONO_CONFS = 2
# the conformer search (phases 16, 17): the port's searches draw from
# np.random.RandomState(SEARCH_SEED), as the JAX x64 reference runs drew
# from numpy's global generator seeded with it (`JAX_PLATFORMS=cpu
# python tests/test_torch_suite_counts.py NAME N GOLDEN.npz` took the
# counts and saved the searched conformers); the search runs in float64
# whatever the embed's dtype
SEARCH_SEED = 0
SEARCH_ATOL = 1e-6         # A, searched conformers against the JAX package's
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                      'golden')
# bench_suite's torsion_drive (phase 16) at the suite's count 16: the
# search from each of 4 conformers of C2F2H4, then the monomolecular embed
DRIVE_CONFS = 16
DRIVE_F64 = {'searched': [3, 3, 3, 3], 'stages': (144, 144, 15),
             'bends': 12, 'bend_reverts': 0, 'bend_hits': 0}
DRIVE_GOLDEN = os.path.join(GOLDEN, 'torsion_drive_search.npz')
# csearch_string (phase 17): 16 conformers of C2H4, the C10H21Cl chain
# searched (8 three-fold rotors, 6,561 candidates, 1,000 kept by the
# seeded draw), then the string embed; the chlorine lies on the reactive
# axis, so the quadruplet ending on it is collinear (phase 7's rule)
SEARCH_CONFS = 16
SEARCH_CANDIDATES = 6561
SEARCH_F64 = (1152000, 3001, 2906, 2906)   # candidates, clash-ok, novel, final
SEARCH_COLLINEAR = [[1, 0, 6, 7]]          # C2H4 C1-C0...C0-Cl of the chain
SEARCH_DROPPED_NOVEL = 1610  # JAX x64 novelty replay without that quadruplet
SEARCH_GOLDEN = os.path.join(GOLDEN, 'csearch_string_search.npz')
# the search's TFD prune (6,561 rows, 8 torsions): the passes of its K
# schedule that run (k = 1,000 down to 1), one T1 launch and one host
# read each
SEARCH_TFD_PASSES = 10
# T1's bound: float64 instructions a pair and a torsion (subtract,
# subtract with an absolute-value operand, min, add; the abs of the
# difference is an operand modifier too), none an FMA, so against the
# card's float64 instruction rate: half the 34 TFLOP/s peak, which counts
# an FMA as two operations. T1's first bound counted 6 operations at 34 T
# (TFD_FIRST_FLOPS), 0.75 of this one
TFD_TORSION_OPS = 4
F64_INSTR_PER_S = 17e12
TFD_FIRST_FLOPS = 6
# csearch_string's back-off with one K1 launch a retreat step, the loop
# torsion_backoff replaced (NVIDIA H100 80GB HBM3, 700 W)
STEP_LOOP_BACKOFF_S = 0.2541
# K1's thread regime (phase 3): the ring kernel and the v1 kernel against
# plain at these batch sizes and atom counts (two fragments, P < 64)
K1_BATCHES = (1, 15, 16, 17, 4099, 415872)
K1_ATOMS = (8, 11, 12, 15)
# the crossover sweep (phase 3): pair counts and the fragments that give
# them, on N_POSES poses
CROSSOVER_FRAGMENTS = {9: (3, 3), 30: (6, 5), 36: (6, 6), 49: (7, 7),
                       56: (8, 7), 64: (8, 8), 75: (5, 5, 5), 144: (12, 12)}
# the ring kernel's launch plans timed by --k1 (tile, stages)
RING_VARIANTS = tuple((t, s) for t in (64, 128, 256) for s in (2, 3, 4))
# the force-field routes (phases 18 and 19), float64 on the card: the
# SADDLE dihedral scan of suite_inputs' chlorocycloalkane ring at
# DSCAN_RING carbons (scan> of C3-C4-C5-C6), then neb>, saddle> and the
# C0-Cl distance scan on the same ring, held to the JAX x64 records of
# tests/test_torch_suite_counts.py (`... dihedral_scan 9 GOLDEN.npz`,
# `... ff_operators 9 GOLDEN.npz`) and to the port's CPU run
DSCAN_RING = 9
DSCAN_GOLDEN = os.path.join(GOLDEN, 'dihedral_scan.npz')
FF_OPS_GOLDEN = os.path.join(GOLDEN, 'ff_operators.npz')
SCAN_TIE = 1e-6            # kcal/mol: a point this close to a decision is a tie
DIMER_TIMED_STEPS = 100    # dimer steps per timing of the replayed step
BAND_TIMED_STEPS = 200     # band steps per timing of the replayed step
EAGER_TIMED_STEPS = 5      # steps per timing of a step queued op by op

# phase 20: the optimisation route, sn2_string without NOOPT (the
# calculators chosen by keyword, every xtb call answered by the stand-in
# of tests/torch_standin), held to the JAX x64 record of the same run
OPT_CONFS = 76
OPT_GOLDEN = os.path.join(GOLDEN, 'sn2_string_opt.npz')

# phase 21: the sharded paths on a mesh naming the card MESH_SHARDS
# times (one process; the counterpart of the JAX tests' virtual CPU
# mesh), every route against its unsharded run in float64
MESH_SHARDS = 4
MESH_ROUTES = (('sn2_string', STRING_CONFS), ('da_cyclical_xl', CYC_CONFS),
               ('multiembed', ME_CONFS), ('trimolecular_rigid', TRI_CONFS),
               ('csearch_string', SEARCH_CONFS))
MESH_ATOL = 1e-6           # A, sharded frames against unsharded
MESH_SCREEN_B = 8 * MESH_SHARDS   # poses of sharded_embed_screen_step

# phase 22: the CLI's --trace; each hand-kernel entry and its kernel's
# __global__ name with the first template argument, as the trace names
# the device events
TRACE_KERNELS = {
    'clash_ok_f32': ('clash_ok_ring_kernel', 'float'),
    'clash_ok_f64': ('clash_ok_ring_kernel', 'double'),
    'clash_ok_v1_f32': ('clash_ok_kernel', 'float'),
    'clash_ok_v1_f64': ('clash_ok_kernel', 'double'),
    'torsion_backoff_f64': ('torsion_backoff_kernel', 'double'),
    'clash_ok_warp_f32': ('clash_ok_warp_kernel', 'float'),
    'clash_ok_warp_f64': ('clash_ok_warp_kernel', 'double'),
    'qcp_kill_f32': ('qcp_kill_warp_kernel', 'float'),
    'qcp_kill_f64': ('qcp_kill_warp_kernel', 'double'),
    'qcp_kill_dev_f32': ('qcp_kill_warp_kernel', 'float'),
    'qcp_kill_dev_f64': ('qcp_kill_warp_kernel', 'double'),
    # the FIRE kernel's forms: ff_fire_group_kernel (lone, warp),
    # ff_fire_large_kernel
    'ff_fire_f32': ('ff_fire_(?:group|large)_kernel', 'float'),
    'ff_fire_f64': ('ff_fire_(?:group|large)_kernel', 'double'),
    # T1, the TFD prune's search (its first template argument: rows a
    # warp); T1's first design, the yardstick (no template)
    'tfd_first_successor': ('tfd_first_tile_kernel', None),
    'tfd_first_warp_successor': ('tfd_first_kernel', None),
    # B1, the block sweep: its screen and its write; B1's first design, the
    # yardstick
    'block_keep_f32': ('block_keep_kernel', 'float'),
    'block_keep_f64': ('block_keep_kernel', 'double'),
    'block_write_f32': ('block_write_kernel', 'float'),
    'block_write_f64': ('block_write_kernel', 'double'),
    'block_screen_row_f32': ('block_screen_kernel', 'float'),
    'block_screen_row_f64': ('block_screen_kernel', 'double'),
    # D1, the dimer (its forms: dimer_lone_kernel<T>,
    # dimer_large_kernel<T, SHARED>; the staged form's dimer_kernel<T>)
    'dimer_f32': ('dimer_(?:lone_|large_)?kernel', 'float'),
    'dimer_f64': ('dimer_(?:lone_|large_)?kernel', 'double'),
    # N1, the NEB band (its forms: neb_band_kernel<CLUSTER, GRID>), and
    # I1, the IDPP relaxation (its forms: idpp_lone_kernel,
    # idpp_cluster_kernel; no template)
    'neb_band_f64': ('neb_band_kernel', '(?:true|false)'),
    'idpp_fire_f64': ('idpp_(?:lone|cluster)_kernel', None),
}
# phase 22: dimer steps replayed under the trace (the captured graph's
# check; a step is ~2,600 kernels)
TRACE_DIMER_STEPS = 20
# D1, the dimer kernel: phase 18 runs every form that fits on each of
# these inputs (dimer_inputs; name -> steps): the SADDLE scan's sub-peak
# guess, saddle>'s C2F2H4 (the monomolecular input's first conformer),
# 150- and 2,500-atom suite_inputs.chain_ff chains; the operations of its
# vector algebra an atom for each of the 19 force evaluations of a step
# whose forces feed it (displaced copies, the Hessian action,
# projection, norm, shift, step), for its bound; the dependent Hessian
# actions of a step at the default n_rot (4 power steps, the shift's, 12
# rotations and the curvature's), for its latency figure; the widths
# that --dimer sweeps
DIMER_CASES = {'scan_guess': 300, 'saddle_c2f2h4': 300, 'chain150': 100,
               'chain2500': 10}
DIMER_ATOM_FLOPS = 40
DIMER_CHAIN = 18
DIMER_CLUSTERS = (1, 2, 4, 8, 16)
# N1 and I1, the NEB band and IDPP kernels: the bands on which phase 19b
# (--neb) holds each kernel to its twin in every form and times it
# (neb_inputs; name -> steps of each band phase): phase 19's band (the
# ring's first scan point and the point 120 degrees on, aligned as neb>
# aligns them, their IDPP band: 400 plain then 400 climbing steps, as
# run_neb runs them), HCOOH's O-H rotor (400 + 400), 150- and
# 2,500-atom suite_inputs.chain_ff chains (10 + 10; I1 there 10 steps at
# fmax 0, so that every image takes them all); the clusters of the large
# form, and the grid form's blocks when few, run beside the rule's plan,
# and the first designs of both kernels (PR 22's, launch_v1) beside them
# in turns; I1's cluster form on IDPP_CLUSTERS blocks;
# for the bounds, the operations of the
# band algebra an atom a step, those an energy adds to a term's forward
# values (its square, the constant, the add into the sum), and those of
# one unordered IDPP pair (both atoms' contributions); the chains on
# which N1 in the rule's plan, the large form and the grid form are timed
# against the graph route a step (neb_crossover), NEB_CROSSOVER_STEPS
# steps
NEB_CASES = {'ring': 400, 'hcooh': 400, 'chain150': 10, 'chain2500': 10}
NEB_IMAGES = 7
NEB_CLUSTERS = (1, 2, 3, 5)
NEB_GRID_FEW = 3
NEB_ATOM_FLOPS = 100
NEB_TERM_ENERGY_FLOPS = 3
NEB_CROSSOVER = (10, 20, 30, 60, 100, 200, 300, 500, 1000, 2500)
NEB_CROSSOVER_STEPS = 10
IDPP_STEPS = 300
IDPP_CLUSTERS = (1, 2, 4, 8, 16)
IDPP_PAIR_FLOPS = 30
# the force field's FIRE kernel: operations of one evaluation of each
# term (the function's work counts each term once a step, whatever the
# kernel recomputes) and of the FIRE update of one atom, for its bound
FF_TERM_FLOPS = {'pair': 20, 'angle': 60, 'dihedral': 110, 'atom': 60}
TRACE_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
TRACE_TOP = 10             # device operations listed per traced run

class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_env():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this '
              'script needs an NVIDIA GPU', file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    try:
        import networkx
    except ImportError as e:
        raise SmokeFailure(f'networkx is missing ({e}); the molecule '
                           f'graph code of tscode_tpu_torch needs it') from e
    try:
        import tscode_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f'the package tscode_tpu_torch is missing ({e}); '
                           f'run this script from the root of a checkout') \
            from e
    try:
        sklearn = 'scikit-learn ' + importlib.metadata.version('scikit-learn') \
            + ' installed, unused (the port clusters with its own cluster.py)'
    except importlib.metadata.PackageNotFoundError:
        sklearn = 'no scikit-learn (the port clusters with its own cluster.py)'
    try:
        mpl = 'matplotlib ' + importlib.metadata.version('matplotlib') + \
            ' (the plots are written)'
    except importlib.metadata.PackageNotFoundError:
        mpl = 'no matplotlib (the plots are skipped, and logged)'
    print(f'[1 env] device {torch.cuda.get_device_name(0)} | nvidia-smi: '
          f'{card} | torch {torch.__version__} | cuda {torch.version.cuda} '
          f'| networkx {networkx.__version__} | {sklearn} | {mpl} | python '
          f'{sys.version.split()[0]}')
    return card


def phase_build():
    '''Build every kernel library at once, one nvcc per source.'''
    from concurrent.futures import ThreadPoolExecutor
    from tscode_tpu_torch.ops.kernels import (block_screen, clash, dimer,
                                              ff_fire, idpp, neb, qcp, tfd)
    libs = (clash.KERNEL, qcp.KERNEL, qcp.THREAD_KERNEL, ff_fire.KERNEL,
            ff_fire.BLOCK_KERNEL, tfd.KERNEL, tfd.WARP_KERNEL,
            block_screen.KERNEL, block_screen.ROW_KERNEL, dimer.KERNEL,
            neb.KERNEL, neb.V1_KERNEL, idpp.KERNEL, idpp.V1_KERNEL)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.build(), libs))
    for k in libs:
        regs = [ln.strip() for ln in k.build_log().splitlines()
                if 'registers' in ln]
        print(f'[2 build] {k.name}: {k.build_seconds:.2f} s '
              f'({k.library}) {" / ".join(regs)}')


def cuda_ms(fn, reps=10):
    '''Mean milliseconds per call after one warm-up call (CUDA events
    around `reps` calls, host enqueue time included): for the plain
    versions, which are many launches each. The hand kernels are timed
    with device_ms.'''
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps=10):
    '''Mean device milliseconds per call after one warm-up call: the
    calls are queued behind a sleep kernel, so CUDA events around them
    time the card's work and not the host's enqueue.'''
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def clash_ties(poses, pairs, thresh):
    '''(B,) bool: poses with a listed pair within CLASH_TIE of thr^2
    (exact float64 difference form).'''
    import torch
    P = poses.double()
    pl = pairs.long()
    d = P[:, pl[:, 0]] - P[:, pl[:, 1]]
    d2 = torch.sum(d * d, dim=-1)
    return ((d2 - thresh * thresh).abs() < CLASH_TIE).any(dim=1)


def qcp_tie_rows(hs, act, end, positions, tol, chunk=1 << 20):
    '''(len(positions),) bool: positions with a pass pair whose float64
    rmsd lies within tol of thr, or maxdev within tol of 2*thr.'''
    import torch
    from tscode_tpu_torch.ops.kernels.qcp import pass_pairs
    from tscode_tpu_torch.ops.linalg import rmsd_and_max
    hs64 = hs.double()
    p, q = pass_pairs(end.long(), positions)
    tie = torch.zeros(p.numel(), dtype=torch.bool, device=hs.device)
    for i in range(0, p.numel(), chunk):
        a = hs64[act[p[i:i + chunk]]]
        b = hs64[act[q[i:i + chunk]]]
        rmsd, maxdev = rmsd_and_max(a, b)
        tie[i:i + chunk] = ((rmsd - THR).abs() < tol) | \
            ((maxdev - 2 * THR).abs() < tol)
    rows = torch.zeros(end.numel(), dtype=torch.bool, device=hs.device)
    rows[p[tie]] = True
    return rows[positions]


def compare_bits(got, want, tie, what):
    '''Exact agreement outside the tie rows; every disagreement must be
    a tie. Returns (max |got - want| outside ties, number of tie rows).'''
    diff = got != want
    check(not bool((diff & ~tie).any()),
          f'{what}: {int((diff & ~tie).sum())} rows disagree away from '
          f'any threshold tie')
    return int(diff[~tie].sum() > 0), int(tie.sum())


def k1_bytes(poses, pairs):
    '''Bytes K1 must move on one call: each pose read once, the pair
    list read once, one byte written a pose.'''
    return poses.numel() * poses.element_size() + pairs.numel() * 4 + \
        poses.shape[0]


def k1_yardstick(poses, pairs, mc=0):
    '''K1's thread regime on one tensor: the ring kernel and the v1
    kernel, both forced, device ms in the order v1, ring, ring, v1
    (means of the two), and the ring's tiles per load path on one
    launch.'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash
    pairs = torch.as_tensor(pairs, dtype=torch.int32,
                            device=poses.device).contiguous()
    clash.reset_tile_paths()
    clash.launch(poses, pairs, CLASH, mc, 'thread')
    paths = clash.tile_paths()
    (v1a, v1b), (ra, rb) = ab_ms(
        lambda: clash.launch(poses, pairs, CLASH, mc, 'v1'),
        lambda: clash.launch(poses, pairs, CLASH, mc, 'thread'))
    return {'thread_ms': (ra + rb) / 2, 'v1_ms': (v1a + v1b) / 2,
            'tile_paths': paths}


def k1_line(rec):
    '''K1's times as phase 5 and the route phases print them: the
    route's kernel / ring kernel / v1 kernel / plain / bound.'''
    return (f'K1 {rec["ms"]:.4f} ms ({rec["regime"]}) / ring '
            f'{rec["thread_ms"]:.4f} / v1 kernel {rec["v1_ms"]:.4f} / plain '
            f'{rec["plain_ms"]:.4f} / bound {rec["bound_ms"]:.4f} ms (bytes), '
            f'device ms; ring tiles by load path {rec["tile_paths"]}')


def thread_kernel_checks(card):
    '''Phase 3: K1's ring kernel (the thread regime) and the v1 thread
    kernel against plain, off ties, at every B of K1_BATCHES and N of
    K1_ATOMS (two fragments), float32 and float64, max_clashes 0 and 3,
    on a batch whose base lies on the 16-byte grid and on the slice
    poses[1:] of a larger one (a base off the grid for N = 11 and 15);
    the ring's tiles per load path. Returns the largest disagreement.'''
    import torch
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.ops.kernels import clash
    err = 0
    gen = torch.Generator(device=DEV).manual_seed(13)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split('.')[-1]
        for N in K1_ATOMS:
            pm = cross_fragment_pair_mask((N // 2, N - N // 2))
            pairs = torch.as_tensor(clash.static_pairs(pm), device=DEV)
            full = (torch.randn((max(K1_BATCHES) + 1, N, 3), generator=gen,
                                dtype=torch.float64, device=DEV)
                    * 2.2).to(dtype)
            paths, n_tie, n_pass = {}, 0, [0, 0]
            for B in K1_BATCHES:
                for where, poses in (('aligned', full[:B]),
                                     ('offset', full[1:B + 1])):
                    tie = clash_ties(poses, pairs, CLASH)
                    for mc in (0, 3):
                        want = clash.clash_ok_plain(poses, pairs, CLASH, mc)
                        clash.reset_tile_paths()
                        got = clash.launch(poses, pairs, CLASH, mc,
                                           'thread')
                        for k, v in clash.tile_paths().items():
                            paths[where, k] = paths.get((where, k), 0) + v
                        what = f'{name} B={B} N={N} {where} mc={mc}'
                        e, _ = compare_bits(got, want, tie, f'K1 ring {what}')
                        compare_bits(clash.launch(poses, pairs, CLASH, mc,
                                                  'v1'), want, tie,
                                     f'K1 v1 kernel {what}')
                        err = max(err, e)
                        n_pass[mc > 0] += int(want.sum())
                    n_tie += int(tie.sum())
            check(all(0 < n for n in n_pass), f'K1 {name} N={N}: '
                  f'degenerate poses ({n_pass} pass)')
            print(f'[3 kernels] K1 ring and v1 kernels {name} N={N} '
                  f'(P={pairs.shape[0]}): B in {list(K1_BATCHES)}, aligned '
                  f'and offset by one pose, max_clashes 0 and 3, equal to '
                  f'plain ({n_tie} tie poses excluded); ring tiles by load '
                  f'path {dict((f"{w} {k}", v) for (w, k), v in paths.items())}'
                  f' [{card}]')
    return err


def large_pose_checks(name, dtype):
    '''Phase 3: 5,000-atom poses, too large for the ring kernel, through
    clash_ok: P = 54 (6 x 9 atoms of two 2,500-atom fragments) and
    P = 49,900 (fragments of 10 and 4,990 atoms, no warp-regime slot
    pair fits in float64), max_clashes 0 and 3, against the plain direct
    differences of the pair list, off ties; the v1 kernel must have
    taken every thread-regime launch. Returns the largest
    disagreement.'''
    import torch
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.ops.kernels import clash
    err = 0
    v1 = 'clash_ok_v1_f64' if dtype == torch.float64 else 'clash_ok_v1_f32'
    for frags, spread in (((2500, 2500), 2.2), ((10, 4990), 26.4)):
        if frags[0] == 2500:
            pairs = np.array([(i, 2500 + j) for i in range(6)
                              for j in range(9)], dtype=np.int32)
        else:
            pairs = clash.static_pairs(cross_fragment_pair_mask(frags))
        pairs = torch.as_tensor(pairs, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(frags[0])
        poses = (torch.randn((67, 5000, 3), generator=gen, dtype=torch.float64,
                             device=DEV) * spread).to(dtype)
        tie = clash_ties(poses, pairs, CLASH)
        regime = clash.clash_regime(pairs.shape[0], 5000,
                                    poses.element_size())
        for mc in (0, 3):
            clash.KERNEL.reset_counts()
            got = clash.clash_ok(poses, pairs, CLASH, mc)
            check(regime == 'warp' or clash.KERNEL.entry_launches[v1] == 1,
                  f'clash {name} 5,000 atoms P={pairs.shape[0]}: the v1 '
                  f'kernel not launched ({clash.KERNEL.entry_launches})')
            want = clash.pair_clash_ok_plain(poses, pairs, CLASH, mc)
            e, _ = compare_bits(got, want, tie, f'clash {name} 5,000 atoms '
                                f'P={pairs.shape[0]} mc={mc}')
            err = max(err, e)
            check(mc or 0 < int(want.sum()) < len(want), f'clash {name} '
                  f'5,000 atoms P={pairs.shape[0]}: degenerate case')
        print(f'[3 kernels] clash {name}: 67 poses of 5,000 atoms, '
              f'P={pairs.shape[0]} ({regime} regime'
              f'{", v1 kernel" if regime == "thread" else ""}), '
              f'max_clashes 0 and 3, equal to plain ({int(tie.sum())} tie '
              f'poses excluded)')
    return err


def crossover_sweep(card, n_poses=N_POSES, reps=10):
    '''Both regimes (the ring kernel and the warp kernel, forced) and
    the v1 kernel at each pair count of CROSSOVER_FRAGMENTS on n_poses
    random poses, float32 and float64, device ms; printed, and returned
    as {dtype: {P: {regime: ms}}}.'''
    import torch
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.ops.kernels import clash
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split('.')[-1]
        rows = out[name] = {}
        for P, frags in CROSSOVER_FRAGMENTS.items():
            pm = cross_fragment_pair_mask(frags)
            pairs = torch.as_tensor(clash.static_pairs(pm), device=DEV)
            gen = torch.Generator(device=DEV).manual_seed(P)
            poses = (torch.randn((n_poses, sum(frags), 3), generator=gen,
                                 dtype=torch.float64, device=DEV)
                     * 2.2).to(dtype)
            rows[P] = {r: device_ms(lambda: clash.launch(
                poses, pairs, CLASH, 0, r), reps=reps)
                for r in ('thread', 'warp', 'v1')}
            rows[P]['N'] = sum(frags)
            rows[P]['bound_ms'] = k1_bytes(poses, pairs) / \
                HBM_BYTES_PER_S * 1e3
            rows[P]['route'] = clash.clash_regime(P, sum(frags),
                                                  poses.element_size())
            del poses
        print(f'[3 kernels] K1 crossover {name}, {n_poses} poses, device '
              f'ms ring / warp / v1 kernel (bound; the route\'s regime): '
              + '; '.join(f'P={P} N={r["N"]}: {r["thread"]:.4f} / '
                          f'{r["warp"]:.4f} / {r["v1"]:.4f} '
                          f'({r["bound_ms"]:.4f}; {r["route"]})'
                          for P, r in rows.items()) + f' [{card}]')
    return out


def backoff_ties(call):
    '''(tie, steps) of one torsion_backoff call (its arguments): the
    candidates with a pair within CLASH_TIE of thr^2 at any step they
    evaluate (up to their first clash-free step, while the angle left is
    >= 0), and the steps each evaluates (0 for an angle-0 row, which the
    kernel leaves as it is).'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash
    coords, quad, move, angles, other, max_steps = call
    pairs = clash.torsion_pairs(move, other, coords.device)
    pl = pairs.long()
    retreat = clash.backoff_retreat(coords, clash.backoff_terms(coords, quad),
                                    move, angles, pairs, CLASH)
    tie = torch.zeros(len(coords), dtype=torch.bool, device=coords.device)
    found = torch.zeros_like(tie)
    steps = torch.zeros(len(coords), dtype=torch.int64, device=coords.device)
    for s in range(max_steps + 1):
        cand, ok = retreat(s)
        live = ~found & (angles - s * clash.BACKOFF_STEP >= 0) & \
            (angles != 0)
        d = cand[:, pl[:, 0]] - cand[:, pl[:, 1]]
        d2 = torch.sum(d * d, dim=-1)
        tie |= live & ((d2 - CLASH * CLASH).abs() < CLASH_TIE).any(dim=1)
        steps += live
        found |= ok
    return tie, steps


def backoff_compare(call, what):
    '''torsion_backoff against its plain twin on one call's arguments:
    frames and flags bit-equal off the tie candidates (backoff_ties).
    Returns (largest frame difference off ties, tie candidates, steps
    evaluated, rows rotated, rows without a clash-free step).'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash
    got, got_rot = clash.torsion_backoff(*call)
    want, want_rot = clash.torsion_backoff_plain(*call)
    tie, steps = backoff_ties(call)
    off = ~tie
    check(torch.equal(got_rot[off], want_rot[off]) and
          torch.equal(got[off], want[off]), f'{what}: torsion_backoff '
          f'differs from its plain twin off ties: '
          f'{int((got_rot != want_rot)[off].sum())} flags, largest frame '
          f'difference {float((got - want)[off].abs().max()):.3e} A')
    angles = call[3]
    err = float((got - want)[off].abs().max()) if bool(off.any()) else 0.0
    return (err, int(tie.sum()), steps, int(want_rot.sum()),
            int(((angles != 0) & ~want_rot).sum()))


def backoff_bound(call, steps):
    '''(bound_ms, bound_by) of one back-off, the function (coords,
    angles) -> (frames, flags): the poses, the angles, the pair list and
    the moved atoms read once, the frames and flags written once (the
    Rodrigues terms are this design's intermediates, not inputs),
    against ~9 operations a pair and 12 a moved atom at every step each
    candidate evaluates.'''
    from tscode_tpu_torch.ops.kernels import clash
    coords, quad, move, angles, other, max_steps = call
    B, N = coords.shape[0], coords.shape[1]
    P = int(clash.torsion_pairs(move, other, coords.device).shape[0])
    M = int(np.count_nonzero(move))
    nbytes = 2 * B * N * 3 * 8 + B * 8 + P * 8 + M * 4 + B
    ops = int(steps.sum()) * (9 * P + 12 * M)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS['float64']
    return max(t_bytes, t_ops) * 1e3, \
        'bytes' if t_bytes >= t_ops else 'operations'


def backoff_phase3(card):
    '''Phase 3: torsion_backoff against its plain twin on seeded
    candidates of the C10H21Cl chain (every torsion), as they are and
    shrunk to 0.75 (rows with no clash-free step), angles 0 to 240 in
    5-degree steps (angle-0 rows), max_steps the largest angle's count
    and a bucket past it. Returns the largest disagreement.'''
    import torch
    from tscode_tpu_torch import torsions as tt
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.ops.kernels import clash
    from tscode_tpu_torch.suite_inputs import chloroalkane
    base, nos = chloroalkane(10)
    graph = graphize(base, nos)
    tors = tt.get_torsions(graph, [], tt.get_double_bonds_indices(base, nos))
    for t in tors:
        t.sort_torsion(graph, np.array([]))
    rng = np.random.default_rng(17)
    err, n_tie, n_rot, n_never, n_calls = 0, 0, 0, 0, 0
    clash.KERNEL.reset_counts()
    for scale in (1.0, 0.75):
        coords = torch.as_tensor(
            (base + rng.normal(size=(4099,) + base.shape) * 0.05) * scale,
            device=DEV)
        angles = rng.integers(0, 49, size=4099) * 5.0
        angles[:3] = (0.0, 0.0, 240.0)
        angles = torch.as_tensor(angles, device=DEV)
        for t in tors:
            move = tt.get_rotation_mask(graph, t.torsion)
            other = ~move
            other[list(t.torsion[1:3])] = False
            for steps in (48, 60):
                e, tie, _, rot, never = backoff_compare(
                    (coords, t.torsion, move, angles, other, steps),
                    f'back-off {t.torsion} scale {scale} steps {steps}')
                err = max(err, e)
                n_tie, n_rot, n_never = n_tie + tie, n_rot + rot, \
                    n_never + never
                n_calls += 1
    check(n_rot > 0 and n_never > 0 and
          clash.launches_by_entry()['torsion_backoff'] == n_calls,
          f'back-off phase 3: {n_rot} rotated, {n_never} rows without a '
          f'clash-free step, launches {clash.launches_by_entry()}')
    print(f'[3 kernels] torsion_backoff f64: {n_calls} calls on 4,099 '
          f'candidates of the C10H21Cl chain ({len(tors)} torsions, as built '
          f'and shrunk to 0.75, max_steps 48 and 60), frames and flags '
          f'bit-equal to the plain twin off {n_tie} tie candidates; '
          f'{n_rot} rotated, {n_never} without a clash-free step [{card}]')
    return err


def qcp_pair_flops(N, name):
    '''Operations of one pair evaluation of csrc/qcp_kill.cu: 24 N for
    S and GB, ~90 for the quartic's coefficients and the rmsd gate, ~14
    for each Newton step.'''
    return 24 * N + 90 + 14 * NEWTON_STEPS[name]


def qcp_bound(M, row_bytes, pairs, N, name):
    '''(bound_ms, bound_by) of one pass: each active row read once with
    its act and end entries (4 B each) and one kill byte written, against
    the pair evaluations these data need (up to each row's first hit).'''
    t_bytes = M * (row_bytes + 9) / HBM_BYTES_PER_S
    t_ops = pairs * qcp_pair_flops(N, name) / PEAK_FLOPS[name]
    return max(t_bytes, t_ops) * 1e3, \
        'bytes' if t_bytes >= t_ops else 'operations'


def ab_ms(parent, change):
    '''Both engines' device times in one call, in the order parent,
    change, change, parent: ((parent, parent), (change, change)) ms.'''
    p1 = device_ms(parent)
    c1 = device_ms(change)
    c2 = device_ms(change)
    return (p1, device_ms(parent)), (c1, c2)


def schedule_passes(hs):
    '''The headline prune over hs with K3, its passes kept:
    ([(k, act, end)], kept).'''
    from tscode_tpu_torch.ops.kernels import qcp
    from tscode_tpu_torch.ops.rmsd_prune import (
        K_SCHEDULE, prune_conformers_rmsd_device)
    seen = []

    def kept_pass(h, act, end, thr):
        seen.append((act, end))
        return qcp.qcp_kill(h, act, end, thr)

    keep = prune_conformers_rmsd_device(hs, THR, pair_kill=kept_pass)
    ks = iter(K_SCHEDULE)        # a pass runs k when 20 k < its M, or k = 1
    passes = [(int(next(k for k in ks if k == 1 or 20 * k < act.numel())),
               act, end) for act, end in seen]
    return passes, int(keep.sum())


def dev_entry_pass(hs, act, end, k, got, plain_time):
    '''K3's device-count entry (qcp_kill_dev) on the pass (act, end) of
    schedule value k, in buffers of hs's rows with the count on the card,
    as device_schedule gives it: its kill bits against qcp_kill's `got`
    (one kernel: bit for bit), the alive bits it clears, nothing written
    with the gate shut (k = M // 20 + 1 when that is not 1), its device
    time, and its plain twin's if asked. Returns (record, rows that
    differ).'''
    import torch
    from tscode_tpu_torch.ops.kernels import qcp
    M, L = act.numel(), hs.shape[0]
    act_b = torch.zeros(L, dtype=torch.int32, device=hs.device)
    end_b = torch.zeros_like(act_b)
    act_b[:M], end_b[:M] = act, end
    m = torch.tensor([M], dtype=torch.int32, device=hs.device)
    live = torch.zeros(L, dtype=torch.bool, device=hs.device)
    live[act.long()] = True
    alive, kill = live.clone(), torch.zeros(L, dtype=torch.bool,
                                            device=hs.device)
    qcp.qcp_kill_dev(hs, act_b, end_b, m, k, THR, alive, kill)
    differ = int((kill[:M] != got).sum())
    want = live.clone()
    want[act.long()[got]] = False
    check(differ == 0 and torch.equal(alive, want), f'qcp_kill_dev at k={k}'
          f', M={M}: {differ} kill bits differ from qcp_kill\'s, alive bits '
          f'equal: {torch.equal(alive, want)}')
    shut = M // 20 + 1
    if shut > 1:
        alive, sentinel = live.clone(), torch.ones_like(kill)
        qcp.qcp_kill_dev(hs, act_b, end_b, m, shut, THR, alive, sentinel)
        check(torch.equal(alive, live) and bool(sentinel.all()),
              f'qcp_kill_dev wrote with its gate shut (k={shut}, M={M})')
    ms = [device_ms(lambda: qcp.qcp_kill_dev(hs, act_b, end_b, m, k, THR,
                                             alive, kill)) for _ in range(2)]
    plain = cuda_ms(lambda: qcp.qcp_kill_dev_plain(
        hs, act_b, end_b, m, k, THR, live.clone(), kill), reps=1) \
        if plain_time else None
    return {'dev_ms': ms, 'dev_plain_ms': plain, 'dev_equal': True,
            'dev_gate_shut_checked': shut > 1,
            'dev_blocks': qcp.device_pass_blocks(L)}, differ


def qcp_pass(card, hs, act, end, name, what, plain_time, k=None):
    '''K3 on one pass: kill bits of the kernel and of the thread-per-row
    kernel against plain off ties, the walks (plain helper on the card),
    the A/B times, plain's time if asked, and the bound; with k, the
    pass's schedule value, also the device-count entry (dev_entry_pass).
    Returns (record, largest disagreement off ties).'''
    import torch
    from tscode_tpu_torch.ops.kernels import qcp
    M, N = act.numel(), hs.shape[1]
    walk = qcp.walk_lengths(hs, act, end, THR)
    got = qcp.qcp_kill(hs, act, end, THR)
    want = qcp.qcp_kill_plain(hs, act, end, THR)
    thread = qcp.qcp_kill_thread(hs, act, end, THR)
    diff = torch.nonzero((got != want) | (thread != want)).squeeze(1)
    tie = torch.zeros_like(got)
    if diff.numel():
        tie[diff] = qcp_tie_rows(hs, act, end, diff, QCP_TIE[name])
    err, _ = compare_bits(got, want, tie, f'qcp {name} {what}')
    compare_bits(thread, want, tie, f'qcp thread-per-row {name} {what}')
    act32, end32 = act.int().contiguous(), end.int().contiguous()
    (p1, p2), (c1, c2) = ab_ms(
        lambda: qcp.qcp_kill_thread(hs, act32, end32, THR),
        lambda: qcp.qcp_kill(hs, act32, end32, THR))
    plain_ms = cuda_ms(lambda: qcp.qcp_kill_plain(hs, act, end, THR),
                       reps=1) if plain_time else None
    pairs, longest = int(walk.sum()), int(walk.max()) if M else 0
    bound, by = qcp_bound(M, N * 3 * hs.element_size(), pairs, N, name)
    rec = {'pass': what, 'dtype': name, 'M': M, 'N': N,
           'longest_walk': longest, 'pairs': pairs,
           'kills': int(got.sum()), 'ms': [c1, c2], 'parent_ms': [p1, p2],
           'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
           'plan': list(qcp.launch_plan(M)),
           'equal_to_thread_kernel': bool(torch.equal(got, thread))}
    plain = f', plain {plain_ms:.4f}' if plain_time else ''
    dev = ''
    if k is not None:
        dev_rec, _ = dev_entry_pass(hs, act, end, k, got, plain_time)
        rec.update(dev_rec)
        dev = (f'; device-count entry {dev_rec["dev_ms"][0]:.4f} / '
               f'{dev_rec["dev_ms"][1]:.4f} ms on {dev_rec["dev_blocks"]} '
               f'blocks, its kill bits equal' + (
                   f', plain twin {dev_rec["dev_plain_ms"]:.4f} ms'
                   if plain_time else ''))
    print(f'[5 qcp {name}] {what}: M={M} N={N}, longest walk {longest}, '
          f'{pairs} pairs, {rec["kills"]} kills ({int(tie.sum())} tie rows '
          f'differ), plan {rec["plan"]}: kernel {c1:.4f} / {c2:.4f} ms, '
          f'thread-per-row {p1:.4f} / {p2:.4f} ms{plain}, bound '
          f'{bound:.4f} ms ({by}); kill bits equal to the thread-per-row '
          f'kernel\'s: {rec["equal_to_thread_kernel"]}{dev} [{card}]')
    return rec, err


def qcp_headline_passes(card, hs, name):
    '''K3 on each pass of the headline prune in dtype `name` (the clash
    survivors' heavy atoms), plain timed at the first pass only.
    Returns (records, kept, largest disagreement off ties).'''
    passes, kept = schedule_passes(hs)
    recs, err = [], 0
    for i, (k, act, end) in enumerate(passes):
        rec, e = qcp_pass(card, hs, act, end, name, f'k={k}', i == 0, k)
        recs.append(rec)
        err = max(err, e)
    return recs, kept, err


def long_chunk(N, dtype):
    '''One long chunk: LONG_ROWS rows under k = 1, noisy copies of
    LONG_BASES base structures drawn at random, so most rows have no
    later copy and walk to the end, thousands of pairs. -> (hs, act,
    end) on the card.'''
    import torch
    rng = np.random.default_rng(LONG_ROWS + N)
    base = rng.normal(size=(LONG_BASES, N, 3)) * 1.5
    pool = base[rng.integers(0, LONG_BASES, size=LONG_ROWS)] + \
        rng.normal(size=(LONG_ROWS, N, 3)) * 0.05
    act = torch.arange(LONG_ROWS, device=DEV)
    return (torch.as_tensor(pool, dtype=dtype, device=DEV), act,
            torch.full_like(act, LONG_ROWS))


def qcp_long_chunks(card):
    '''K3 on the long chunks, N = 4 and 8, f32 and f64.'''
    import torch
    recs, err = [], 0
    for N in (4, 8):
        for dtype in (torch.float32, torch.float64):
            hs, act, end = long_chunk(N, dtype)
            rec, e = qcp_pass(card, hs, act, end, str(dtype).split('.')[-1],
                              f'one chunk of {LONG_ROWS}', True, 1)
            recs.append(rec)
            err = max(err, e)
    return recs, err


def big_fragment_poses(rng, n_poses, n_atoms):
    '''Poses of two n_atoms-atom fragments, gaussian blobs (sigma 2 A)
    whose centers lie 5 to 16 A apart: from hundreds of cross clashes per
    pose down to none.'''
    f1 = rng.normal(size=(n_poses, n_atoms, 3)) * 2.0
    f2 = rng.normal(size=(n_poses, n_atoms, 3)) * 2.0
    f2[..., 0] += rng.uniform(5.0, 16.0, size=(n_poses, 1))
    return np.concatenate([f1, f2], axis=1)


def near_dup_blocks(rng, B, L, N):
    '''Blocks of noisy copies of a few base structures, with noise
    levels that put pair rmsds on both sides of 0.5 A (and, for N = 8,
    inside the sqrt(N) band where the maxdev gate decides).'''
    base = rng.normal(size=(B, 4, N, 3)) * 1.5
    which = rng.integers(0, 4, size=(B, L))
    sigma = rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=(B, L))
    P = base[np.arange(B)[:, None], which] + \
        rng.normal(size=(B, L, N, 3)) * sigma[..., None, None]
    return P, rng.integers(1, L + 1, size=B)


def phase_kernels(card):
    '''Phase 3: every kernel against its plain twin at small shapes, K1's
    thread regime at every shape of thread_kernel_checks, the back-off
    entry (backoff_phase3), and the crossover sweep. Returns (largest
    disagreement per kernel, the sweep).'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash, qcp
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.ops.rmsd_prune import (
        prune_conformers_rmsd_device)
    dev = torch.device(DEV)
    errs = {'clash': 0, 'qcp_kill': 0}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split('.')[-1]
        clash.KERNEL.reset_counts()
        qcp.KERNEL.reset_counts()

        # clash, both entries, B not a multiple of 2048
        rng = np.random.default_rng(11)
        pm = cross_fragment_pair_mask((6, 5))
        pairs = torch.as_tensor(clash.static_pairs(pm), device=dev)
        poses = torch.as_tensor(rng.normal(size=(4099, 11, 3)) * 2.2,
                                dtype=dtype, device=dev)
        tie = clash_ties(poses, pairs, CLASH)
        for mc in (0, 3):
            want = clash.clash_ok_plain(poses, pairs, CLASH, mc)
            for got in (clash.clash_ok(poses, pairs, CLASH, mc),
                        clash.compenetration_mask_kernel(poses, pm, CLASH,
                                                         mc)):
                e, _ = compare_bits(got, want, tie, f'clash {name} mc={mc}')
                errs['clash'] = max(errs['clash'], e)
        print(f'[3 kernels] clash {name}: B=4099 max_clashes 0 and 3, '
              f'K1 and K2 entries equal to plain on '
              f'{int((~tie).sum())} poses ({int(tie.sum())} tie poses '
              f'excluded)')

        # clash at any size: two 160-atom fragments, P = 25,600 pairs and
        # N = 320 atoms, more than one block's shared memory holds
        pm = cross_fragment_pair_mask((160, 160))
        pairs = torch.as_tensor(clash.static_pairs(pm), device=dev)
        poses = torch.as_tensor(
            big_fragment_poses(np.random.default_rng(160), 2048, 160),
            dtype=dtype, device=dev)
        tie = clash_ties(poses, pairs, CLASH)
        for mc in (0, 3, 100):
            want = torch.cat([
                clash.clash_ok_plain(poses[i:i + 256], pairs, CLASH, mc)
                for i in range(0, poses.shape[0], 256)])
            got = clash.clash_ok(poses, pairs, CLASH, mc)
            e, _ = compare_bits(got, want, tie, f'clash {name} 160+160 '
                                f'atoms mc={mc}')
            errs['clash'] = max(errs['clash'], e)
            check(0 < int(want.sum()) < poses.shape[0],
                  f'clash {name} 160+160 atoms mc={mc}: degenerate case')
        print(f'[3 kernels] clash {name}: 2048 poses of 160+160 atoms '
              f'(P=25600, N=320), max_clashes 0, 3 and 100, equal to plain '
              f'on {int((~tie).sum())} poses ({int(tie.sum())} tie poses '
              f'excluded)')
        errs['clash'] = max(errs['clash'], large_pose_checks(name, dtype))

        # qcp: planted duplicates -> exactly 3 kills
        rng = np.random.default_rng(3)
        blocks = rng.normal(size=(4, 32, 8, 3)) * 2
        blocks[0, 10] = blocks[0, 3] + 1e-3
        blocks[2, 20] = blocks[2, 5] + 1e-3
        blocks[2, 25] = blocks[2, 5] + 2e-3
        P = torch.as_tensor(blocks, dtype=dtype, device=dev)
        m_real = torch.as_tensor([32, 20, 32, 5], device=dev)
        got = qcp.qcp_kill_blocks(P, m_real, THR)
        act, end = qcp.blocks_as_pass(m_real, 32)
        want = qcp.qcp_kill_plain(P.reshape(-1, 8, 3), act, end, THR)
        check(torch.equal(got.reshape(-1), want),
              f'qcp planted {name}: kernel != plain')
        check(int(got.sum()) == 3, f'qcp planted {name}: '
              f'{int(got.sum())} kills, expected 3')

        # qcp: random near-duplicate blocks at N = 4 and N = 8
        for N in (4, 8):
            Pn, m_real = near_dup_blocks(np.random.default_rng(N), 64, 64, N)
            P = torch.as_tensor(Pn, dtype=dtype, device=dev)
            m_real = torch.as_tensor(m_real, device=dev)
            got = qcp.qcp_kill_blocks(P, m_real, THR).reshape(-1)
            act, end = qcp.blocks_as_pass(m_real, 64)
            hs = P.reshape(-1, N, 3)
            want = qcp.qcp_kill_plain(hs, act, end, THR)
            pos = torch.arange(act.numel(), device=dev)
            tie = qcp_tie_rows(hs, act, end, pos, QCP_TIE[name])
            e, n_tie = compare_bits(got, want, tie, f'qcp blocks {name} '
                                    f'N={N}')
            errs['qcp_kill'] = max(errs['qcp_kill'], e)
            print(f'[3 kernels] qcp_kill_blocks {name} N={N}: 64x64 blocks, '
                  f'{int(want.sum())} kills, equal to plain '
                  f'({n_tie} tie rows excluded)')

        # the prune, pair kernel vs plain, on a 4096-row N = 8 pool
        # without threshold ties (rows of tie pairs are dropped first)
        rng = np.random.default_rng(8)
        base = rng.normal(size=(600, 8, 3)) * 1.5
        pool = base[rng.integers(0, 600, size=4096)] + \
            rng.normal(size=(4096, 8, 3)) * \
            rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=4096)[:, None, None]
        hs = torch.as_tensor(pool, dtype=dtype, device=dev)
        n = hs.shape[0]
        act = torch.arange(n, device=dev)
        tie = qcp_tie_rows(hs, act, torch.full_like(act, n), act,
                           QCP_TIE[name])
        hs = hs[~tie].contiguous()
        keep_k = prune_conformers_rmsd_device(hs, THR)
        keep_p = prune_conformers_rmsd_device(
            hs, THR, pair_kill=qcp.qcp_kill_plain)
        check(np.array_equal(keep_k, keep_p),
              f'prune {name}: kernel keeps {keep_k.sum()}, plain '
              f'{keep_p.sum()}, masks differ')
        print(f'[3 kernels] prune {name}: {hs.shape[0]}-row N=8 pool '
              f'({int(tie.sum())} tie rows dropped) -> {int(keep_k.sum())} '
              f'kept, kernel mask == plain mask')
        check(clash.KERNEL.launches > 0 and qcp.KERNEL.launches > 0,
              f'kernel launch counters stayed 0 ({name})')
    errs['clash'] = max(errs['clash'], thread_kernel_checks(card))
    errs['backoff'] = backoff_phase3(card)
    return errs, crossover_sweep(card)


def main_launches(tag):
    '''Launches of the main path's kernels since the counts were reset:
    K1 (every clash entry), K3's device-count entry (the captured
    schedule's pass; counted where it was queued: the warm-up run, the
    capture's warm-ups and the capture) and K3's host entry, which the
    main path must not launch (the host loop's). Fails unless K1 and the
    device-count entry launched and the host entry did not.'''
    from tscode_tpu_torch.ops.kernels import clash, qcp
    by_entry = qcp.KERNEL.entry_launches
    launches = {
        'clash': clash.KERNEL.launches,
        'qcp_kill_dev': sum(by_entry[f'qcp_kill_dev_{t}']
                            for t in ('f32', 'f64')),
        'qcp_kill': sum(by_entry[f'qcp_kill_{t}'] for t in ('f32', 'f64'))}
    check(launches['clash'] > 0 and launches['qcp_kill_dev'] > 0
          and launches['qcp_kill'] == 0, f'{tag}: the main path launched '
          f'{launches} (K1 and qcp_kill_dev wanted, qcp_kill none)')
    return launches


def host_driven_run(inp):
    '''The slice as the host drives it (run_pipeline's form before the
    captured program): clash_survivors, then the prune's host loop, the
    clock stopped when the keep mask is on the host; timed as the
    replays are, with no sync instrumentation. -> (seconds, keep).'''
    import torch
    from tscode_tpu_torch.ops.rmsd_prune import prune_conformers_rmsd_device
    from tscode_tpu_torch.pipeline import clash_survivors
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hs = clash_survivors(inp)
    keep = prune_conformers_rmsd_device(hs, THR)
    return time.perf_counter() - t0, keep


class synced:
    '''Records the host syncs of the block: torch.cuda's sync debug
    mode warns at each synchronising operation (a prototype: it does not
    see every one), and the warnings are kept.'''

    def __enter__(self):
        import torch
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self.seen = self._catch.__enter__()
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        return self.seen

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self.seen[:] = [w for w in self.seen
                        if 'synchroniz' in str(w.message)]
        return self._catch.__exit__(*exc)


def captured_record(card, tag, mols, dtype, secs, info, n_ok, n_final):
    '''The captured headline program against the host-driven slice, in
    one process: run_pipeline's best of 3 replays (secs) beside the best
    of 3 host-driven runs (both timed with no sync instrumentation), the
    keep mask of the replay equal to the host loop's on the same
    survivors, bit for bit; then one replay under the profiler (device
    busy share, device operations a replay, K1's and K3's kernels among
    them; no device time there fails), the ring's tile counter across a
    replay, and the host syncs of a run (the stats read) and of one
    more, untimed host-driven run. Prints one line; returns the
    record.'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash
    from tscode_tpu_torch.pipeline import (N_ANGLES, inputs_from_numpy,
                                           pipeline_call, pool_size,
                                           spin_angles)
    inp = inputs_from_numpy(*mols, DEV, dtype)
    host = [host_driven_run(inp) for _ in range(3)]
    host_s = min(h[0] for h in host)
    check(all(np.array_equal(h[1][:n_ok], info['keep']) for h in host),
          f'{tag}: the captured keep mask differs from the host loop\'s on '
          f'the same survivors')
    with synced() as host_syncs:
        host_driven_run(inp)
    angles = spin_angles(N_ANGLES, dtype, torch.device(DEV))
    s_pool = pool_size(n_ok)

    def run():
        return pipeline_call(inp, angles, s_pool, n_ok, CLASH,
                             THR)[2].tolist()

    clash.reset_tile_paths()
    torch.cuda.synchronize()
    with synced() as syncs:
        stats = run()
    tiles = clash.tile_paths()
    check(stats == [n_final, n_ok, 1], f'{tag}: a replay gave {stats}')
    wall, busy, ops, names = profiled_kernels(run)
    k1 = sum(c for n, (c, _) in names.items() if 'clash_ok_ring_kernel' in n)
    k3 = sum(c for n, (c, _) in names.items() if 'qcp_kill_warp_kernel' in n)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:TRACE_TOP]
    check(sum(tiles.values()) > 0, f'{tag}: K1 loaded no tile in a replay')
    check(busy is not None, f'{tag}: the profiler saw no device time in '
          f'a replay')
    check(k1 > 0 and k3 > 0, f'{tag}: a replay ran {k1} K1 and {k3} K3 '
          f'kernels')
    rec = {'dtype': str(dtype).split('.')[-1], 'replay_s': secs,
           'replay_runs_s': info['run_s'], 'host_driven_s': host_s,
           'host_driven_runs_s': [h[0] for h in host],
           'busy_share': busy / wall,
           'profiled_wall_s': wall, 'device_ops_per_replay': ops,
           'k1_per_replay': k1, 'k3_per_replay': k3,
           'k1_tiles_per_replay': tiles,
           'host_reads_per_run': len(syncs),
           'top_device_ops': [[n[:80], c, ms] for n, (c, ms) in top],
           'host_syncs_per_host_driven_run': len(host_syncs),
           'warmup_embed_clash_s': info['embed_clash_s'],
           'warmup_prune_s': info['prune_s']}
    print(f'[{tag}] captured program: best of 3 replays {secs:.6f} s '
          f'(runs {", ".join(f"{t:.6f}" for t in info["run_s"])}) against '
          f'the host-driven best of 3 {host_s:.6f} s (runs '
          f'{", ".join(f"{h[0]:.6f}" for h in host)}); keep masks equal; a '
          f'replay under the profiler: busy {rec["busy_share"]} of '
          f'{wall:.6f} s, {ops} device operations, {k1} K1 and {k3} K3 '
          f'kernels, K1 tiles {tiles}; host reads a run {len(syncs)}, '
          f'host syncs of a host-driven run {len(host_syncs)} [{card}]')
    for n, (c, ms) in top:
        print(f'[{tag}] a replay\'s device time: {ms:.4f} ms in {c} x '
              f'{n[:100]}')
    return rec


def profiled_kernels(fn):
    '''profiled(fn) with the device operations by name: (wall, busy,
    operations, {name: (count, device ms)}); the last three None / {}
    when the profiler saw no device time.'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(a.self_device_time_total for a in ops) / 1e6
    if busy == 0:
        return wall, None, None, {}
    return wall, busy, sum(a.count for a in ops), \
        {a.key: (a.count, a.self_device_time_total / 1e3) for a in ops}


def phase_main_f64(card, mols):
    '''Phase 4: the headline in float64 through run_pipeline, the
    captured program (the JAX x64 counts, exactly; its keep mask the
    host loop's), then K3 and its device-count entry on each pass.
    Returns (pass records, largest K3 disagreement off ties, the main
    path's launches by kernel, the captured record).'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash, qcp
    from tscode_tpu_torch.pipeline import (clash_survivors, embed_clash_all,
                                           inputs_from_numpy, run_pipeline)
    clash.KERNEL.reset_counts()
    qcp.KERNEL.reset_counts()
    n_poses, secs, n_ok, n_final, info = run_pipeline(
        *mols, device=DEV, dtype=torch.float64, return_masks=True)
    launches = main_launches('main path f64')
    print(f'[4 main f64] {n_poses} poses -> {n_ok} clash-ok -> {n_final} '
          f'final, best of 3 replays of the captured program {secs:.6f} s, '
          f'kernel launches (warm-up and capture) {launches}, clash by '
          f'regime {clash.launches_by_regime()} [{card}]')
    check(n_poses == N_POSES, f'{n_poses} poses, expected {N_POSES}')
    check((n_ok, n_final) == F64_COUNTS,
          f'f64 counts {(n_ok, n_final)} != {F64_COUNTS}')
    rec = captured_record(card, '4 main f64', mols, torch.float64, secs,
                          info, n_ok, n_final)

    inp = inputs_from_numpy(*mols, DEV, torch.float64)
    poses, ok = embed_clash_all(inp)
    check(bool(torch.isfinite(poses).all()), 'non-finite f64 poses')
    check(np.array_equal(ok.cpu().numpy(), info['clash_ok']),
          'f64 clash mask differs between two runs')
    P = poses.double()
    pl = inp.pairs.long()
    d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, dim=-1)
    near = torch.nonzero(((d2 - CLASH * CLASH).abs() < 1e-9).any(dim=1))
    for i in near.squeeze(1).tolist():
        print(f'[4 main f64] pose {i} within 1e-9 A^2 of the clash threshold')
    print(f'[4 main f64] {near.numel()} poses within 1e-9 A^2 of thr^2')

    _, hs = clash_survivors(inp)
    recs, kept, err = qcp_headline_passes(card, hs, 'float64')
    check(kept == F64_COUNTS[1], f'f64 pass-by-pass schedule keeps {kept}, '
          f'expected {F64_COUNTS[1]}')
    return recs, err, launches, rec


def phase_small_parity():
    '''The 2,592-pose grid on the card in f64 against the CPU run of the
    port (plain twins): identical masks and counts.'''
    import torch
    from tscode_tpu_torch.pipeline import build_workload, run_pipeline
    mols = build_workload(n_confs=6)
    gpu = run_pipeline(*mols, device=DEV, dtype=torch.float64,
                       return_masks=True)
    cpu = run_pipeline(*mols, device='cpu', dtype=torch.float64,
                       return_masks=True)
    check(gpu[2:4] == cpu[2:4] == (1362, 6),
          f'small grid counts gpu {gpu[2:4]} cpu {cpu[2:4]}, expected '
          f'(1362, 6)')
    check(np.array_equal(gpu[4]['clash_ok'], cpu[4]['clash_ok'])
          and np.array_equal(gpu[4]['keep'], cpu[4]['keep']),
          'small grid masks differ between card and CPU')
    print('[4 main f64] 2592-pose grid: card == CPU plain twins, '
          '1362 clash-ok -> 6 final')


def phase_main_f32(card, mols):
    '''Phase 5: the headline in float32 through run_pipeline, the
    captured program (counts in their brackets; the keep mask the host
    loop's), timed against the host-driven slice; then K1, K3 and K3's
    device-count entry against their plain twins at the slice's shapes,
    timed. Returns (the kernel records of the JSON line, the captured
    record).'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash, qcp
    from tscode_tpu_torch.ops.rmsd_prune import prune_conformers_rmsd_device
    from tscode_tpu_torch.pipeline import (clash_survivors, embed_clash_all,
                                           inputs_from_numpy, run_pipeline)
    clash.KERNEL.reset_counts()
    qcp.KERNEL.reset_counts()
    n_poses, secs, n_ok, n_final, info = run_pipeline(
        *mols, device=DEV, dtype=torch.float32, return_masks=True)
    launches = main_launches('main path f32')
    print(f'[5 main f32] {n_poses} poses -> {n_ok} clash-ok -> {n_final} '
          f'final, best of 3 replays of the captured program {secs:.6f} s, '
          f'{n_poses / secs:.0f} poses/s (the warm-up run: embed+clash '
          f'{info["embed_clash_s"]:.4f} s, prune {info["prune_s"]:.4f} s), '
          f'kernel launches (warm-up and capture) {launches}, clash by '
          f'regime {clash.launches_by_regime()} [{card}]')
    check(F32_OK[0] <= n_ok <= F32_OK[1],
          f'f32 clash-ok {n_ok} outside {F32_OK}')
    check(F32_FINAL[0] <= n_final <= F32_FINAL[1],
          f'f32 final {n_final} outside {F32_FINAL}')
    captured = captured_record(card, '5 main f32', mols, torch.float32,
                               secs, info, n_ok, n_final)

    # kernel vs plain at the slice's shapes: the grid's poses for the
    # clash, the clash survivors' heavy atoms for the prune
    inp = inputs_from_numpy(*mols, DEV, torch.float32)
    poses, _ = embed_clash_all(inp)
    pairs = inp.pairs
    got = clash.clash_ok(poses, pairs, CLASH)
    want = clash.clash_ok_plain(poses, pairs, CLASH)
    err_clash, n_tie = compare_bits(got, want,
                                    clash_ties(poses, pairs, CLASH),
                                    'clash f32 main grid')
    ms_clash = device_ms(lambda: clash.clash_ok(poses, pairs, CLASH))
    ms_clash_plain = cuda_ms(lambda: clash.clash_ok_plain(poses, pairs,
                                                          CLASH))
    head = dict(k1_yardstick(poses, pairs), ms=ms_clash,
                plain_ms=ms_clash_plain,
                regime=clash.clash_regime(pairs.shape[0], poses.shape[1],
                                          poses.element_size()),
                bound_ms=k1_bytes(poses, pairs) / HBM_BYTES_PER_S * 1e3,
                shape=list(poses.shape), P=int(pairs.shape[0]))
    print(f'[5 main f32] clash {tuple(poses.shape)}, P = {pairs.shape[0]}: '
          f'{k1_line(head)}; equal to plain ({n_tie} tie poses) [{card}]')

    _, hs = clash_survivors(inp)
    recs, kept, err_qcp = qcp_headline_passes(card, hs, 'float32')
    check(kept == n_final, f'f32 pass-by-pass schedule keeps {kept}, the '
          f'prune {n_final}')
    long_recs, e = qcp_long_chunks(card)
    err_qcp = max(err_qcp, e)

    def prune(engine):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = prune_conformers_rmsd_device(hs, THR, pair_kill=engine)
        return (time.perf_counter() - t0) * 1e3, keep

    def best_prune(engine):
        return min((prune(engine) for _ in range(3)), key=lambda r: r[0])

    ms_thread, keep_t = best_prune(qcp.qcp_kill_thread)
    ms_prune, keep_k = best_prune(qcp.qcp_kill)
    ms_prune2, _ = best_prune(qcp.qcp_kill)
    ms_thread2, _ = best_prune(qcp.qcp_kill_thread)
    ms_prune_plain, keep_p = prune(qcp.qcp_kill_plain)
    check(np.array_equal(keep_k, keep_t), 'f32 prune: the kernel and the '
          'thread-per-row kernel keep different rows')
    print(f'[5 main f32] whole prune of {hs.shape[0]} survivors, best of 3 '
          f'(host clock): kernel {ms_prune:.3f} / {ms_prune2:.3f} ms, '
          f'thread-per-row kernel {ms_thread:.3f} / {ms_thread2:.3f} ms, '
          f'plain {ms_prune_plain:.3f} ms, {int(keep_k.sum())} vs '
          f'{int(keep_p.sum())} kept [{card}]')
    first = recs[0]
    return [
        {'name': 'clash_ok', 'route': 'cuda',
         'source': 'tscode_tpu_torch/csrc/clash.cu',
         'replaces': 'tscode_tpu/ops/pallas/clash.py:119',
         'launches': launches['clash'], 'max_abs_err': err_clash,
         'ms': ms_clash, 'plain_ms': ms_clash_plain,
         'bound_ms': head['bound_ms'], 'bound_by': 'bytes',
         'library_ms': None, 'headline': head},
        {'name': 'qcp_kill', 'route': 'cuda',
         'source': 'tscode_tpu_torch/csrc/qcp_kill.cu',
         'replaces': 'tscode_tpu/ops/pallas/qcp.py:240',
         # the host loop's entry, held to none on the main path (which
         # runs the device-count entry); the route phases add theirs
         'launches': launches['qcp_kill'], 'max_abs_err': err_qcp,
         'ms': sum(first['ms']) / 2, 'plain_ms': first['plain_ms'],
         'bound_ms': first['bound_ms'], 'bound_by': first['bound_by'],
         'library_ms': None, 'passes': recs + long_recs},
        {'name': 'qcp_kill_dev', 'route': 'cuda',
         'source': 'tscode_tpu_torch/csrc/qcp_kill.cu',
         'replaces': 'tscode_tpu/ops/pallas/qcp.py:240',
         'launches': launches['qcp_kill_dev'], 'max_abs_err': 0,
         'ms': sum(first['dev_ms']) / 2, 'plain_ms': first['dev_plain_ms'],
         'bound_ms': first['bound_ms'], 'bound_by': first['bound_by'],
         'library_ms': None, 'pass': first['pass'], 'M': first['M'],
         'qcp_kill_ms': sum(first['ms']) / 2, 'blocks': first['dev_blocks'],
         'captured': {'float32': captured}},
    ]


class FireCalls:
    '''While open: the fire_minimize_batch calls (the name in optimizers
    and the names bending, scans and neb imported) on a non-empty CUDA
    batch, by whether the energy registers force-field terms
    (`fire_terms`), and the CPU calls; the graph runs (fire_run_graph)
    by the same split; the force field's FIRE kernel's launches (its
    counts set to 0 on entry). record() gives them.'''

    MODULES = ('optimizers', 'bending', 'scans', 'neb')

    def __enter__(self):
        import importlib
        from tscode_tpu_torch import optimizers
        from tscode_tpu_torch.ops.kernels import ff_fire
        self.calls = {'registered': 0, 'other': 0, 'cpu': 0}
        self.graph = {'registered': 0, 'other': 0}
        self.undo = []
        fire, graph = optimizers.fire_minimize_batch, optimizers.fire_run_graph

        def kind(energy_fn):
            return 'registered' if hasattr(energy_fn, 'fire_terms') \
                else 'other'

        def fire_spy(coords, energy_fn, *args, **kw):
            if not coords.is_cuda:
                self.calls['cpu'] += 1
            elif coords.shape[0]:
                self.calls[kind(energy_fn)] += 1
            return fire(coords, energy_fn, *args, **kw)

        def graph_spy(coords, energy_fn, *args):
            self.graph[kind(energy_fn)] += 1
            return graph(coords, energy_fn, *args)

        for name in self.MODULES:
            mod = importlib.import_module(f'tscode_tpu_torch.{name}')
            self.undo.append((mod, 'fire_minimize_batch', fire))
            mod.fire_minimize_batch = fire_spy
        self.undo.append((optimizers, 'fire_run_graph', graph))
        optimizers.fire_run_graph = graph_spy
        ff_fire.KERNEL.reset_counts()
        return self

    def __exit__(self, *exc):
        from tscode_tpu_torch.ops.kernels import ff_fire
        self.launches = ff_fire.KERNEL.launches
        for mod, name, fn in reversed(self.undo):
            setattr(mod, name, fn)

    def record(self):
        return {'ff_fire_launches': self.launches, 'calls': dict(self.calls),
                'graph_runs': dict(self.graph)}


# T1's launches in the CLI runs on the card, by phase (run_cli), and the
# phase that runs (timed_phase)
TFD_LAUNCHES = {}
# B1's launches on the main path, by phase
B1_LAUNCHES = {}
PHASE = [None]


# the force field's FIRE kernel's launches on the main path, by phase
FIRE_LAUNCHES = {}


def count_fire(phase, tag, rec, launched=True):
    '''check_fire, and the launches added to FIRE_LAUNCHES[phase];
    prints them. Returns the launches.'''
    n = check_fire(tag, rec, launched)
    FIRE_LAUNCHES[phase] = FIRE_LAUNCHES.get(phase, 0) + n
    print(f'[{phase} ff_fire] {tag}: {n} launches of the force field\'s '
          f'FIRE kernel for {rec["calls"]["registered"]} FIRE calls on the '
          f'card; graph runs {rec["graph_runs"]}')
    return n


def check_fire(tag, rec, launched=True):
    '''Every FIRE call of a registered energy on the card launched the
    force field's kernel once, none replayed a graph; with `launched`,
    at least one did. Returns the kernel's launches.'''
    n = rec['ff_fire_launches']
    check(n == rec['calls']['registered'] and
          rec['graph_runs']['registered'] == 0 and (n > 0 or not launched),
          f'{tag}: ff_fire launched {n} times for '
          f'{rec["calls"]["registered"]} FIRE calls of the force field\'s '
          f'energies, {rec["graph_runs"]["registered"]} graph runs of them '
          f'(expected one launch a call, no graph)')
    return n


class DimerCalls:
    '''While open: the saddle.dimer_saddle calls on a CUDA tensor, by
    whether the energy registers force-field terms (`fire_terms`), and
    the CPU calls; the captured graph runs of the dimer step
    (saddle.graph_loop) by the same split; D1's launches (its counts set
    to 0 on entry). record() gives them.'''

    def __enter__(self):
        from tscode_tpu_torch import saddle
        from tscode_tpu_torch.ops.kernels import dimer
        self.calls = {'registered': 0, 'other': 0, 'cpu': 0}
        self.graph = {'registered': 0, 'other': 0}
        self.kind = None
        self.real = (saddle.dimer_saddle, saddle.graph_loop)
        real_dimer, real_graph = self.real

        def dimer_spy(coords, energy_fn, *args, **kw):
            self.kind = 'registered' if hasattr(energy_fn, 'fire_terms') \
                else 'other'
            self.calls['cpu' if not coords.is_cuda else self.kind] += 1
            return real_dimer(coords, energy_fn, *args, **kw)

        def graph_spy(*args):
            self.graph[self.kind] += 1
            return real_graph(*args)

        saddle.dimer_saddle, saddle.graph_loop = dimer_spy, graph_spy
        dimer.KERNEL.reset_counts()
        return self

    def __exit__(self, *exc):
        from tscode_tpu_torch import saddle
        from tscode_tpu_torch.ops.kernels import dimer
        self.launches = dimer.KERNEL.launches
        saddle.dimer_saddle, saddle.graph_loop = self.real

    def record(self):
        return {'dimer_launches': self.launches, 'calls': dict(self.calls),
                'graph_runs': dict(self.graph)}


# D1's launches on the main path, by phase
DIMER_LAUNCHES = {}


def count_dimer(phase, tag, rec):
    '''Every dimer_saddle call of a registered energy on the card
    launched D1 once and replayed no graph, at least one did; the
    launches added to DIMER_LAUNCHES[phase] and printed. Returns them.'''
    n = rec['dimer_launches']
    check(n == rec['calls']['registered'] > 0 and
          rec['graph_runs']['registered'] == 0, f'{tag}: D1 launched {n} '
          f'times for {rec["calls"]["registered"]} dimer calls of the force '
          f'field on the card, {rec["graph_runs"]["registered"]} graph runs '
          f'of them (expected one launch a call, no graph)')
    DIMER_LAUNCHES[phase] = DIMER_LAUNCHES.get(phase, 0) + n
    print(f'[{phase} dimer] {tag}: {n} launches of D1 for '
          f'{rec["calls"]["registered"]} dimer calls on the card; graph '
          f'runs {rec["graph_runs"]}')
    return n


class NebCalls:
    '''While open: the neb.run_neb calls on the card, by whether the
    energy registers force-field terms (`fire_terms`), and the CPU calls;
    the captured graph runs of the band step (neb.graph_loop) by the
    same split; the idpp_interpolate calls on the card and the CPU; N1's
    and I1's launches (their counts set to 0 on entry). record() gives
    them.'''

    def __enter__(self):
        import torch
        from tscode_tpu_torch import neb
        from tscode_tpu_torch.ops.kernels import idpp
        from tscode_tpu_torch.ops.kernels import neb as kn
        self.calls = {'registered': 0, 'other': 0, 'cpu': 0}
        self.graph = {'registered': 0, 'other': 0}
        self.idpp = {'card': 0, 'cpu': 0}
        self.kind = None
        self.real = (neb.run_neb, neb.graph_loop, neb.idpp_interpolate)
        real_neb, real_graph, real_idpp = self.real

        def on_card(device):
            return torch.device(device).type == 'cuda'

        def neb_spy(*args, device, **kw):
            self.kind = 'registered' if hasattr(args[2], 'fire_terms') \
                else 'other'
            self.calls[self.kind if on_card(device) else 'cpu'] += 1
            return real_neb(*args, device=device, **kw)

        def graph_spy(*args):
            self.graph[self.kind] += 1
            return real_graph(*args)

        def idpp_spy(*args, device, **kw):
            self.idpp['card' if on_card(device) else 'cpu'] += 1
            return real_idpp(*args, device=device, **kw)

        neb.run_neb, neb.graph_loop, neb.idpp_interpolate = \
            neb_spy, graph_spy, idpp_spy
        for k in (kn.KERNEL, idpp.KERNEL, kn.V1_KERNEL, idpp.V1_KERNEL):
            k.reset_counts()
        return self

    def __exit__(self, *exc):
        from tscode_tpu_torch import neb
        from tscode_tpu_torch.ops.kernels import idpp
        from tscode_tpu_torch.ops.kernels import neb as kn
        self.launches = (kn.KERNEL.launches, idpp.KERNEL.launches,
                         kn.V1_KERNEL.launches + idpp.V1_KERNEL.launches)
        neb.run_neb, neb.graph_loop, neb.idpp_interpolate = self.real

    def record(self):
        return {'n1_launches': self.launches[0],
                'i1_launches': self.launches[1],
                'v1_launches': self.launches[2], 'calls': dict(self.calls),
                'graph_runs': dict(self.graph), 'idpp': dict(self.idpp)}


# N1's and I1's launches on the main path, by phase
NEB_LAUNCHES = {}
IDPP_LAUNCHES = {}


def count_neb(phase, tag, rec):
    '''Every run_neb call of a registered energy on the card launched N1
    once a phase (twice: the plain band and the climbing one) and
    replayed no graph, and every idpp_interpolate on the card launched
    I1 once; at least one of each; their first designs (the yardsticks)
    never; the launches added to NEB_LAUNCHES and IDPP_LAUNCHES[phase] and
    printed. Returns them.'''
    n1, i1 = rec['n1_launches'], rec['i1_launches']
    calls = rec['calls']['registered']
    check(n1 == 2 * calls > 0 and rec['graph_runs']['registered'] == 0 and
          i1 == rec['idpp']['card'] > 0 and rec['v1_launches'] == 0,
          f'{tag}: N1 launched {n1} times '
          f'for {calls} run_neb calls of the force field on the card, '
          f'{rec["graph_runs"]["registered"]} graph runs of them (expected '
          f'one launch a phase, no graph); I1 launched {i1} times for '
          f'{rec["idpp"]["card"]} IDPP bands on the card; the first designs '
          f'{rec["v1_launches"]} times')
    NEB_LAUNCHES[phase] = NEB_LAUNCHES.get(phase, 0) + n1
    IDPP_LAUNCHES[phase] = IDPP_LAUNCHES.get(phase, 0) + i1
    print(f'[{phase} neb] {tag}: {n1} launches of N1 for {calls} run_neb '
          f'calls on the card, {i1} of I1 for {rec["idpp"]["card"]} IDPP '
          f'bands; graph runs {rec["graph_runs"]}')
    return n1, i1


def run_cli(tmp, inp, dtype, device=None, seed=SEARCH_SEED, args=()):
    '''One run of the port's CLI on `inp` in `dtype`, its stdout kept in
    a file; the working directory is restored afterwards. The Embedder
    the CLI builds draws the searches' random numbers from
    np.random.RandomState(seed) (the CLI itself has no seed). The kernels'
    launch counts are set to 0 first (qcp.KERNEL.launches holds the
    run's K3 launches after it). Returns (report, frames (F, N, 3),
    clash launches per regime, seconds); the report also gets the clash
    launches per entry, K1 `clash_ok` and K2
    `compenetration_mask_kernel`, as `clash_entry_launches`, and what
    the compenetration stage gave K2's entry, one (poses, pair mask,
    thresh, max_clashes) per call, as `k2_calls`, and each library's
    launches per exported entry as `kernel_entries`, and the run's FIRE
    calls and the force field's FIRE kernel's launches (FireCalls) as
    `fire`, and T1's launches as `tfd_launches` (also added to
    TFD_LAUNCHES under the running phase, for a run on the card), and
    B1's screen launches (one a chunk) as `b1_launches` (B1_LAUNCHES
    likewise) and its write launches as `b1_write_launches`; the
    yardsticks (B1's and T1's first designs) must not run. `args` go to the
    CLI after the others (e.g. --trace DIR).'''
    import contextlib
    import os
    from tscode_tpu_torch import embedder
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.__main__ import main as cli
    from tscode_tpu_torch.ops.kernels import (block_screen, clash, ff_fire,
                                              qcp, tfd)
    device = device or DEV
    stamp = f'smoke_{device}_{dtype}'
    cwd = os.getcwd()
    k2_entry, k2_calls = embedder.compenetration_mask_kernel, []

    def k2_recorded(poses, pair_mask, thresh=1.5, max_clashes=0):
        k2_calls.append((poses, pair_mask, thresh, max_clashes))
        return k2_entry(poses, pair_mask, thresh, max_clashes)

    seeded = embedder.Embedder

    class Seeded(seeded):
        def __init__(self, *args, **kw):
            super().__init__(*args, rng=np.random.RandomState(seed), **kw)

    embedder.compenetration_mask_kernel = k2_recorded
    embedder.Embedder = Seeded
    clash.KERNEL.reset_counts()
    qcp.KERNEL.reset_counts()
    for k in (tfd.KERNEL, tfd.WARP_KERNEL, block_screen.KERNEL,
              block_screen.ROW_KERNEL):
        k.reset_counts()
    t0 = time.perf_counter()
    try:
        with open(os.path.join(tmp, f'{stamp}.out'), 'w') as out, \
                contextlib.redirect_stdout(out), FireCalls() as fire:
            rc = cli([inp, '--device', device, '--dtype', dtype, '-n',
                      stamp, *args])
    finally:
        os.chdir(cwd)
        embedder.compenetration_mask_kernel = k2_entry
        embedder.Embedder = seeded
    secs = time.perf_counter() - t0
    launches = clash.launches_by_regime()
    entries = clash.launches_by_entry()
    check(rc == 0, f'CLI on {inp} ({device}, {dtype}): exit code {rc}')
    with open(os.path.join(tmp, f'tscode_report_{stamp}.json')) as f:
        report = json.load(f)
    report['clash_entry_launches'] = entries
    report['k2_calls'] = k2_calls
    report['kernel_entries'] = {k.name: dict(k.entry_launches)
                                for k in (clash.KERNEL, qcp.KERNEL,
                                          ff_fire.KERNEL, tfd.KERNEL,
                                          block_screen.KERNEL)}
    check(tfd.WARP_KERNEL.launches == block_screen.ROW_KERNEL.launches == 0,
          f'CLI on {inp}: a yardstick kernel ran on the route (T1\'s '
          f'first design '
          f'{tfd.WARP_KERNEL.launches}, B1\'s '
          f'{block_screen.ROW_KERNEL.launches})')
    report['tfd_launches'] = tfd.KERNEL.launches
    b1_by = block_screen.KERNEL.wrapper_launches
    report['b1_launches'] = b1_by.get('block_screen', 0)
    report['b1_write_launches'] = b1_by.get('block_survivors', 0)
    for by_phase, n in ((TFD_LAUNCHES, tfd.KERNEL.launches),
                        (B1_LAUNCHES, report['b1_launches'])):
        if device != 'cpu' and n:
            by_phase[PHASE[0]] = by_phase.get(PHASE[0], 0) + n
    report['fire'] = fire.record()
    frames = read_xyz(os.path.join(
        tmp, f'tscode_unoptimized_{stamp}.xyz')).atomcoords
    return report, np.asarray(frames), launches, secs


def string_setup(inp, dtype, seed=SEARCH_SEED):
    '''The set-up of a string-route input through the port's Embedder
    (its log kept quiet; a search drawing from
    np.random.RandomState(seed)): (grid inputs on the card, spin angles,
    torsion quadruplets) in `dtype`.'''
    import contextlib
    import io
    import os
    from tscode_tpu_torch.graphs import get_quadruplets, get_sum_graph
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.embeds.common import inputs_from_numpy
    from tscode_tpu_torch.embeds.string import spin_angles
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            emb = Embedder(inp, stamp='smoke_setup', device=DEV, dtype=dtype,
                           rng=np.random.RandomState(seed))
        emb.logfile.close()
    finally:
        os.chdir(cwd)
    m1, m2 = emb.objects
    r1 = int(m1.reactive_indices[0])
    r2 = int(m2.reactive_indices[0]) + m1.n_atoms
    quads = get_quadruplets(get_sum_graph((m1.graph, m2.graph), [[r1, r2]]))
    return (inputs_from_numpy(m1, m2, DEV, dtype),
            spin_angles(emb.systematic_angles, dtype, DEV), quads)


def suite_input(name, tmp, n_confs):
    '''bench_suite's `name` input at n_confs conformers, written into
    tmp by the port's own writer; returns the input file's path.'''
    from tscode_tpu_torch.suite_inputs import config_files
    return config_files(name, tmp, n_confs)


def clash_offsets(poses, pairs):
    '''(B,) float64: each pose's smallest |d^2 - thr^2| over the listed
    pairs (exact float64 difference form).'''
    import torch
    pl = pairs.long()
    step = max(1, (1 << 25) // max(1, pl.shape[0]))   # ~0.8 GB a chunk
    out = []
    for lo in range(0, poses.shape[0], step):
        P = poses[lo:lo + step].double()
        d2 = torch.sum((P[:, pl[:, 0]] - P[:, pl[:, 1]]) ** 2, -1)
        out.append((d2 - CLASH * CLASH).abs().amin(dim=1))
    return torch.cat(out)


def novelty_ties(fps, novel):
    '''Rows of `fps` whose wrapped-L1 distance to an accepted (novel)
    fingerprint lies within 1e-9 degrees of the novelty threshold
    (listed), and how many lie within STRING_TFD_TIE (counted).'''
    import torch
    from tscode_tpu_torch.ops.tfd import wrapped_l1
    acc = fps[torch.as_tensor(novel, device=fps.device)]
    near, n_tie = [], 0
    for c0 in range(0, fps.shape[0], 1 << 16):
        s = (wrapped_l1(fps[c0:c0 + (1 << 16)], acc) - TFD_THRESH).abs() \
            .amin(dim=1)
        near += (c0 + torch.nonzero(s < 1e-9).squeeze(1)).tolist()
        n_tie += int((s < STRING_TFD_TIE).sum())
    return near, n_tie


def string_ties(tmp, inp):
    '''Threshold ties of the string route in float64 on the card: the
    grid poses with a cross pair within 1e-9 A^2 (listed) and within
    CLASH_TIE (counted) of the clash threshold, and the clash
    survivors with a wrapped-L1 distance to an accepted (novel)
    fingerprint within 1e-9 degrees (listed) and STRING_TFD_TIE
    (counted) of the novelty threshold.'''
    import torch
    from tscode_tpu_torch.embeds.string import bcast_tiles
    from tscode_tpu_torch.ops.tfd import (tfd_novelty_device,
                                          torsion_fingerprints)
    grid, angles, quads = string_setup(inp, torch.float64)
    near, n_tie, lo, fps = [], 0, 0, []
    for poses, ok in bcast_tiles(grid, angles, CLASH):
        off = clash_offsets(poses, grid.pairs)
        near += (lo + torch.nonzero(off < 1e-9).squeeze(1)).tolist()
        n_tie += int((off < CLASH_TIE).sum())
        lo += poses.shape[0]
        fps.append(torsion_fingerprints(poses[ok], quads))
    fps = torch.cat(fps)
    novel, ok = tfd_novelty_device(fps, thresh=TFD_THRESH)
    check(ok, 'string ties: novelty cache overflow')
    tfd_near, n_tfd_tie = novelty_ties(fps, novel)
    return near, n_tie, tfd_near, n_tfd_tie, int(novel.sum())


def phase_string_route(card):
    '''Phase 6: the production string route through the CLI, float64
    (exact reference counts) then float32 (brackets).'''
    import os
    import tempfile
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    launches = 0
    with tempfile.TemporaryDirectory(prefix='smoke_string_') as tmp:
        inp = suite_input('sn2_string', tmp, STRING_CONFS)
        counts = {}
        for dtype in ('float64', 'float32'):
            report, frames, regimes, secs = run_cli(tmp, inp, dtype)
            n_launch = sum(regimes.values())
            se = report['string_embed']
            counts[dtype] = (se['candidates'], se['clash_ok'], se['novel'],
                             report['final_structures'])
            launches += n_launch
            check(n_launch > 0, f'string route {dtype}: clash kernel not '
                  f'launched')
            check(se['tfd_lane'] == 'device', f'string route {dtype}: '
                  f'novelty lane {se["tfd_lane"]}, expected device')
            n_final = counts[dtype][3]
            check(frames.shape == (n_final, 11, 3)
                  and bool(np.isfinite(frames).all()),
                  f'string route {dtype}: .xyz holds {frames.shape}, '
                  f'expected ({n_final}, 11, 3) finite')
            stages = ', '.join(f'{s["stage"]} {s["seconds"]:.3f} s '
                               f'({s["structures_in"]} -> '
                               f'{s["structures_out"]})'
                               for s in report['stages'])
            print(f'[6 string {dtype}] {" -> ".join(map(str, counts[dtype]))}'
                  f' (candidates -> clash-ok -> novel -> final) in '
                  f'{secs:.3f} s, clash launches {regimes}, novelty lane '
                  f'{se["tfd_lane"]} {se["novelty_stats"]} [{card}]')
            print(f'[6 string {dtype}] stages: {stages}; report total '
                  f'{report["total_seconds"]} s [{card}]')
            print(f'[6 string {dtype}] embed split: sweep '
                  f'{se["sweep_s"]:.4f} s, compaction {se["compaction_s"]:.4f}'
                  f' s, novelty {se["novelty_s"]:.4f} s, pull '
                  f'{se["pull_s"]:.4f} s [{card}]')
        near, n_tie, tfd_near, n_tfd_tie, n_novel = string_ties(tmp, inp)

    # the listed ties, first LIST_MAX of each (spin steps of 10 degrees
    # put many fingerprint distances at exactly 10.0, which `<` rejects
    # alike on every lane)
    for i in near[:LIST_MAX]:
        print(f'[6 string float64] pose {i} within 1e-9 A^2 of the clash '
              f'threshold')
    for i in tfd_near[:LIST_MAX]:
        print(f'[6 string float64] survivor {i} within 1e-9 degrees of the '
              f'novelty threshold')
    print(f'[6 string float64] {len(near)} poses within 1e-9 A^2 of thr^2, '
          f'{len(tfd_near)} survivors within 1e-9 deg of {TFD_THRESH}; '
          f'{n_tie} poses within {CLASH_TIE} A^2, {n_tfd_tie} '
          f'survivors within {STRING_TFD_TIE} deg')
    check(counts['float64'] == STRING_F64,
          f'string route f64 counts {counts["float64"]} != {STRING_F64}')
    check(n_novel == STRING_F64[2], f'string ties: {n_novel} novel rows, '
          f'expected {STRING_F64[2]}')

    c32, c64 = counts['float32'], counts['float64']
    check(c32[0] == c64[0], f'f32 candidates {c32[0]} != {c64[0]}')
    check(abs(c32[1] - c64[1]) <= n_tie, f'f32 clash-ok {c32[1]} outside '
          f'{c64[1]} +- {n_tie} (poses within {CLASH_TIE} A^2)')
    for k, what in ((2, 'novel'), (3, 'final')):
        lo = round(c64[k] * (1 - STRING_F32_SLACK))
        hi = round(c64[k] * (1 + STRING_F32_SLACK))
        check(lo <= c32[k] <= hi, f'f32 {what} {c32[k]} outside {(lo, hi)}')
    print(f'[6 string float32] inside the brackets: clash-ok {c64[1]} +- '
          f'{n_tie}, novel and final within {STRING_F32_SLACK:.0%} of '
          f'{c64[2]} and {c64[3]}')
    return launches


def bracket(ref, slack):
    return round(ref * (1 - slack)), round(ref * (1 + slack))


def phase_large_route(card, keep):
    '''Phase 7, the CLI part: bench_suite's large_n_string (two C24H49Cl
    chains, 148-atom poses, P = 5,476 cross pairs, so K1's warp regime)
    at 16 conformers, float64 then float32, and the exact gate: the
    novelty replay of the float64 clash survivors on the card without
    the collinear quadruplet. The float64 run's output ensemble is
    copied into the directory `keep` as large_n_f64.xyz (phase 9).
    Returns the clash launches per regime.'''
    import os
    import shutil
    import tempfile
    import torch
    from tscode_tpu_torch.embeds.string import bcast_tiles
    from tscode_tpu_torch.ops.tfd import (tfd_novelty_device,
                                          torsion_end_sines,
                                          torsion_fingerprints)
    launches = {'thread': 0, 'warp': 0}
    counts = {}
    with tempfile.TemporaryDirectory(prefix='smoke_large_') as tmp:
        inp = suite_input('large_n_string', tmp, LARGE_CONFS)
        for dtype in ('float64', 'float32'):
            report, frames, regimes, secs = run_cli(tmp, inp, dtype)
            se = report['string_embed']
            counts[dtype] = c = (se['candidates'], se['clash_ok'],
                                 se['novel'], report['final_structures'])
            for k in launches:
                launches[k] += regimes[k]
            check(regimes['warp'] > 0, f'large_n {dtype}: the warp kernel '
                  f'was not launched ({regimes})')
            if dtype == 'float64':
                shutil.copy(os.path.join(
                    tmp, f'tscode_unoptimized_smoke_{DEV}_{dtype}.xyz'),
                    os.path.join(keep, 'large_n_f64.xyz'))
            check(frames.shape == (c[3], 148, 3)
                  and bool(np.isfinite(frames).all()),
                  f'large_n {dtype}: .xyz holds {frames.shape}, expected '
                  f'({c[3]}, 148, 3) finite')
            stages = ', '.join(f'{s["stage"]} {s["seconds"]:.3f} s'
                               for s in report['stages'])
            print(f'[7 large_n {dtype}] {" -> ".join(map(str, c))} '
                  f'(candidates -> clash-ok -> novel -> final) in {secs:.3f}'
                  f' s, clash launches {regimes}, novelty lane '
                  f'{se["tfd_lane"]} {se["novelty_stats"]}; {stages}; embed '
                  f'split: sweep {se["sweep_s"]:.4f} s, compaction '
                  f'{se["compaction_s"]:.4f} s, novelty {se["novelty_s"]:.4f}'
                  f' s [{card}]')

        # the float64 grid on the card: clash ties, survivors, and the
        # novelty replay without the collinear quadruplets
        grid, angles, quads = string_setup(inp, torch.float64)
        tiles = list(bcast_tiles(grid, angles, CLASH))
        poses = torch.cat([p for p, _ in tiles])
        ok = torch.cat([o for _, o in tiles])
        del tiles
    off = clash_offsets(poses, grid.pairs)
    near = torch.nonzero(off < 1e-9).squeeze(1).tolist()
    n_tie = int((off < CLASH_TIE).sum())
    survivors = poses[ok]
    fps = torsion_fingerprints(survivors, quads)
    col = (torsion_end_sines(survivors, quads) <= COLLINEAR_SINE) \
        .any(dim=0).cpu().numpy()
    check(np.asarray(quads)[col].tolist() == LARGE_COLLINEAR,
          f'large_n: collinear quadruplets {np.asarray(quads)[col].tolist()}'
          f', expected {LARGE_COLLINEAR}')
    fps = fps[:, torch.as_tensor(~col, device=fps.device)].contiguous()
    novel, lane_ok = tfd_novelty_device(fps, thresh=TFD_THRESH,
                                        cache_cap=fps.shape[0])
    check(lane_ok, 'large_n replay: the device novelty lane refused')
    tfd_near, n_tfd_tie = novelty_ties(fps, novel)
    n_novel = int(novel.sum())

    for i in near[:LIST_MAX]:
        print(f'[7 large_n float64] pose {i} within 1e-9 A^2 of the clash '
              f'threshold')
    for i in tfd_near[:LIST_MAX]:
        print(f'[7 large_n float64] survivor {i} within 1e-9 degrees of the '
              f'novelty threshold (collinear quadruplet dropped)')
    print(f'[7 large_n float64] {len(near)} poses within 1e-9 A^2 of thr^2, '
          f'{n_tie} within {CLASH_TIE} A^2; replay without the collinear '
          f'quadruplet {LARGE_COLLINEAR[0]} on the card: {n_novel} novel of '
          f'{fps.shape[0]} ({len(tfd_near)} survivors within 1e-9 deg of '
          f'{TFD_THRESH}, {n_tfd_tie} within {STRING_TFD_TIE} deg)')
    c64, c32 = counts['float64'], counts['float32']
    check(c64[0] == c32[0] == LARGE_F64[0], f'large_n candidates '
          f'{c64[0]}, {c32[0]} != {LARGE_F64[0]}')
    check(abs(c64[1] - LARGE_F64[1]) <= len(near), f'large_n f64 clash-ok '
          f'{c64[1]} != {LARGE_F64[1]} beyond {len(near)} poses within '
          f'1e-9 A^2 of thr^2')
    check(abs(c32[1] - c64[1]) <= n_tie, f'large_n f32 clash-ok {c32[1]} '
          f'outside {c64[1]} +- {n_tie}')
    for dtype, c in counts.items():
        for k, what in ((2, 'novel'), (3, 'final')):
            lo, hi = bracket(LARGE_F64[k], LARGE_SLACK)
            check(lo <= c[k] <= hi, f'large_n {dtype} {what} {c[k]} outside '
                  f'{(lo, hi)}')
    check(n_novel == LARGE_DROPPED_NOVEL, f'large_n replay without the '
          f'collinear quadruplet: {n_novel} novel, JAX x64 gives '
          f'{LARGE_DROPPED_NOVEL}')
    print(f'[7 large_n] gates held: candidates {LARGE_F64[0]}, f64 clash-ok '
          f'{c64[1]} (JAX {LARGE_F64[1]}), f32 clash-ok {c32[1]}, novel and '
          f'final within {LARGE_SLACK:.0%} of {LARGE_F64[2]} and '
          f'{LARGE_F64[3]}, replay {n_novel} == {LARGE_DROPPED_NOVEL}')
    return launches


def phase_large_grid(card):
    '''Phase 7, the grid part: large_n_string at 76 conformers (207,936
    poses of 148 atoms) through the string embed's tiles, float64 (the
    JAX x64 clash-ok count) and float32; K1 against its plain twin on
    the grid, both timed. Returns (clash launches per regime, the
    largest disagreement outside ties).'''
    import tempfile
    import torch
    from tscode_tpu_torch.embeds.string import bcast_tiles
    from tscode_tpu_torch.ops.kernels import clash
    launches = {'thread': 0, 'warp': 0}
    err = 0
    with tempfile.TemporaryDirectory(prefix='smoke_large76_') as tmp:
        inp = suite_input('large_n_string', tmp, LARGE_GRID_CONFS)
        setups = {dtype: string_setup(inp, dtype)
                  for dtype in (torch.float64, torch.float32)}
    for dtype, (grid, angles, _) in setups.items():
        name = str(dtype).split('.')[-1]
        clash.KERNEL.reset_counts()
        tiles = list(bcast_tiles(grid, angles, CLASH))
        regimes = clash.launches_by_regime()
        for k in launches:
            launches[k] += regimes[k]
        check(regimes['warp'] > 0, f'large_n grid {name}: the warp kernel '
              f'was not launched ({regimes})')
        poses = torch.cat([p for p, _ in tiles])
        ok = torch.cat([o for _, o in tiles])
        del tiles
        pairs = grid.pairs
        off = clash_offsets(poses, pairs)
        tie, n_near = off < CLASH_TIE, int((off < 1e-9).sum())
        n_ok = int(ok.sum())
        if dtype == torch.float64:
            check(abs(n_ok - LARGE_GRID_OK) <= n_near, f'large_n grid f64 '
                  f'clash-ok {n_ok} != {LARGE_GRID_OK} beyond {n_near} poses '
                  f'within 1e-9 A^2 of thr^2')

        def plain():
            return torch.cat([
                clash.clash_ok_plain(poses[i:i + LARGE_PLAIN_CHUNK], pairs,
                                     CLASH)
                for i in range(0, poses.shape[0], LARGE_PLAIN_CHUNK)])

        got = clash.clash_ok(poses, pairs, CLASH)
        check(torch.equal(got, ok), f'large_n grid {name}: two launches '
              f'differ')
        e, n_tie = compare_bits(got, plain(), tie, f'clash {name} large_n '
                                f'grid')
        err = max(err, e)
        ms = device_ms(lambda: clash.clash_ok(poses, pairs, CLASH))
        ms_plain = cuda_ms(plain, reps=2)
        bound = (poses.numel() * poses.element_size() + pairs.numel() * 4
                 + poses.shape[0]) / HBM_BYTES_PER_S * 1e3
        print(f'[7 large_n grid {name}] (c) {poses.shape[0]} poses x '
              f'{poses.shape[1]} atoms, P = {pairs.shape[0]}: K1 {ms:.4f} ms'
              f' (device), plain {ms_plain:.4f} ms (chunks of '
              f'{LARGE_PLAIN_CHUNK} poses), bound {bound:.4f} ms (bytes); '
              f'clash-ok {n_ok}, equal to plain off {n_tie} tie '
              f'poses, {n_near} within 1e-9 A^2; launches {regimes}, plan '
              f'{clash.warp_plan()} [{card}]')
        del poses, ok, got
        torch.cuda.empty_cache()
    return launches, err


def embedder_setup(inp, dtype):
    '''The port's Embedder set up on `inp` on the card in `dtype`, its
    log kept quiet; the working directory is restored afterwards.'''
    import contextlib
    import io
    import os
    from tscode_tpu_torch.embedder import Embedder
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            emb = Embedder(inp, stamp='smoke_setup', device=DEV, dtype=dtype)
        emb.logfile.close()
    finally:
        os.chdir(cwd)
    return emb


def clash_walked(poses, pairs):
    '''Pairs a clash screen with an early exit must evaluate on poses
    (B, N, 3): for each pose, its listed pairs up to and including its
    first with d^2 < thr^2 (float64), all of them when none is.'''
    import torch
    pl = pairs.long()
    P = pl.shape[0]
    step = max(1, (1 << 25) // max(1, P))
    n = 0
    for lo in range(0, poses.shape[0], step):
        X = poses[lo:lo + step].double()
        hit = torch.sum((X[:, pl[:, 0]] - X[:, pl[:, 1]]) ** 2, -1) < \
            CLASH * CLASH
        first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1, P)
        n += int(first.sum())
    return n


def lazy_keep(ok, gate):
    '''B1's dedup in its order, on the host (tests/torch_parity.py's
    copy): ok (rows, A) numpy bool, gate(b, t, t0) whether pose t of row
    b passes both gates against pose t0. In each row the smallest live
    angle is kept and every live angle after it is gated against it,
    dropping out on a hit. Returns (keep (rows, A) bool, the gate pairs
    evaluated: the data-dependent work of B1's bound).'''
    import numpy as np
    ok = np.asarray(ok, dtype=bool)
    keep = np.zeros_like(ok)
    n = 0
    for b in range(ok.shape[0]):
        live = [int(t) for t in np.flatnonzero(ok[b])]
        while live:
            t0 = live.pop(0)
            keep[b, t0] = True
            n += len(live)
            live = [t for t in live if not gate(b, t, t0)]
    return keep, n


def b1_bound(coords, rows, A, N, P, itemsize, M, clash_pairs, gate_pairs,
             passed, survivors=None):
    '''(bound ms, 'bytes' or 'operations', bytes, operations) of one B1
    call on `rows` block rows: each input read once (the conformers, the
    ids, the 18 geometry values and the grid's sine and cosine a row and
    molecule, the pair list) and each output written once: a keep byte a
    pose and the `survivors` kept poses (B1's function), or
    with survivors None every pose (B1's first design, the full write); the
    operations its data need: each pose built (~100 a molecule for its
    transform, 18 an atom), the clash pairs walked to each pose's first
    hit (9 each), the squared norm of each of the `passed` poses that
    passed the screen (6 N), the gate pairs the dedup evaluates (K3's ~24
    N + ~380 each, Newton's 30 steps).'''
    written = rows * A if survivors is None else survivors
    nbytes = sum(c.numel() for c in coords) * itemsize + rows * M * 4 + \
        rows * M * 18 * itemsize + A * M * 2 * itemsize + P * 8 + \
        written * N * 3 * itemsize + rows * A
    ops = rows * A * (100 * M + 18 * N) + 9 * clash_pairs + \
        6 * N * passed + (24 * N + 380) * gate_pairs
    name = 'float64' if itemsize == 8 else 'float32'
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops
            else 'operations', nbytes, ops)


def sweep_check(card, tag, blk, mols, angles):
    '''The block sweep of a cyclical route on its own, chunk by chunk as
    the route cuts it on the card (cyclical._card_chunk), over the block
    rows `blk` of the molecules `mols`, each chunk B1's two launches
    (ops/kernels/block_screen: the screen, then the write of the kept
    poses). In both types B1 is held against B1's first design (launch_row,
    every pose written) on the same card tensors: keep bits equal and the
    survivors that kernel's poses compacted by its keep mask, bit for bit
    (in float32 the block rows that differ are counted; in float64 none
    may). In float64 B1's first design is held against the plain twin on the
    same card tensors, run in the twin's own chunks
    (cyclical._auto_chunk) with its gate matrices: poses within
    B1_POSE_ATOL, keep bits equal off the tied blocks, which each pose's
    clash offset and each block's gate offsets (the smallest |rmsd - 1|
    and |maxdev - 2| over its pose pairs) mark; the clash pairs walked
    and the gate pairs B1 evaluates (lazy_keep on the twin's gates) are
    counted for its bounds; on the first chunk B1, B1's first design and
    the twin are timed (b1_chunk_timing), and K1 is held against the
    plain clash twin on the twin's first poses (K1 in device time, plain
    with its enqueue time). In float32 B1's keep mask, held against
    float64's off the tied blocks (hold_float32). Returns a dict: keep64,
    keep32 (Bb, A); per block tie_poses (its poses within CLASH_TIE of the
    clash threshold), tie_kept (those of them that float64 keeps),
    gate_tied (a pose pair within GATE_TIE of a dedup gate) and tied (a
    tie pose or a tied gate); near (the float64 poses within 1e-9 A^2 of
    the clash threshold); err (the largest disagreement: K1's bits, B1's
    poses in A); rec (K1's record); b1 (B1's record on the first chunk,
    with the whole sweep's chunks, launches, pairs and tied blocks).'''
    import torch
    from tscode_tpu_torch.embeds import cyclical as cyc
    from tscode_tpu_torch.ops.kernels import block_screen as b1
    from tscode_tpu_torch.ops.kernels import clash
    from tscode_tpu_torch.ops.rmsd_prune import pair_gate_matrices
    keeps, tie_poses, tie_kept, gate_tied = {}, [], [], []
    near, err, b1err, rec, b1rec = 0, 0, 0.0, None, None
    walked = {'clash': 0, 'gate': 0, 'passed': 0}
    differ, row_differ32, launches = 0, 0, {'screen': 0, 'write': 0}
    for dtype in (torch.float64, torch.float32):
        coords, grid, pairs, rows = cyc.sweep_inputs(
            blk, mols, angles, torch.device(DEV), dtype)
        half = b1.half_angles(grid)
        gates = (cyc.DEDUP_RMSD, cyc.DEDUP_MAXDEV)
        Bb, A = len(blk['ids']), grid.shape[0]
        N = sum(c.shape[1] for c in coords)
        itemsize = coords[0].element_size()
        chunk = cyc._card_chunk(Bb, A, len(coords), itemsize)
        parts = []
        for lo in range(0, Bb, chunk):
            hi = min(Bb, lo + chunk)
            confs, *geo = rows(lo, hi)
            geometry = cyc.block_geometry(*geo)
            b1.KERNEL.reset_counts()
            surv, keep = b1.block_screen(coords, confs, geometry, half,
                                         pairs, CLASH, gates)
            by = dict(b1.KERNEL.wrapper_launches)
            check(by.get('block_screen') == 1 and
                  by.get('block_survivors', 0) == int(surv.shape[0] > 0),
                  f'{tag} {dtype}: B1 launched {by} for a chunk (one '
                  f'screen, one write when anything survives)')
            launches['screen'] += 1
            launches['write'] += by.get('block_survivors', 0)
            parts.append(keep)
            conf, packed = b1.pack_rows(confs, geometry)
            poses = torch.empty((hi - lo, A, N, 3), dtype=dtype,
                                device=keep.device)
            row_keep = torch.empty_like(keep)
            b1.launch_row(coords, conf, packed, half, pairs, CLASH, gates,
                          poses, row_keep)
            same = (row_keep == keep).all(dim=1)
            same_surv = bool(same.all()) and torch.equal(surv,
                                                         poses[row_keep])
            if dtype == torch.float64:
                check(same_surv, f'{tag} f64 rows {lo}..: B1 differs from its '
                      f'first design: keep bits in {int((~same).sum())} block '
                      f'rows, survivors equal {same_surv}')
            else:
                row_differ32 += int((~same).sum())
                check(not bool(same.all()) or same_surv, f'{tag} f32 rows '
                      f'{lo}..: B1\'s survivors differ from the first '
                      f'design\'s '
                      f'kernel\'s poses under the same keep bits')
                del poses, row_keep
                continue
            sub = cyc._auto_chunk(hi - lo, A, N, itemsize)
            for s in range(0, hi - lo, sub):
                sl = slice(s, s + sub)
                pp, ok = cyc.block_poses(
                    coords, [c[sl] for c in confs], *(g[sl] for g in geometry),
                    grid, pairs, CLASH, clash=clash.clash_ok_plain)
                rmsd, maxdev = pair_gate_matrices(pp, N)
                similar = (rmsd < cyc.DEDUP_RMSD) & (maxdev < cyc.DEDUP_MAXDEV)
                twin_keep = cyc.greedy_keep_device(ok, similar)
                d = float((poses[sl] - pp).abs().max())
                b1err = max(b1err, d)
                check(d <= B1_POSE_ATOL, f'{tag} f64 rows {lo + s}..: B1\'s '
                      f'poses lie {d:.2e} A from the twin\'s')
                flat = pp.reshape(-1, N, 3)
                off = clash_offsets(flat, pairs)
                near += int((off < 1e-9).sum())
                gate = torch.minimum((rmsd - cyc.DEDUP_RMSD).abs(),
                                     (maxdev - cyc.DEDUP_MAXDEV).abs())
                tie_poses.append((off < CLASH_TIE).reshape(-1, A).sum(dim=1))
                tie_kept.append(((off < CLASH_TIE).reshape(-1, A)
                                 & twin_keep).sum(dim=1))
                gate_tied.append(gate.amin(dim=(1, 2)) < GATE_TIE)
                tied = (tie_poses[-1] > 0) | gate_tied[-1]
                other = (keep[sl] != twin_keep).any(dim=1)
                differ += int(other.sum())
                check(not bool((other & ~tied).any()), f'{tag} f64 rows '
                      f'{lo + s}..: B1\'s keep bits differ from the twin\'s '
                      f'in {int((other & ~tied).sum())} untied blocks')
                sim = similar.cpu().numpy()
                _, n = lazy_keep(ok.cpu().numpy(),
                                 lambda b, t, t0: sim[b, t, t0])
                walked['gate'] += n
                walked['passed'] += int(ok.sum())
                walked['clash'] += clash_walked(flat, pairs)
                if lo == 0 and s == 0:
                    rec = k1_chunk_record(card, tag, flat, ok.reshape(-1),
                                          off, pairs, N)
                    err = max(err, rec['err'])
                del pp, ok, rmsd, maxdev, similar, gate
            if lo == 0:
                b1rec = b1_chunk_timing(coords, confs, geo, geometry, grid,
                                        pairs, poses, keep, surv, sub)
                first_walked, chunk64 = dict(walked), chunk
            del poses, row_keep
        keeps[dtype] = torch.cat(parts).cpu().numpy()
        del parts
    tie_poses = torch.cat(tie_poses).cpu().numpy()
    tie_kept = torch.cat(tie_kept).cpu().numpy()
    gate_tied = torch.cat(gate_tied).cpu().numpy()
    tied = (tie_poses > 0) | gate_tied
    first = b1rec['rows']
    args = (coords, first, A, N, int(pairs.shape[0]), 8, len(coords),
            first_walked['clash'], first_walked['gate'],
            first_walked['passed'])
    bound, by, nbytes, ops = b1_bound(*args, survivors=b1rec['survivors'])
    row_bound, row_by, row_bytes, _ = b1_bound(*args)
    b1rec.update(
        blocks=Bb, A=A, N=N, P=int(pairs.shape[0]), chunk_rows=chunk64,
        chunks=-(-Bb // chunk64), bound_ms=bound, bound_by=by, bytes=nbytes,
        operations=ops, row_bound_ms=row_bound, row_bound_by=row_by,
        row_bytes=row_bytes, clash_pairs=first_walked['clash'],
        gate_pairs=first_walked['gate'], sweep_gate_pairs=walked['gate'],
        gate_matrix_pairs=Bb * A * A, b1_twin_differ=differ,
        f32_rows_differ_from_first_design=row_differ32,
        sweep_launches=launches,
        tied_blocks=int(tied.sum()), max_pose_diff_A=b1err,
        plan=b1.launch_plan(A, N, int(pairs.shape[0]), 8, M=len(coords)),
        row_plan=b1.row_launch_plan(A, N, int(pairs.shape[0]), 8))
    forms = ', '.join(f'{k} {v:.4f}' for k, v in b1rec['forms'].items())
    print(f'[{tag}] B1, float64, first chunk of {first} block rows x {A} '
          f'angles, N = {N}, P = {b1rec["P"]}, {b1rec["survivors"]} '
          f'survivors: {b1rec["ms"]:.4f} ms device (screen '
          f'{b1rec["screen_ms"]:.4f} in runs {b1rec["screen_ms_runs"]}, '
          f'write {b1rec["write_ms"]:.4f}; wrapper with its host read '
          f'{b1rec["wrapper_ms"]:.4f}); B1\'s first design '
          f'{b1rec["row_ms"]:.4f} ms in runs {b1rec["row_ms_runs"]} (its '
          f'compaction, nonzero and gather, {b1rec["row_compaction_ms"]:.4f} '
          f'ms more); screen forms {forms}; twin {b1rec["plain_ms"]:.2f} '
          f'ms over its {b1rec["twin_chunks"]} chunks; bound {bound:.4f} ms '
          f'({by}; {nbytes} bytes, {ops} operations), the first design\'s '
          f'full-write '
          f'bound {row_bound:.4f} ms ({row_by}; {row_bytes} bytes); plan '
          f'{b1rec["plan"]}; the sweep in {b1rec["chunks"]} chunks of '
          f'{chunk64} ({launches["screen"]} screens, {launches["write"]} '
          f'writes over both types): keep bits and survivors equal to the '
          f'first design\'s in float64 ({row_differ32} block rows differ in '
          f'float32), equal to the twin\'s off {int(tied.sum())} tied '
          f'blocks ({differ} blocks differ, all tied), poses within '
          f'{b1err:.2e} A; B1 evaluated {walked["gate"]} gate pairs against '
          f'{Bb * A * A} in the twin\'s matrices, {walked["clash"]} clash '
          f'pairs [{card}]')
    return {'keep64': keeps[torch.float64], 'keep32': keeps[torch.float32],
            'tie_poses': tie_poses, 'tie_kept': tie_kept,
            'gate_tied': gate_tied, 'tied': tied, 'near': near, 'err': err,
            'rec': rec, 'b1': b1rec}


def k1_chunk_record(card, tag, flat, plain_ok, off, pairs, N):
    '''K1 held against the plain clash twin's bits `plain_ok` on the
    poses `flat` (the twin's first chunk of a sweep), off the poses within
    CLASH_TIE of the threshold, and timed (device time; plain with its
    enqueue time), with the v1 kernel and the ring as yardsticks.'''
    from tscode_tpu_torch.ops.kernels import clash
    e, n_tie = compare_bits(clash.clash_ok(flat, pairs, CLASH), plain_ok,
                            off < CLASH_TIE, f'clash f64 {tag} chunk')
    clash.KERNEL.reset_counts()
    ms = device_ms(lambda: clash.clash_ok(flat, pairs, CLASH))
    regime = max(clash.launches_by_regime().items(),
                 key=lambda kv: kv[1])[0]
    ms_plain = cuda_ms(lambda: clash.clash_ok_plain(flat, pairs, CLASH),
                       reps=2)
    rec = {'poses': flat.shape[0], 'N': N, 'P': int(pairs.shape[0]),
           'regime': regime, 'ms': ms, 'plain_ms': ms_plain,
           'bound_ms': k1_bytes(flat, pairs) / HBM_BYTES_PER_S * 1e3,
           'err': e, **k1_yardstick(flat.contiguous(), pairs)}
    print(f'[{tag}] K1 on the twin\'s first chunk, float64: {rec["poses"]} '
          f'poses of {N} atoms, P = {pairs.shape[0]}: {k1_line(rec)}; clash '
          f'bits equal to plain off {n_tie} tie poses [{card}]')
    return rec


def b1_chunk_timing(coords, confs, geo, geometry, grid, pairs, poses, keep,
                    surv, sub):
    '''B1 on one chunk, float64: its screen alone on packed inputs in
    device time, interleaved with B1's first design (screen, first
    design, screen, first design; `poses` and `keep` that kernel's
    output, `surv` B1's survivors), its write alone, the screen in each
    form of its store (launch_plan: 'smem', 'scratch') and with the
    other clash screen
    ('warp_clash': the warp's where the plan has a lane's), each output
    held bit for bit, the wrapper as the route calls it (packing, both
    launches and the host read of the survivor count; CUDA events,
    enqueue time included), the first design's compaction (a nonzero and
    a gather of its poses, the route's DeviceSurvivors.add before), and
    the twin (cyclical.block_screen_plain) in one pass over the chunk in
    its own chunks of `sub` rows (CUDA events, enqueue time
    included).'''
    import torch
    from tscode_tpu_torch.embeds import cyclical as cyc
    from tscode_tpu_torch.ops.kernels import block_screen as b1
    half = b1.half_angles(grid)
    gates = (cyc.DEDUP_RMSD, cyc.DEDUP_MAXDEV)
    conf, packed = b1.pack_rows(confs, geometry)
    rows, A = keep.shape
    N = poses.shape[2]
    P, itemsize = int(pairs.shape[0]), poses.element_size()
    shape = (A, N, P, itemsize)
    plan = b1.launch_plan(*shape, M=len(coords))
    forms = {'scratch': {'form': 'scratch'},
             'warp_clash': {'warp_clash': not plan['warp_clash']}}
    if plan['form'] == 'smem':
        forms.update(smem={'form': 'smem'})
    forms = {name: b1.launch_plan(*shape, M=len(coords), **kw)
             for name, kw in forms.items()}
    kept, counts = torch.empty_like(keep), torch.empty(
        rows, dtype=torch.int32, device=keep.device)
    row_poses, row_keep = torch.empty_like(poses), torch.empty_like(keep)
    counted = keep.sum(dim=1, dtype=torch.int32)
    offsets = torch.cumsum(counted, 0) - counted
    out = torch.empty_like(surv)

    def screen(p=plan):
        b1.launch(coords, conf, packed, half, pairs, CLASH, gates, kept,
                  counts, p)

    def row():
        b1.launch_row(coords, conf, packed, half, pairs, CLASH, gates,
                      row_poses, row_keep)

    runs = {'screen': [], 'row': []}
    for _ in range(2):
        runs['screen'].append(device_ms(screen, reps=5))
        runs['row'].append(device_ms(row, reps=5))
    write_ms = device_ms(lambda: b1.launch_write(
        coords, conf, packed, half, keep, offsets, out), reps=5)
    check(torch.equal(kept, keep) and torch.equal(counts, counted) and
          torch.equal(out, surv) and torch.equal(row_keep, keep) and
          torch.equal(row_poses, poses), 'B1 or B1\'s first design on packed '
          'inputs gave other bits than the route\'s call')
    form_ms = {}
    for name, p in forms.items():
        kept.zero_()
        form_ms[name] = device_ms(lambda: screen(p), reps=5)
        check(torch.equal(kept, keep) and torch.equal(counts, counted),
              f'B1\'s screen in the {name} form gave other bits')
    del row_poses
    wrapper_ms = cuda_ms(lambda: b1.block_screen(
        coords, confs, geometry, half, pairs, CLASH, gates), reps=5)
    flat, mask = poses.reshape(-1, N, 3), keep.reshape(-1)
    compaction_ms = cuda_ms(
        lambda: flat[torch.nonzero(mask).squeeze(1)], reps=5)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in range(0, rows, sub):
        cyc.block_screen_plain(coords, [c[s:s + sub] for c in confs],
                               [g[s:s + sub] for g in geo], grid, pairs,
                               CLASH)
    stop.record()
    stop.synchronize()
    screen_ms = sum(runs['screen']) / 2
    return {'rows': rows, 'survivors': int(surv.shape[0]),
            'ms': screen_ms + write_ms, 'screen_ms': screen_ms,
            'screen_ms_runs': runs['screen'], 'write_ms': write_ms,
            'row_ms': sum(runs['row']) / 2, 'row_ms_runs': runs['row'],
            'row_compaction_ms': compaction_ms, 'forms': form_ms,
            'wrapper_ms': wrapper_ms, 'plain_ms': start.elapsed_time(stop),
            'twin_chunks': -(-rows // sub), 'library_ms': None}


def hold_float32(tag, sweep):
    '''The float32 gate of a block sweep (sweep_check's dict): in every
    block without a near tie the float32 run keeps the float64 run's
    angles, and at most 5% of the blocks hold a near tie. Prints the
    tally; returns the blocks that keep other angles (Bb,) bool.'''
    keep64, keep32, tied = sweep['keep64'], sweep['keep32'], sweep['tied']
    differ = (keep64 != keep32).any(axis=1)
    print(f'[{tag}] sweep on its own: {int(keep64.sum())} float64 and '
          f'{int(keep32.sum())} float32 survivors; {int(tied.sum())} of '
          f'{len(tied)} blocks ({tied.mean():.2%}) hold a near tie: '
          f'{int((sweep["tie_poses"] > 0).sum())} a pose within {CLASH_TIE} '
          f'A^2 of the clash threshold ({int(sweep["tie_poses"].sum())} such '
          f'poses, {int(sweep["tie_kept"].sum())} of them survivors), {int(sweep["gate_tied"].sum())} a pose pair within '
          f'{GATE_TIE} A of a dedup gate; {sweep["near"]} poses within 1e-9 '
          f'A^2 of the clash threshold; {int(differ.sum())} blocks keep '
          f'other angles in float32, {int((differ & ~tied).sum())} of them '
          f'untied')
    check(not bool((differ & ~tied).any()), f'{tag} f32: blocks without '
          f'a near tie keep other angles than in f64')
    check(tied.mean() <= 0.05, f'{tag}: {tied.mean():.2%} of the blocks '
          f'hold a near tie, so the float32 gate holds under 95% of them')
    return differ


def float32_slack(sweep, differ, rows=slice(None)):
    '''How far a float32 count may lie from the float64 one over the
    block rows `rows`: (after the sweep, after the later stages). The
    sweep may differ by the angles of the blocks that keep other angles
    in float32 (all of them tied, hold_float32); a later stage also by
    the survivors within CLASH_TIE of the clash threshold, which the
    compenetration stage screens again.'''
    A = sweep['keep64'].shape[1]
    swept = A * int(differ[rows].sum())
    return swept, swept + int(sweep['tie_kept'][rows].sum())


def embed_split(tag, dtype, report, key, card):
    '''Print the sweep's split of a cyclical-family CLI run from its
    report (on the card B1's chunks are all screen: the dedup reads 0.0);
    checks that B1 ran, once a chunk, and K1 did not. Returns the
    sweep's seconds (screen and dedup).'''
    ce = report[key]
    sweep = ce['screen_s'] + ce['dedup_s']
    gen = next(s['seconds'] for s in report['stages']
               if s['stage'] == 'generate_candidates')
    adjust = f', adjust {ce["adjust_s"]:.4f} s ({ce["adjust_near_ties"]} ' \
        f'near ties)' if 'adjust_s' in ce else ''
    print(f'[{tag} {dtype}] sweep split: blocks {ce["blocks_s"]:.4f} s'
          f'{adjust}, screen {ce["screen_s"]:.4f} s, dedup '
          f'{ce["dedup_s"]:.4f} s ({ce["sweep_kernel"]}), assemble '
          f'{ce["assemble_s"]:.4f} s '
          f'({ce.get("union_blocks", ce.get("blocks"))} blocks in '
          f'{ce["chunks"]} chunks of {ce["chunk_rows"]}, B1 screened '
          f'{report["b1_launches"]} and wrote {report["b1_write_launches"]} '
          f'times); the sweep is {sweep:.4f} s, '
          f'{sweep / gen:.1%} of generate_candidates [{card}]')
    check_b1_route(f'{tag} {dtype}', report, ce)
    return sweep


def check_b1_route(tag, report, ce):
    '''A block sweep on the card: B1's screen once a chunk (of each
    shard) and its write once a chunk with survivors, the split says so,
    no K1 launch on the sweep.'''
    check(ce['sweep_kernel'] == 'B1' and ce['dedup_s'] == 0.0 and
          report['b1_launches'] == ce['chunks'] > 0 and
          0 < report['b1_write_launches'] <= ce['chunks'] and
          report['clash_entry_launches']['clash_ok'] == 0,
          f'{tag}: sweep {ce["sweep_kernel"]}, B1 screened '
          f'{report["b1_launches"]} and wrote {report["b1_write_launches"]} '
          f'times for {ce["chunks"]} chunks, K1 '
          f'{report["clash_entry_launches"]["clash_ok"]} times, dedup '
          f'{ce["dedup_s"]} s')


def cli_stages(report):
    return ', '.join(f'{s["stage"]} {s["seconds"]:.3f} s '
                     f'({s["structures_in"]} -> {s["structures_out"]})'
                     for s in report['stages'])


def phase_cyclical_route(card, tmp):
    '''Phase 8: the rigid cyclical route through the CLI on bench_suite's
    da_cyclical_xl at CYC_CONFS conformers (the block sweep, one B1
    launch a chunk, the similarity prunes, the .xyz), float64 (the JAX
    x64 counts exactly) then float32 (brackets from the float64 near
    ties), and the sweep checked on its own (sweep_check: B1 against its
    twin). The inputs and the float64 output stay in `tmp`. Returns (K1
    launches, largest K1 disagreement, K1's record on the twin's first
    chunk, path of the float64 output ensemble, B1's record).'''
    import os
    import torch
    from tscode_tpu_torch.embeds import cyclical as cyc
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    inp = suite_input('da_cyclical_xl', tmp, CYC_CONFS)
    counts, launches = {}, 0
    for dtype in ('float64', 'float32'):
        report, frames, regimes, secs = run_cli(tmp, inp, dtype)
        ce = report['cyclical_embed']
        counts[dtype] = c = (ce['candidates'], ce['survivors'],
                             report['final_structures'])
        launches += sum(regimes.values())
        check(sum(regimes.values()) == 0 and report['b1_launches'] ==
              ce['chunks'] == 1, f'cyclical {dtype}: K1 launches {regimes}, '
              f'B1 {report["b1_launches"]}, expected one B1 launch for the '
              f'one chunk, no K1 ({ce["chunks"]} chunks)')
        check(frames.shape == (min(c[2], 10000), 11, 3)
              and bool(np.isfinite(frames).all()),
              f'cyclical {dtype}: .xyz holds {frames.shape}, expected '
              f'({min(c[2], 10000)}, 11, 3) finite')
        print(f'[8 cyclical {dtype}] {" -> ".join(map(str, c))} '
              f'(candidates -> embedded -> final) in {secs:.3f} s, B1 '
              f'launches {report["b1_launches"]}, K1 {regimes}; stages: '
              f'{cli_stages(report)}; report total '
              f'{report["total_seconds"]} s [{card}]')
        embed_split('8 cyclical', dtype, report, 'cyclical_embed', card)
    emb = embedder_setup(inp, torch.float64)
    blk = cyc.bimol_rigid_blocks(*emb.objects, 5, emb.pairing_ok_fn())
    sweep = sweep_check(card, '8 cyclical', blk, emb.objects,
                        emb.systematic_angles)
    differ = hold_float32('8 cyclical', sweep)
    keep64, keep32 = sweep['keep64'], sweep['keep32']
    slack = float32_slack(sweep, differ)
    c64, c32 = counts['float64'], counts['float32']
    check(c64 == CYC_F64, f'cyclical f64 counts {c64} != {CYC_F64}')
    check(int(keep64.sum()) == c64[1] and int(keep32.sum()) == c32[1],
          f'cyclical: the sweep on its own keeps {int(keep64.sum())} / '
          f'{int(keep32.sum())}, the route {c64[1]} / {c32[1]}')
    check(c32[0] == c64[0], f'cyclical f32 candidates {c32[0]} != {c64[0]}')
    for k, what in ((1, 'embedded'), (2, 'final')):
        check(abs(c32[k] - c64[k]) <= slack[k - 1], f'cyclical f32 {what} '
              f'{c32[k]} outside {c64[k]} +- {slack[k - 1]}')
    print(f'[8 cyclical] gates held: float64 {" -> ".join(map(str, c64))} '
          f'(JAX x64), float32 {" -> ".join(map(str, c32))} within +- '
          f'{slack[0]} (embedded: the angles of the blocks that differ) and '
          f'+- {slack[1]} (final: and the clash-tie survivors)')
    return launches, sweep['err'], sweep['rec'], os.path.join(
        tmp, f'tscode_unoptimized_smoke_{DEV}_float64.xyz'), sweep['b1']


def refine_pool(path):
    '''The RMSD stage's pool of a REFINE run on the ensemble `path`: the
    structures that pass the compenetration rule and, up to 500
    structures, the MOI prune. Returns (structures (n, N, 3) numpy,
    heavy-atom mask (N,), MOI pairs within MOI_TIE of the MOI
    threshold, or 0 when that prune does not run).'''
    import torch
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.ops.clash import count_intra_clashes_np
    from tscode_tpu_torch.ops.linalg import get_inertia_moments
    from tscode_tpu_torch.ops.moi import prune_by_moment_of_inertia
    from tscode_tpu_torch.pt import masses_of
    ens = read_xyz(path)
    s, atomnos = np.asarray(ens.atomcoords), np.asarray(ens.atomnos)
    heavy = atomnos != 1
    s = s[count_intra_clashes_np(s, thresh=0.5) == 0]
    moi_marked = 0
    if len(s) <= 500:
        m = get_inertia_moments(
            torch.as_tensor(s[:, heavy], dtype=torch.float64, device=DEV),
            torch.as_tensor(masses_of(atomnos[heavy]), dtype=torch.float64,
                            device=DEV))
        rel = (m[:, None] - m[None]).abs() / m[:, None]
        near = ((rel - MOI_THRESH).abs() < MOI_TIE).any(dim=-1)
        moi_marked = int(torch.triu(near | near.T, diagonal=1).sum())
        s = prune_by_moment_of_inertia(s, atomnos, device=DEV)[0]
    return s, heavy, moi_marked


def refine_k3_passes(card, pool, heavy, what):
    '''K3 on each pass of the RMSD stage that REFINE runs on `pool`
    (refine_pool's structures), heavy atoms, float64 on the card; each
    pass through qcp_pass (kill bits against plain and the
    thread-per-row kernel, device ms; plain timed at the first pass),
    and the pass's pairs whose float64 rmsd lies within
    QCP_TIE['float32'] of the threshold or whose max deviation lies
    within it of twice the threshold: the pairs a float32 run may decide
    otherwise. Returns (records, kept, largest disagreement, marked
    pairs, rows with a marked pair).'''
    import torch
    from tscode_tpu_torch.ops.kernels.qcp import pass_pairs
    from tscode_tpu_torch.ops.linalg import rmsd_and_max
    hs = torch.as_tensor(pool[:, heavy], dtype=torch.float64,
                         device=DEV).contiguous()
    passes, kept = schedule_passes(hs)
    recs, err, marked, rows = [], 0, 0, 0
    tol = QCP_TIE['float32']
    for i, (k, act, end) in enumerate(passes):
        rec, e = qcp_pass(card, hs, act, end, 'float64', f'{what} k={k}',
                          i == 0)
        recs.append(rec)
        err = max(err, e)
        pos = torch.arange(act.numel(), device=hs.device)
        p, q = pass_pairs(end.long(), pos)
        row_hit = torch.zeros(act.numel(), dtype=torch.bool, device=hs.device)
        for lo in range(0, p.numel(), 1 << 18):
            pp, qq = p[lo:lo + (1 << 18)], q[lo:lo + (1 << 18)]
            rmsd, maxdev = rmsd_and_max(hs[act[pp]], hs[act[qq]])
            tie = ((rmsd - THR).abs() < tol) | \
                ((maxdev - 2 * THR).abs() < tol)
            marked += int(tie.sum())
            row_hit[pp[tie]] = True
        rows += int(row_hit.sum())
    return recs, kept, err, marked, rows


def refine_counts(report):
    '''(structures in, after compenetration, after the RMSD prune,
    final) of a refine run.'''
    st = {s['stage']: s for s in report['stages']}
    sim = {r['stage']: r for r in report['similarity']}
    return (st['generate_candidates']['structures_in'],
            st['compenetration_refining']['structures_out'],
            sim['rmsd']['structures_out'], report['final_structures'])


def phase_refine_route(card, xl_path, large_path):
    '''Phase 9: REFINE through the CLI. (a) On phase 8's float64 output
    (10,000 frames of 11 atoms, 4 heavy): float64 gives the JAX x64
    counts of the same chain exactly. (b) On phase 7's float64
    large_n_string output (148 atoms, 50 heavy): the card's float64
    output equals the port's CPU run of the same file. For both, K3's
    passes on the RMSD stage's pool with device times, and the float32
    run (the CLI's default dtype on the card) held against the float64
    run: with no marked pair (refine_k3_passes, refine_pool) the same
    frames, else the counts after the RMSD prune and at the end within
    the marked rows and pairs of float64's. Returns (K3 launches, pass
    records, largest disagreement).'''
    import tempfile
    from tscode_tpu_torch.ops.kernels import qcp
    from tscode_tpu_torch.suite_inputs import refine_input
    launches, recs, err = 0, [], 0
    for what, path in (('refine xl', xl_path), ('refine large_n', large_path)):
        with tempfile.TemporaryDirectory(prefix='smoke_refine_') as tmp:
            inp = refine_input(path, tmp)
            runs = {}
            for dtype in ('float64', 'float32'):
                report, frames, _, secs = run_cli(tmp, inp, dtype)
                n_k3 = qcp.KERNEL.launches
                launches += n_k3
                check(n_k3 > 0, f'{what} {dtype}: K3 was not launched')
                counts = refine_counts(report)
                check(frames.shape[0] == counts[3] and
                      bool(np.isfinite(frames).all()), f'{what} {dtype}: '
                      f'.xyz holds {frames.shape}, expected {counts[3]} '
                      f'finite frames')
                print(f'[9 {what} {dtype}] {" -> ".join(map(str, counts))} '
                      f'(structures -> after compenetration -> after the '
                      f'RMSD prune -> final) in {secs:.3f} s, K3 launches '
                      f'{n_k3}; stages: {cli_stages(report)}; prunes: '
                      + ', '.join(f'{r["stage"]} {r["structures_in"]} -> '
                                  f'{r["structures_out"]} {r["seconds"]:.4f} s'
                                  for r in report['similarity'])
                      + f' [{card}]')
                runs[dtype] = (counts, frames)
            counts, frames = runs['float64']
            if what == 'refine xl':
                check(counts[:2] + counts[3:] == REFINE_XL_F64, f'{what}: '
                      f'counts {counts} != {REFINE_XL_F64} (JAX x64)')
            else:
                cpu_report, cpu_frames, _, cpu_secs = run_cli(
                    tmp, inp, 'float64', device='cpu')
                check(refine_counts(cpu_report) == counts and
                      np.array_equal(cpu_frames, frames), f'{what}: the card '
                      f'keeps {counts}, the CPU run '
                      f'{refine_counts(cpu_report)}, or other frames')
                print(f'[9 {what}] the CPU run of the port ({cpu_secs:.3f} s)'
                      f' keeps the same {counts[3]} frames')
            pool, heavy, moi_marked = refine_pool(path)
            pass_recs, kept, e, marked, rows = refine_k3_passes(
                card, pool, heavy, what)
            check(kept == counts[2], f'{what}: the pass by pass replay '
                  f'keeps {kept}, the RMSD stage {counts[2]}')
            recs += pass_recs
            err = max(err, e)
            print(f'[9 {what}] K3 passes on the RMSD stage\'s pool (N = '
                  f'{pass_recs[0]["N"]}): ' + ', '.join(
                      f'{r["pass"].split()[-1]} M={r["M"]} '
                      f'{sum(r["ms"]) / 2:.4f} ms' for r in pass_recs)
                  + f'; device ms in all {sum(sum(r["ms"]) / 2 for r in pass_recs):.4f} [{card}]')
            c32, f32 = runs['float32']
            same = f32.shape == frames.shape and np.array_equal(f32, frames)
            slack = rows + moi_marked
            print(f'[9 {what}] float32 against float64: {marked} pairs in '
                  f'{rows} rows marked (float64 rmsd within '
                  f'{QCP_TIE["float32"]} A of {THR} or max deviation within '
                  f'it of {2 * THR}), {moi_marked} MOI pairs marked (a '
                  f'relative moment deviation within {MOI_TIE} of '
                  f'{MOI_THRESH}); float32 {" -> ".join(map(str, c32))}, '
                  f'frames equal to float64\'s: {same}')
            check(c32[:2] == counts[:2], f'{what} f32: {c32[:2]} structures '
                  f'before the prunes, f64 {counts[:2]}')
            if slack == 0:
                check(same, f'{what} f32: no marked pair, but the frames '
                      f'differ from f64\'s ({c32} against {counts})')
            else:
                for k, name in ((2, 'after the RMSD prune'), (3, 'final')):
                    check(abs(c32[k] - counts[k]) <= slack, f'{what} f32 '
                          f'{name}: {c32[k]} outside {counts[k]} +- {slack} '
                          f'marked rows and MOI pairs')
    return launches, recs, err


def k2_check(card, tag, report, ids, dtype_name):
    '''K2's entry on what a CLI run's compenetration stage gave it
    (`report` from run_cli: one call, on the stage's structures_in
    structures, in the run's dtype, with the cross-fragment mask of the
    fragment sizes `ids`), against the plain version: on the structures
    as they are (the sweep screened them, so all pass) and with the
    second fragment pulled toward the first by 0 to 60% of the centroid
    distance (max_clashes 0 and 2), off poses within CLASH_TIE of the
    threshold. Times the entry (device_ms; its pair list is kept from
    its first call), the same with its enqueue time, and the plain
    version. Returns (record, largest disagreement).'''
    import torch
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.ops.kernels import clash
    stage = next(st for st in report['stages']
                 if st['stage'] == 'compenetration_refining')
    check(len(report['k2_calls']) == 1, f'K2 {tag}: the compenetration '
          f'stage called the entry {len(report["k2_calls"])} times')
    poses, pm, thresh, max_clashes = report['k2_calls'][0]
    want_pm = cross_fragment_pair_mask(tuple(ids))
    check(tuple(poses.shape) == (stage['structures_in'], sum(ids), 3)
          and poses.is_cuda and poses.dtype == getattr(torch, dtype_name)
          and np.array_equal(np.asarray(pm), want_pm)
          and (thresh, max_clashes) == (CLASH, 0),
          f'K2 {tag}: the stage gave the entry poses {tuple(poses.shape)} '
          f'{poses.dtype} on {poses.device}, thresh {thresh}, max_clashes '
          f'{max_clashes}; expected its {stage["structures_in"]} structures '
          f'in {dtype_name} on the card, {CLASH} and 0')
    poses = poses.contiguous()
    pairs = torch.as_tensor(clash.static_pairs(pm), device=DEV)
    mask = torch.as_tensor(pm, device=DEV)
    n1 = int(ids[0])
    shift = poses[:, :n1].mean(dim=1) - poses[:, n1:].mean(dim=1)
    pulled = poses.clone()
    pulled[:, n1:] += shift[:, None] * torch.linspace(
        0, 0.6, len(poses), dtype=poses.dtype, device=DEV)[:, None, None]
    err = 0
    for what, p in (('as embedded', poses), ('pulled together', pulled)):
        tie = clash_ties(p, pairs, CLASH)
        for mc in (0, 2):
            want = clash.clash_counts_plain(p, mask, CLASH) <= mc
            got = clash.compenetration_mask_kernel(p, pm, CLASH, mc)
            e, n_tie = compare_bits(got, want, tie, f'K2 {tag} {what} '
                                    f'mc={mc}')
            err = max(err, e)
            if what == 'pulled together':
                check(0 < int(want.sum()) < len(p), f'K2 {tag} {what} '
                      f'mc={mc}: degenerate case ({int(want.sum())} pass)')
            elif mc == 0:
                n_pass = int(got.sum())
    check(n_pass == stage['structures_out'], f'K2 {tag}: {n_pass} pass '
          f'here, {stage["structures_out"]} left the stage')
    ms = device_ms(lambda: clash.compenetration_mask_kernel(poses, pm, CLASH))
    ms_enqueued = cuda_ms(lambda: clash.compenetration_mask_kernel(
        poses, pm, CLASH))
    ms_plain = cuda_ms(lambda: clash.clash_counts_plain(poses, mask, CLASH)
                       <= 0)
    nbytes = poses.numel() * poses.element_size() + pm.size + len(poses)
    rec = {'poses': len(poses), 'N': int(poses.shape[1]),
           'P': int(pairs.shape[0]), 'dtype': dtype_name, 'ms': ms,
           'enqueued_ms': ms_enqueued, 'plain_ms': ms_plain,
           'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3,
           'regime': clash.clash_regime(pairs.shape[0], poses.shape[1],
                                        poses.element_size()),
           **k1_yardstick(poses, pairs)}
    print(f'[{tag}] K2 on the stage\'s {len(poses)} structures of '
          f'{poses.shape[1]} atoms ({dtype_name}, P = {pairs.shape[0]}): '
          f'{n_pass} pass as embedded; equal to plain as embedded and pulled '
          f'together, max_clashes 0 and 2; entry {k1_line(rec)}; '
          f'{ms_enqueued:.4f} ms with its enqueue time [{card}]')
    return rec, err


def k2_checks(card, tag, reports, ids):
    '''k2_check on the float64 and the float32 run of a route; returns
    (records by dtype, largest disagreement).'''
    recs, err = {}, 0
    for dtype, report in reports.items():
        recs[dtype], e = k2_check(card, tag, report, ids, dtype)
        err = max(err, e)
    return recs, err


def stage_counts(report):
    return tuple([report['stages'][0]['structures_out']]
                 + [s['structures_out'] for s in report['stages'][1:]])


def phase_multiembed_route(card):
    '''Phase 10: the multi-arrangement route through the CLI on
    bench_suite's multiembed at ME_CONFS conformers (12 arrangements'
    block rows in one sweep, one B1 launch a chunk, each arrangement's
    stages and the parent's compenetration stage with K2, the prunes),
    float64 (the JAX x64 counts at every stage) then float32 (held as
    phase 8 holds it), the union sweep checked on its own (B1 against
    its twin), and K2 on the parent's structures. Returns (K1 launches,
    K2 launches, largest K1 disagreement, K2's records by dtype, largest
    K2 disagreement, B1's record).'''
    import tempfile
    import torch
    from tscode_tpu_torch import multiembed
    from tscode_tpu_torch.embeds import cyclical as cyc
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    k1 = k2 = 0
    runs, reports = {}, {}
    with tempfile.TemporaryDirectory(prefix='smoke_multi_') as tmp:
        inp = suite_input('multiembed', tmp, ME_CONFS)
        for dtype in ('float64', 'float32'):
            report, frames, regimes, secs = run_cli(tmp, inp, dtype)
            me = report['multiembed_embed']
            entry = report['clash_entry_launches']
            k1 += entry['clash_ok']
            k2 += entry['compenetration_mask_kernel']
            kids = me['children']
            # an arrangement is a cyclical embed, whose compenetration
            # stage screens nothing: K2 is the parent's launch
            check(entry == {'clash_ok': 0,
                            'compenetration_mask_kernel': 1,
                            'torsion_clash_ok': 0,
                            'torsion_backoff': 0} and
                  report['b1_launches'] == me['chunks'] == 1,
                  f'multiembed {dtype}: launches {entry}, B1 '
                  f'{report["b1_launches"]}, expected B1 once for the one '
                  f'chunk ({me["chunks"]}), no K1, K2 once, for the parent')
            parent = stage_counts(report)
            check(frames.shape == (min(parent[2], 10000), 11, 3)
                  and bool(np.isfinite(frames).all()),
                  f'multiembed {dtype}: .xyz holds {frames.shape}')
            runs[dtype] = (kids, parent)
            reports[dtype] = report
            print(f'[10 multiembed {dtype}] {me["arrangements"]} '
                  f'arrangements, {me["union_candidates"]} candidates -> '
                  f'{me["union_survivors"]} survivors of the sweep; parent '
                  f'{" -> ".join(map(str, parent))} (in -> after '
                  f'compenetration -> final) in {secs:.3f} s; launches '
                  f'{entry}, B1 {report["b1_launches"]}; stages: '
                  f'{cli_stages(report)}; report total '
                  f'{report["total_seconds"]} s [{card}]')
            print(f'[10 multiembed {dtype}] per arrangement, blocks / '
                  f'survivors / structures / seconds: ' + ', '.join(
                      f'{c["blocks"]} / {c["survivors"]} / {c["structures"]} '
                      f'/ {c["seconds"]:.3f}' for c in kids) + f' [{card}]')
            embed_split('10 multiembed', dtype, report, 'multiembed_embed',
                        card)
        # the union sweep on its own: the children's block rows again
        emb = embedder_setup(inp, torch.float64)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            blks = []
            for i, c in enumerate(runs['float64'][0]):
                run, folder, blk = multiembed._build_child(
                    emb, c['arrangement'], i)
                blks.append(blk)
        finally:
            os.chdir(cwd)
        sweep = sweep_check(card, '10 multiembed', cyc.concat_blocks(blks),
                            run.objects, run.systematic_angles)
    differ = hold_float32('10 multiembed', sweep)
    keep64, keep32 = sweep['keep64'], sweep['keep32']

    kids64, parent64 = runs['float64']
    kids32, parent32 = runs['float32']
    check(tuple(c['blocks'] for c in kids64) == (ME_BLOCKS,) * 12 and
          all(c['candidates'] == ME_BLOCKS * 36 for c in kids64),
          f'multiembed f64: blocks {[c["blocks"] for c in kids64]}, expected '
          f'{ME_BLOCKS} each')
    check(tuple(c['survivors'] for c in kids64) == ME_SURVIVORS,
          f'multiembed f64: survivors {[c["survivors"] for c in kids64]} != '
          f'{ME_SURVIVORS} (JAX x64)')
    check(tuple(c['structures'] for c in kids64) == ME_STRUCTURES,
          f'multiembed f64: structures {[c["structures"] for c in kids64]} '
          f'!= {ME_STRUCTURES} (JAX x64)')
    check(parent64 == ME_PARENT, f'multiembed f64: parent {parent64} != '
          f'{ME_PARENT} (JAX x64)')
    lo = 0
    for i, (c64, c32) in enumerate(zip(kids64, kids32)):
        rows = slice(lo, lo + c64['blocks'])
        lo += c64['blocks']
        check(int(keep64[rows].sum()) == c64['survivors'] and
              int(keep32[rows].sum()) == c32['survivors'],
              f'multiembed arrangement {i + 1}: the sweep on its own keeps '
              f'{int(keep64[rows].sum())} / {int(keep32[rows].sum())}, the '
              f'route {c64["survivors"]} / {c32["survivors"]}')
        slack = float32_slack(sweep, differ, rows)
        for key, room in zip(('survivors', 'structures'), slack):
            check(abs(c32[key] - c64[key]) <= room, f'multiembed f32 '
                  f'arrangement {i + 1} {key}: {c32[key]} outside '
                  f'{c64[key]} +- {room}')
    slack = float32_slack(sweep, differ)
    for k, what in enumerate(('in', 'after compenetration', 'final')):
        check(abs(parent32[k] - parent64[k]) <= slack[1], f'multiembed '
              f'f32 parent {what}: {parent32[k]} outside {parent64[k]} +- '
              f'{slack[1]}')
    print(f'[10 multiembed] gates held: float64 survivors and structures '
          f'per arrangement and parent {" -> ".join(map(str, parent64))} '
          f'(JAX x64); float32 parent {" -> ".join(map(str, parent32))}, '
          f'each arrangement\'s survivors within the angles of its blocks '
          f'that differ ({slack[0]} in all), later counts within those and '
          f'its clash-tie survivors ({slack[1]} in all)')
    recs, e2 = k2_checks(card, '10 multiembed', reports, (5, 6))
    return k1, k2, sweep['err'], recs, e2, sweep['b1']


def phase_chelotropic_route(card):
    '''Phase 11: the rigid chelotropic route through the CLI on the
    port's chelotropic input at CHEL_CONFS conformers (the block sweep
    with B1, the compenetration stage with K2, the prunes), float64
    (the JAX x64 counts) then float32 (held as phase 8 holds it), and K2
    on its structures. Returns as phase_multiembed_route.'''
    import tempfile
    import torch
    from tscode_tpu_torch.embeds import cyclical as cyc
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    k1 = k2 = 0
    counts, reports = {}, {}
    with tempfile.TemporaryDirectory(prefix='smoke_chel_') as tmp:
        inp = suite_input('chelotropic', tmp, CHEL_CONFS)
        for dtype in ('float64', 'float32'):
            report, frames, regimes, secs = run_cli(tmp, inp, dtype)
            ce = report['chelotropic_embed']
            entry = report['clash_entry_launches']
            k1 += entry['clash_ok']
            k2 += entry['compenetration_mask_kernel']
            check(entry == {'clash_ok': 0,
                            'compenetration_mask_kernel': 1,
                            'torsion_clash_ok': 0,
                            'torsion_backoff': 0} and
                  report['b1_launches'] == ce['chunks'] == 1,
                  f'chelotropic {dtype}: launches {entry}, B1 '
                  f'{report["b1_launches"]}, expected B1 once for the one '
                  f'chunk ({ce["chunks"]}), no K1, K2 once')
            counts[dtype] = c = (ce['candidates'],) + stage_counts(report)
            reports[dtype] = report
            check(frames.shape == (min(c[3], 10000), 12, 3)
                  and bool(np.isfinite(frames).all()),
                  f'chelotropic {dtype}: .xyz holds {frames.shape}')
            print(f'[11 chelotropic {dtype}] {" -> ".join(map(str, c))} '
                  f'(candidates -> embedded -> after compenetration -> '
                  f'final) in {secs:.3f} s; launches {entry}, B1 '
                  f'{report["b1_launches"]}; stages: {cli_stages(report)}; '
                  f'report total {report["total_seconds"]} s [{card}]')
            embed_split('11 chelotropic', dtype, report, 'chelotropic_embed',
                        card)
        emb = embedder_setup(inp, torch.float64)
    blk = cyc.bimol_rigid_blocks(*emb.objects, 5, emb.pairing_ok_fn())
    sweep = sweep_check(card, '11 chelotropic', blk, emb.objects,
                        emb.systematic_angles)
    differ = hold_float32('11 chelotropic', sweep)
    keep64, keep32 = sweep['keep64'], sweep['keep32']
    slack = float32_slack(sweep, differ)
    c64, c32 = counts['float64'], counts['float32']
    check(c64 == CHEL_F64, f'chelotropic f64 counts {c64} != {CHEL_F64}')
    check(int(keep64.sum()) == c64[1] and int(keep32.sum()) == c32[1],
          f'chelotropic: the sweep on its own keeps {int(keep64.sum())} / '
          f'{int(keep32.sum())}, the route {c64[1]} / {c32[1]}')
    check(c32[0] == c64[0], f'chelotropic f32 candidates {c32[0]}')
    for k in (1, 2, 3):
        check(abs(c32[k] - c64[k]) <= slack[k > 1], f'chelotropic f32 count '
              f'{k}: {c32[k]} outside {c64[k]} +- {slack[k > 1]}')
    print(f'[11 chelotropic] gates held: float64 '
          f'{" -> ".join(map(str, c64))} (JAX x64), float32 '
          f'{" -> ".join(map(str, c32))} within +- {slack[0]} (embedded: the '
          f'angles of the blocks that differ) and +- {slack[1]} (later: and '
          f'the clash-tie survivors)')
    recs, e2 = k2_checks(card, '11 chelotropic', reports,
                         [m.n_atoms for m in emb.objects])
    return k1, k2, sweep['err'], recs, e2, sweep['b1']


def phase_trimol_route(card):
    '''Phase 12: the rigid three-molecule route through the CLI on
    bench_suite's trimolecular input with RIGID at TRI_CONFS // 4
    conformers of HCOOH (the chained direction adjustment, the block
    sweep with B1 over the pair list of three fragments, BYPASS), float64
    (the JAX x64 blocks, candidates and survivors) then float32, and
    the sweep checked on its own (B1 against its twin; K1 against plain
    on the twin's first chunk). Returns (K1 launches, largest K1
    disagreement, K1's record, B1's record).'''
    import tempfile
    import torch
    from tscode_tpu_torch.embeds import cyclical as cyc
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    k1 = 0
    counts = {}
    with tempfile.TemporaryDirectory(prefix='smoke_tri_') as tmp:
        inp = suite_input('trimolecular_rigid', tmp, TRI_CONFS)
        for dtype in ('float64', 'float32'):
            report, frames, regimes, secs = run_cli(tmp, inp, dtype)
            ce = report['cyclical_embed']
            entry = report['clash_entry_launches']
            k1 += entry['clash_ok']
            check(entry == {'clash_ok': 0,
                            'compenetration_mask_kernel': 0,
                            'torsion_clash_ok': 0,
                            'torsion_backoff': 0} and
                  report['b1_launches'] == ce['chunks'] == 1,
                  f'trimolecular {dtype}: launches {entry} {regimes}, B1 '
                  f'{report["b1_launches"]}, expected B1 once for the one '
                  f'chunk ({ce["chunks"]}), no K1')
            counts[dtype] = c = (ce['blocks'], ce['candidates'],
                                 ce['survivors'])
            check(report['final_structures'] == c[2] and
                  frames.shape == (min(c[2], 10000), 15, 3)
                  and bool(np.isfinite(frames).all()),
                  f'trimolecular {dtype}: .xyz holds {frames.shape}, final '
                  f'{report["final_structures"]}')
            print(f'[12 trimolecular {dtype}] {" -> ".join(map(str, c))} '
                  f'(blocks -> candidates -> embedded) in {secs:.3f} s; '
                  f'B1 launches {report["b1_launches"]}; adjust chain '
                  f'{ce["adjust_s"]:.4f} s in float64, '
                  f'{ce["adjust_near_ties"]} blocks whose two best grid '
                  f'costs lie within {cyc.ADJ_TIE} degrees; stages: '
                  f'{cli_stages(report)}; report total '
                  f'{report["total_seconds"]} s [{card}]')
            check(ce['adjust_near_ties'] == 0, f'trimolecular {dtype}: '
                  f'{ce["adjust_near_ties"]} adjust-chain near ties')
            embed_split('12 trimolecular', dtype, report, 'cyclical_embed',
                        card)
        emb = embedder_setup(inp, torch.float64)
    blk = cyc.trimol_rigid_blocks(emb.objects, emb.pairing_ok_fn())
    blk['dirs'], _ = cyc.adjust_chain(*(blk[k] for k in cyc._ADJUST),
                                      device=torch.device(DEV))
    sweep = sweep_check(card, '12 trimolecular', blk, emb.objects,
                        emb.systematic_angles)
    differ = hold_float32('12 trimolecular', sweep)
    keep64, keep32, rec = sweep['keep64'], sweep['keep32'], sweep['rec']
    slack = float32_slack(sweep, differ)[0]
    check(rec['regime'] == 'warp' and rec['N'] == 15 and rec['P'] == 75,
          f'trimolecular chunk: {rec}')
    c64, c32 = counts['float64'], counts['float32']
    check(c64 == TRI_F64, f'trimolecular f64 counts {c64} != {TRI_F64}')
    check(int(keep64.sum()) == c64[2] and int(keep32.sum()) == c32[2],
          f'trimolecular: the sweep on its own keeps {int(keep64.sum())} / '
          f'{int(keep32.sum())}, the route {c64[2]} / {c32[2]}')
    check(c32[:2] == c64[:2] and abs(c32[2] - c64[2]) <= slack,
          f'trimolecular f32 {c32} outside {c64} +- {slack}')
    print(f'[12 trimolecular] gates held: float64 '
          f'{" -> ".join(map(str, c64))} (JAX x64), float32 '
          f'{" -> ".join(map(str, c32))} within +- {slack} (the angles of '
          f'the blocks that differ)')
    return k1, sweep['err'], rec, sweep['b1']


def profiled(fn):
    '''fn() under torch.profiler, ended by a synchronise: (wall seconds,
    seconds of kernel time on the card, kernel launches); the last two
    None when the profiler saw no device time.'''
    return profiled_kernels(fn)[:3]


def trimol_topology():
    '''The rigid three-molecule embed's survivors at TRI_CONFS (phase
    12's, (S, 15, 3) float64 numpy) and the merged force field of its
    three molecules (FFParams).'''
    import tempfile
    import torch
    from tscode_tpu_torch.embeds import cyclical as cyc
    from tscode_tpu_torch.ff import build_ff_params, merge_ff_params
    with tempfile.TemporaryDirectory(prefix='smoke_ff_') as tmp:
        emb = embedder_setup(suite_input('trimolecular_rigid', tmp,
                                         TRI_CONFS), torch.float64)
    mols = emb.objects
    poses, _ = cyc.cyclical_embed_trimol_rigid(
        mols, emb.systematic_angles, emb.options.clash_thresh,
        pairing_ok=emb.pairing_ok_fn(), log=lambda *a: None, device=DEV,
        dtype=torch.float64)
    offsets = np.concatenate([[0], np.cumsum([m.n_atoms for m in mols])[:-1]])
    params = merge_ff_params(
        [build_ff_params(m.atomcoords[0], m.atomnos, m.graph) for m in mols],
        offsets)
    return poses, params


def fire_timing(card, what, x, params, profile, steps=FIRE_TIMED_STEPS):
    '''Seconds per FIRE step of the batch x under the force field, over
    `steps` steps after as many of warm-up, the step replayed from its
    CUDA graph and queued op by op; with `profile`, launches per step
    and the card's busy share from the profiler over as many again
    (starting and stopping the profiler costs seconds). Prints one line;
    returns the record.'''
    import torch
    from tscode_tpu_torch import optimizers as opt
    from tscode_tpu_torch.ff import ff_energy
    args = (x, ff_energy, steps, 0.05, 0.05, None, (params,))

    def timed(run):
        run(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    rec = {'rows': int(x.shape[0]), 'atoms': int(x.shape[1]),
           'dtype': str(x.dtype).split('.')[-1], 'steps': steps}
    for name, run in (('graph', opt.fire_run_graph),
                      ('eager', opt.fire_run_eager)):
        rec[f'{name}_s_per_step'] = timed(run)
        wall, busy, launches = profiled(lambda: run(*args)) if profile \
            else (None, None, None)
        rec[f'{name}_busy_share'] = None if busy is None else busy / wall
        rec[f'{name}_launches_per_step'] = None if launches is None \
            else launches / steps
    print(f'[13 fire] {what}, {rec["rows"]} x {rec["atoms"]} atoms, '
          f'{rec["dtype"]}, {steps} steps: graph replay '
          f'{rec["graph_s_per_step"] * 1e3:.4f} ms a step (busy share '
          f'{rec["graph_busy_share"]}, {rec["graph_launches_per_step"]} '
          f'kernels a step), op by op {rec["eager_s_per_step"] * 1e3:.4f} '
          f'ms a step (busy share {rec["eager_busy_share"]}, '
          f'{rec["eager_launches_per_step"]} launches a step) [{card}]')
    return rec


def ff_fire_bound(x, params, steps):
    '''(ms, 'operations' or 'bytes'): the least time of the FIRE kernel's
    function on the batch x (B, N, 3) under the force field `params`,
    the larger of its bytes (coordinates read and written once, the
    flags and counts written, the tables read once) over the memory rate
    and its operations (each term once and each atom's update a force
    evaluation, FF_TERM_FLOPS, times the evaluations `steps` this run's
    structures took) over the card's peak for the type.'''
    nb, na, npairs, nd = (int(params[k].shape[0]) for k in (0, 2, 4, 6))
    per = FF_TERM_FLOPS['pair'] * (nb + npairs) + \
        FF_TERM_FLOPS['angle'] * na + FF_TERM_FLOPS['dihedral'] * nd + \
        FF_TERM_FLOPS['atom'] * x.shape[1]
    ops_ms = per * int(steps.sum()) / \
        PEAK_FLOPS[str(x.dtype).split('.')[-1]] * 1e3
    nbytes = 2 * x.numel() * x.element_size() + 5 * x.shape[0] + \
        sum(t.numel() * t.element_size() for t in params)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms \
        else (bytes_ms, 'bytes')


def fire_f32_ok(what, x, c, done, params, terms):
    '''Phase 13's float32 rule for a FIRE result: finite, no energy
    rises, the stopped rows' largest atomic force under fmax.'''
    import torch
    from tscode_tpu_torch.ff import ff_energy
    from tscode_tpu_torch.ops.kernels import ff_fire
    e0, e1 = ff_energy(x, params), ff_energy(c, params)
    f = ff_fire.ff_forces_plain(c, terms)
    fmax = torch.linalg.norm(f, dim=-1).amax(dim=-1)
    check(bool(torch.isfinite(c).all()) and
          bool((e1 <= e0 + 1e-4 * (1 + e0.abs())).all()) and
          bool((fmax[done] < 0.05 + 1e-4).all()),
          f'ff_fire {what} float32: an energy rose or a stopped row '
          f'has force {float(fmax[done].max()) if done.any() else 0}')


def fire_shapes(x, params):
    '''(FireTerms, kinds, incidence entries) of the force field `params`
    for the batch x: what ff_fire.launch_plan reads.'''
    from tscode_tpu_torch.ff import FireTerms, incidence
    kinds = tuple(int(params[k].shape[0]) for k in (0, 2, 4, 6))
    _, codes, _ = incidence(params, x.shape[1])
    return FireTerms(params), kinds, codes.numel()


def fire_form_record(card, what, x, params, n_steps, form, want):
    '''One form of the FIRE kernel (ff_fire.launch, regime=form) on the
    call: against the plain twin's result `want` (float64: within
    FIRE_ATOL, the same stop flags and force evaluations; float32:
    fire_f32_ok), two launches bit for bit, timed with device_ms; its
    registers and resident warps (ff_fire.kernel_info), microseconds a
    step (the time over the longest structure's force evaluations).'''
    import torch
    from tscode_tpu_torch.ops.kernels import ff_fire
    terms, _, _ = fire_shapes(x, params)
    plan = ff_fire.plan_for(x, terms, form)
    c, done, steps = ff_fire.launch(x, terms, n_steps, regime=form)
    c2, done2, steps2 = ff_fire.launch(x, terms, n_steps, regime=form)
    check(torch.equal(c, c2) and torch.equal(done, done2) and
          torch.equal(steps, steps2), f'ff_fire {what}, form {form}: two '
          f'launches differ')
    cp, dp, sp = want
    err = float((c - cp).abs().max())
    flags = int((done != dp).sum())
    if x.dtype == torch.float64:
        check(err <= FIRE_ATOL and flags == 0 and torch.equal(steps, sp),
              f'ff_fire {what}, form {form}, float64: {err:.2e} A from its '
              f'plain twin, stop flags unlike its in {flags} rows, '
              f'{int((steps != sp).sum())} force-evaluation counts unlike')
    else:
        fire_f32_ok(f'{what}, form {form}', x, c, done, params, terms)
    ms = device_ms(lambda: ff_fire.launch(x, terms, n_steps, regime=form),
                   reps=5)
    return {'ms': ms, 'us_per_step': ms * 1e3 / max(1, int(steps.max())),
            'plain_diff_A': err, 'flags_unlike_plain': flags,
            'threads': plan.threads, 'structures_a_block': plan.groups,
            'warps_a_structure': plan.warps, 'cluster': plan.cluster,
            'smem': plan.smem,
            **ff_fire.kernel_info(plan, x.shape[1], x.dtype, x.device)}


def fire_kernel_record(card, what, x, params, n_steps):
    '''The force field's FIRE kernel on the batch x (ff_fire.launch,
    n_steps, the form launch_plan picks) against its plain twin on the
    card and against the graph path (fire_run_graph) on the same call:
    float64 within FIRE_ATOL of both with the same rows stopped (and the
    plain twin's force evaluations); float32 as phase 13 holds
    fire_minimize_batch (fire_f32_ok), its distance to the two printed.
    Then every form on the same call (fire_form_record; at these
    shapes each fits, and a refusal fails the phase): held the same way,
    timed, its registers and resident warps; the chosen form no slower
    than the block form (the first design) in this run.
    The plain twin and the graph path timed with cuda_ms; bounded
    (ff_fire_bound). Prints a line a form and one for the call; returns
    (the record, the force evaluations of each structure).'''
    import torch
    from tscode_tpu_torch import optimizers as opt
    from tscode_tpu_torch.ff import ff_energy
    from tscode_tpu_torch.ops.kernels import ff_fire
    terms, _, _ = fire_shapes(x, params)
    name = str(x.dtype).split('.')[-1]
    plan = ff_fire.plan_for(x, terms)
    c, done, steps = ff_fire.launch(x, terms, n_steps)
    cp, dp, sp = ff_fire.ff_fire_plain(x, terms, n_steps)
    graph = opt.fire_run_graph(x, ff_energy, n_steps, 0.05, 0.05, None,
                               (params,))
    plain_err = float((c - cp).abs().max())
    graph_err = float((c - graph[0]).abs().max())
    same = [int((done != d).sum()) for d in (dp, graph[5])]
    if x.dtype == torch.float64:
        check(plain_err <= FIRE_ATOL and graph_err <= FIRE_ATOL and
              same == [0, 0] and torch.equal(steps, sp),
              f'ff_fire {what} float64: {plain_err:.2e} A from its plain '
              f'twin, {graph_err:.2e} A from the graph path, stop flags '
              f'unlike theirs in {same} rows')
    else:
        fire_f32_ok(what, x, c, done, params, terms)
    forms = {}
    for form in ff_fire.FORMS:
        forms[form] = fire_form_record(card, what, x, params, n_steps, form,
                                       (cp, dp, sp))
        r = forms[form]
        print(f'[13 ff_fire] {what}, {name}, form {form}'
              f'{" (chosen)" if form == plan.form else ""}: '
              f'{r["ms"]:.4f} ms, {r["us_per_step"]:.3f} us a step, '
              f'{r["registers"]} registers a thread ({r["local_bytes"]} B '
              f'spilled), {r["resident_warps"]} resident warps an SM '
              f'({r["blocks_per_sm"]} blocks of {r["threads"]} threads, '
              f'{r["structures_a_block"]} structures a block, '
              f'{r["smem"]} shared bytes); {r["plain_diff_A"]:.2e} A from '
              f'the plain twin [{card}]')
    chosen, block = forms[plan.form]['ms'], forms['block']['ms']
    check(chosen <= block * FIRE_AB_SLACK, f'ff_fire {what} {name}: the '
          f'chosen form {plan.form} {chosen:.4f} ms, slower than the block '
          f'form {block:.4f} ms')
    bound, by = ff_fire_bound(x, params, steps)
    rec = {'what': what, 'rows': int(x.shape[0]), 'atoms': int(x.shape[1]),
           'dtype': name, 'n_steps': n_steps, 'form': plan.form,
           'force_evaluations': int(steps.sum()),
           'mean_steps': float(steps.float().mean()),
           'max_steps': int(steps.max()),
           'stopped': int(done.sum()), 'plain_diff_A': plain_err,
           'graph_diff_A': graph_err,
           'flags_unlike_plain_graph': same, 'ms': chosen,
           'block_ms': block, 'us_per_step': forms[plan.form]['us_per_step'],
           'forms': forms,
           'plain_ms': cuda_ms(lambda: ff_fire.ff_fire_plain(
               x, terms, n_steps), reps=1),
           'graph_ms': cuda_ms(lambda: opt.fire_run_graph(
               x, ff_energy, n_steps, 0.05, 0.05, None, (params,)), reps=1),
           'bound_ms': bound, 'bound_by': by}
    rec['bound_share'] = bound / chosen
    print(f'[13 ff_fire] {what}, {rec["rows"]} x {rec["atoms"]} atoms, '
          f'{name}, {n_steps} steps ({rec["mean_steps"]:.1f} force '
          f'evaluations a structure, at most {rec["max_steps"]}, '
          f'{rec["stopped"]} stopped): form {plan.form} {chosen:.4f} ms '
          f'({rec["us_per_step"]:.3f} us a step; the block form '
          f'{block:.4f} ms), plain twin {rec["plain_ms"]:.4f} ms, graph '
          f'path {rec["graph_ms"]:.4f} ms, bound {bound:.6f} ms ({by}, '
          f'{100 * rec["bound_share"]:.2f}% of it); {plain_err:.2e} A from '
          f'the plain twin, {graph_err:.2e} A from the graph path, stop '
          f'flags unlike theirs in {same} rows [{card}]')
    return rec, steps


def fire_sweep(card, poses, ffp):
    '''The sweep behind ff_fire.launch_plan's rule: the first B of
    phase 12's survivors for B in FIRE_SWEEP_ROWS, FIRE_SWEEP_STEPS
    steps, every form (ff_fire.FORMS), both types, in device time; the
    form the rule picks beside the fastest. Prints a line a shape;
    returns the rows.'''
    import torch
    from tscode_tpu_torch.ff import params_to_device
    from tscode_tpu_torch.ops.kernels import ff_fire
    rows = []
    for dtype in (torch.float64, torch.float32):
        params = params_to_device(ffp, DEV, dtype)
        for B in FIRE_SWEEP_ROWS:
            x = torch.as_tensor(poses[:B], dtype=dtype, device=DEV)
            terms, _, _ = fire_shapes(x, params)
            row = {'rows': len(x), 'dtype': str(dtype).split('.')[-1],
                   'chosen': ff_fire.plan_for(x, terms).form,
                   'lone_warps': ff_fire.plan_for(x, terms, 'lone').warps}
            for form in ff_fire.FORMS:
                row[form] = device_ms(lambda: ff_fire.launch(
                    x, terms, FIRE_SWEEP_STEPS, regime=form), reps=3)
            row['fastest'] = min(ff_fire.FORMS, key=row.get)
            rows.append(row)
            print(f'[13 fire sweep] {row["rows"]} x {x.shape[1]} atoms, '
                  f'{row["dtype"]}, {FIRE_SWEEP_STEPS} steps: ' +
                  ', '.join(f'{f} {row[f]:.4f} ms' for f in ff_fire.FORMS) +
                  f' (lone on {row["lone_warps"]} warps a structure); '
                  f'fastest {row["fastest"]}, the rule picks '
                  f'{row["chosen"]} [{card}]')
    return rows


def fire_size_sweep(card):
    '''The plan rule past the 15-atom topology: chains of
    suite_inputs.chain_ff at FIRE_SIZE_CASES' atoms and structures,
    FIRE_SWEEP_STEPS steps, both types, every form whose shared memory
    fits (a refusal is checked: only past SMEM_BYTES, never the large
    form), each form's resident warps, in device time; from
    BATCH_MIN_ROWS structures also the lone form at each width the rule
    weighs (ff_fire.lone_widths); the rule's pick beside the fastest.
    Float64: one structure's forms within FIRE_ATOL of the plain twin, a
    batch's of the rule's form, with the same force evaluations. Prints
    a line a shape; returns the rows.'''
    import torch
    from tscode_tpu_torch.ff import params_to_device
    from tscode_tpu_torch.ops.kernels import ff_fire
    from tscode_tpu_torch.suite_inputs import chain_ff
    rows = []
    for n_atoms in sorted({n for n, _ in FIRE_SIZE_CASES}):
        counts = [B for n, B in FIRE_SIZE_CASES if n == n_atoms]
        X, ffp = chain_ff(n_atoms, max(counts), seed=n_atoms)
        for dtype in (torch.float64, torch.float32):
            params = params_to_device(ffp, DEV, dtype)
            for B in counts:
                x = torch.as_tensor(X[:B], dtype=dtype, device=DEV)
                terms, kinds, entries = fire_shapes(x, params)
                plan = ff_fire.plan_for(x, terms)
                if dtype == torch.float64 and B == 1:
                    ref = ff_fire.ff_fire_plain(x, terms, FIRE_SWEEP_STEPS)
                elif dtype == torch.float64:
                    ref = ff_fire.launch(x, terms, FIRE_SWEEP_STEPS)
                row = {'atoms': n_atoms, 'rows': B, 'entries': entries,
                       'dtype': str(dtype).split('.')[-1],
                       'chosen': plan.form, 'chosen_warps': plan.warps,
                       'refused': [], 'warps': {}}
                for form in ff_fire.FORMS:
                    try:
                        fp = ff_fire.plan_for(x, terms, form)
                    except ValueError:   # past a block's shared memory
                        check(form != 'large', f'ff_fire {n_atoms} atoms: '
                              f'the large form refused')
                        row['refused'].append(form)
                        continue
                    row['warps'][form] = ff_fire.kernel_info(
                        fp, n_atoms, dtype, x.device)['resident_warps']
                    got = ff_fire.launch(x, terms, FIRE_SWEEP_STEPS,
                                         regime=form)
                    if dtype == torch.float64:
                        err = float((got[0] - ref[0]).abs().max())
                        check(err <= FIRE_ATOL and
                              torch.equal(got[2], ref[2]),
                              f'ff_fire {n_atoms} atoms x {B}, form '
                              f'{form}: {err:.2e} A from the reference, '
                              f'force evaluations unlike')
                    row[form] = device_ms(lambda: ff_fire.launch(
                        x, terms, FIRE_SWEEP_STEPS, regime=form), reps=3)
                row['fastest'] = min((f for f in ff_fire.FORMS if f in row),
                                     key=row.get)
                widths = ''
                if B >= ff_fire.BATCH_MIN_ROWS and 'lone' in row:
                    row['lone_widths'] = {
                        p.warps: [device_ms(lambda: ff_fire.launch(
                            x, terms, FIRE_SWEEP_STEPS, plan=p), reps=3),
                            ff_fire.kernel_info(p, n_atoms, dtype,
                                                x.device)['resident_warps']]
                        for p in ff_fire.lone_widths(n_atoms, kinds, entries,
                                                     x.element_size())}
                    widths = '; lone by warps a structure: ' + ', '.join(
                        f'{w} {ms:.4f} ms ({r} warps)'
                        for w, (ms, r) in row['lone_widths'].items())
                rows.append(row)
                print(f'[13 fire size sweep] {B} x {n_atoms} atoms '
                      f'({entries} entries), {row["dtype"]}, '
                      f'{FIRE_SWEEP_STEPS} steps: ' + ', '.join(
                          f'{f} {row[f]:.4f} ms ({row["warps"][f]} warps)'
                          for f in ff_fire.FORMS if f in row) +
                      f'; refused {row["refused"]}{widths}; fastest '
                      f'{row["fastest"]}, the rule picks {row["chosen"]} '
                      f'on {plan.warps} warps a structure [{card}]')
    return rows


def fire_large_record(card):
    '''A FIRE_LARGE_N-atom chain (suite_inputs.chain_ff), float64,
    FIRE_LARGE_STEPS steps through ff_fire.ff_fire: the plan's large form
    (the block form's shared memory does not hold it) against its plain
    twin within FIRE_ATOL with the same force evaluations, two launches
    bit for bit, and so the form with its coordinates in device memory;
    timed (the plain twin on its one run, host enqueue included) and
    bounded. Prints one line; returns the record.'''
    import torch
    from tscode_tpu_torch.ff import params_to_device
    from tscode_tpu_torch.ops.kernels import ff_fire
    from tscode_tpu_torch.suite_inputs import chain_ff
    X, ffp = chain_ff(FIRE_LARGE_N, 1, seed=13)
    params = params_to_device(ffp, DEV, torch.float64)
    x = torch.as_tensor(X, device=DEV)
    terms, kinds, entries = fire_shapes(x, params)
    plan = ff_fire.launch_plan(1, x.shape[1], kinds, entries, 8)
    try:
        ff_fire.launch_plan(1, x.shape[1], kinds, entries, 8, 'block')
        block_fits = True
    except ValueError:
        block_fits = False
    check(plan.form == 'large' and not block_fits, f'ff_fire at '
          f'{FIRE_LARGE_N} atoms: form {plan.form}, block form fits '
          f'{block_fits}')
    c, done, steps = ff_fire.ff_fire(x, terms, FIRE_LARGE_STEPS)
    c2, _, _ = ff_fire.ff_fire(x, terms, FIRE_LARGE_STEPS)
    # the plain twin (~10,000 launches a step) timed on its one run
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    cp, dp, sp = ff_fire.ff_fire_plain(x, terms, FIRE_LARGE_STEPS)
    stop.record()
    stop.synchronize()
    err = float((c - cp).abs().max())
    moved = float((c - x).abs().max())
    check(torch.equal(c, c2) and err <= FIRE_ATOL and torch.equal(done, dp)
          and torch.equal(steps, sp) and moved > 1e-3, f'ff_fire at '
          f'{FIRE_LARGE_N} atoms: {err:.2e} A from its plain twin, moved '
          f'{moved:.2e} A')
    ms = device_ms(lambda: ff_fire.ff_fire(x, terms, FIRE_LARGE_STEPS),
                   reps=3)
    # the same form with the coordinates left in device memory (the
    # form of structures past a block's copy): the same bits
    dm = plan._replace(staged=False, smem=0)
    c3, _, _ = ff_fire.launch(x, terms, FIRE_LARGE_STEPS, plan=dm)
    check(torch.equal(c3, c), f'ff_fire at {FIRE_LARGE_N} atoms: the '
          f'large form with its coordinates in device memory differs')
    device_memory_ms = device_ms(lambda: ff_fire.launch(
        x, terms, FIRE_LARGE_STEPS, plan=dm), reps=1)
    bound, by = ff_fire_bound(x, params, steps)
    rec = {'atoms': int(x.shape[1]), 'repulsion_pairs': kinds[2],
           'entries': entries, 'dtype': 'float64',
           'n_steps': FIRE_LARGE_STEPS, 'form': plan.form,
           'cluster': plan.cluster, 'force_evaluations': int(steps.sum()),
           'plain_diff_A': err, 'ms': ms,
           'us_per_step': ms * 1e3 / max(1, int(steps.max())),
           'coords_in_device_memory_ms': device_memory_ms,
           'plain_ms': start.elapsed_time(stop),
           'bound_ms': bound, 'bound_by': by,
           **ff_fire.kernel_info(plan, x.shape[1], x.dtype, x.device)}
    print(f'[13 ff_fire] {rec["atoms"]} atoms ({kinds[2]} repulsion pairs), '
          f'float64, {FIRE_LARGE_STEPS} steps: form large (a cluster of '
          f'{plan.cluster} blocks, the coordinates in each block\'s shared '
          f'memory) {ms:.4f} ms, {rec["us_per_step"]:.1f} us a step '
          f'({device_memory_ms:.4f} ms with them in device memory), '
          f'{rec["registers"]} registers a thread; plain twin '
          f'{rec["plain_ms"]:.1f} ms, bound {bound:.6f} ms ({by}); {err:.2e} '
          f'A from the plain twin, the same force evaluations; the block '
          f'form does not fit [{card}]')
    return rec


def phase_ff_fire(card):
    '''Phase 13: the force field and FIRE on the card. (a) ff_energy and
    its autograd gradient on FF_STRUCTS jittered structures of the merged
    three-molecule topology, card against CPU in float64. (b)
    fire_minimize_batch on phase 12's survivors for FIRE_STEPS steps,
    float64 and float32 (one launch of the force field's FIRE kernel
    each): no energy rises, stopped rows have their largest atomic force
    under fmax, and the float64 coordinates of FIRE_CPU_ROWS rows equal
    the CPU's. (c) The kernel against its plain twin and the graph path,
    timed and bounded, at the whole batch (FIRE_STEPS) and at one
    structure (a bend's call, BEND_FIRE_STEPS, on the survivor whose
    relaxation took the batch's median count of steps), in both types,
    in every form (fire_kernel_record). Then the graph path's step times,
    at the whole batch and at one structure; the forms' sweep over the
    batch size (fire_sweep) and over chain sizes (fire_size_sweep); a
    FIRE_LARGE_N-atom structure (fire_large_record). Returns the record;
    its `kernel` holds the
    float64 kernel records and `launches` the kernel's launches by the
    fire_minimize_batch calls.'''
    import torch
    from tscode_tpu_torch import optimizers as opt
    from tscode_tpu_torch.bending import BEND_FIRE_STEPS
    from tscode_tpu_torch.ff import ff_energy, params_to_device
    poses, ffp = trimol_topology()
    rng = np.random.default_rng(13)
    rec = {'card': card, 'survivors': len(poses), 'timing': [],
           'kernel': [], 'launches': 0}

    def energy_and_gradient(x, params):
        x = x.clone().requires_grad_(True)
        e = ff_energy(x, params)
        return e.detach(), torch.autograd.grad(e.sum(), x)[0]

    jit = torch.as_tensor(
        poses[:FF_STRUCTS] + rng.normal(size=poses[:FF_STRUCTS].shape)
        * FF_JITTER)
    e_cpu, g_cpu = energy_and_gradient(
        jit, params_to_device(ffp, 'cpu', torch.float64))
    p64 = params_to_device(ffp, DEV, torch.float64)
    e_gpu, g_gpu = energy_and_gradient(jit.to(DEV), p64)
    e_err = float((e_gpu.cpu() - e_cpu).abs().max() / e_cpu.abs().max())
    g_err = float((g_gpu.cpu() - g_cpu).abs().max() / g_cpu.abs().max())
    check(e_err <= FF_RTOL and g_err <= FF_RTOL, f'ff_energy card against '
          f'CPU: energy {e_err:.2e}, gradient {g_err:.2e} (relative)')
    print(f'[13 ff] {len(jit)} jittered structures of 15 atoms ('
          f'{len(ffp.bonds)} bonds, {len(ffp.angles)} angles, '
          f'{len(ffp.nb_pairs)} repulsion pairs), float64: energy within '
          f'{e_err:.2e} and gradient within {g_err:.2e} of the CPU '
          f'(relative to the largest; energies up to '
          f'{float(e_cpu.max()):.1f} kcal/mol)')
    rec.update(ff_energy_rel_err=e_err, ff_gradient_rel_err=g_err)

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split('.')[-1]
        params = params_to_device(ffp, DEV, dtype)
        x = torch.as_tensor(poses, dtype=dtype, device=DEV)
        e0 = ff_energy(x, params)
        with FireCalls() as calls:
            c, e1, done = opt.fire_minimize_batch(
                x, ff_energy, n_steps=FIRE_STEPS, energy_args=(params,))
            torch.cuda.synchronize()
        rec['launches'] += count_fire('13', f'FIRE {name}', calls.record())
        f = opt.forces(c, ff_energy, (params,))
        fmax = torch.linalg.norm(f, dim=-1).amax(dim=-1)
        slack = 1e-9 if dtype == torch.float64 else 1e-4
        check(bool(torch.isfinite(c).all()) and
              bool((e1 <= e0 + slack * (1 + e0.abs())).all()),
              f'FIRE {name}: an energy rose')
        check(bool((fmax[done] < 0.05 + slack).all()),
              f'FIRE {name}: a stopped row has force '
              f'{float(fmax[done].max()) if done.any() else 0}')
        line = f'[13 fire] {len(x)} survivors, {name}, {FIRE_STEPS} steps: ' \
            f'energy {float(e0.mean()):.3f} -> {float(e1.mean()):.3f} ' \
            f'kcal/mol (mean), {int(done.sum())} rows stopped, largest ' \
            f'force of a stopped row {float(fmax[done].max()) if done.any() else 0:.4f}'
        if dtype == torch.float64:
            rows = slice(0, FIRE_CPU_ROWS)
            c_cpu, _, done_cpu = opt.fire_minimize_batch(
                torch.as_tensor(poses[rows]), ff_energy, n_steps=FIRE_STEPS,
                energy_args=(params_to_device(ffp, 'cpu', dtype),))
            err = float((c[rows].cpu() - c_cpu).abs().max())
            check(err <= FIRE_ATOL and
                  torch.equal(done[rows].cpu(), done_cpu),
                  f'FIRE float64: card {err:.2e} A from the CPU on '
                  f'{FIRE_CPU_ROWS} rows')
            rec['fire_card_vs_cpu_A'] = err
            line += f'; {FIRE_CPU_ROWS} rows within {err:.2e} A of the ' \
                f'CPU, same rows stopped'
        print(line)
        rec[f'fire_{name}'] = {
            'e0_mean': float(e0.mean()), 'e1_mean': float(e1.mean()),
            'stopped': int(done.sum())}
        # one structure: a bend's call (BEND_FIRE_STEPS) on the survivor
        # whose relaxation in the batch took the median count of steps
        whole, steps = fire_kernel_record(card, 'whole batch', x, params,
                                          FIRE_STEPS)
        i = int(torch.argsort(steps)[len(steps) // 2])
        one, _ = fire_kernel_record(card, f'one structure (row {i})',
                                    x[i:i + 1], params, BEND_FIRE_STEPS)
        rec['kernel' if dtype == torch.float64 else 'kernel_f32'] = \
            [whole, one]
        profile = dtype == torch.float64     # the launches are the same
        rec['timing'].append(fire_timing(card, 'whole batch', x, params,
                                         profile))
        rec['timing'].append(fire_timing(card, 'one structure', x[:1],
                                         params, profile))
    rec['sweep'] = fire_sweep(card, poses, ffp)
    rec['size_sweep'] = fire_size_sweep(card)
    rec['large_n'] = fire_large_record(card)
    return rec


def recorded_bends():
    '''Patch bending.bend_molecule (and the monomolecular embed's own
    reference to it) so that every call that bends (no cache hit) is
    recorded: returns (records, undo). A record is (mol, conf, pivot,
    target, keywords, the result).'''
    from tscode_tpu_torch import bending
    from tscode_tpu_torch.embeds import monomolecular
    entry, records = bending.bend_molecule, []

    def spy(mol, conf, pivot, threshold, **kw):
        hit = bending.bend_key(mol, pivot, threshold, conf=conf) \
            in kw['cache']
        out = entry(mol, conf, pivot, threshold, **kw)
        if not hit:
            records.append((mol, conf, pivot, threshold, kw, out))
        return out

    def undo():
        bending.bend_molecule = monomolecular.bend_molecule = entry

    bending.bend_molecule = monomolecular.bend_molecule = spy
    return records, undo


def bends_on_cpu(tag, records):
    '''Every recorded bend run again on the CPU (float64, no cache) from
    the same molecule, pivot and target: the bent conformer within
    BEND_ATOL of the card's, the same pivots kept, the same verdict of
    the scramble check. Returns the largest coordinate difference.'''
    from tscode_tpu_torch import bending
    worst = 0.0
    for k, (mol, conf, pivot, target, kw, out) in enumerate(records):
        kw = dict(kw, cache=None, stats=None, logfunction=None, device='cpu')
        cpu = bending.bend_molecule(mol, conf, pivot, target, **kw)
        err = float(np.abs(cpu.atomcoords[conf]
                           - out.atomcoords[conf]).max())
        check(err <= BEND_ATOL and (cpu is mol) == (out is mol) and
              [p.index for p in cpu.pivots[conf]] ==
              [p.index for p in out.pivots[conf]],
              f'{tag}: bend {k} on the card lies {err:.2e} A from the CPU '
              f'run (reverted: {out is mol} / {cpu is mol})')
        worst = max(worst, err)
    return worst


def bend_split(tag, dtype, ce, secs, card):
    print(f'[{tag} {dtype}] embed split: blocks {ce["blocks_s"]:.4f} s, '
          f'bends {ce["bends_s"]:.4f} s ({ce["bends"]} bends, '
          f'{ce["bend_relaxations"]} FIRE calls, {ce["bend_hits"]} cache '
          f'hits, {ce["bend_reverts"]} reverts, {ce["groups"]} groups)'
          + (f', adjust {ce["adjust_s"]:.4f} s' if 'adjust_s' in ce else '')
          + f', screen {ce["screen_s"]:.4f} s, dedup {ce["dedup_s"]:.4f} s, '
          f'assemble {ce["assemble_s"]:.4f} s ({ce["blocks"]} blocks in '
          f'{ce["chunks"]} chunks); the bends are '
          f'{ce["bends_s"] / secs:.1%} of the run\'s {secs:.3f} s [{card}]')


def phase_bend_trimol_route(card):
    '''Phase 14: the non-rigid three-molecule route through the CLI on
    bench_suite's trimolecular input as written at BEND_TRI_CONFS (the
    bends on the internal force field in float64, the chained direction
    adjustment, the block sweep group by group with B1, BYPASS), float64
    (the JAX x64 bends and survivors) then float32 (the same bent
    molecules; the sweep held as phase 8 holds it), every bend run again
    on the CPU, and the sweep checked on its own group by group.
    Returns (K1 launches, largest disagreement, the bends' record).'''
    import tempfile
    import torch
    from tscode_tpu_torch import bending
    from tscode_tpu_torch.embeds import cyclical as cyc
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    k1 = 0
    ces, bends = {}, {}
    with tempfile.TemporaryDirectory(prefix='smoke_bend_') as tmp:
        inp = suite_input('trimolecular', tmp, BEND_TRI_CONFS)
        for dtype in ('float64', 'float32'):
            bends[dtype], undo = recorded_bends()
            try:
                report, frames, regimes, secs = run_cli(tmp, inp, dtype)
            finally:
                undo()
            ces[dtype] = ce = report['cyclical_embed']
            entry = report['clash_entry_launches']
            k1 += entry['clash_ok']
            count_fire('14', f'non-rigid trimolecular {dtype}',
                       report['fire'])
            check(report['fire']['calls']['registered'] ==
                  ce['bend_relaxations'], f'non-rigid trimolecular '
                  f'{dtype}: {report["fire"]} for '
                  f'{ce["bend_relaxations"]} bend relaxations')
            check(entry == {'clash_ok': 0,
                            'compenetration_mask_kernel': 0,
                            'torsion_clash_ok': 0,
                            'torsion_backoff': 0} and
                  report['b1_launches'] == ce['chunks'] >= ce['groups'] and
                  ce['sweep_kernel'] == 'B1',
                  f'non-rigid trimolecular {dtype}: launches {entry} '
                  f'{regimes}, B1 {report["b1_launches"]}, expected B1 once '
                  f'per chunk ({ce["chunks"]}) of {ce["groups"]} groups, no '
                  f'K1')
            check(report['final_structures'] == ce['survivors'] and
                  frames.shape == (min(ce['survivors'], 10000), 15, 3)
                  and bool(np.isfinite(frames).all())
                  and len(bends[dtype]) == ce['bends'],
                  f'non-rigid trimolecular {dtype}: .xyz holds '
                  f'{frames.shape}, final {report["final_structures"]}, '
                  f'{len(bends[dtype])} bends recorded')
            check(all(out.atomcoords.dtype == np.float64
                      for *_, out in bends[dtype]),
                  f'non-rigid trimolecular {dtype}: a bend left float64')
            print(f'[14 bend trimolecular {dtype}] {ce["blocks"]} blocks, '
                  f'{ce["candidates"]} candidates -> {ce["survivors"]} '
                  f'embedded in {secs:.3f} s; launches {entry}, B1 '
                  f'{report["b1_launches"]}; '
                  f'stages: {cli_stages(report)} [{card}]')
            bend_split('14 bend trimolecular', dtype, ce, secs, card)
        emb = embedder_setup(inp, torch.float64)
    got = {'bends': ces['float64']['bends'],
           'bend_reverts': ces['float64']['bend_reverts'],
           'bend_hits': ces['float64']['bend_hits'],
           'embedded': ces['float64']['survivors']}
    check(got == BEND_TRI_F64, f'non-rigid trimolecular f64 {got} != '
          f'{BEND_TRI_F64} (JAX x64)')
    # the float32 run bends in float64 too: the same molecules
    same = max(float(np.abs(a[-1].atomcoords - b[-1].atomcoords).max())
               for a, b in zip(bends['float64'], bends['float32']))
    check(len(bends['float32']) == len(bends['float64']) and same <= 1e-9,
          f'the float32 run\'s bent molecules lie {same:.2e} A from the '
          f'float64 run\'s')
    t0 = time.perf_counter()
    worst = bends_on_cpu('non-rigid trimolecular', bends['float64'])
    cpu_s = time.perf_counter() - t0
    n_relax = ces['float64']['bend_relaxations']
    print(f'[14 bend trimolecular] {got["bends"]} bends ({n_relax} FIRE '
          f'calls of {bending.BEND_FIRE_STEPS} steps), '
          f'{got["bend_reverts"]} reverts, {got["bend_hits"]} cache hits, '
          f'{got["embedded"]} embedded: the JAX x64 counts; bent '
          f'coordinates within {worst:.2e} A of the CPU\'s (the same bends '
          f'on the CPU: {cpu_s:.3f} s, on the card '
          f'{ces["float64"]["bends_s"]:.3f} s); the float32 run\'s bent '
          f'molecules within {same:.2e} A of the float64 run\'s [{card}]')

    # the sweep on its own, with the float64 run's bent molecules
    bent = {bending.bend_key(mol, pivot, target, conf=conf): out
            for mol, conf, pivot, target, _, out in bends['float64']}
    emb.log = lambda *a, **kw: None         # its log file is closed
    groups = cyc.nonrigid_rows(
        emb, 5, lambda mol, conf, pivot, target:
        bent[bending.bend_key(mol, pivot, target, conf=conf)])
    blks, _ = cyc.nonrigid_blocks(groups, torch.device(DEV))
    sweeps = [sweep_check(card, f'14 bend trimolecular group {i}', blk,
                          g['mols'], emb.systematic_angles)
              for i, (g, blk) in enumerate(zip(groups, blks))]
    sweep = {k: np.concatenate([s[k] for s in sweeps])
             for k in ('keep64', 'keep32', 'tie_poses', 'tie_kept',
                       'gate_tied', 'tied')}
    sweep['near'] = sum(s['near'] for s in sweeps)
    differ = hold_float32('14 bend trimolecular', sweep)
    slack = float32_slack(sweep, differ)[0]
    c64, c32 = (ces[d]['survivors'] for d in ('float64', 'float32'))
    check(len(groups) == ces['float64']['groups'] and
          int(sweep['keep64'].sum()) == c64 and
          int(sweep['keep32'].sum()) == c32 and abs(c32 - c64) <= slack,
          f'non-rigid trimolecular: the sweep on its own keeps '
          f'{int(sweep["keep64"].sum())} / {int(sweep["keep32"].sum())} in '
          f'{len(groups)} groups, the route {c64} / {c32} in '
          f'{ces["float64"]["groups"]} (float32 slack {slack})')
    rec = {d: {k: ces[d][k] for k in (
        'bends', 'bend_relaxations', 'bend_hits', 'bend_reverts', 'groups',
        'bends_s', 'blocks_s', 'adjust_s', 'screen_s', 'dedup_s',
        'assemble_s', 'chunks')} for d in ces}
    rec.update(cpu_bends_s=cpu_s, bent_vs_cpu_A=worst,
               b1_groups=[s['b1'] for s in sweeps])
    return k1, max(s['err'] for s in sweeps), rec


def card_against_cpu(tag, name, n_confs, atoms, key):
    '''One input through the CLI in float64 on the card and on the CPU:
    the same stage counts, the written structures within BEND_ATOL (the
    .xyz holds 6 decimals). Returns the card run's report.'''
    import tempfile
    out = {}
    for device in (DEV, 'cpu'):
        with tempfile.TemporaryDirectory(prefix='smoke_small_') as tmp:
            inp = suite_input(name, tmp, n_confs)
            out[device] = run_cli(tmp, inp, 'float64', device=device)
    (report, frames, _, secs), (report_cpu, frames_cpu, _, secs_cpu) = \
        out[DEV], out['cpu']
    check(stage_counts(report) == stage_counts(report_cpu) and
          frames.shape == frames_cpu.shape and frames.shape[1:] == (atoms, 3)
          and len(frames) > 0,
          f'{tag}: card stages {stage_counts(report)} frames '
          f'{frames.shape}, CPU {stage_counts(report_cpu)} '
          f'{frames_cpu.shape}')
    err = float(np.abs(frames - frames_cpu).max())
    check(err <= 2 * BEND_ATOL, f'{tag}: card structures {err:.2e} A from '
          f'the CPU run\'s')
    ce = report[key]
    print(f'[{tag}] float64: {" -> ".join(map(str, stage_counts(report)))} '
          f'on the card in {secs:.3f} s and on the CPU in {secs_cpu:.3f} s, '
          f'structures within {err:.2e} A; {ce["bends"]} bends, '
          f'{ce["bend_relaxations"]} FIRE calls, {ce["bend_reverts"]} '
          f'reverts; launches {report["clash_entry_launches"]}, B1 '
          f'{report["b1_launches"]}')
    return report


def phase_small_bend_routes(card):
    '''Phase 15: the non-rigid chelotropic input (phase 11's without
    RIGID) at CHEL_BEND_CONFS conformers, which launches K2 on a
    non-rigid route, and the monomolecular embed on MONO_CONFS
    conformers of C2F2H4, each in float64 on the card against the CPU.
    Returns (K1 launches, K2 launches); B1's go to B1_LAUNCHES.'''
    report = card_against_cpu('15 chelotropic non-rigid',
                              'chelotropic_nonrigid', CHEL_BEND_CONFS, 12,
                              'chelotropic_embed')
    count_fire('15', 'chelotropic non-rigid', report['fire'],
               launched=report['chelotropic_embed']['bend_relaxations'] > 0)
    entry = report['clash_entry_launches']
    check(entry == {'clash_ok': 0, 'compenetration_mask_kernel': 1,
                    'torsion_clash_ok': 0, 'torsion_backoff': 0},
          f'non-rigid chelotropic: launches {entry}')
    check_b1_route('15 chelotropic non-rigid', report,
                   report['chelotropic_embed'])
    mono = card_against_cpu('15 monomolecular', 'monomolecular', MONO_CONFS,
                            8, 'monomolecular_embed')
    count_fire('15', 'monomolecular', mono['fire'])
    check(mono['monomolecular_embed']['bends'] > 0 and
          mono['clash_entry_launches'] ==
          {'clash_ok': 0, 'compenetration_mask_kernel': 0,
           'torsion_clash_ok': 0, 'torsion_backoff': 0} and
          mono['b1_launches'] == 0,
          f'monomolecular: {mono["monomolecular_embed"]}, launches '
          f'{mono["clash_entry_launches"]}')
    return entry['clash_ok'], entry['compenetration_mask_kernel']


def recorded_searches():
    '''Patch torsions.csearch so that every search's conformers are
    recorded, one array per search: returns (records, undo).'''
    from tscode_tpu_torch import torsions
    entry, records = torsions.csearch, []

    def spy(*args, **kw):
        out = entry(*args, **kw)
        records.append(np.asarray(out))
        return out

    def undo():
        torsions.csearch = entry

    torsions.csearch = spy
    return records, undo


def recorded_backoff(calls):
    '''Patch the search's back-off entry so that every call on the card
    (its arguments, the tensors copied; one a torsion) is appended to
    `calls`; every call still launches the kernel, and calls on the CPU
    are not recorded. Returns undo.'''
    from tscode_tpu_torch import torsions
    entry = torsions.torsion_backoff

    def spy(coords, quad, move_mask, angles, other_mask, max_steps, *args,
            **kw):
        if coords.is_cuda:
            calls.append((coords.clone(), tuple(quad), np.array(move_mask),
                          angles.clone(), np.array(other_mask),
                          int(max_steps)))
        return entry(coords, quad, move_mask, angles, other_mask, max_steps,
                     *args, **kw)

    def undo():
        torsions.torsion_backoff = entry

    torsions.torsion_backoff = spy
    return undo


def searched_against(tag, searches, golden):
    '''Every search's conformers, in order, against the JAX x64 run's
    (an .npz of frames and sizes): the same counts and frames within
    SEARCH_ATOL. Returns the largest difference.'''
    ref = np.load(golden)
    sizes = [len(f) for f in searches]
    check(sizes == ref['sizes'].tolist(), f'{tag}: the searches kept '
          f'{sizes} conformers, the JAX x64 run {ref["sizes"].tolist()}')
    err = float(np.abs(np.concatenate(searches) - ref['frames']).max())
    check(err <= SEARCH_ATOL, f'{tag}: searched conformers {err:.2e} A '
          f'from the JAX x64 run\'s')
    return err


def same_searches(tag, a, b, atol):
    '''Two runs' searches: the same conformers within atol.'''
    check(len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b)),
          f'{tag}: {[x.shape for x in a]} against {[y.shape for y in b]}')
    err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    check(err <= atol, f'{tag}: searched conformers {err:.2e} A apart')
    return err


def search_split(tag, report, secs, card):
    '''Print the searches' counts and split (group, back-off, TFD prune,
    selection) and K1's launches by entry.'''
    cs = report['csearch']
    tot = {k: sum(r[k] for r in cs) for k in (
        'group_s', 'backoff_s', 'tfd_s', 'select_s', 'seconds')}
    print(f'[{tag}] {len(cs)} searches, {sum(r["candidates"] for r in cs)} '
          f'candidates ({[r["torsions"] for r in cs]} torsions, '
          f'{[r["conformers"] for r in cs]} kept) in {tot["seconds"]:.3f} s: '
          f'group {tot["group_s"]:.4f} s, back-off {tot["backoff_s"]:.4f} s, '
          f'TFD {tot["tfd_s"]:.4f} s, selection {tot["select_s"]:.4f} s; K1 '
          f'launches by entry {report["clash_entry_launches"]}; the run '
          f'{secs:.3f} s, stages: {cli_stages(report)} [{card}]')
    return tot


def phase_torsion_drive(card):
    '''Phase 16: bench_suite's torsion_drive through the CLI (csearch>
    on each of 4 conformers of C2F2H4, the back-off launching K1's entry
    torsion_clash_ok, then the monomolecular embed, which bends), in
    float64 on the card and on the CPU (the JAX x64 searched conformers,
    bends and stage counts; card within BEND_ATOL of the CPU), then in
    float32 on the card (the search and the bends are float64 always:
    the same conformers and bent molecules). The back-off entry
    torsion_backoff (one launch a torsion) is held against its plain
    twin on every back-off call of the float64 card run (a search's 3
    candidates) and timed on the first. Returns (K1 `clash_ok` launches,
    torsion_backoff launches, largest disagreement, the back-off's
    record).'''
    import tempfile
    searches, undo = recorded_searches()
    bends, undo_bends = recorded_bends()
    calls = []
    undo_calls = recorded_backoff(calls)
    try:
        report = card_against_cpu('16 torsion_drive', 'torsion_drive',
                                  DRIVE_CONFS, 8, 'monomolecular_embed')
    finally:
        undo()
        undo_bends()
        undo_calls()
    n = len(DRIVE_F64['searched'])
    check(len(searches) == 2 * n, f'torsion_drive: {len(searches)} '
          f'searches in the card and CPU runs, expected {2 * n}')
    err = searched_against('torsion_drive float64', searches[:n],
                           DRIVE_GOLDEN)
    cpu_err = same_searches('torsion_drive card against CPU', searches[:n],
                            searches[n:], 1e-9)
    me = report['monomolecular_embed']
    count_fire('16', 'torsion_drive float64', report['fire'])
    got = {'searched': [r['conformers'] for r in report['csearch']],
           'stages': stage_counts(report), 'bends': me['bends'],
           'bend_reverts': me['bend_reverts'], 'bend_hits': me['bend_hits']}
    check(got == DRIVE_F64, f'torsion_drive f64 {got} != {DRIVE_F64} '
          f'(JAX x64)')
    entry = report['clash_entry_launches']
    n_tors = sum(r['torsions'] for r in report['csearch'])
    check(entry == {'clash_ok': 0, 'compenetration_mask_kernel': 0,
                    'torsion_clash_ok': 0, 'torsion_backoff': n_tors},
          f'torsion_drive f64: launches {entry}, expected one '
          f'torsion_backoff a torsion ({n_tors})')
    tot = search_split('16 torsion_drive float64', report,
                       report['total_seconds'], card)
    check(len(calls) == entry['torsion_backoff'], f'torsion_drive: '
          f'{len(calls)} back-off calls recorded, {entry} launches')
    k1_err, rec = backoff_kernel_check('16', card, calls)
    rec.update(launches=entry['torsion_backoff'], backoff_s=tot['backoff_s'],
               search_s=tot['seconds'])

    with tempfile.TemporaryDirectory(prefix='smoke_drive_') as tmp:
        inp = suite_input('torsion_drive', tmp, DRIVE_CONFS)
        s32, undo = recorded_searches()
        b32, undo_bends = recorded_bends()
        try:
            report32, frames32, _, secs32 = run_cli(tmp, inp, 'float32')
        finally:
            undo()
            undo_bends()
    same_searches('torsion_drive float32 against float64', s32,
                  searches[:n], 1e-12)
    card_bends = bends[:len(bends) // 2]
    check(len(b32) == len(card_bends) and all(
        np.abs(a[-1].atomcoords - b[-1].atomcoords).max() <= 1e-9
        for a, b in zip(b32, card_bends)),
        f'torsion_drive float32: {len(b32)} bends, not the float64 run\'s '
        f'{len(card_bends)} bent molecules')
    check(stage_counts(report32) == DRIVE_F64['stages'] and
          frames32.shape == (DRIVE_F64['stages'][-1], 8, 3) and
          bool(np.isfinite(frames32).all()),
          f'torsion_drive float32: stages {stage_counts(report32)}, frames '
          f'{frames32.shape}')
    entry32 = report32['clash_entry_launches']
    count_fire('16', 'torsion_drive float32', report32['fire'])
    search_split('16 torsion_drive float32', report32, secs32, card)
    print(f'[16 torsion_drive] float64: searched {got["searched"]} '
          f'conformers within {err:.2e} A of the JAX x64 run\'s (card '
          f'against CPU {cpu_err:.2e} A), {got["bends"]} bends, stages '
          f'{got["stages"]}: the JAX x64 counts; float32: the same '
          f'conformers, bends and counts; the back-off {tot["backoff_s"]:.4f}'
          f' s of the search\'s {tot["seconds"]:.3f} s [{card}]')
    check(entry32['torsion_clash_ok'] == 0 and entry32['torsion_backoff']
          == n_tors, f'torsion_drive f32: launches {entry32}')
    return 0, entry['torsion_backoff'] + entry32['torsion_backoff'], \
        k1_err, rec


def backoff_kernel_check(phase, card, calls):
    '''The back-off entry torsion_backoff against its plain twin on the
    recorded calls (float64, the search's own tensors): frames
    and flags bit-equal off tie candidates (backoff_ties); the first call
    timed: the kernel alone (device_ms on the call's Rodrigues terms),
    the entry with its terms, and the plain twin (cuda_ms), against the
    bound of its bytes and its candidates' steps. Returns (largest
    disagreement, record).'''
    from tscode_tpu_torch.ops.kernels import clash
    err, n_tie, n_rot = 0, 0, 0
    for k, call in enumerate(calls):
        e, tie, _, rot, _ = backoff_compare(call, f'[{phase}] back-off call '
                                            f'{k}')
        err, n_tie, n_rot = max(err, e), n_tie + tie, n_rot + rot
    call = calls[0]
    coords, quad, move, angles, other, steps = call
    terms = clash.backoff_terms(coords, quad)
    ms = device_ms(lambda: clash.backoff_launch(coords, terms, move, angles,
                                                other, steps))
    entry_ms = device_ms(lambda: clash.torsion_backoff(*call))
    plain_ms = cuda_ms(lambda: clash.torsion_backoff_plain(*call))
    bound, by = backoff_bound(call, backoff_ties(call)[1])
    rec = {'candidates': coords.shape[0], 'N': coords.shape[1],
           'P': int(clash.torsion_pairs(move, other, coords.device)
                    .shape[0]),
           'max_steps': steps, 'dtype': 'float64', 'ms': ms,
           'entry_ms': entry_ms, 'plain_ms': plain_ms, 'bound_ms': bound,
           'bound_by': by, 'calls_checked': len(calls), 'tie_candidates':
           n_tie, 'rotated': n_rot}
    print(f'[{phase} back-off] torsion_backoff equal to its plain twin bit '
          f'for bit on {len(calls)} back-off calls ({n_tie} tie candidates '
          f'excluded, {n_rot} rotations); on {rec["candidates"]} x '
          f'{rec["N"]} float64, P = {rec["P"]}, {steps} steps: kernel '
          f'{ms:.4f} ms (device), with its terms {entry_ms:.4f} ms, plain '
          f'loop {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}) [{card}]')
    return err, rec


def recorded_tfd_prunes():
    """Patch the search's TFD prune (torsions.prune_conformers_tfd) so
    that each call records its input (structures and quadruplets,
    copied), its keep mask, T1's launches in the call, the passes it ran
    ((d, k, num_active, seconds to the end of its kernel) of each call of
    the pass entry), the seconds the
    card took to finish the work queued before the call (a synchronize
    on entry) and the call's own seconds. Returns (records, undo)."""
    import torch
    from tscode_tpu_torch import torsions
    from tscode_tpu_torch.ops import tfd
    from tscode_tpu_torch.ops.kernels import tfd as kt
    entry, pass_entry = torsions.prune_conformers_tfd, tfd.first_successor_pass
    records, passes = [], []

    def pass_spy(tf, d, k, num_active, thresh, rows=None):
        t0 = time.perf_counter()
        out = pass_entry(tf, d, k, num_active, thresh, rows)
        if out.is_cuda:
            torch.cuda.synchronize()
        passes.append((d, k, num_active, time.perf_counter() - t0, t0))
        return out

    def spy(structures, quadruplets, *args, **kw):
        n0 = kt.KERNEL.launches
        passes.clear()
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = entry(structures, quadruplets, *args, **kw)
        t2 = time.perf_counter()
        # the host's seconds before the first pass call (fingerprints),
        # after each pass call up to the next (its read and bookkeeping)
        starts = [p[4] for p in passes] + [t2]
        gaps = [starts[0] - t1] + [starts[i + 1] - p[4] - p[3]
                                   for i, p in enumerate(passes)]
        records.append({'structures': np.array(structures),
                        'quadruplets': np.array(quadruplets),
                        'keep': np.array(out[1]),
                        'launches': kt.KERNEL.launches - n0,
                        'passes': [p[:4] for p in passes],
                        'queued_s': t1 - t0, 'prune_s': t2 - t1,
                        'host_gaps_s': gaps})
        return out

    def undo():
        torsions.prune_conformers_tfd = entry
        tfd.first_successor_pass = pass_entry

    torsions.prune_conformers_tfd = spy
    tfd.first_successor_pass = pass_spy
    return records, undo


def tfd_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode('warn'): the number of
    synchronizing CUDA operations it made (host reads, uploads from
    pageable memory), and their distinct warning texts."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    texts = [str(w.message) for w in seen
             if 'called a synchronizing' in str(w.message)]
    return len(texts), sorted({t[:120] for t in texts})


def first_graph_s(edges):
    """Seconds of a fresh process's first networkx graph built from a
    two-edge `edges` ('set' or 'list'), networkx imported before: a set
    goes through networkx's type probes (which import pandas and scipy),
    a list is taken as an edge list at once."""
    code = ('import time, networkx as nx; t = time.perf_counter(); '
            f'nx.Graph({edges}([(0, 1), (2, 3)])); '
            'print(time.perf_counter() - t)')
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120)
    check(r.returncode == 0, f'first_graph_s({edges}): {r.stderr[-500:]}')
    return float(r.stdout.strip())


def tfd_timed_prune(structures, quads, pass_fn):
    """prune_conformers_tfd on the card (float64, as the search runs it)
    with the pass entry replaced by pass_fn, timed: (keep, passes
    [(tf, d, k, num_active, first numpy)], split seconds: fingerprints,
    the pass calls up to their kernels' end, the reads, the rest (the
    networkx bookkeeping), the whole prune). The pass's result is read
    inside the timed call, so the prune's own read is a no-op."""
    import torch
    from tscode_tpu_torch.ops import tfd
    fp_entry, pass_entry = tfd.torsion_fingerprints, tfd.first_successor_pass
    passes, t = [], dict.fromkeys(('fingerprints_s', 'pass_s', 'read_s'), 0.0)

    def fp_spy(coords, q):
        t0 = time.perf_counter()
        out = fp_entry(coords, q)
        torch.cuda.synchronize()
        t['fingerprints_s'] += time.perf_counter() - t0
        return out

    def pass_spy(tf, d, k, num_active, thresh, rows=None):
        t0 = time.perf_counter()
        out = pass_fn(tf, d, k, num_active, thresh, rows)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = out.cpu()
        t['pass_s'] += t1 - t0
        t['read_s'] += time.perf_counter() - t1
        passes.append((tf, d, k, num_active, host.numpy()))
        return host

    tfd.torsion_fingerprints, tfd.first_successor_pass = fp_spy, pass_spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, keep = tfd.prune_conformers_tfd(structures, quads, device=DEV)
        t['prune_s'] = time.perf_counter() - t0
    finally:
        tfd.torsion_fingerprints, tfd.first_successor_pass = fp_entry, \
            pass_entry
    t['bookkeeping_s'] = t['prune_s'] - t['fingerprints_s'] - t['pass_s'] - \
        t['read_s']
    return keep, passes, t


def tfd_prune_check(phase, card, rec):
    """T1 on the search's own TFD prune input (`rec`, recorded from the
    float64 CLI run): the prune again on the card, its mask the CLI's;
    one launch and one host read a pass (the reads counted under the
    sync debug mode, with the fingerprints handed over: one upload);
    every pass's first array against the plain twin on the same card
    tensor (the old per-chunk tile loop) and T1's first design
    (first_successor_pass_warp), identical, and T1 on one window and
    unstaged; each pass timed (device_ms, T1 and its first design in
    turns, T1, first design, T1, first design, and each other plan; the
    twin with cuda_ms) and bounded from its walked pairs
    (TFD_TORSION_OPS an f64 instruction each, and the first count beside
    it);
    the prune's seconds split (fingerprints, T1, reads, bookkeeping), and
    the whole prune with the old tile loop as the pass entry, the same
    run's yardstick (new, old, new). Returns (largest disagreement,
    record)."""
    import torch
    from tscode_tpu_torch.ops import tfd
    from tscode_tpu_torch.ops.kernels import tfd as kt
    structures, quads = rec['structures'], rec['quadruplets']
    kt.KERNEL.reset_counts()
    keep, passes, split = tfd_timed_prune(structures, quads,
                                          kt.first_successor_pass)
    launches = kt.KERNEL.launches
    check(np.array_equal(keep, rec['keep']) and launches == len(passes) ==
          rec['launches'] == SEARCH_TFD_PASSES,
          f'[{phase} T1] the prune again: {launches} launches, '
          f'{len(passes)} passes (the CLI run {rec["launches"]}, expected '
          f'{SEARCH_TFD_PASSES}), mask equal {np.array_equal(keep, rec["keep"])}')
    # host reads: the synchronizing operations of the prune (given its
    # fingerprints) less those of the same prune whose pass entry hands
    # back the recorded first arrays, already on the host
    fps = passes[0][0].cpu().numpy()
    syncs, texts = tfd_syncs(lambda: tfd.prune_conformers_tfd(
        structures, quads, tf_mat=fps, device=DEV))
    recorded = {p[2]: torch.from_numpy(p[-1]) for p in passes}
    real = tfd.first_successor_pass
    tfd.first_successor_pass = lambda tf, d, k, *a, **kw: recorded[k]
    try:
        base, base_texts = tfd_syncs(lambda: tfd.prune_conformers_tfd(
            structures, quads, tf_mat=fps, device=DEV))
    finally:
        tfd.first_successor_pass = real
    reads = syncs - base
    check(reads == len(passes), f'[{phase} T1] {syncs} synchronizing '
          f'operations in a prune of {len(passes)} passes, {base} without '
          f'its pass calls: expected one read a pass ({texts}; {base_texts})')
    n, Q = fps.shape
    rows, err = [], 0
    for tf, d, k, m, first in passes:
        twin = kt.first_successor_pass_plain(tf, d, k, m, TFD_THRESH)
        twin = twin.cpu().numpy()
        again = kt.first_successor_pass(tf, d, k, m, TFD_THRESH).cpu().numpy()
        warp = kt.first_successor_pass_warp(tf, d, k, m,
                                            TFD_THRESH).cpu().numpy()
        by_plan = {'staged': kt.first_successor_pass(
            tf, d, k, m, TFD_THRESH,
            plan=kt.launch_plan(Q)).cpu().numpy()}
        by_plan['one window'] = kt.first_successor_pass(
            tf, d, k, m, TFD_THRESH,
            plan=kt.launch_plan(Q, segment=0)).cpu().numpy()
        by_plan['unstaged'] = kt.first_successor_pass(
            tf, d, k, m, TFD_THRESH,
            plan=kt.launch_plan(Q, tile=0)).cpu().numpy()
        err = max([err] + [int(np.abs(a.astype(np.int64) - first).max())
                           for a in (twin, again, warp, *by_plan.values())])
        check(all(np.array_equal(a, first) for a in
                  (twin, again, warp, *by_plan.values())),
              f'[{phase} T1] pass k = {k}: the kernel\'s first array differs '
              f'from its plain twin\'s or the first design\'s')
        walked = kt.walked_pairs(first, d, k, m)
        nbytes = n * Q * 4 + n * 4
        b_ops = walked * Q * TFD_TORSION_OPS / F64_INSTR_PER_S * 1e3
        b_first = walked * Q * TFD_FIRST_FLOPS / PEAK_FLOPS['float64'] * 1e3
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        runs = {'ms': [], 'warp_ms': []}
        for _ in range(2):
            runs['ms'].append(device_ms(lambda: kt.first_successor_pass(
                tf, d, k, m, TFD_THRESH)))
            runs['warp_ms'].append(device_ms(
                lambda: kt.first_successor_pass_warp(tf, d, k, m,
                                                     TFD_THRESH)))
        rows.append({
            'k': k, 'd': d, 'num_active': m,
            'chunks': len(list(kt.pass_chunks(d, k, m))),
            'hits': int((first >= 0).sum()), 'walked_pairs': walked,
            'ms': sum(runs['ms']) / 2, 'ms_runs': runs['ms'],
            'warp_ms': sum(runs['warp_ms']) / 2,
            'warp_ms_runs': runs['warp_ms'],
            'plan': kt.pass_plan(Q, d, k, m),
            'windows': kt.windows(kt.pass_plan(Q, d, k, m), d, k, m)[1],
            'staged_ms': device_ms(lambda: kt.first_successor_pass(
                tf, d, k, m, TFD_THRESH, plan=kt.launch_plan(Q))),
            'one_window_ms': device_ms(lambda: kt.first_successor_pass(
                tf, d, k, m, TFD_THRESH,
                plan=kt.launch_plan(Q, segment=0))),
            'unstaged_ms': device_ms(lambda: kt.first_successor_pass(
                tf, d, k, m, TFD_THRESH, plan=kt.launch_plan(Q, tile=0))),
            'plain_ms': cuda_ms(lambda: kt.first_successor_pass_plain(
                tf, d, k, m, TFD_THRESH), reps=1),
            'bound_ms': max(b_ops, b_bytes),
            'bound_by': 'operations' if b_ops >= b_bytes else 'bytes',
            'first_count_bound_ms': max(b_first, b_bytes),
            'launches': 1, 'ops_ms': b_ops, 'bytes_ms': b_bytes})
    for r in rows:
        print(f'[{phase} T1] pass k = {r["k"]}: {r["num_active"]} active, '
              f'{r["chunks"]} chunks, {r["hits"]} hits, {r["walked_pairs"]} '
              f'pairs walked; kernel {r["ms"]:.4f} ms (device; runs '
              f'{r["ms_runs"]}, tile {r["plan"]["tile"]}, {r["windows"]} '
              f'windows; staged {r["staged_ms"]:.4f}, one window '
              f'{r["one_window_ms"]:.4f}, unstaged {r["unstaged_ms"]:.4f}), '
              f'T1\'s first design '
              f'{r["warp_ms"]:.4f} ms (runs {r["warp_ms_runs"]}); plain twin (the tile loop) {r["plain_ms"]:.4f} ms, '
              f'bound {r["bound_ms"]:.6f} ms ({r["bound_by"]}; the first '
              f'count {r["first_count_bound_ms"]:.6f}), {r["launches"]} '
              f'launch '
              f'[{card}]')
    _, old_passes, old = tfd_timed_prune(structures, quads,
                                         kt.first_successor_pass_plain)
    check(len(old_passes) == len(passes) and all(
        np.array_equal(a[-1], b[-1]) for a, b in zip(old_passes, passes)),
        f'[{phase} T1] the tile loop as the pass entry ran other passes')
    _, _, split2 = tfd_timed_prune(structures, quads, kt.first_successor_pass)
    best = min((split, split2), key=lambda t: t['prune_s'])
    tot = {key: sum(r[key] for r in rows) for key in
           ('ms', 'warp_ms', 'plain_ms', 'bound_ms', 'first_count_bound_ms',
            'walked_pairs')}
    out = {'rows': n, 'torsions': Q, 'passes': rows, 'launches': launches,
           'host_reads': reads, 'ms': tot['ms'], 'warp_ms': tot['warp_ms'],
           'plain_ms': tot['plain_ms'], 'bound_ms': tot['bound_ms'],
           'first_count_bound_ms': tot['first_count_bound_ms'],
           'bound_by': 'operations' if sum(r['ops_ms'] for r in rows) >=
           sum(r['bytes_ms'] for r in rows) else 'bytes',
           'walked_pairs': tot['walked_pairs'], 'split': best,
           'prune_s_runs': [split['prune_s'], split2['prune_s']],
           'tile_loop_split': old, 'max_abs_err': err,
           'kept': int(keep.sum()), 'cli_prune_s': rec['prune_s'],
           'cli_queued_s': rec['queued_s'],
           'cli_host_gaps_s': rec['host_gaps_s'],
           'first_graph_s': {e: first_graph_s(e) for e in ('set', 'list')}}
    print(f'[{phase} T1] the search\'s TFD prune, {n} x {Q} float32 '
          f'fingerprints -> {out["kept"]} kept: {launches} T1 launches and '
          f'{out["host_reads"]} host reads for {len(passes)} passes; every '
          f'first array equal to the plain twin\'s and the first design\'s; '
          f'T1 {tot["ms"]:.4f} ms (device, all passes), T1\'s first design '
          f'{tot["warp_ms"]:.4f} ms, plain twin {tot["plain_ms"]:.1f} ms, '
          f'bound {tot["bound_ms"]:.6f} ms over {tot["walked_pairs"]} pairs '
          f'(the first count {tot["first_count_bound_ms"]:.6f}); the '
          f'prune {split["prune_s"]:.4f} / {split2["prune_s"]:.4f} s '
          f'(fingerprints {best["fingerprints_s"]:.4f}, T1 calls '
          f'{best["pass_s"]:.4f}, reads {best["read_s"]:.4f}, bookkeeping '
          f'{best["bookkeeping_s"]:.4f}); with the tile loop '
          f'{old["prune_s"]:.4f} s (its calls and reads '
          f'{old["pass_s"] + old["read_s"]:.4f}, bookkeeping '
          f'{old["bookkeeping_s"]:.4f}); in the CLI run the prune took '
          f'{rec["prune_s"]:.4f} s after {rec["queued_s"]:.4f} s of queued '
          f'device work; a fresh process\'s first networkx graph from a set '
          f'{out["first_graph_s"]["set"]:.4f} s, from a list (as the prune '
          f'builds it) {out["first_graph_s"]["list"]:.4f} s [{card}]')
    return err, out


def search_string_replay(inp):
    '''The float64 string grid of csearch_string on the card (the
    searched chain set up again from the same seed): the poses within
    1e-9 A^2 (listed) and CLASH_TIE (counted) of the clash threshold, the
    collinear quadruplets and the novelty replay of the clash survivors
    without them.'''
    import torch
    from tscode_tpu_torch.embeds.string import bcast_tiles
    from tscode_tpu_torch.ops.tfd import (tfd_novelty_device,
                                          torsion_end_sines,
                                          torsion_fingerprints)
    grid, angles, quads = string_setup(inp, torch.float64)
    near, n_tie, lo, kept = [], 0, 0, []
    for poses, ok in bcast_tiles(grid, angles, CLASH):
        off = clash_offsets(poses, grid.pairs)
        near += (lo + torch.nonzero(off < 1e-9).squeeze(1)).tolist()
        n_tie += int((off < CLASH_TIE).sum())
        lo += poses.shape[0]
        kept.append(poses[ok])
    survivors = torch.cat(kept)
    col = (torsion_end_sines(survivors, quads) <= COLLINEAR_SINE) \
        .any(dim=0).cpu().numpy()
    fps = torsion_fingerprints(survivors, np.asarray(quads)[~col])
    novel, lane_ok = tfd_novelty_device(fps.contiguous(), thresh=TFD_THRESH,
                                        cache_cap=fps.shape[0])
    check(lane_ok, 'csearch_string replay: the device novelty lane refused')
    return (near, n_tie, survivors.shape[0],
            np.asarray(quads)[col].tolist(), int(novel.sum()))


def phase_search_string(card):
    '''Phase 17: csearch_string through the CLI at SEARCH_CONFS, float64
    then float32: the search of the C10H21Cl chain (6,561 candidates,
    eight torsions' back-off with K1's entry torsion_backoff, one launch
    a torsion, the TFD prune, the seeded draw of 1,000) equal to the JAX
    x64 run's frame for frame, then the string embed against C2H4 (K1
    `clash_ok`) held to the JAX x64 counts by phase 7's rule for its
    collinear quadruplet; the back-off entry checked and timed on the
    search's own tensors; T1, the TFD prune's search, one launch and one
    host read a pass of the search's prune, held against its plain twin
    on every pass of the float64 run's prune input and timed
    (tfd_prune_check). Returns (K1 `clash_ok` launches,
    torsion_backoff launches, largest disagreement, the back-off's
    record, T1's record).'''
    import tempfile
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    counts, searches, entries, splits, calls = {}, {}, {}, {}, []
    prunes, t1_runs = {}, {}
    with tempfile.TemporaryDirectory(prefix='smoke_search_') as tmp:
        inp = suite_input('csearch_string', tmp, SEARCH_CONFS)
        for dtype in ('float64', 'float32'):
            searches[dtype], undo = recorded_searches()
            prunes[dtype], undo_prunes = recorded_tfd_prunes()
            undo_calls = recorded_backoff(calls) if dtype == 'float64' \
                else (lambda: None)
            try:
                report, frames, regimes, secs = run_cli(tmp, inp, dtype)
            finally:
                undo()
                undo_prunes()
                undo_calls()
            t1_runs[dtype] = report['tfd_launches']
            check(prunes[dtype] and prunes[dtype][0]['launches'] ==
                  len(prunes[dtype][0]['passes']) == SEARCH_TFD_PASSES,
                  f'csearch_string {dtype}: the search\'s TFD prune made '
                  f'{[(r["launches"], len(r["passes"])) for r in prunes[dtype]]}'
                  f' (T1 launches, passes), expected {SEARCH_TFD_PASSES} each')
            print(f'[17 T1] csearch_string {dtype}: the search\'s TFD prune '
                  f'{prunes[dtype][0]["prune_s"]:.4f} s after '
                  f'{prunes[dtype][0]["queued_s"]:.4f} s of queued device '
                  f'work; {prunes[dtype][0]["launches"]} T1 launches, the pass '
                  f'calls {[round(p[3], 5) for p in prunes[dtype][0]["passes"]]}'
                  f' s, the host before the first and after each '
                  f'{[round(g, 4) for g in prunes[dtype][0]["host_gaps_s"]]} s;'
                  f' the run\'s TFD prunes '
                  f'{[round(r["prune_s"], 4) for r in prunes[dtype]]} s [{card}]')
            se, cs = report['string_embed'], report['csearch']
            counts[dtype] = c = (se['candidates'], se['clash_ok'],
                                 se['novel'], report['final_structures'])
            entries[dtype] = entry = report['clash_entry_launches']
            check(len(cs) == 1 and cs[0]['candidates'] == SEARCH_CANDIDATES
                  and cs[0]['torsions'] == 8 and
                  entry['torsion_backoff'] == 8 and entry['clash_ok'] > 0
                  and entry['torsion_clash_ok'] == 0
                  and entry['compenetration_mask_kernel'] == 0,
                  f'csearch_string {dtype}: searches {cs}, launches {entry}')
            check(frames.shape == (c[3], 38, 3) and
                  bool(np.isfinite(frames).all()),
                  f'csearch_string {dtype}: .xyz holds {frames.shape}, '
                  f'expected ({c[3]}, 38, 3) finite')
            splits[dtype] = search_split(f'17 csearch_string {dtype}', report,
                                         secs, card)
            print(f'[17 csearch_string {dtype}] {" -> ".join(map(str, c))} '
                  f'(candidates -> clash-ok -> novel -> final), clash '
                  f'launches {regimes}, novelty lane {se["tfd_lane"]}; embed '
                  f'split: sweep {se["sweep_s"]:.4f} s, compaction '
                  f'{se["compaction_s"]:.4f} s, novelty {se["novelty_s"]:.4f}'
                  f' s, pull {se["pull_s"]:.4f} s [{card}]')
        near, n_tie, n_ok, collinear, n_novel = search_string_replay(inp)
    err = searched_against('csearch_string float64', searches['float64'],
                           SEARCH_GOLDEN)
    same_searches('csearch_string float32 against float64',
                  searches['float32'], searches['float64'], 1e-12)
    c64, c32 = counts['float64'], counts['float32']
    check(c64[0] == c32[0] == SEARCH_F64[0], f'csearch_string candidates '
          f'{c64[0]}, {c32[0]} != {SEARCH_F64[0]}')
    check(n_ok == c64[1] and abs(c64[1] - SEARCH_F64[1]) <= len(near),
          f'csearch_string f64 clash-ok {c64[1]} (replay {n_ok}) != '
          f'{SEARCH_F64[1]} beyond {len(near)} poses within 1e-9 A^2')
    check(abs(c32[1] - c64[1]) <= n_tie, f'csearch_string f32 clash-ok '
          f'{c32[1]} outside {c64[1]} +- {n_tie}')
    check(collinear == SEARCH_COLLINEAR, f'csearch_string: collinear '
          f'quadruplets {collinear}, expected {SEARCH_COLLINEAR}')
    check(n_novel == SEARCH_DROPPED_NOVEL, f'csearch_string replay without '
          f'the collinear quadruplet: {n_novel} novel, JAX x64 gives '
          f'{SEARCH_DROPPED_NOVEL}')
    for dtype, c in counts.items():
        for k, what in ((2, 'novel'), (3, 'final')):
            lo, hi = bracket(SEARCH_F64[k], LARGE_SLACK)
            check(lo <= c[k] <= hi, f'csearch_string {dtype} {what} {c[k]} '
                  f'outside {(lo, hi)}')
    k1_err, rec = backoff_kernel_check('17', card, calls)
    _, t1 = tfd_prune_check('17', card, prunes['float64'][0])
    t1.update(cli_launches=t1_runs, tfd_s={d: splits[d]['tfd_s'] for d in
                                           splits},
              search_s={d: splits[d]['seconds'] for d in splits})
    rec.update(launches=entries['float64']['torsion_backoff'],
               backoff_s=splits['float64']['backoff_s'],
               search_s=splits['float64']['seconds'],
               backoff_s_step_loop=STEP_LOOP_BACKOFF_S)
    print(f'[17 csearch_string] gates held: the searched 1,000 conformers '
          f'within {err:.2e} A of the JAX x64 run\'s, in order (float32 the '
          f'same); candidates {SEARCH_F64[0]}, clash-ok {c64[1]} (JAX '
          f'{SEARCH_F64[1]}; {len(near)} poses within 1e-9 A^2, {n_tie} '
          f'within {CLASH_TIE} A^2), f32 clash-ok {c32[1]}; novel and final '
          f'within {LARGE_SLACK:.0%} of {SEARCH_F64[2]} and {SEARCH_F64[3]}; '
          f'replay without {SEARCH_COLLINEAR[0]} {n_novel} == '
          f'{SEARCH_DROPPED_NOVEL}; the back-off: {rec["launches"]} '
          f'torsion_backoff launches, {rec["backoff_s"]:.4f} s (a K1 '
          f'launch a retreat step: {STEP_LOOP_BACKOFF_S} s), kernel device '
          f'time ~{rec["launches"] * rec["ms"]:.3f} ms of it [{card}]')
    print(f'[17 csearch_string] T1: {SEARCH_TFD_PASSES} launches and '
          f'reads in each run\'s search prune, {t1_runs} in the runs; TFD '
          f'prune {t1["tfd_s"]["float64"]:.4f} s (float64), '
          f'{t1["tfd_s"]["float32"]:.4f} s (float32) [{card}]')
    return (sum(e['clash_ok'] for e in entries.values()),
            sum(e['torsion_backoff'] for e in entries.values()),
            k1_err, rec, t1)


def golden_record(path):
    '''A force-field route's JAX x64 record as ff_records gives it, from
    its .npz (counts as JSON under `record`, the arrays beside them).'''
    g = np.load(path)
    rec = json.loads(str(g['record']))
    rec['arrays'] = {k: g[k] for k in g.files if k != 'record'}
    return rec


def held_records(what, got, want):
    '''ff_records records equal in every count and index, arrays within
    ff_records.FF_ATOL: the largest array difference, or a failure.'''
    from tscode_tpu_torch import ff_records
    try:
        return ff_records.same_records(got, want)
    except AssertionError as e:
        raise SmokeFailure(f'{what}: {e}') from e


def scan_ties(rec, tie=SCAN_TIE):
    '''Energies of a dihedral-scan record within `tie` kcal/mol of a
    decision: of the peak window (e_min + 5, e_min + 75), of a
    neighbour or window comparison of the peak rule, and, in the
    accurate re-scans, of the ad libitum stop (crest - last > 1, last <
    first, last - min > 50) at every length from 20 points.'''
    e, sizes, peaks = (rec['arrays']['sweep_energies'], rec['sweeps'],
                       rec['peaks'])
    near = 0
    i = pos = 0
    while i < len(sizes):
        n_acc = len(peaks[i])
        sweeps = []
        for size in sizes[i:i + 1 + n_acc]:
            sweeps.append(e[pos:pos + size])
            pos += size
        e_min = sweeps[0].min()
        for m, sw in enumerate(sweeps):
            gaps = [sw - e_min - 5.0, sw - e_min - 75.0, np.diff(sw),
                    sw[2:] - sw[:-2], sw[-1:] - sw[:1]]
            if m:
                for k in range(20, len(sw) + 1):
                    pre = sw[:k]
                    gaps.append(np.array([pre.max() - pre[-1] - 1.0,
                                          pre[-1] - pre[0],
                                          pre[-1] - pre.min() - 50.0]))
            near += int(sum(np.sum(np.abs(g) < tie) for g in gaps))
        i += 1 + n_acc
    return near


def once_ms(fn):
    '''(fn(), its milliseconds: CUDA events around one call, host enqueue
    included): for calls too slow to repeat (the plain twins, D1 on a
    chain past shared memory).'''
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def ff_term_flops(params):
    '''The operations of one evaluation of every term of the force field
    `params` (FF_TERM_FLOPS).'''
    nb, na, npairs = (int(params[k].shape[0]) for k in (0, 2, 4))
    nd = int(params[6].shape[0]) if len(params) > 6 else 0
    return FF_TERM_FLOPS['pair'] * (nb + npairs) + \
        FF_TERM_FLOPS['angle'] * na + FF_TERM_FLOPS['dihedral'] * nd


def bound_of(ops, nbytes, dtype='float64'):
    '''(ms, 'operations' or 'bytes'): the larger of ops at the card's
    peak for `dtype` and nbytes at its memory rate.'''
    ops_ms = ops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms \
        else (bytes_ms, 'bytes')


def dimer_bound(x, params, steps):
    '''(ms, 'operations' or 'bytes'): the least time of D1's function on
    x (B, N, 3) under the force field `params`, the larger of its
    operations over the card's peak for the type (each step 37 force
    evaluations, each term once an evaluation (FF_TERM_FLOPS), and
    DIMER_ATOM_FLOPS an atom for each of the 19 evaluations whose forces
    feed the vector algebra; times the steps this run's structures took)
    and its bytes over the memory rate (coordinates read and written
    once, the initial mode read once, the flags and steps written, the
    tables read once).'''
    per_step = 37 * ff_term_flops(params) + \
        19 * DIMER_ATOM_FLOPS * x.shape[1]
    nbytes = (2 * x.numel() + x[0].numel()) * x.element_size() + \
        5 * x.shape[0] + sum(t.numel() * t.element_size() for t in params)
    return bound_of(per_step * int(steps.sum()), nbytes,
                    str(x.dtype).split('.')[-1])


def dimer_inputs(tmp):
    '''D1's inputs of DIMER_CASES, float64 on the card: name -> (coords
    (1, N, 3), the force field's tables (params_to_device), ff.FireTerms
    of them).'''
    import torch
    from tscode_tpu_torch.ff import build_ff_params, ff_energy, \
        params_to_device
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.suite_inputs import chain_ff, chlorocycloalkane

    def case(x, params):
        p = params_to_device(params, DEV, torch.float64)
        return (torch.as_tensor(x, dtype=torch.float64, device=DEV)[None], p,
                ff_energy.fire_terms(p))
    guess = golden_record(DSCAN_GOLDEN)['arrays']['saddle_guess'][0]
    _, ring_nos = chlorocycloalkane(DSCAN_RING)
    ens = read_xyz(os.path.join(os.path.dirname(
        suite_input('monomolecular', tmp, MONO_CONFS)), 'm1.xyz'))
    mono, mono_nos = np.asarray(ens.atomcoords)[0], np.asarray(ens.atomnos)
    inputs = {
        'scan_guess': case(guess, build_ff_params(
            guess, ring_nos, graphize(guess, ring_nos))),
        'saddle_c2f2h4': case(mono, build_ff_params(
            mono, mono_nos, graphize(mono, mono_nos)))}
    for n in (150, 2500):
        X, ffp = chain_ff(n, 1, seed=13)
        inputs[f'chain{n}'] = case(X[0], ffp)
    return inputs


def dimer_eval_ms(x, terms, steps=200):
    '''The least device time of one force evaluation of x (1, N, 3) on
    the card: F1 (ops/kernels/ff_fire, the rule's form) a step, with
    fmax 0 so that no step stops it (one evaluation, its reductions and
    the FIRE update a step).'''
    from tscode_tpu_torch.ops.kernels import ff_fire
    reps = 1 if x.shape[1] > 1000 else 3
    return device_ms(lambda: ff_fire.launch(x, terms, steps, fmax=0.0),
                     reps=reps) / steps


def dimer_forms(card, name, x, params, terms, n, want, plans=None):
    '''D1 on x (1, N, 3) for n steps in every form that fits (or in each
    Plan of `plans`): two launches the same bits, within FF_ATOL of the
    plain twin's `want` (coords, done, steps) with the same flag and
    steps; device ms (behind a sleep kernel), us a step, registers,
    resident warps, whether its bits equal the first form's; the bound
    (dimer_bound) and the latency figure (DIMER_CHAIN dependent Hessian
    actions a step at dimer_eval_ms each). Prints a line a form; returns
    {label: record}.'''
    import torch
    from tscode_tpu_torch.ff_records import FF_ATOL
    from tscode_tpu_torch.ops.kernels import dimer
    if plans is None:
        plans = {}
        for form in dimer.FORMS:
            try:
                plans[form] = dimer.plan_for(x, terms, form)
            except ValueError:
                pass
    pc, pdone, psteps = want
    bound, by = dimer_bound(x, params, psteps)
    eval_ms = dimer_eval_ms(x, terms)
    latency = DIMER_CHAIN * eval_ms * int(psteps.max())
    recs, first = {}, None
    for label, plan in plans.items():
        got = dimer.launch(x, terms, n, plan=plan)
        again = dimer.launch(x, terms, n, plan=plan)
        err = float((got[0] - pc).abs().max())
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        check(repeat and err <= FF_ATOL and torch.equal(got[1], pdone) and
              torch.equal(got[2], psteps), f'D1 {name} {label} ({plan}): '
              f'{err:.2e} A from its plain twin, done {got[1].tolist()} / '
              f'{pdone.tolist()}, steps {got[2].tolist()} / '
              f'{psteps.tolist()}, two launches the same bits {repeat}')
        if first is None:
            first = got[0]
        ms = device_ms(lambda: dimer.launch(x, terms, n, plan=plan),
                       reps=1 if x.shape[1] > 1000 else 3)
        rec = {'form': plan.form, 'threads': plan.threads,
               'smem': plan.smem, 'warps': plan.warps,
               'cluster': plan.cluster, 'lanes': plan.lanes,
               'shared': plan.shared, 'ms': ms,
               'us_per_step': ms * 1e3 / int(psteps.max()),
               'plain_diff_A': err, 'bits_as_first': torch.equal(got[0], first),
               'bound_ms': bound, 'bound_by': by, 'latency_ms': latency,
               **dimer.kernel_info(plan, x.dtype, x.device)}
        recs[label] = rec
        print(f'[18 dimer] {name} ({x.shape[1]} atoms, {int(psteps.max())} '
              f'steps) {label}: {ms:.4f} ms, {rec["us_per_step"]:.2f} us a '
              f'step ({plan.threads} threads, {plan.smem} shared bytes, '
              f'{rec["registers"]} registers, {rec["local_bytes"]} local '
              f'bytes, {rec["resident_warps"]} resident warps); {err:.2e} A '
              f'from the twin, bits as {next(iter(plans))} '
              f'{rec["bits_as_first"]}; bound {bound:.6f} ms ({by}), latency '
              f'figure {latency:.4f} ms ({DIMER_CHAIN} actions a step x '
              f'{eval_ms * 1e3:.2f} us, F1\'s evaluation) [{card}]')
    return recs


def dimer_case_record(card, name, x, params, terms, n):
    '''One of DIMER_CASES past the scan's guess: the plain twin (its one
    run timed) and dimer_forms. Returns the record.'''
    from tscode_tpu_torch.ops.kernels import dimer
    want, plain_ms = once_ms(lambda: dimer.dimer_plain(x, terms, n))
    plan = dimer.plan_for(x, terms)
    rec = {'atoms': int(x.shape[1]), 'n_steps': n, 'rule': plan.form,
           'steps': int(want[2].max()), 'done': bool(want[1].all()),
           'plain_ms': plain_ms,
           'forms': dimer_forms(card, name, x, params, terms, n, want)}
    rec['ms'] = rec['forms'][plan.form]['ms']
    rec['plain_diff_A'] = max(r['plain_diff_A']
                              for r in rec['forms'].values())
    for k in ('bound_ms', 'bound_by', 'latency_ms'):
        rec[k] = rec['forms'][plan.form][k]
    print(f'[18 dimer] {name}: the rule picks {plan.form}; plain twin '
          f'{plain_ms:.1f} ms [{card}]')
    return rec


def dimer_sweep(card, out):
    '''--dimer OUT.json: the widths behind the plan rule, on each of
    DIMER_CASES (float64): the lone form at each width of LONE_WIDTHS
    where it fits, the large form on each cluster of DIMER_CLUSTERS, the
    rule's plan and the staged form where it fits, each checked and
    timed by dimer_forms. Writes the records to `out`.'''
    import tempfile
    from tscode_tpu_torch.ops.kernels import dimer
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dimer_inputs(tmp)
    recs = {'card': card}
    for name, (x, params, terms) in inputs.items():
        n = DIMER_CASES[name]
        plans = {'rule': dimer.plan_for(x, terms)}
        for form, key, widths in (('staged', None, (None,)),
                                  ('lone', 'warps', dimer.LONE_WIDTHS),
                                  ('large', 'cluster', DIMER_CLUSTERS)):
            for w in widths:
                try:
                    plans[f'{form} {w}' if key else form] = dimer.plan_for(
                        x, terms, form, **({key: w} if key else {}))
                except ValueError:
                    pass
        want = dimer.dimer_plain(x, terms, n)
        recs[name] = dimer_forms(card, name, x, params, terms, n, want,
                                 plans)
    with open(out, 'w') as f:
        json.dump(recs, f, indent=1)


def dimer_kernel_record(card, guess, atomnos, graph_step_ms):
    '''D1 on the SADDLE scan's sub-peak guess (the ring's force field
    from the guess, float64, 300 steps, ops/kernels/dimer.dimer: the
    rule's form) against its plain twin and against the graph path
    (saddle._dimer_step under capture.graph_loop, a replay a step, so its
    flag gives its steps taken): coordinates within FF_ATOL A of both,
    the same flag and the same steps taken; every form by dimer_forms
    (the staged form, the first design, among them). Timed: the rule's
    form (device_ms), us a step, the twin (its one run), the graph path
    as graph_step_ms (the replayed step, timed in this run on the same
    structure) x the steps; bounded (dimer_bound). Float32 beside
    float64, no gate. Then
    dimer_case_record on the other inputs of DIMER_CASES. Prints;
    returns the record.'''
    import tempfile
    import torch
    from tscode_tpu_torch import capture, saddle
    from tscode_tpu_torch.ff import build_ff_params, ff_energy, \
        params_to_device
    from tscode_tpu_torch.ff_records import FF_ATOL
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.ops.kernels import dimer
    graph = graphize(guess, atomnos)
    params = params_to_device(build_ff_params(guess, atomnos, graph), DEV,
                              torch.float64)
    terms = ff_energy.fire_terms(params)
    x = torch.as_tensor(guess, dtype=torch.float64, device=DEV)[None]
    n = DIMER_CASES['scan_guess']
    plan = dimer.plan_for(x, terms)
    c, done, steps = dimer.dimer(x, terms, n)
    (pc, pdone, psteps), plain_ms = once_ms(
        lambda: dimer.dimer_plain(x, terms, n))
    body = saddle._dimer_step(ff_energy, 12, 1e-3, 0.02, 0.05)
    state = (x[0], saddle.dimer_start(x[0]),
             torch.zeros((), dtype=torch.bool, device=DEV))
    gsteps = n
    for k in range(n):
        state = capture.graph_loop(body, state, (params,), 1)
        if gsteps == n and bool(state[2]):
            gsteps = k + 1
    plain_err = float((c - pc).abs().max())
    graph_err = float((c[0] - state[0]).abs().max())
    check(plain_err <= FF_ATOL and graph_err <= FF_ATOL and
          torch.equal(done, pdone) and torch.equal(steps, psteps) and
          bool(done[0]) == bool(state[2]) and int(steps[0]) == gsteps,
          f'D1 on the scan\'s guess: {plain_err:.2e} A from its plain twin, '
          f'{graph_err:.2e} A from the graph path, done {done.tolist()} / '
          f'{pdone.tolist()} / {bool(state[2])}, steps {steps.tolist()} / '
          f'{psteps.tolist()} / {gsteps}')
    forms = dimer_forms(card, 'scan_guess', x, params, terms, n,
                        (pc, pdone, psteps))
    ms = forms[plan.form]['ms']
    params32 = tuple(t.float() if t.is_floating_point() else t
                     for t in params)
    c32, done32, steps32 = dimer.dimer(x.float(), ff_energy.fire_terms(
        params32), n)
    bound, by = dimer_bound(x, params, steps)
    rec = {'atoms': int(x.shape[1]), 'n_steps': n, 'form': plan.form,
           'threads': plan.threads, 'smem': plan.smem,
           'steps': int(steps[0]), 'done': bool(done[0]), 'ms': ms,
           'us_per_step': ms * 1e3 / int(steps[0]), 'plain_ms': plain_ms,
           'graph_step_ms': graph_step_ms,
           'graph_ms': graph_step_ms * int(steps[0]),
           'plain_diff_A': max(plain_err, max(
               r['plain_diff_A'] for r in forms.values())),
           'graph_diff_A': graph_err,
           'bound_ms': bound, 'bound_by': by,
           'latency_ms': forms[plan.form]['latency_ms'],
           'staged_ms': forms['staged']['ms'],
           'float32_diff_A': float((c32.double() - c).abs().max()),
           'float32_done': bool(done32[0]),
           'float32_steps': int(steps32[0]), 'forms': forms,
           **dimer.kernel_info(plan, x.dtype, x.device)}
    rec['bound_share'] = bound / ms
    print(f'[18 dimer] the scan\'s guess ({rec["atoms"]} atoms), float64, '
          f'{n} steps, {rec["steps"]} taken (done {rec["done"]}): D1 form '
          f'{plan.form} ({plan.threads} threads, {plan.smem} shared bytes, '
          f'{rec["registers"]} registers a thread) {ms:.4f} ms, '
          f'{rec["us_per_step"]:.2f} us a step (the staged form '
          f'{rec["staged_ms"]:.4f} ms); plain twin {plain_ms:.1f} ms;'
          f' graph path {graph_step_ms:.3f} ms a step x {rec["steps"]} = '
          f'{rec["graph_ms"]:.1f} ms; bound {bound:.6f} ms ({by}, '
          f'{100 * rec["bound_share"]:.3f}% of it), latency figure '
          f'{rec["latency_ms"]:.4f} ms; {plain_err:.2e} A from '
          f'the twin, {graph_err:.2e} A from the graph path, the same flags '
          f'and steps; float32 {rec["float32_diff_A"]:.2e} A from float64 '
          f'(done {rec["float32_done"]}, {rec["float32_steps"]} steps; no '
          f'gate) [{card}]')
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dimer_inputs(tmp)
    rec['cases'] = {name: dimer_case_record(card, name, *inputs[name],
                                            DIMER_CASES[name])
                    for name in DIMER_CASES if name != 'scan_guess'}
    return rec


def replayed_ms(body, state, args, n):
    '''ms a step of `body` replayed n steps from its CUDA graph
    (capture.graph_loop), after a warm-up run that captures it.'''
    from tscode_tpu_torch import capture
    capture.graph_loop(body, state, args, n)
    return cuda_ms(lambda: capture.graph_loop(body, state, args, n),
                   reps=1) / n


def ff_step_times(card, guess, chain, atomnos):
    '''The dimer step on `guess` and the climbing band step on `chain`
    (force field of the ring from guess, float64 on the card), each
    replayed from its CUDA graph and queued op by op (CUDA events around
    the steps after a warm-up; kernels a step from the profiler), and one
    Hessian with its eigensolve (vibrations.frequencies); then D1 on the
    guess beside the replayed step (dimer_kernel_record, under 'd1').
    Returns the record, ms.'''
    import torch
    from tscode_tpu_torch import neb, saddle, vibrations
    from tscode_tpu_torch.ff import build_ff_params, ff_energy, params_to_device
    from tscode_tpu_torch.graphs import graphize
    params = params_to_device(build_ff_params(guess, atomnos,
                                              graphize(guess, atomnos)),
                              DEV, torch.float64)
    x = torch.as_tensor(guess, dtype=torch.float64, device=DEV)
    dimer = saddle._dimer_step(ff_energy, 12, 1e-3, 0.02, 0.05)
    d_state = (x, saddle.dimer_start(x), torch.zeros((), dtype=torch.bool,
                                                      device=DEV))
    c = torch.as_tensor(chain, dtype=torch.float64, device=DEV)
    b_state, dt0 = neb._band_state(c, 0.01)
    band = neb._band_body(ff_energy, 1.0, 0.05, True)
    d_args, b_args = (params,), (dt0, (params,))

    def eager(body, state, args, n=EAGER_TIMED_STEPS):
        def run():
            st = state
            for _ in range(n):
                st = body(st, args)
        ms = cuda_ms(run, reps=1) / n
        _, _, launches = profiled(run)
        return ms, None if launches is None else launches / n

    rec = {'dimer_step_graph_ms': replayed_ms(dimer, d_state, d_args,
                                              DIMER_TIMED_STEPS),
           'band_step_graph_ms': replayed_ms(band, b_state, b_args,
                                             BAND_TIMED_STEPS)}
    rec['dimer_step_eager_ms'], rec['dimer_kernels_a_step'] = \
        eager(dimer, d_state, d_args)
    rec['band_step_eager_ms'], rec['band_kernels_a_step'] = \
        eager(band, b_state, b_args)
    rec['hessian_eigensolve_ms'] = cuda_ms(lambda: vibrations.frequencies(
        guess, atomnos, lambda y: ff_energy(y, params), device=DEV), reps=3)
    rec['d1'] = dimer_kernel_record(card, guess, atomnos,
                                    rec['dimer_step_graph_ms'])
    print(f'[18 dihedral_scan] step times, float64, {len(atomnos)} atoms: '
          f'dimer step replayed {rec["dimer_step_graph_ms"]:.3f} ms, op by '
          f'op {rec["dimer_step_eager_ms"]:.3f} ms '
          f'({rec["dimer_kernels_a_step"]} kernels a step); NEB band step '
          f'({len(chain)} images, climbing) replayed '
          f'{rec["band_step_graph_ms"]:.3f} ms, op by op '
          f'{rec["band_step_eager_ms"]:.3f} ms '
          f'({rec["band_kernels_a_step"]} kernels a step); Hessian + '
          f'eigensolve {rec["hessian_eigensolve_ms"]:.3f} ms [{card}]')
    return rec


def ff_energy_graph(c, params):
    '''ff_energy without its `fire_terms`: the route before N1 (the band
    step captured in a CUDA graph and replayed).'''
    from tscode_tpu_torch.ff import ff_energy
    return ff_energy(c, params)


def neb_inputs():
    '''The bands of NEB_CASES, float64 on the card: name -> (start (N,
    3), end (N, 3), aligned as neb> aligns them, the force field's tables
    (params_to_device of the start's topology), ff.FireTerms of them).'''
    import torch
    from tscode_tpu_torch.ff import build_ff_params, ff_energy, \
        params_to_device
    from tscode_tpu_torch.ff_records import operator_frames
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.molecule import align_structures
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    from tscode_tpu_torch.rot_rmsd import _rotate
    from tscode_tpu_torch.suite_inputs import chain_ff, chlorocycloalkane

    def case(a, b, params):
        p = params_to_device(params, DEV, torch.float64)
        a, b = align_structures(np.array([a, b]))
        return a, b, p, ff_energy.fire_terms(p)
    start, far, _ = operator_frames(golden_record(DSCAN_GOLDEN))
    _, ring_nos = chlorocycloalkane(DSCAN_RING)
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    x, nos = mol.atomcoords[0], mol.atomnos
    mask = np.zeros(5, dtype=bool)
    mask[4] = True
    rng = np.random.default_rng(2)
    a, b = (_rotate(x, (1, 0, 3, 4), t, mask) +
            rng.normal(size=x.shape) * 0.05 for t in (0, 180))
    inputs = {'ring': case(start, far, build_ff_params(
                  start, ring_nos, graphize(start, ring_nos))),
              'hcooh': case(a, b, build_ff_params(x, nos, graphize(x, nos)))}
    for n in (150, 2500):
        X, ffp = chain_ff(n, 2, seed=13)
        inputs[f'chain{n}'] = case(X[0], X[1], ffp)
    return inputs


def neb_bound(x, params, steps):
    '''N1's least time on the band x (I, N, 3) for `steps` steps: each
    step every term of each interior image once for its energy and its
    forces together (FF_TERM_FLOPS holds the forward values the energy
    uses) plus NEB_TERM_ENERGY_FLOPS a term for the energy itself, and
    NEB_ATOM_FLOPS an interior atom (the endpoints' energies, once a
    call, left out); the chain read and written once, the tables read
    once.'''
    M, N = x.shape[0] - 2, x.shape[1]
    n_terms = sum(int(params[k].shape[0]) for k in (0, 2, 4, 6)
                  if k < len(params))
    ops = steps * M * (ff_term_flops(params) +
                       NEB_TERM_ENERGY_FLOPS * n_terms + NEB_ATOM_FLOPS * N)
    nbytes = 2 * x.numel() * 8 + 5 + sum(t.numel() * t.element_size()
                                          for t in params)
    return bound_of(ops, nbytes)


def idpp_bound(x, steps):
    '''I1's least time on the band x (I, N, 3): the interior images'
    steps (`steps` (I,), the frozen endpoints' left out), each unordered
    pair of an image's atoms once, IDPP_PAIR_FLOPS for both atoms'
    contributions; the interior images' rows of the two (I, N, N) tables
    read once, the chain read and written once.'''
    M, N = x.shape[0] - 2, x.shape[1]
    ops = int(steps[1:-1].sum()) * N * (N - 1) // 2 * IDPP_PAIR_FLOPS
    nbytes = (2 * M * N * N + 2 * x.numel()) * 8 + 5 * x.shape[0]
    return bound_of(ops, nbytes)


def neb_plans(x, terms):
    '''{label: Plan}: the rule's plan, the lone form where it fits, the
    large form on each cluster of NEB_CLUSTERS up to I - 2 blocks, the
    grid form on the card's resident blocks and on NEB_GRID_FEW (more
    than one interior image a block); at 2,500 atoms the large form on
    min(I - 2, 8) blocks only and the grid on all (a large launch there
    takes ~0.3 s a cluster of 5, ~0.8 s of 2).'''
    from tscode_tpu_torch.ops.kernels import neb
    M = x.shape[0] - 2
    big = x.shape[1] > 1000
    plans = {'rule': neb.plan_for(x, terms)}
    try:
        plans['lone'] = neb.plan_for(x, terms, 'lone')
    except ValueError:
        pass
    clusters = (min(M, neb.MAX_CLUSTER),) if big else NEB_CLUSTERS
    for cl in clusters:
        if cl <= min(M, neb.MAX_CLUSTER):
            plans[f'large {cl}'] = neb.plan_for(x, terms, 'large', cl)
    plans['grid'] = neb.plan_for(x, terms, 'grid')
    if not big:
        plans[f'grid {NEB_GRID_FEW}'] = neb.plan_for(x, terms, 'grid',
                                                    NEB_GRID_FEW)
    return plans


def in_turns(new, old, reps):
    '''(device ms of `new`, of `old`): each timed twice, new, old, old,
    new (device_ms), the two readings of each averaged.'''
    t = [device_ms(f, reps=reps) for f in (new, old, old, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def neb_forms(card, name, x, params, terms, n, climbing, want, eval_ms):
    '''N1 on the band x for n steps (climbing or not) in each plan of
    neb_plans: two launches the same bits, the bits of N1's first design
    (PR 22's kernel, launch_v1, its rule's plan; the redesign keeps its
    sums' orders), within FF_ATOL of the plain twin's `want` (chain,
    done, steps, ties) with the same flag and steps (held strictly: the
    record counts the twin's near ties); device ms (the rule's plan in
    turns with the first design's), us a step, registers, resident warps;
    the bound (neb_bound) and the latency figure (the steps x eval_ms,
    one F1 step on an interior image: one evaluation of its terms, its
    reductions and a FIRE update). Prints a line a plan; returns {label:
    record}, the first design's under 'v1'.'''
    import torch
    from tscode_tpu_torch.ff_records import FF_ATOL
    from tscode_tpu_torch.ops.kernels import neb
    pc, pdone, psteps, ties = want
    bound, by = neb_bound(x, params, int(psteps))
    latency = eval_ms * int(psteps)
    reps = 1 if x.shape[1] > 1000 else 3
    old_plan = neb.plan_for_v1(x, terms)
    old = neb.launch_v1(x, terms, n, climbing=climbing, plan=old_plan)
    recs = {}
    for label, plan in neb_plans(x, terms).items():
        got = neb.launch(x, terms, n, climbing=climbing, plan=plan)
        again = neb.launch(x, terms, n, climbing=climbing, plan=plan)
        err = float((got[0] - pc).abs().max())
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        same = all(torch.equal(a, b) for a, b in zip(got, old))
        check(repeat and same and err <= FF_ATOL and
              bool(got[1]) == bool(pdone) and int(got[2]) == int(psteps),
              f'N1 {name} {label} ({plan}), climbing {climbing}: {err:.2e} '
              f'A from its plain twin, done {bool(got[1])} / {bool(pdone)}, '
              f'steps {int(got[2])} / {int(psteps)}, two launches the same '
              f'bits {repeat}, the first design\'s bits {same}, the twin\'s '
              f'near ties {ties}')

        def run(plan=plan):
            return neb.launch(x, terms, n, climbing=climbing, plan=plan)
        if label == 'rule':
            ms, v1_ms = in_turns(run, lambda: neb.launch_v1(
                x, terms, n, climbing=climbing, plan=old_plan), reps)
            recs['v1'] = {'form': old_plan.form,
                          'cluster': old_plan.cluster, 'ms': v1_ms,
                          'plain_diff_A': float((old[0] - pc).abs().max()),
                          'us_per_step': v1_ms * 1e3 / int(psteps),
                          **neb.kernel_info_v1(old_plan, x.device)}
        else:
            ms = device_ms(run, reps=reps)
        rec = {'form': plan.form, 'cluster': plan.cluster,
               'shared': plan.shared, 'staged': plan.staged,
               'smem': plan.smem, 'ms': ms,
               'us_per_step': ms * 1e3 / int(psteps), 'plain_diff_A': err,
               'bound_ms': bound, 'bound_by': by, 'latency_ms': latency,
               **neb.kernel_info(plan, x.device)}
        recs[label] = rec
        print(f'[19b neb] N1 {name} ({x.shape[0]} x {x.shape[1]} atoms, '
              f'{"climbing" if climbing else "plain"}, {int(psteps)} steps, '
              f'done {bool(pdone)}) {label} ({plan.form}, cluster '
              f'{plan.cluster}, shared {plan.shared}, staged {plan.staged}, '
              f'{plan.smem} shared bytes, {rec["registers"]} registers, '
              f'{rec["local_bytes"]} local bytes, {rec["resident_warps"]} '
              f'resident warps an SM): {ms:.4f} ms, '
              f'{rec["us_per_step"]:.2f} us a step; {err:.2e} A from the '
              f'twin; bound {bound:.6f} ms ({by}), latency figure '
              f'{latency:.4f} ms [{card}]')
    v = recs['v1']
    print(f'[19b neb] N1 {name} {"climbing" if climbing else "plain"}: the '
          f'first design (PR 22, {v["form"]} on {v["cluster"]} blocks, '
          f'{v["registers"]} registers) {v["ms"]:.4f} ms, '
          f'{v["us_per_step"]:.2f} us a step, in turns with the rule\'s '
          f'{recs["rule"]["ms"]:.4f} ms; every plan its bits [{card}]')
    return recs


def neb_graph_step_ms(x, params, climbing, n):
    '''The band step replayed from its CUDA graph (neb._band_body under
    capture.graph_loop, the route before N1): ms a step over n steps
    after a warm-up.'''
    from tscode_tpu_torch import neb
    from tscode_tpu_torch.ff import ff_energy
    state, dt0 = neb._band_state(x, 0.01)
    return replayed_ms(neb._band_body(ff_energy, 1.0, 0.05, climbing),
                       state, (dt0, (params,)), n)


def neb_case_record(card, name, start, end, params, terms):
    '''One band of NEB_CASES: its IDPP band by I1 against the twin
    (idpp_record), then both band phases as run_neb runs them, the plain
    one from the IDPP band and the climbing one from its end: N1 in every
    plan (neb_forms) against the twin (its one run timed), the graph
    path's replayed step x the twin's steps. Returns the record.'''
    import torch
    from tscode_tpu_torch import neb
    from tscode_tpu_torch.ops.kernels import neb as kn
    n = NEB_CASES[name]
    chain = neb.interpolate_chain(start, end, NEB_IMAGES)
    eval_ms = dimer_eval_ms(torch.as_tensor(chain[1:2], device=DEV), terms)
    rec = {'atoms': int(chain.shape[1]), 'images': NEB_IMAGES,
           'n_steps': n, 'f1_step_ms': eval_ms,
           'idpp': idpp_record(card, name, chain, eval_ms)}
    x = torch.as_tensor(rec['idpp'].pop('band'), device=DEV)
    rule = kn.plan_for(x, terms)
    for phase, climbing in (('plain', False), ('climbing', True)):
        want, plain_ms = once_ms(lambda: kn.neb_relax_plain(
            x, terms, n, climbing=climbing))
        forms = neb_forms(card, name, x, params, terms, n, climbing, want,
                          eval_ms)
        steps = int(want[2])
        step_ms = neb_graph_step_ms(x, params, climbing, min(n, 50))
        r = forms['rule']
        rec[phase] = {'steps': steps, 'done': bool(want[1]),
                      'near_ties': want[3], 'plain_ms': plain_ms,
                      'graph_step_ms': step_ms, 'graph_ms': step_ms * steps,
                      'forms': forms, 'v1_ms': forms['v1']['ms'],
                      **{k: r[k] for k in ('form', 'ms', 'us_per_step',
                                           'bound_ms', 'bound_by',
                                           'latency_ms', 'plain_diff_A')}}
        print(f'[19b neb] N1 {name} {phase}: the rule picks {rule.form} '
              f'(cluster {rule.cluster}) {r["ms"]:.4f} ms; plain twin '
              f'{plain_ms:.1f} ms; graph path {step_ms:.4f} ms a step x '
              f'{steps} = {step_ms * steps:.2f} ms; twin\'s near ties '
              f'{want[3]} [{card}]')
        x = kn.launch(x, terms, n, climbing=climbing)[0]
    return rec


def idpp_plans(N):
    '''{label: Plan} of I1 on images of N atoms: the rule's, the lone
    form where it takes the image, the cluster form on each of
    IDPP_CLUSTERS blocks that keeps its blocks within 512 threads.'''
    from tscode_tpu_torch.ops.kernels import idpp
    plans = {'rule': idpp.launch_plan(N)}
    if N <= idpp.LONE_ATOMS:
        plans['lone'] = idpp.launch_plan(N, 'lone')
    for cl in IDPP_CLUSTERS:
        if -(-N // cl) <= idpp.MAX_THREADS:
            plans[f'cluster {cl}'] = idpp.launch_plan(N, 'cluster', cl)
    return plans


def idpp_record(card, name, chain, eval_ms):
    '''I1 on the IDPP band of the linear chain (I, N, 3) numpy, in each
    plan of idpp_plans: against its twin (within FF_ATOL, the same flags
    and steps, two launches the same bits) and against I1's first design
    (PR 22's kernel, launch_v1: the same bits), timed (the rule's plan in
    turns with the first design) beside the twin (its one run) and
    fire_run_graph (the route before I1: the autograd step of
    neb._idpp_energy replayed from a CUDA graph), bounded (idpp_bound),
    with a latency figure (the most steps x eval_ms, one F1 step on an
    image, an evaluation over its pairs with its reductions, standing in
    for an IDPP step), registers and resident warps; the tables' symmetry
    check (check_symmetric, made anew each call) timed. IDPP_STEPS steps;
    the chains 10 at fmax 0. Returns the record, the band under `band`.'''
    import torch
    from tscode_tpu_torch import neb, optimizers
    from tscode_tpu_torch.ff_records import FF_ATOL
    from tscode_tpu_torch.ops.kernels import idpp
    n, fmax = (IDPP_STEPS, 0.05) if name in ('ring', 'hcooh') else (10, 0.0)
    x = torch.as_tensor(chain, dtype=torch.float64, device=DEV)
    tables = tuple(torch.as_tensor(t, device=DEV)
                   for t in neb.idpp_tables(chain))
    (pc, pdone, psteps), plain_ms = once_ms(
        lambda: idpp.idpp_fire_plain(x, *tables, n, fmax=fmax))
    old = idpp.launch_v1(x, *tables, n, fmax=fmax)
    reps = 1 if x.shape[1] > 1000 else 3
    forms, err = {}, 0.0
    for label, plan in idpp_plans(x.shape[1]).items():
        got = idpp.launch(x, *tables, n, fmax=fmax, plan=plan)
        again = idpp.launch(x, *tables, n, fmax=fmax, plan=plan)
        e = float((got[0] - pc).abs().max())
        err = max(err, e)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        same = all(torch.equal(a, b) for a, b in zip(got, old))
        check(repeat and same and e <= FF_ATOL and
              torch.equal(got[1], pdone) and torch.equal(got[2], psteps),
              f'I1 {name} {label} ({plan}): {e:.2e} A from its plain twin, '
              f'done {got[1].tolist()} / {pdone.tolist()}, steps '
              f'{got[2].tolist()} / {psteps.tolist()}, two launches the same '
              f'bits {repeat}, the first design\'s bits {same}')

        def run(plan=plan):
            return idpp.launch(x, *tables, n, fmax=fmax, plan=plan)
        if label == 'rule':
            ms, v1_ms = in_turns(run, lambda: idpp.launch_v1(
                x, *tables, n, fmax=fmax), reps)
        else:
            ms = device_ms(run, reps=reps)
        forms[label] = {'form': plan.form, 'cluster': plan.cluster,
                        'threads': plan.threads, 'smem': plan.smem,
                        'ms': ms, 'plain_diff_A': e,
                        **idpp.kernel_info(plan, x.device)}
        f = forms[label]
        print(f'[19b neb] I1 {name} {label} ({plan.form}, {plan.cluster} '
              f'blocks of {plan.threads} threads an image, {plan.smem} '
              f'shared bytes, {f["registers"]} registers, '
              f'{f["resident_warps"]} resident warps an SM): {ms:.4f} ms; '
              f'{e:.2e} A from the twin [{card}]')
    def check_anew():
        for t in tables:    # the check's own cache: compare again
            t.__dict__.pop('_idpp_symmetric', None)
        idpp.check_symmetric(*tables)
    sym_ms = cuda_ms(check_anew, reps=3)
    freeze = torch.zeros(x.shape[:2], dtype=torch.bool, device=DEV)
    freeze[0] = freeze[-1] = True

    def graph():
        return optimizers.fire_run_graph(x, neb._idpp_energy, n, 0.05, fmax,
                                         freeze, tables)
    gc = graph()[0]
    graph_ms = cuda_ms(graph, reps=1)
    bound, by = idpp_bound(x, psteps)
    latency = eval_ms * int(psteps.max())
    rule = forms['rule']
    rec = {'steps': psteps.tolist(), 'done': pdone.tolist(), 'fmax': fmax,
           'ms': rule['ms'], 'v1_ms': v1_ms, 'form': rule['form'],
           'cluster': rule['cluster'], 'plain_ms': plain_ms,
           'graph_ms': graph_ms, 'plain_diff_A': err,
           'graph_diff_A': float((old[0] - gc).abs().max()),
           'bound_ms': bound, 'bound_by': by, 'latency_ms': latency,
           'symmetry_check_ms': sym_ms, 'forms': forms, 'band': old[0]}
    print(f'[19b neb] I1 {name} ({x.shape[0]} x {x.shape[1]} atoms, {n} '
          f'steps at fmax {fmax}, steps taken {rec["steps"]}): the rule '
          f'({rule["form"]} on {rule["cluster"]} blocks) {rule["ms"]:.4f} '
          f'ms, the first design (PR 22) {v1_ms:.4f} ms in turns; plain '
          f'twin {plain_ms:.1f} ms; fire_run_graph {graph_ms:.3f} ms; '
          f'{err:.2e} A from the twin, {rec["graph_diff_A"]:.2e} A from the '
          f'graph path; every form the first design\'s bits; bound '
          f'{bound:.6f} ms ({by}), latency figure {latency:.4f} ms; the '
          f'tables\' symmetry check {sym_ms:.4f} ms (CUDA events, each '
          f'call ending in its host read) '
          f'[{card}]')
    return rec


def neb_route_seconds(card, start, end, params):
    '''neb>'s band on phase 19's input (run_neb, 7 images, 400 + 400
    steps, its IDPP band first), float64 on the card, by the route of I1
    and N1 and by the route before them (IDPP by fire_minimize_batch on
    neb._idpp_energy, the band on ff_energy_graph: both replayed from
    CUDA graphs), in turns (after, before, before, after), each after a
    warm-up run; the two bands within FF_ATOL, the same TS image. Returns
    {'after_s': [...], 'before_s': [...]}.'''
    import torch
    from tscode_tpu_torch import neb, optimizers
    from tscode_tpu_torch.ff import ff_energy
    from tscode_tpu_torch.ff_records import FF_ATOL

    def after():
        return neb.run_neb(start, end, ff_energy, energy_args=(params,),
                           device=DEV)

    def before():
        chain = neb.interpolate_chain(start, end, NEB_IMAGES)
        x = torch.as_tensor(chain, device=DEV)
        freeze = np.zeros(chain.shape[:2], dtype=bool)
        freeze[0] = freeze[-1] = True
        tables = tuple(torch.as_tensor(t, device=DEV)
                       for t in neb.idpp_tables(chain))
        band = optimizers.fire_minimize_batch(
            x, neb._idpp_energy, n_steps=IDPP_STEPS, freeze_mask=freeze,
            energy_args=tables)[0]
        return neb.run_neb(start, end, ff_energy_graph,
                           chain=band.cpu().numpy(), energy_args=(params,),
                           device=DEV)
    runs = {'after': after, 'before': before}
    out = {k: fn() for k, fn in runs.items()}
    err = float(np.abs(out['after'][0] - out['before'][0]).max())
    check(err <= FF_ATOL and out['after'][2] == out['before'][2],
          f'neb> by N1 and I1 against the route before them: {err:.2e} A, '
          f'TS image {out["after"][2]} / {out["before"][2]}')
    secs = {'after_s': [], 'before_s': []}
    for key in ('after', 'before', 'before', 'after'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[key]()
        torch.cuda.synchronize()
        secs[key + '_s'].append(time.perf_counter() - t0)
    secs['band_diff_A'] = err
    print(f'[19b neb] neb>\'s band on phase 19\'s input, float64: by I1 and '
          f'N1 {secs["after_s"]} s, by the route before them (graph '
          f'replays) {secs["before_s"]} s; the bands {err:.2e} A apart, '
          f'the same TS image [{card}]')
    return secs


def neb_crossover(card):
    '''N1 against the route before it (the band step replayed from its
    CUDA graph) by chain size: on the linear 7-image band between two
    jittered conformers of each suite_inputs.chain_ff chain of
    NEB_CROSSOVER atoms (seed 13), NEB_CROSSOVER_STEPS plain steps, N1 in
    the rule's plan, the lone form where it fits, the large form on
    min(I - 2, 8) blocks and the grid form, and N1's first design in its
    rule's plan (device ms over the steps taken, each a step) against the
    graph route's replayed step (neb_graph_step_ms); the rule's
    thresholds (neb.LONE_MAX_ATOMS, GRID_MIN_ATOMS) are read from these
    points. Returns {'points': [...],
    'graph_wins_from': the fewest atoms at which the graph route's step
    is shorter than the rule's (None if the rule's always is)}.'''
    import torch
    from tscode_tpu_torch import neb
    from tscode_tpu_torch.ff import ff_energy, params_to_device
    from tscode_tpu_torch.ops.kernels import neb as kn
    from tscode_tpu_torch.suite_inputs import chain_ff
    n = NEB_CROSSOVER_STEPS
    points, wins = [], None
    for n_atoms in NEB_CROSSOVER:
        X, ffp = chain_ff(n_atoms, 2, seed=13)
        params = params_to_device(ffp, DEV, torch.float64)
        terms = ff_energy.fire_terms(params)
        x = torch.as_tensor(neb.interpolate_chain(X[0], X[1], NEB_IMAGES),
                            device=DEV)
        plans = {'rule': kn.plan_for(x, terms),
                 'large': kn.plan_for(x, terms, 'large'),
                 'grid': kn.plan_for(x, terms, 'grid')}
        try:
            plans['lone'] = kn.plan_for(x, terms, 'lone')
        except ValueError:
            pass
        graph = neb_graph_step_ms(x, params, False, n)
        point = {'atoms': n_atoms, 'graph_step_ms': graph}
        for label, plan in plans.items():
            steps = int(kn.launch(x, terms, n, plan=plan)[2])
            ms = device_ms(lambda: kn.launch(x, terms, n, plan=plan),
                           reps=3)
            point[label] = {'form': plan.form, 'blocks': plan.cluster,
                            'shared': plan.shared, 'staged': plan.staged,
                            'steps': steps, 'step_ms': ms / steps}
        old = kn.plan_for_v1(x, terms)
        steps = int(kn.launch_v1(x, terms, n, plan=old)[2])
        ms = device_ms(lambda: kn.launch_v1(x, terms, n, plan=old), reps=3)
        point['v1'] = {'form': old.form, 'blocks': old.cluster,
                       'steps': steps, 'step_ms': ms / steps}
        rule = point['rule']['step_ms']
        point['ratio'] = rule / graph
        points.append(point)
        if wins is None and graph < rule:
            wins = n_atoms
        lone = f', lone {point["lone"]["step_ms"]:.4f}' \
            if 'lone' in point else ''
        print(f'[19b neb] crossover: {n_atoms} atoms x {NEB_IMAGES} images, '
              f'ms a step: the rule ({plans["rule"].form}) {rule:.4f}{lone}, '
              f'large on {plans["large"].cluster} blocks (shared '
              f'{plans["large"].shared}, staged {plans["large"].staged}) '
              f'{point["large"]["step_ms"]:.4f}, grid on '
              f'{plans["grid"].cluster} blocks {point["grid"]["step_ms"]:.4f}'
              f', the first design ({old.form}) '
              f'{point["v1"]["step_ms"]:.4f}, the graph route {graph:.4f}; '
              f'rule / graph {rule / graph:.3f} [{card}]')
    print(f'[19b neb] crossover: the graph route\'s step is shorter than '
          f'the rule\'s from {wins} atoms on (of {list(NEB_CROSSOVER)}) '
          f'[{card}]')
    return {'points': points, 'graph_wins_from': wins}


def phase_neb(card):
    '''Phase 19b: N1 and I1 on the bands of NEB_CASES (neb_case_record:
    every plan against the twin, timed, bounded), neb>'s seconds by the
    kernels' route and the route before them (neb_route_seconds), and
    N1's forms against the route before them by chain size
    (neb_crossover). The launches here compare the kernels with their
    twins and time them: none counts as a main-path launch. Returns the
    record.'''
    inputs = neb_inputs()
    rec = {name: neb_case_record(card, name, *inputs[name])
           for name in NEB_CASES}
    start, end, params, _ = inputs['ring']
    rec['neb_route'] = neb_route_seconds(card, start, end, params)
    rec['crossover'] = neb_crossover(card)
    return rec


def phase_dihedral_scan(card):
    '''Phase 18: the atropisomer route at full size, float64 on the
    card: `SADDLE` + scan> of the ring torsion C3-C4-C5-C6 of the
    DSCAN_RING-carbon chlorocycloalkane through the Embedder (both coarse
    sweeps, the accurate re-scans of their peaks, the dimer on every
    sub-peak, one D1 launch each (DimerCalls), the RMSD prune of the
    maxima with K3; then, apart from the route, the frequencies of each
    refined maximum, the step times and D1's record (ff_step_times)).
    Held to the JAX x64
    record (every sweep's points,
    peaks and sub-peaks, dimer flags, imaginary-mode counts and surviving
    maxima equal; frames within ff_records.FF_ATOL A, energies within
    as many kcal/mol) and to the port's CPU run; K3 against its plain twin on
    the maxima pool. Returns (K3's launches, largest K3 disagreement,
    record).'''
    import tempfile
    from tscode_tpu_torch.ops import rmsd_prune
    from tscode_tpu_torch.ops.kernels import qcp
    from tscode_tpu_torch.suite_inputs import chlorocycloalkane
    from tscode_tpu_torch.ff_records import port_package, record
    want = golden_record(DSCAN_GOLDEN)
    ties = scan_ties(want)
    pools = []
    prune = rmsd_prune.prune_conformers_rmsd

    def kept_pool(structures, atomnos, *args, **kw):
        pools.append(np.array(structures))
        return prune(structures, atomnos, *args, **kw)

    with tempfile.TemporaryDirectory(prefix='smoke_scan_') as tmp:
        for d in ('card', 'cpu'):
            os.mkdir(os.path.join(tmp, d))
        rmsd_prune.prune_conformers_rmsd = kept_pool
        qcp.KERNEL.reset_counts()
        try:
            with FireCalls() as fire, DimerCalls() as dim:
                got = record(port_package(DEV), 'dihedral_scan', DSCAN_RING,
                             os.path.join(tmp, 'card'))
            launches = qcp.KERNEL.launches
            cpu = record(port_package('cpu'), 'dihedral_scan', DSCAN_RING,
                         os.path.join(tmp, 'cpu'))
        finally:
            rmsd_prune.prune_conformers_rmsd = prune
    err = held_records('dihedral_scan float64 against JAX x64', got, want)
    cpu_err = held_records('dihedral_scan card against CPU', got, cpu)
    count_fire('18', 'dihedral_scan', fire.record())
    count_dimer('18', 'dihedral_scan', dim.record())
    check(launches > 0 and len(pools) == 2 and len(pools[0]) > 1,
          f'dihedral_scan: K3 launched {launches} times on pools of '
          f'{[len(p) for p in pools]} maxima')
    _, atomnos = chlorocycloalkane(DSCAN_RING)
    recs, kept, k3_err, marked, _ = refine_k3_passes(
        card, pools[0], atomnos != 1, 'dihedral_scan maxima')
    check(kept == got['maxima'], f'dihedral_scan: K3 keeps {kept} of the '
          f'pool, the route {got["maxima"]}')
    times = got['times']
    points = sum(got['sweeps'])
    rec = {'points': points, 'sweeps': got['sweeps'],
           'run_s': got['seconds'], 'scan_s': times['dihedral_scan'][0],
           'sweeps_s': sum(times['_dihedral_sweep']),
           'point_ms': 1e3 * sum(times['_dihedral_sweep']) / points,
           'dimer_s': times['saddle_refine_structure'],
           'frequencies_s': times['frequencies'],
           'cpu_scan_s': cpu['seconds'], 'k3_launches': launches,
           'k3_passes': recs, 'ties': ties}
    rec.update(ff_step_times(card, want['arrays']['saddle_guess'][0],
                             golden_record(FF_OPS_GOLDEN)['arrays'][
                                 'neb_frames'][0], atomnos))
    print(f'[18 dihedral_scan] float64, ring of {DSCAN_RING} carbons '
          f'({len(atomnos)} atoms): sweeps {got["sweeps"]}, peaks '
          f'{got["peaks"]}, dimers converged {got["saddle_converged"]}, '
          f'imaginary modes {got["n_imag"]}, {got["maxima"]} maxima after '
          f'the prune: the JAX x64 record (largest difference {err:.2e}; '
          f'card against CPU {cpu_err:.2e}; {ties} points within '
          f'{SCAN_TIE} kcal/mol of a decision); K3 {launches} launches, '
          f'{marked} pairs near the threshold; run {got["seconds"]:.2f} s, '
          f'scan {rec["scan_s"]:.2f} s: sweeps {rec["sweeps_s"]:.2f} s '
          f'({points} points, {rec["point_ms"]:.1f} ms a point), dimers '
          f'{", ".join(f"{t:.3f}" for t in rec["dimer_s"])} s; after the '
          f'route, frequencies '
          f'{", ".join(f"{t:.3f}" for t in rec["frequencies_s"])} s; the '
          f'CPU run {cpu["seconds"]:.2f} s [{card}]')
    return launches, k3_err, rec


def phase_ff_operators(card):
    '''Phase 19: neb> (the scan's first point and the point 120
    degrees on, 7 images, climbing), saddle> (the scan's highest coarse
    point) and scan> of the C0-Cl distance on the same ring, one input,
    float64 on the card (saddle>'s dimer one D1 launch, DimerCalls;
    neb>'s IDPP band one I1 launch and its two band phases one N1 launch
    each, NebCalls), their inputs from the JAX x64 dihedral-scan
    record: held to the JAX x64 record (the TS image, the dimer's flag,
    its imaginary modes, the distance scan's points and peak equal;
    frames within ff_records.FF_ATOL A, energies within as many kcal/mol)
    and to
    the port's CPU run. Returns the record.'''
    import tempfile
    from tscode_tpu_torch.ff_records import port_package, record
    scan = golden_record(DSCAN_GOLDEN)
    want = golden_record(FF_OPS_GOLDEN)
    with tempfile.TemporaryDirectory(prefix='smoke_ffops_') as tmp:
        for d in ('card', 'cpu'):
            os.mkdir(os.path.join(tmp, d))
        with FireCalls() as fire, DimerCalls() as dim, NebCalls() as nb:
            got = record(port_package(DEV), 'ff_operators', DSCAN_RING,
                         os.path.join(tmp, 'card'), scan)
        cpu = record(port_package('cpu'), 'ff_operators', DSCAN_RING,
                     os.path.join(tmp, 'cpu'), scan)
    err = held_records('ff_operators float64 against JAX x64', got, want)
    cpu_err = held_records('ff_operators card against CPU', got, cpu)
    count_fire('19', 'ff_operators', fire.record())
    count_dimer('19', 'ff_operators', dim.record())
    count_neb('19', 'ff_operators', nb.record())
    times = got['times']
    rec = {'neb_s': times['run_neb'][0],
           'saddle_s': times['saddle_refine_structure'][0],
           'distance_s': times['distance_scan'][0],
           'distance_points': got['distance_points'],
           'cpu_s': cpu['seconds']}
    print(f'[19 ff_operators] float64: neb> TS image {got["neb_ts"]} '
          f'({rec["neb_s"]:.3f} s), saddle> converged '
          f'{got["saddle_converged"]} with {got["n_imag"]} imaginary modes '
          f'({rec["saddle_s"]:.3f} s), distance scan {got["distance_points"]}'
          f' points, peak {got["distance_peak"]} ({rec["distance_s"]:.3f} s)'
          f': the JAX x64 record (largest difference {err:.2e}; card '
          f'against CPU {cpu_err:.2e}); the CPU run {cpu["seconds"]:.2f} s '
          f'[{card}]')
    return rec


def phase_opt_route(card):
    '''Phase 20: the optimisation route at full size through the
    Embedder the CLI builds: sn2_string at 76 conformers with NOOPT
    replaced by CALC=XTB FFCALC=XTB FFOPT=ON, so its 290 candidates go
    through the force-field pre-optimisation, loose and tight stages and
    the calculator's loose and tight stages, each followed by the
    prunes (the RMSD prune on K3). Every xtb call is answered by the
    stand-in of tests/torch_standin (a test double, no number it gives is
    chemistry), run as an executable first on PATH: settings were read
    when this script imported them, without it, so the calculators come
    from the keywords and a bend (none on this input) would stay on the
    internal force field. Float64 on the card is held to the JAX x64
    record taken with the same stand-in (tests/golden/sn2_string_opt.npz:
    every stage's and prune's counts, exit status and stand-in calls
    equal, stage energies within opt_records.OPT_ATOL kcal/mol away from
    marked ties, final frames and the poses file's rows within
    opt_records.OPT_ATOL A); K3 is held against its plain version on every
    RMSD prune pool. Float32 (the embed's dtype) runs the route once more:
    the embed's count into the first stage within STRING_F32_SLACK of
    float64's, every stage run, the final count bracketed the same way
    (at least +-2). Returns (K3 launches, largest K3 disagreement, record).'''
    import contextlib
    import tempfile
    import torch
    from tscode_tpu_torch import opt_records
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.ops.kernels import qcp
    want = golden_record(OPT_GOLDEN)
    marked = opt_records.energy_ties(want)
    recs = {}
    with tempfile.TemporaryDirectory(prefix='smoke_opt_') as tmp:
        for dtype in ('float64', 'float32'):
            d = os.path.join(tmp, dtype)
            os.mkdir(d)
            qcp.KERNEL.reset_counts()
            with open(os.path.join(tmp, f'{dtype}.out'), 'w') as out, \
                    contextlib.redirect_stdout(out):
                recs[dtype] = opt_records.record(
                    opt_records.port_package(DEV, getattr(torch, dtype)),
                    'sn2_string_opt', OPT_CONFS, d, standin='path')
            recs[dtype]['k3_launches'] = qcp.KERNEL.launches
            with open(os.path.join(d, 'tscode_report_port.json')) as f:
                recs[dtype]['report'] = json.load(f)
            if dtype == 'float64':
                atomnos = read_xyz(os.path.join(
                    d, 'tscode_poses_port.xyz')).atomnos
    got, f32 = recs['float64'], recs['float32']
    launches = got.pop('k3_launches')
    report = got.pop('report')
    try:
        err = opt_records.same_records(got, want, marked=marked)
    except AssertionError as e:
        raise SmokeFailure(f'opt_route float64 against JAX x64: {e}') from e
    check(launches > 0, f'opt_route: K3 launched {launches} times')
    heavy = np.asarray(atomnos) != 1
    kept_by_prune = [p[2] for p in got['prunes'] if p[0] == 'rmsd']
    k3_recs, k3_err, k3_marked, n_pools = [], 0.0, 0, 0
    for i, (pool, n_kept) in enumerate(zip(got['pools'], kept_by_prune)):
        if len(pool) < 2:
            continue
        n_pools += 1
        r, kept, e, m, _ = refine_k3_passes(card, pool, heavy,
                                            f'opt_route pool {i}')
        check(kept == n_kept, f'opt_route pool {i}: K3 keeps {kept} of '
              f'{len(pool)}, the route {n_kept}')
        k3_recs += r
        k3_err = max(k3_err, e)
        k3_marked += m

    stages = [s for s in report['stages'] if s['stage'] in
              ('force_field_refining', 'optimization_refining')]
    refine = report['refine']
    wait = sum(r['seconds'] for r in refine)
    prunes = sum(got['times']['prunes'])
    rec = {'seconds': got['seconds'], 'calls': got['calls'],
           'workers': [r['workers'] for r in refine],
           'jobs': got['refine'], 'final': got['final'],
           'stage_s': [s['seconds'] for s in stages],
           'standin_wait_s': wait, 'prunes_s': prunes,
           'k3_launches': launches, 'k3_pools': n_pools,
           'k3_pool_sizes': [len(p) for p in got['pools']],
           'ties': len(marked), 'float32_s': f32['seconds'],
           'float32_jobs': f32['refine'], 'float32_final': f32['final'],
           'k3_passes': k3_recs}
    stage_s = ', '.join(f'{s["stage"]} {s["seconds"]:.3f} s '
                        f'({s["structures_in"]} -> {s["structures_out"]})'
                        for s in stages)
    print(f'[20 opt_route float64] {got["refine"]} jobs through the five '
          f'stages -> {got["final"]} final, {got["calls"]} stand-in calls, '
          f'{rec["workers"]} thread workers: the JAX x64 record (largest '
          f'difference {err:.2e}; {len(marked)} stage energies marked as '
          f'ties); run {got["seconds"]:.2f} s [{card}]')
    print(f'[20 opt_route float64] stages: {stage_s}; waiting on the '
          f'stand-in {wait:.3f} s against {prunes:.3f} s in the prunes '
          f'[{card}]')
    print(f'[20 opt_route float64] K3: {launches} launches, held against '
          f'plain on {len(k3_recs)} passes of the {n_pools} pools of 2 or '
          f'more (pool sizes {rec["k3_pool_sizes"]}) '
          f'({k3_marked} pairs near the threshold) [{card}]')

    # float32: the embed's dtype; the stages' energies stay float64
    lo, hi = bracket(got['refine'][0], STRING_F32_SLACK)
    check(lo <= f32['refine'][0] <= hi, f'opt_route float32: '
          f'{f32["refine"][0]} candidates into the stages, outside '
          f'{(lo, hi)}')
    check(len(f32['refine']) == 5, f'opt_route float32: '
          f'{len(f32["refine"])} refine stages ran, expected 5')
    lo, hi = bracket(got['final'], STRING_F32_SLACK)
    lo, hi = min(lo, got['final'] - 2), max(hi, got['final'] + 2)
    check(lo <= f32['final'] <= hi, f'opt_route float32: final '
          f'{f32["final"]} outside {(lo, hi)}')
    e32 = f32['arrays']['final_energies']
    check(bool(np.isfinite(f32['arrays']['final_frames']).all())
          and bool(np.isfinite(e32).all()) and bool((e32 < 1e10).all()),
          'opt_route float32: final frames or energies not finite')
    # OpenBabel is absent here too: the force-field stage's probe raises
    # the JAX package's error (tests/test_torch_calculators.py holds the
    # text to the JAX package's)
    from tscode_tpu_torch.calculators.openbabel import probe_openbabel
    from tscode_tpu_torch.errors import InputError
    try:
        probe_openbabel('UFF')
    except InputError as e:
        check(str(e).startswith('FFCALC=OB needs OpenBabel'),
              f'opt_route: probe_openbabel raised {e}')
        print(f'[20 opt_route] FFCALC=OB: {e}')
    else:
        print('[20 opt_route] FFCALC=OB: OpenBabel is installed here')
    print(f'[20 opt_route float32] {f32["refine"]} jobs -> {f32["final"]} '
          f'final, {f32["calls"]} stand-in calls, run {f32["seconds"]:.2f} '
          f's: inside the brackets of float64\'s [{card}]')
    return launches, k3_err, rec


def route_counts(report):
    '''Every count of a CLI run report: the stages, the prunes, the
    embed's record, each arrangement of a multiembed, each search.'''
    def rows(recs):
        return [(r['stage'], r['structures_in'], r['structures_out'])
                for r in recs]
    out = {'stages': rows(report['stages']),
           'similarity': rows(report.get('similarity', [])),
           'final': report['final_structures']}
    for key, fields in (('string_embed', ('candidates', 'clash_ok', 'novel')),
                        ('cyclical_embed', ('blocks', 'candidates',
                                            'survivors')),
                        ('multiembed_embed', ('union_candidates',
                                              'union_survivors'))):
        if key in report:
            out[key] = [report[key][f] for f in fields]
    if 'multiembed_embed' in report:
        out['children'] = [(c['blocks'], c['survivors'], c['structures'])
                           for c in report['multiembed_embed']['children']]
    if 'csearch' in report:
        out['csearch'] = [(c['candidates'], c.get('conformers'))
                          for c in report['csearch']]
    return out


class MeshRecorder:
    '''While installed: the first string tile a sharded sweep builds
    (poses and pair list, K1's input), every tensor a sharded
    compenetration stage gives K2, and every slice a sharded prune pass
    gives K3 (pool, act, end, rows).'''

    def __init__(self):
        from tscode_tpu_torch.embeds import string
        from tscode_tpu_torch.parallel import prune, sharding
        self.k1, self.k2, self.k3 = [], [], []
        self.undo = []
        self.sharded = False          # set while a sharded run goes
        block = string.bcast_block

        def k1_block(inp, angles, c2_lo, c2_hi, clash_thresh):
            poses, ok = block(inp, angles, c2_lo, c2_hi, clash_thresh)
            if self.sharded and not self.k1:
                self.k1.append((poses, inp.pairs))
            return poses, ok
        k2_entry = sharding.compenetration_mask_kernel

        def k2(poses, pair_mask, thresh=1.5, max_clashes=0):
            self.k2.append((poses, pair_mask, thresh, max_clashes))
            return k2_entry(poses, pair_mask, thresh, max_clashes)
        pass_kill = prune.sharded_pass_kill

        def k3(pools, act, end, thr, mesh, pair_kill=prune.qcp_kill):
            def recorded(hs, a, e, t, rows):
                self.k3.append((hs, a, e, rows))
                return pair_kill(hs, a, e, t, rows=rows)
            return pass_kill(pools, act, end, thr, mesh, recorded)
        for mod, name, fn in ((string, 'bcast_block', k1_block),
                              (sharding, 'compenetration_mask_kernel', k2),
                              (prune, 'sharded_pass_kill', k3)):
            self.undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    def close(self):
        for mod, name, fn in self.undo:
            setattr(mod, name, fn)


def mesh_cli(tmp, inp, mesh, sharded, rec):
    '''run_cli in float64 on `inp`, unsharded (TSCODE_DISABLE_MESH=1) or
    under `mesh` with every mesh call site forced (TSCODE_MESH=1), the
    MeshRecorder `rec` told which. Returns run_cli's result and the
    kernels' launches of the run (run_cli sets the counts to 0 first):
    K1 `clash_ok`, K2 `compenetration_mask_kernel`, K1's search entries
    `torsion_clash_ok` and `torsion_backoff`, K3, T1 `tfd_first`, B1
    `block_screen`.'''
    from tscode_tpu_torch.ops.kernels import clash, qcp
    from tscode_tpu_torch.parallel.sharding import default_mesh
    key = 'TSCODE_MESH' if sharded else 'TSCODE_DISABLE_MESH'
    os.environ[key] = '1'
    rec.sharded = sharded
    try:
        with default_mesh(mesh):
            out = run_cli(tmp, inp, 'float64')
    finally:
        del os.environ[key]
        rec.sharded = False
    launches = dict(clash.launches_by_entry(), qcp_kill=qcp.KERNEL.launches,
                    tfd_first=out[0]['tfd_launches'],
                    block_screen=out[0]['b1_launches'])
    return out, launches


def mesh_route(card, name, n_confs, mesh, rec, tmp):
    '''One route unsharded then sharded through the CLI in float64: every
    count equal, frames within MESH_ATOL. name 'refine' takes the
    ensemble file to refine in place of n_confs. Returns (record, a copy
    of the sharded run's frames file).'''
    import shutil
    runs = {}
    for sharded in (False, True):
        d = os.path.join(tmp, f'{name}_{"sharded" if sharded else "single"}')
        os.makedirs(d)
        if name == 'refine':
            from tscode_tpu_torch.suite_inputs import refine_input
            inp = refine_input(n_confs, d)
        else:
            inp = suite_input(name, d, n_confs)
        (report, frames, _, secs), launches = mesh_cli(d, inp, mesh,
                                                       sharded, rec)
        sweeps = [report[k] for k in ('cyclical_embed', 'multiembed_embed')
                  if k in report]
        if sweeps:
            check_b1_route(f'[21 mesh] {name} sharded={sharded}', report,
                           sweeps[0])
            check('cyclical_embed' not in report or sweeps[0]['shards'] ==
                  (mesh.size if sharded else 1), f'[21 mesh] {name}: the '
                  f'sweep ran on {sweeps[0]["shards"]} shards')
        runs[sharded] = (route_counts(report), frames, secs, launches, d)
    (c0, f0, s0, l0, d0), (c1, f1, s1, l1, d1) = runs[False], runs[True]
    check(c1 == c0, f'[21 mesh] {name}: sharded counts {c1} != unsharded '
          f'{c0}')
    check(f1.shape == f0.shape and len(f0) > 0 and
          bool(np.isfinite(f1).all()), f'[21 mesh] {name}: frames '
          f'{f1.shape} against {f0.shape}')
    diff = float(np.abs(f1 - f0).max())
    check(diff <= MESH_ATOL, f'[21 mesh] {name}: sharded frames {diff:.2e} '
          f'A from the unsharded')
    stamp = f'smoke_{DEV}_float64'
    out = os.path.join(tmp, f'{name}_out.xyz')
    shutil.copy(os.path.join(d1, f'tscode_unoptimized_{stamp}.xyz'), out)
    r = {'counts': c1, 'final': c1['final'], 'max_frame_diff_A': diff,
         'unsharded_s': s0, 'sharded_s': s1, 'unsharded_launches': l0,
         'sharded_launches': l1}
    print(f'[21 mesh] {name}: sharded == unsharded, final {c1["final"]}, '
          f'frames within {diff:.2e} A; {s0:.3f} s unsharded, {s1:.3f} s '
          f'on {mesh.size} shards of one card (the sharding overhead, not '
          f'a speed-up); launches unsharded {l0}, sharded {l1} [{card}]')
    return r, out


def mesh_kernels(card, rec):
    '''K1, K2 and K3 on the shard-shaped tensors the sharded runs gave
    them, against their plain twins (off threshold ties), timed
    (device_ms; the plain twins with cuda_ms) and bounded (K1 and K2 by
    their bytes, K3 by qcp_bound over the slice's walks). Returns
    (records, largest disagreement).'''
    import torch
    from tscode_tpu_torch.ops.kernels import clash, qcp
    check(rec.k1 and rec.k2 and rec.k3, f'[21 mesh] recorded K1 '
          f'{len(rec.k1)}, K2 {len(rec.k2)}, K3 {len(rec.k3)} sharded inputs')
    out, err = {}, 0
    poses, pairs = rec.k1[0]
    want = clash.clash_ok_plain(poses, pairs, CLASH)
    e, _ = compare_bits(clash.clash_ok(poses, pairs, CLASH), want,
                        clash_ties(poses, pairs, CLASH), '[21 mesh] K1')
    err = max(err, e)
    out['clash_ok'] = {
        'shape': list(poses.shape), 'P': int(pairs.shape[0]),
        'ms': device_ms(lambda: clash.clash_ok(poses, pairs, CLASH)),
        'plain_ms': cuda_ms(lambda: clash.clash_ok_plain(poses, pairs,
                                                         CLASH)),
        'bound_ms': k1_bytes(poses, pairs) / HBM_BYTES_PER_S * 1e3,
        'bound_by': 'bytes',
        'regime': clash.clash_regime(pairs.shape[0], poses.shape[1],
                                     poses.element_size()),
        **k1_yardstick(poses, pairs)}
    for poses, pm, thresh, mc in rec.k2:
        mask = torch.as_tensor(pm, device=poses.device)
        pl = clash.pairs_of_mask(pm, poses.device)
        e, _ = compare_bits(clash.compenetration_mask_kernel(poses, pm,
                                                             thresh, mc),
                            clash.clash_counts_plain(poses, mask, thresh)
                            <= mc, clash_ties(poses, pl, thresh),
                            '[21 mesh] K2')
        err = max(err, e)
    poses, pm, thresh, mc = rec.k2[0]
    mask = torch.as_tensor(pm, device=poses.device)
    nbytes = poses.numel() * poses.element_size() + pm.size + \
        poses.shape[0]
    out['compenetration_mask_kernel'] = {
        'shape': list(poses.shape), 'shards': len(rec.k2),
        'ms': device_ms(lambda: clash.compenetration_mask_kernel(
            poses, pm, thresh, mc)),
        'plain_ms': cuda_ms(lambda: clash.clash_counts_plain(
            poses, mask, thresh) <= mc),
        'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3, 'bound_by': 'bytes'}
    for hs, act, end, rows in rec.k3:
        pos = torch.arange(rows, device=hs.device)
        e, _ = compare_bits(qcp.qcp_kill(hs, act, end, THR, rows=rows),
                            qcp.qcp_kill_plain(hs, act, end, THR, rows),
                            qcp_tie_rows(hs, act, end, pos,
                                         QCP_TIE['float64']),
                            '[21 mesh] K3')
        err = max(err, e)
    hs, act, end, rows = rec.k3[0]
    # the slice's walks: positions past `rows` get an empty chunk
    walk = qcp.walk_lengths(hs, act, torch.cat(
        [end, end.new_zeros(act.numel() - rows)]), THR)[:rows]
    bound, by = qcp_bound(rows, hs.shape[1] * 3 * hs.element_size(),
                          int(walk.sum()), hs.shape[1], 'float64')
    out['qcp_kill'] = {
        'slices': len(rec.k3), 'first_slice_rows': rows,
        'pool': list(hs.shape), 'pairs': int(walk.sum()),
        'ms': device_ms(lambda: qcp.qcp_kill(hs, act, end, THR, rows=rows)),
        'plain_ms': cuda_ms(lambda: qcp.qcp_kill_plain(hs, act, end, THR,
                                                       rows), reps=3),
        'bound_ms': bound, 'bound_by': by}
    for k, r in out.items():
        print(f'[21 mesh] {k} on a shard\'s tensor {r}: equal to plain off '
              f'ties [{card}]')
    return out, err


def mesh_screen_step(card, mesh, tmp):
    '''sharded_embed_screen_step on MESH_SCREEN_B poses of the sn2_string
    molecules over the mesh, against the same step on one shard.'''
    import torch
    from tscode_tpu_torch.embeds.common import stacked_lobes
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.parallel.sharding import (make_mesh,
                                                    sharded_embed_screen_step)
    emb = embedder_setup(suite_input('sn2_string', tmp, STRING_CONFS),
                         torch.float64)
    m1, m2 = emb.objects
    (c1, v1), (c2, v2) = stacked_lobes(m1), stacked_lobes(m2)
    rng = np.random.default_rng(21)
    B = MESH_SCREEN_B
    args = (m1.atomcoords, m2.atomcoords, c1, v1, c2, v2,
            rng.integers(0, m1.n_confs, B), rng.integers(0, m2.n_confs, B),
            rng.integers(0, c1.shape[1], B), rng.integers(0, c2.shape[1], B),
            rng.choice(np.linspace(0.0, 350.0, 36), B),
            cross_fragment_pair_mask((m1.n_atoms, m2.n_atoms)))
    args = tuple(torch.as_tensor(a, device=DEV) if i < 6 or i == 10 else a
                 for i, a in enumerate(args))
    one = make_mesh(devices=[DEV])
    p1, k1, n1 = sharded_embed_screen_step(one)(*args)
    p4, k4, n4 = sharded_embed_screen_step(mesh)(*args)
    diff = float((p4 - p1).abs().max())
    check(torch.equal(k4, k1) and n4 == n1 and diff <= MESH_ATOL and
          p4.shape == (B, m1.n_atoms + m2.n_atoms, 3),
          f'[21 mesh] screen step: {n4} kept on {mesh.size} shards, {n1} on '
          f'one, poses {diff:.2e} A apart')
    print(f'[21 mesh] sharded_embed_screen_step, B = {B} on {mesh.size} '
          f'shards: {n4} kept, equal to one shard (poses within '
          f'{diff:.2e} A) [{card}]')
    return {'B': B, 'kept': n4, 'max_pose_diff_A': diff}


def mesh_fire(card, mesh):
    '''fire_minimize_batch_sharded on phase 12's survivors for FIRE_STEPS
    steps in float64 against the unsharded batch: coordinates within
    MESH_ATOL, the same rows stopped; the force field's FIRE kernel
    launched once a call unsharded and once a shard sharded; both timed
    (host clock, synced, after a warm-up run).'''
    import torch
    from tscode_tpu_torch import optimizers as opt
    from tscode_tpu_torch.ff import ff_energy, params_to_device
    poses, ffp = trimol_topology()
    params = params_to_device(ffp, DEV, torch.float64)
    x = torch.as_tensor(poses, dtype=torch.float64, device=DEV)
    kw = dict(n_steps=FIRE_STEPS, energy_args=(params,))
    secs, launches = {}, {}
    for name, run in (('unsharded', lambda: opt.fire_minimize_batch(
            x, ff_energy, **kw)), ('sharded', lambda: opt.
            fire_minimize_batch_sharded(x, ff_energy, mesh, **kw))):
        with FireCalls() as fire:
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
        secs[name] = (time.perf_counter() - t0, out)
        launches[name] = count_fire('21', f'mesh FIRE {name}',
                                    fire.record())
    check(launches == {'unsharded': 2, 'sharded': 2 * MESH_SHARDS},
          f'[21 mesh] FIRE kernel launches {launches} in two calls each, '
          f'expected 2 and {2 * MESH_SHARDS}')
    (c0, _, d0), (c1, _, d1) = secs['unsharded'][1], secs['sharded'][1]
    diff = float((c1 - c0).abs().max())
    check(diff <= MESH_ATOL and torch.equal(d0, d1), f'[21 mesh] FIRE: '
          f'sharded {diff:.2e} A from unsharded, stopped rows '
          f'{int(d1.sum())} against {int(d0.sum())}')
    r = {'rows': len(x), 'steps': FIRE_STEPS, 'stopped': int(d1.sum()),
         'max_diff_A': diff, 'unsharded_s': secs['unsharded'][0],
         'sharded_s': secs['sharded'][0], 'ff_fire_launches': launches}
    print(f'[21 mesh] FIRE on {len(x)} survivors, {FIRE_STEPS} steps, '
          f'float64: sharded within {diff:.2e} A of unsharded, '
          f'{r["stopped"]} rows stopped in both; {r["unsharded_s"]:.4f} s '
          f'unsharded, {r["sharded_s"]:.4f} s on {mesh.size} shards [{card}]')
    return r


def phase_mesh(card):
    '''Phase 21: the sharded paths on a mesh naming the card MESH_SHARDS
    times. Each route of MESH_ROUTES through the CLI in float64, first
    unsharded, then with the mesh installed and every mesh call site
    forced (TSCODE_MESH=1): the string sweep's c2 slices (K1 per shard),
    the rigid block sweeps' row slices (K1 per shard), the back-off
    (one torsion_backoff a torsion a shard), the compenetration stage (K2 per
    shard), the TFD first-successor and moments sharded; then REFINE on
    the rigid route's output (every RMSD pass split over the shards, K3
    per slice); each TFD prune pass one T1 launch a shard. Every count equals the unsharded run's, frames within
    MESH_ATOL. Then K1, K2 and K3 against their plain twins on the
    shard-shaped inputs, sharded_embed_screen_step, and the sharded FIRE.
    Returns (record, the sharded launches per kernel, largest
    disagreement).'''
    import tempfile
    from tscode_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(devices=[DEV] * MESH_SHARDS)
    rec = MeshRecorder()
    routes = {}
    with tempfile.TemporaryDirectory(prefix='smoke_mesh_') as tmp:
        try:
            for name, n in MESH_ROUTES:
                routes[name], out = mesh_route(card, name, n, mesh, rec, tmp)
                if name == 'da_cyclical_xl':
                    routes['refine'], _ = mesh_route(card, 'refine', out,
                                                     mesh, rec, tmp)
        finally:
            rec.close()
        screen = mesh_screen_step(card, mesh, tmp)
    check(routes['sn2_string']['counts']['string_embed'] + [
        routes['sn2_string']['final']] == list(STRING_F64),
        f'[21 mesh] sn2_string sharded counts != {STRING_F64}')
    check(routes['da_cyclical_xl']['counts']['cyclical_embed'][1:] + [
        routes['da_cyclical_xl']['final']] == list(CYC_F64),
        f'[21 mesh] da_cyclical_xl sharded counts != {CYC_F64}')
    kernels, err = mesh_kernels(card, rec)
    fire = mesh_fire(card, mesh)
    launches = {'clash_ok': 0, 'compenetration_mask_kernel': 0,
                'torsion_backoff': 0, 'qcp_kill': 0, 'tfd_first': 0,
                'block_screen': 0}
    for r in routes.values():
        for k in launches:
            launches[k] += r['sharded_launches'][k]
        check(r['sharded_launches']['torsion_clash_ok'] ==
              r['unsharded_launches']['torsion_clash_ok'] == 0,
              f'[21 mesh] torsion_clash_ok launched on a route: {r}')
    check(all(launches.values()), f'[21 mesh] sharded launches {launches}: '
          f'a kernel did not launch on a sharded path')
    cs = routes['csearch_string']
    check(cs['unsharded_launches']['torsion_backoff'] == 8 and
          cs['sharded_launches']['torsion_backoff'] == 8 * MESH_SHARDS,
          f'[21 mesh] csearch_string back-off launches unsharded '
          f'{cs["unsharded_launches"]}, sharded {cs["sharded_launches"]}: '
          f'expected one torsion_backoff a torsion (8), a shard '
          f'({MESH_SHARDS})')
    t1 = (cs['unsharded_launches']['tfd_first'],
          cs['sharded_launches']['tfd_first'])
    check(t1[0] >= SEARCH_TFD_PASSES and t1[1] == MESH_SHARDS * t1[0],
          f'[21 mesh] csearch_string T1 launches unsharded {t1[0]}, sharded '
          f'{t1[1]}: expected one a pass ({SEARCH_TFD_PASSES} in the search\'s '
          f'prune), one a pass a shard sharded')
    print(f'[21 mesh] csearch_string: T1 launched {t1[0]} times unsharded, '
          f'{t1[1]} times on {MESH_SHARDS} shards (one a pass a shard, one '
          f'gather and read a pass) [{card}]')
    record = {'card': card, 'mesh': [str(d) for d in mesh.devices],
              'routes': routes, 'kernels': kernels, 'screen_step': screen,
              'fire': fire, 'sharded_launches': launches}
    return record, launches, err


def trace_events(path):
    '''The events of a Chrome trace file (torch.profiler's JSON).'''
    with open(path) as f:
        return json.load(f)['traceEvents']


def innermost_spans(spans, points):
    '''For each (tid, ts, key) of `points`, the name of the innermost
    host span of `spans` (user_annotation events, nested per thread)
    enclosing ts on that thread: {key: name}. One sweep per thread.'''
    by_tid = {}
    for s in spans:
        by_tid.setdefault(s['tid'], ([], []))[0].append(s)
    for tid, ts, key in points:
        by_tid.setdefault(tid, ([], []))[1].append((ts, key))
    out = {}
    for sp, pts in by_tid.values():
        sp.sort(key=lambda e: (e['ts'], -e['dur']))
        pts.sort()
        stack, i = [], 0
        for ts, key in pts:
            while i < len(sp) and sp[i]['ts'] <= ts:
                while stack and stack[-1]['ts'] + stack[-1]['dur'] < \
                        sp[i]['ts']:
                    stack.pop()
                stack.append(sp[i])
                i += 1
            while stack and stack[-1]['ts'] + stack[-1]['dur'] < ts:
                stack.pop()
            out[key] = stack[-1]['name'] if stack else None
    return out


def busy_share(device, window):
    '''The share of the window (t0, t1) in which some device event ran
    (the union of their intervals).'''
    t0, t1 = window
    busy, end = 0.0, t0
    for e in sorted(device, key=lambda e: e['ts']):
        lo, hi = max(e['ts'], end), min(e['ts'] + e['dur'], t1)
        if hi > lo:
            busy += hi - lo
            end = hi
    return busy / (t1 - t0) if t1 > t0 else None


def trace_kernels(tag, events, spans, api, report):
    '''Each hand-kernel entry the run launched, found in the trace: its
    device events under the kernel's __global__ name (TRACE_KERNELS) and
    its launch spans `<library>.<entry>`, as many of each as the entry's
    launch count, paired in time order (the stream runs them in launch
    order). When CUPTI correlates the i-th event with its launch call
    (`api`: the CUDA API calls by correlation id), that call lies inside
    the i-th span; an event it does not correlate must start after the
    span began. (A correlated event is not held to that: the kernel
    records' clock, converted from the card's, ran up to 1.05 ms ahead
    of the host's spans in some runs while its launch call lay inside
    its span; `kernel_minus_launch_us` records that offset.) Each clash,
    ff_fire, dimer and block_screen launch span lies inside the span of
    the wrapper that asked for it, as many wrapper spans as that wrapper's
    launches (B1's screen under `block_screen`, its write under
    `block_survivors`).
    Returns ({entry: record}, {id of a kernel event: its launch
    span}).'''
    import re
    out, owner = {}, {}
    launched = {TRACE_KERNELS[e]
                for entries in report['kernel_entries'].values()
                for e, n in entries.items() if n}
    for lib, entries in report['kernel_entries'].items():
        for entry, n in entries.items():
            name, arg = TRACE_KERNELS[entry]
            if not n and (name, arg) in launched:
                continue    # another entry launched this kernel
            pat = re.compile(rf'\b{name}<{arg}\b' if arg else
                             rf'\b{name}\b')
            ks = sorted((e for e in events if e.get('cat') == 'kernel'
                         and pat.search(e['name'])), key=lambda e: e['ts'])
            ss = sorted((s for s in spans if s['name'] == f'{lib}.{entry}'),
                        key=lambda s: s['ts'])
            check(len(ks) == n == len(ss), f'[22 trace] {tag}: {lib}.{entry}'
                  f' launched {n} times, {len(ss)} launch spans, {len(ks)} '
                  f'device events named {name}<{arg}...>')
            lead = []
            for k, s in zip(ks, ss):
                a = api.get(k.get('args', {}).get('correlation'))
                if a is not None:
                    check(s['ts'] <= a['ts'] <= s['ts'] + s['dur'],
                          f'[22 trace] {tag}: {k["name"][:60]} correlates '
                          f'with a launch outside its span {s["name"]}')
                    lead.append(k['ts'] - a['ts'])
                else:
                    check(k['ts'] >= s['ts'], f'[22 trace] {tag}: an '
                          f'uncorrelated {name} event starts '
                          f'{s["ts"] - k["ts"]} us before its launch span')
                owner[id(k)] = s['name']
            if n:
                out[f'{lib}.{entry}'] = {
                    'launches': n, 'events': len(ks), 'correlated': len(lead),
                    'kernel': ks[0]['name'][:80],
                    'kernel_minus_launch_us': [min(lead), max(lead)]
                    if lead else None}
    wrappers = dict(report['clash_entry_launches'], ff_fire=sum(
        report['kernel_entries'].get('ff_fire', {}).values()),
        dimer=sum(report['kernel_entries'].get('dimer', {}).values()),
        block_screen=report.get('b1_launches', 0),
        block_survivors=report.get('b1_write_launches', 0),
        neb_band=sum(report['kernel_entries'].get('neb_band', {}).values()),
        idpp_fire=sum(
            report['kernel_entries'].get('idpp_fire', {}).values()))
    for wrapper, n in wrappers.items():
        ws = [s for s in spans if s['name'] == wrapper]
        check(len(ws) == n, f'[22 trace] {tag}: {n} {wrapper} launches, '
              f'{len(ws)} {wrapper} spans')
    for s in spans:
        if s['name'].startswith(('clash.', 'ff_fire.', 'dimer.',
                                 'block_screen.', 'neb_band.',
                                 'idpp_fire.')):
            check(any(w['name'] in wrappers and
                      w['tid'] == s['tid'] and w['ts'] <= s['ts'] and
                      s['ts'] + s['dur'] <= w['ts'] + w['dur']
                      for w in spans), f'[22 trace] {tag}: launch span '
                  f'{s["name"]} outside any wrapper span')
    return out, owner


def trace_check(card, tag, path, report, secs, secs_plain):
    '''One traced run's trace: it parses as Chrome-trace JSON; every hand
    kernel found (trace_kernels); a span for each timed stage of the run
    report; no fewer kernel events than kernel launch calls (a trace
    taken right after a multi-gigabyte one lost some). Prints and
    returns the trace's bytes, the wall seconds
    traced and not, the device's busy share over the profile's window
    and the TRACE_TOP device operations that took the most time, each
    with the innermost host span around its launch.'''
    t0 = time.perf_counter()
    events = trace_events(path)
    spans = [e for e in events if e.get('cat') == 'user_annotation'
             and e.get('ph') == 'X']
    names = {}
    for s in spans:
        names[s['name']] = names.get(s['name'], 0) + 1
    for st in report['stages']:
        check(st['stage'] in names, f'[22 trace] {tag}: no span of the '
              f'stage {st["stage"]}')
    api = {e['args']['correlation']: e for e in events
           if e.get('cat') in ('cuda_runtime', 'cuda_driver')
           and 'correlation' in e.get('args', {})}
    kernels, owner = trace_kernels(tag, events, spans, api, report)
    device = [e for e in events if e.get('cat') in TRACE_DEVICE_CATS
              and e.get('ph') == 'X']
    check(device, f'[22 trace] {tag}: no device event in {path}')
    n_kernels = sum(e.get('cat') == 'kernel' for e in events)
    n_calls = sum(e['name'] in ('cudaLaunchKernel', 'cuLaunchKernel')
                  for e in api.values())
    check(n_kernels >= n_calls, f'[22 trace] {tag}: {n_kernels} kernel '
          f'events for {n_calls} kernel launch calls: device events lost')
    timed = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    window = (min(e['ts'] for e in timed),
              max(e['ts'] + e['dur'] for e in timed))
    launch = {}
    for e in device:
        a = api.get(e.get('args', {}).get('correlation'))
        if a is not None and id(e) not in owner:
            launch[id(e)] = (a['tid'], a['ts'], id(e))
    where = innermost_spans(spans, launch.values())
    where.update(owner)
    top = {}
    for e in device:
        key = (e['name'][:70], where.get(id(e)))
        top[key] = top.get(key, 0.0) + e['dur']
    top = sorted(top.items(), key=lambda kv: -kv[1])[:TRACE_TOP]
    rec = {'route': tag, 'trace_bytes': os.path.getsize(path),
           'traced_s': secs, 'untraced_s': secs_plain,
           'busy_share': busy_share(device, window),
           'window_s': (window[1] - window[0]) / 1e6,
           'device_events': len(device), 'spans': len(spans),
           'kernel_events': n_kernels, 'kernel_launch_calls': n_calls,
           'kernels': kernels, 'parse_s': time.perf_counter() - t0,
           'top': [{'op': k[0], 'span': k[1], 'ms': v / 1e3}
                   for k, v in top]}
    print(f'[22 trace {tag}] {rec["trace_bytes"]} bytes, traced '
          f'{secs:.3f} s, untraced {secs_plain:.3f} s, device busy '
          f'{rec["busy_share"]:.4f} of {rec["window_s"]:.3f} s, '
          f'{len(device)} device events ({rec["kernel_events"]} kernels for '
          f'{rec["kernel_launch_calls"]} kernel launch calls, graphs '
          f'aside), {len(spans)} spans; hand kernels {kernels} [{card}]')
    for i, t in enumerate(rec['top']):
        print(f'[22 trace {tag}] top {i + 1}: {t["ms"]:.4f} ms {t["op"]} '
              f'(span {t["span"]}) [{card}]')
    return rec, names


class CaptureCount:
    '''While open, the CUDA graphs that capture.graph_loop captures.'''

    def __enter__(self):
        from tscode_tpu_torch import capture
        self.n, self.real = 0, capture.GraphLoop
        count = self

        class Counted(self.real):
            def __init__(self, *args):
                count.n += 1
                super().__init__(*args)
        capture.GraphLoop = Counted
        return self

    def __exit__(self, *exc):
        from tscode_tpu_torch import capture
        capture.GraphLoop = self.real


def trace_file(trace_dir):
    '''The one Chrome trace a --trace run wrote into trace_dir.'''
    import glob
    paths = glob.glob(os.path.join(trace_dir, '*.pt.trace.json'))
    check(len(paths) == 1, f'[22 trace] trace files in {trace_dir}: {paths}')
    return paths[0]


NO_LAUNCHES = {'kernel_entries': {'clash': {}, 'qcp_kill': {}},
               'clash_entry_launches': {}, 'stages': []}


def traced_route(card, tag, tmp, inp):
    '''One input through the CLI in float64 untraced, then with --trace:
    the same stage counts and frames; the trace checked (trace_check).
    Returns (traced run's report, trace record, span counts, launches of
    both runs: K1, K2, K3, torsion_backoff, ff_fire, T1, B1).'''
    trace_dir = os.path.join(tmp, 'trace')
    runs = [run_cli(tmp, inp, 'float64', args=args)
            for args in ((), ('--trace', trace_dir))]
    (r0, f0, _, s0), (r1, f1, _, s1) = runs
    check(stage_counts(r1) == stage_counts(r0) and f1.shape == f0.shape
          and len(f0) and np.array_equal(f1, f0), f'[22 trace] {tag}: '
          f'stages {stage_counts(r1)} frames {f1.shape} against the '
          f'untraced run\'s {stage_counts(r0)} {f0.shape}, or other frames')
    rec, names = trace_check(card, tag, trace_file(trace_dir), r1, s1, s0)
    launches = [0, 0, 0, 0, 0, 0, 0]
    for r, _, _, _ in runs:
        e = r['clash_entry_launches']
        launches[0] += e['clash_ok'] + e['torsion_clash_ok']
        launches[1] += e['compenetration_mask_kernel']
        launches[2] += sum(r['kernel_entries']['qcp_kill'].values())
        launches[3] += e['torsion_backoff']
        launches[4] += check_fire(f'[22 trace] {tag}', r['fire'], False)
        launches[5] += r['tfd_launches']
        launches[6] += r['b1_launches']
    return r1, rec, names, launches


def traced_fire(card, tmp):
    """A bend's FIRE call under the CLI's trace (backend.DeviceTrace, as
    --trace opens it): one fire_minimize_batch of a bend's length
    (BEND_FIRE_STEPS steps) on the monomolecular input's MONO_CONFS
    C2F2H4 conformers under the internal force field, float64, untraced
    then traced: one launch of the force field's FIRE kernel each, no
    graph captured, the same coordinates, energies and stop flags bit for
    bit; in the trace one event of the chosen form's kernel
    (ff_fire_group_kernel<double, ...> for the lone form) inside its
    launch span ff_fire.ff_fire_f64 inside the wrapper's span ff_fire
    (trace_check). Then saddle>'s dimer on the first conformer, one D1
    launch (traced_d1), and neb> between the two conformers, one I1 and
    two N1 launches (traced_neb). Then the captured graph on a body that runs
    through capture.graph_loop for other energies, the dimer step
    (saddle._dimer_step) from
    the first conformer for TRACE_DIMER_STEPS steps: run with the graph
    cache emptied untraced, then again emptied and traced (the graph
    captured under the profiler), then traced no more (replayed from that
    graph, not captured again): the same state bit for bit; in the trace
    the capture and replay spans, one cudaGraphLaunch a step inside the
    replay span, the same kernels behind each. Returns the record."""
    import contextlib
    import torch
    from tscode_tpu_torch import capture, optimizers, saddle
    from tscode_tpu_torch.backend import DeviceTrace
    from tscode_tpu_torch.bending import BEND_FIRE_STEPS
    from tscode_tpu_torch.ff import build_ff_params, ff_energy, \
        params_to_device
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.ops.kernels import ff_fire
    ens = read_xyz(os.path.join(os.path.dirname(
        suite_input('monomolecular', tmp, MONO_CONFS)), 'm1.xyz'))
    coords, atomnos = np.asarray(ens.atomcoords), np.asarray(ens.atomnos)
    params = params_to_device(build_ff_params(
        coords[0], atomnos, graphize(coords[0], atomnos)), DEV,
        torch.float64)
    x = torch.as_tensor(coords, dtype=torch.float64, device=DEV)

    fire_dir = os.path.join(tmp, 'fire')
    runs, secs = [], []
    for traced in (False, True):
        ff_fire.KERNEL.reset_counts()
        with CaptureCount() as cap, DeviceTrace(fire_dir, DEV) if traced \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            runs.append(optimizers.fire_minimize_batch(
                x, ff_energy, n_steps=BEND_FIRE_STEPS, energy_args=(params,)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        check(cap.n == 0 and ff_fire.KERNEL.entry_launches ==
              {'ff_fire_f32': 0, 'ff_fire_f64': 1}, f'[22 trace] FIRE: '
              f'{cap.n} graphs captured, kernel launches '
              f'{ff_fire.KERNEL.entry_launches} (traced: {traced})')
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          '[22 trace] FIRE: the traced run differs from the untraced one')
    report = dict(NO_LAUNCHES, kernel_entries=dict(
        NO_LAUNCHES['kernel_entries'],
        ff_fire=dict(ff_fire.KERNEL.entry_launches)))
    rec, names = trace_check(card, 'fire', trace_file(fire_dir), report,
                             secs[1], secs[0])
    check(names.get('fire_minimize_batch') == 1 and
          names.get('ff_fire') == 1 and
          not any(n.startswith('GraphLoop') for n in names) and
          rec['kernels']['ff_fire.ff_fire_f64']['events'] == 1,
          f'[22 trace] FIRE: spans {names}, kernels {rec["kernels"]}')
    rec.update(steps=BEND_FIRE_STEPS, shape=list(x.shape))
    print(f'[22 trace fire] {x.shape[0]} x {x.shape[1]} atoms, '
          f'{BEND_FIRE_STEPS} steps, float64: one ff_fire launch, its '
          f'{rec["kernels"]["ff_fire.ff_fire_f64"]["kernel"]} event inside '
          f'ff_fire.ff_fire_f64 inside '
          f'ff_fire; no graph captured; the traced coordinates equal the '
          f'untraced ones bit for bit ({secs[1]:.4f} / {secs[0]:.4f} s) '
          f'[{card}]')

    rec['d1'] = traced_d1(card, tmp, x[0], params)
    rec['neb'] = traced_neb(card, tmp, x, params)

    dimer_dir = os.path.join(tmp, 'dimer')
    body = saddle._dimer_step(ff_energy, 12, 1e-3, 0.02, 0.05)
    maker = '_dimer_step'
    state = (x[0], saddle.dimer_start(x[0]),
             torch.zeros((), dtype=torch.bool, device=DEV))
    runs, secs, caps = [], [], []
    for traced, fresh in ((False, True), (True, True), (False, False)):
        if fresh:
            capture._graphs.clear()
        with CaptureCount() as cap, DeviceTrace(dimer_dir, DEV) if traced \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = capture.graph_loop(body, state, (params,),
                                     TRACE_DIMER_STEPS)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        runs.append(out)
        caps.append(cap.n)
    check(caps == [1, 1, 0] and all(
        torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0])),
        f'[22 trace] dimer: captures {caps} (untraced, traced, replayed), '
        f'or the runs differ')
    path = trace_file(dimer_dir)
    rec_d, names = trace_check(card, 'dimer', path, NO_LAUNCHES, secs[1],
                               secs[0])
    events = trace_events(path)
    run = [e for e in events if e.get('cat') == 'user_annotation'
           and e['name'] == f'GraphLoop.run:{maker}']
    launches = {e['args']['correlation']: e for e in events
                if e.get('name') == 'cudaGraphLaunch'}
    per = {}
    for e in events:
        c = e.get('args', {}).get('correlation')
        if e.get('cat') == 'kernel' and c in launches:
            per[c] = per.get(c, 0) + 1
    check(len(run) == 1 and names.get(f'GraphLoop.capture:{maker}') == 1
          and len(launches) == TRACE_DIMER_STEPS == len(per) and
          len(set(per.values())) == 1 and all(
              run[0]['ts'] <= a['ts'] <= run[0]['ts'] + run[0]['dur']
              for a in launches.values()), f'[22 trace] dimer: spans '
          f'{names}, {len(launches)} graph launches for {TRACE_DIMER_STEPS} '
          f'steps, kernels a replay {sorted(set(per.values()))}')
    rec_d.update(steps=TRACE_DIMER_STEPS, atoms=int(x.shape[1]),
                 kernels_per_replay=next(iter(per.values())), captures=caps,
                 replayed_s=secs[2])
    rec['dimer_graph'] = rec_d
    print(f'[22 trace dimer] {x.shape[1]} atoms, {TRACE_DIMER_STEPS} dimer '
          f'steps, float64: the graph captured under the profiler gives the '
          f'untraced run\'s state bit for bit and is replayed untraced '
          f'without a new capture ({secs[2]:.4f} s); {TRACE_DIMER_STEPS} '
          f'cudaGraphLaunch inside GraphLoop.run:{maker}, '
          f'{rec_d["kernels_per_replay"]} kernels each [{card}]')
    return rec


def traced_d1(card, tmp, x, params):
    '''saddle>'s dimer under the CLI's trace (backend.DeviceTrace):
    saddle.dimer_saddle on x (N, 3) under ff_energy's tables `params`,
    float64, untraced then traced: one D1 launch each, no graph
    captured, the same coordinates, energy and flag bit for bit; in the
    trace one dimer_lone_kernel<double> event (the lone form) inside its
    launch span dimer.dimer_f64 inside the wrapper's span dimer inside
    dimer_saddle (trace_check). Returns the record.'''
    import contextlib
    import torch
    from tscode_tpu_torch import saddle
    from tscode_tpu_torch.backend import DeviceTrace
    from tscode_tpu_torch.ff import ff_energy
    from tscode_tpu_torch.ops.kernels import dimer
    d1_dir = os.path.join(tmp, 'd1')
    runs, secs = [], []
    for traced in (False, True):
        dimer.KERNEL.reset_counts()
        with CaptureCount() as cap, DeviceTrace(d1_dir, DEV) if traced \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            runs.append(saddle.dimer_saddle(x, ff_energy,
                                            energy_args=(params,)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        check(cap.n == 0 and dimer.KERNEL.entry_launches ==
              {'dimer_f32': 0, 'dimer_f64': 1}, f'[22 trace] D1: {cap.n} '
              f'graphs captured, kernel launches '
              f'{dimer.KERNEL.entry_launches} (traced: {traced})')
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          '[22 trace] D1: the traced run differs from the untraced one')
    report = dict(NO_LAUNCHES, kernel_entries=dict(
        NO_LAUNCHES['kernel_entries'],
        dimer=dict(dimer.KERNEL.entry_launches)))
    path = trace_file(d1_dir)
    rec, names = trace_check(card, 'd1', path, report, secs[1], secs[0])
    kernel = rec['kernels'].get('dimer.dimer_f64', {})
    check(names.get('dimer_saddle') == 1 and names.get('dimer') == 1 and
          not any(n.startswith('GraphLoop') for n in names) and
          kernel.get('events') == 1, f'[22 trace] D1: spans {names}, '
          f'kernels {rec["kernels"]}')
    spans = {e['name']: e for e in trace_events(path)
             if e.get('cat') == 'user_annotation' and e.get('ph') == 'X'}
    check(all(spans[a]['ts'] <= spans[b]['ts'] and
              spans[b]['ts'] + spans[b]['dur'] <=
              spans[a]['ts'] + spans[a]['dur']
              for a, b in (('dimer_saddle', 'dimer'),
                           ('dimer', 'dimer.dimer_f64'))),
          '[22 trace] D1: dimer.dimer_f64 not inside dimer inside '
          'dimer_saddle')
    rec.update(atoms=int(x.shape[0]), converged=bool(runs[0][2]))
    print(f'[22 trace d1] {x.shape[0]} atoms, float64: one D1 launch, its '
          f'{kernel["kernel"]} event inside dimer.dimer_f64 inside dimer '
          f'inside dimer_saddle; no graph captured; the traced coordinates '
          f'equal the untraced ones bit for bit ({secs[1]:.4f} / '
          f'{secs[0]:.4f} s) [{card}]')
    return rec


def traced_neb(card, tmp, x, params):
    '''neb> between two conformers x (2, N, 3) under the CLI's trace
    (backend.DeviceTrace): neb.run_neb (7 images, 400 + 400 steps) on
    ff_energy's tables `params`, float64, untraced then traced: one I1
    launch and two N1 launches each, no graph captured, the same band,
    energies and TS image bit for bit; in the trace the I1 event inside
    its launch span idpp_fire.idpp_fire_f64 inside the wrapper's span
    idpp_fire, and each N1 event (neb_band_kernel<double, ...>) inside
    neb_band.neb_band_f64 inside neb_band, all inside run_neb
    (trace_check). Returns the record.'''
    import contextlib
    import torch
    from tscode_tpu_torch import neb
    from tscode_tpu_torch.backend import DeviceTrace
    from tscode_tpu_torch.ff import ff_energy
    from tscode_tpu_torch.ops.kernels import idpp
    from tscode_tpu_torch.ops.kernels import neb as kn
    neb_dir = os.path.join(tmp, 'neb')
    start, end = x[0].cpu().numpy(), x[1].cpu().numpy()
    runs, secs = [], []
    for traced in (False, True):
        kn.KERNEL.reset_counts()
        idpp.KERNEL.reset_counts()
        with CaptureCount() as cap, DeviceTrace(neb_dir, DEV) if traced \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            runs.append(neb.run_neb(start, end, ff_energy,
                                    energy_args=(params,), device=DEV))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        check(cap.n == 0 and kn.KERNEL.entry_launches == {'neb_band_f64': 2}
              and idpp.KERNEL.entry_launches == {'idpp_fire_f64': 1},
              f'[22 trace] neb: {cap.n} graphs captured, kernel launches '
              f'{kn.KERNEL.entry_launches} {idpp.KERNEL.entry_launches} '
              f'(traced: {traced})')
    check(all(np.array_equal(a, b) for a, b in zip(runs[0][:2], runs[1][:2]))
          and runs[0][2] == runs[1][2],
          '[22 trace] neb: the traced run differs from the untraced one')
    report = dict(NO_LAUNCHES, kernel_entries=dict(
        NO_LAUNCHES['kernel_entries'],
        neb_band=dict(kn.KERNEL.entry_launches),
        idpp_fire=dict(idpp.KERNEL.entry_launches)))
    path = trace_file(neb_dir)
    rec, names = trace_check(card, 'neb', path, report, secs[1], secs[0])
    n1 = rec['kernels'].get('neb_band.neb_band_f64', {})
    i1 = rec['kernels'].get('idpp_fire.idpp_fire_f64', {})
    check(names.get('run_neb') == 1 and names.get('neb_band') == 2 and
          names.get('idpp_fire') == 1 and
          not any(n.startswith('GraphLoop') for n in names) and
          n1.get('events') == 2 and i1.get('events') == 1,
          f'[22 trace] neb: spans {names}, kernels {rec["kernels"]}')
    spans = [e for e in trace_events(path)
             if e.get('cat') == 'user_annotation' and e.get('ph') == 'X']

    def inside(outer, inner):
        return all(any(o['name'] == outer and o['ts'] <= s['ts'] and
                       s['ts'] + s['dur'] <= o['ts'] + o['dur']
                       for o in spans) for s in spans if s['name'] == inner)
    check(all(inside(a, b) for a, b in (
        ('run_neb', 'neb_band'), ('neb_band', 'neb_band.neb_band_f64'),
        ('run_neb', 'idpp_fire'), ('idpp_fire', 'idpp_fire.idpp_fire_f64'))),
        '[22 trace] neb: a launch span outside its wrapper or run_neb')
    rec.update(atoms=int(x.shape[1]), ts_image=int(runs[0][2]))
    print(f'[22 trace neb] {x.shape[1]} atoms, 7 images, float64: one I1 '
          f'launch, its {i1["kernel"]} event inside idpp_fire.idpp_fire_f64 '
          f'inside idpp_fire, and two N1 launches, their {n1["kernel"]} '
          f'events inside neb_band.neb_band_f64 inside neb_band, all inside '
          f'run_neb; no graph captured; the traced band equals the '
          f'untraced one bit for bit ({secs[1]:.4f} / {secs[0]:.4f} s) '
          f'[{card}]')
    return rec


def traced_thread(card, tmp):
    '''A K1 launch from a worker thread, as the calculator dispatch runs
    its jobs, under the CLI's trace (backend.DeviceTrace): its device
    event is in the trace, found under the kernel's name; whether its
    spans, entered on the worker, are there too is printed (the profiler
    records the host ops of the thread that started it). Returns the
    record.'''
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from tscode_tpu_torch.backend import DeviceTrace
    from tscode_tpu_torch.ops.kernels import clash
    rng = np.random.default_rng(22)
    poses = torch.as_tensor(rng.normal(size=(256, 11, 3)) * 3,
                            device=DEV)
    pairs = torch.as_tensor([[i, j] for i in range(4) for j in range(4, 11)],
                            dtype=torch.int32, device=DEV)
    clash.KERNEL.reset_counts()
    with DeviceTrace(tmp, DEV) as trace, ThreadPoolExecutor(1) as pool:
        ok = pool.submit(clash.clash_ok, poses, pairs, CLASH).result()
    check(torch.equal(ok, clash.clash_ok_plain(poses, pairs, CLASH)),
          '[22 trace] thread: K1 against plain')
    events = trace_events(trace.path)
    kernels = sum(e.get('cat') == 'kernel' and
                  'clash_ok_ring_kernel<double' in e['name'] for e in events)
    spans = sorted({e['name'] for e in events
                    if e.get('cat') == 'user_annotation'})
    check(kernels == clash.KERNEL.launches == 1, f'[22 trace] thread: '
          f'{kernels} clash_ok_ring_kernel events for '
          f'{clash.KERNEL.launches} launch')
    print(f'[22 trace thread] a K1 launch on a worker thread: its kernel '
          f'in the trace; spans of the worker in the trace: {spans} '
          f'[{card}]')
    return {'kernel_events': kernels, 'worker_spans': spans}


def traced_backoff(card, tmp):
    '''The search's back-off under the CLI's trace (backend.DeviceTrace,
    as --trace opens it): apply_torsion_group on 512 candidates of the
    C10H21Cl chain, one torsion_backoff a torsion, each launch's device
    event found under the kernel's name inside its launch span inside
    the wrapper's span (trace_kernels); frames against the CPU's loop
    (1e-9 A). Returns the record.'''
    import torch
    from tscode_tpu_torch import torsions as tt
    from tscode_tpu_torch.backend import DeviceTrace
    from tscode_tpu_torch.graphs import graphize
    from tscode_tpu_torch.ops.kernels import clash
    from tscode_tpu_torch.suite_inputs import chloroalkane
    base, nos = chloroalkane(10)
    graph = graphize(base, nos)
    tors = tt.get_torsions(graph, [], tt.get_double_bonds_indices(base, nos))
    for t in tors:
        t.sort_torsion(graph, np.array([]))
    rng = np.random.default_rng(22)
    coords = torch.as_tensor(
        base + rng.normal(size=(512,) + base.shape) * 0.05, device=DEV)
    angles = rng.integers(0, 49, size=(512, len(tors))) * 5.0
    clash.KERNEL.reset_counts()
    with DeviceTrace(tmp, DEV) as trace:
        got, n_rot = tt.apply_torsion_group(coords, tors, graph, angles)
        torch.cuda.synchronize()
    entries = clash.launches_by_entry()
    report = {'kernel_entries': {'clash': dict(clash.KERNEL.entry_launches)},
              'clash_entry_launches': entries}
    want, want_rot = tt.apply_torsion_group(coords.cpu(), tors, graph, angles)
    diff = float((got.cpu() - want).abs().max())
    check(diff <= 1e-9 and torch.equal(n_rot.cpu(), want_rot),
          f'[22 trace] back-off: card {diff:.2e} A from the CPU loop')
    events = trace_events(trace.path)
    spans = [e for e in events if e.get('cat') == 'user_annotation'
             and e.get('ph') == 'X']
    api = {e['args']['correlation']: e for e in events
           if e.get('cat') in ('cuda_runtime', 'cuda_driver')
           and 'correlation' in e.get('args', {})}
    kernels, _ = trace_kernels('backoff', events, spans, api, report)
    check(entries['torsion_backoff'] == len(tors) and
          kernels['clash.torsion_backoff_f64']['events'] == len(tors),
          f'[22 trace] back-off: launches {entries}, trace {kernels}')
    print(f'[22 trace backoff] {len(tors)} torsion_backoff launches on 512 '
          f'candidates, each found in the trace: {kernels}; frames within '
          f'{diff:.1e} A of the CPU loop [{card}]')
    return {'launches': entries['torsion_backoff'], 'kernels': kernels,
            'max_diff_A': diff}


def tfd_grid(rng, q, dup=0.4, jitter=1.0):
    """float32 fingerprints of a clustered 3^q torsion grid, as a
    conformer search makes them: every combination of three staggered
    angles a torsion, in random order, a share `dup` of the rows copies
    of others, every angle jittered (normal, degrees), wrapped."""
    axes = np.meshgrid(*[np.array([-60.0, 60.0, 180.0])] * q, indexing='ij')
    grid = np.stack([a.ravel() for a in axes], axis=1)
    grid = grid[rng.permutation(len(grid))]
    who = rng.random(len(grid)) < dup
    grid[who] = grid[rng.integers(0, len(grid), int(who.sum()))]
    fps = grid + rng.normal(size=grid.shape) * jitter
    return ((fps + 180) % 360 - 180).astype(np.float32)


def traced_tfd(card, tmp):
    """The TFD prune under the CLI's trace (backend.DeviceTrace): a 3^7
    torsion grid's fingerprints pruned on the card, one T1 launch a pass,
    each launch's device event found under the kernel's name inside its
    launch span `tfd_first.tfd_first_successor` (trace_kernels), one
    `first_successor_pass` span a launch; the mask against the CPU
    run's. Returns the record."""
    import torch
    from tscode_tpu_torch.backend import DeviceTrace
    from tscode_tpu_torch.ops.kernels import tfd as kt
    from tscode_tpu_torch.ops.tfd import prune_conformers_tfd
    fps = tfd_grid(np.random.default_rng(22), 7)
    dummy = np.zeros((len(fps), 1, 3))
    quads = np.zeros((fps.shape[1], 4), dtype=int)
    kt.KERNEL.reset_counts()
    with DeviceTrace(tmp, DEV) as trace:
        _, keep = prune_conformers_tfd(dummy, quads, tf_mat=fps, device=DEV)
        torch.cuda.synchronize()
    n = kt.KERNEL.launches
    _, want = prune_conformers_tfd(dummy, quads, tf_mat=fps, device='cpu')
    check(np.array_equal(keep, want) and n > 0, f'[22 trace] TFD prune: '
          f'{n} T1 launches, the mask equal to the CPU run\'s '
          f'{np.array_equal(keep, want)}')
    events = trace_events(trace.path)
    spans = [e for e in events if e.get('cat') == 'user_annotation'
             and e.get('ph') == 'X']
    api = {e['args']['correlation']: e for e in events
           if e.get('cat') in ('cuda_runtime', 'cuda_driver')
           and 'correlation' in e.get('args', {})}
    report = {'kernel_entries': {'tfd_first': dict(kt.KERNEL.entry_launches)},
              'clash_entry_launches': {}}
    kernels, _ = trace_kernels('tfd', events, spans, api, report)
    wrapper = sum(s['name'] == 'first_successor_pass' for s in spans)
    check(kernels['tfd_first.tfd_first_successor']['events'] == n == wrapper,
          f'[22 trace] TFD prune: {n} launches, trace {kernels}, {wrapper} '
          f'first_successor_pass spans')
    print(f'[22 trace tfd] the TFD prune of {len(fps)} fingerprints: {n} T1 '
          f'launches, each found in the trace: {kernels}; {int(keep.sum())} '
          f'kept, the CPU run\'s mask [{card}]')
    return {'launches': n, 'kernels': kernels, 'kept': int(keep.sum())}


def phase_trace(card):
    '''Phase 22: the CLI's --trace, float64, on short routes of the
    earlier phases, each also run untraced (traced_route): sn2_string at
    STRING_CONFS (K1's thread kernel, the TFD novelty lane; phase 6's
    JAX x64 counts), the non-rigid chelotropic input at CHEL_BEND_CONFS
    (K1 and K2 once; phase 15's), and REFINE on da_cyclical_xl's float64
    output at CYC_CONFS, made as phase 8 makes it (K3's passes; the JAX
    x64 counts of phase 9); then a launch from a worker thread
    (traced_thread), the search's back-off (traced_backoff) and a bend's
    FIRE call and a captured dimer graph under the trace (traced_fire).
    Then the TFD prune's T1 launches under the trace (traced_tfd).
    Returns (records, launches K1, K2, K3, torsion_backoff, ff_fire, T1,
    B1, D1, N1 and I1 of the runs).'''
    import tempfile
    from tscode_tpu_torch.suite_inputs import refine_input
    recs, launches = {}, [0] * 10

    def add(n):
        for i, k in enumerate(n):
            launches[i] += k
    with tempfile.TemporaryDirectory(prefix='smoke_trace_') as tmp:
        def route(tag, name, n_confs):
            d = os.path.join(tmp, tag)
            os.makedirs(d)
            return traced_route(card, tag, d, suite_input(name, d, n_confs))
        rep, recs['sn2_string'], names, n = route('sn2_string', 'sn2_string',
                                                  STRING_CONFS)
        add(n)
        se = rep['string_embed']
        got = (se['candidates'], se['clash_ok'], se['novel'],
               rep['final_structures'])
        check(got == STRING_F64 and se['tfd_lane'] == 'device' and
              'tfd_novelty_device' in names and 'bcast_block' in names,
              f'[22 trace] sn2_string: {got} (JAX x64 {STRING_F64}), lane '
              f'{se["tfd_lane"]}, spans {sorted(names)}')
        rep, recs['chelotropic_nonrigid'], names, n = route(
            'chelotropic_nonrigid', 'chelotropic_nonrigid', CHEL_BEND_CONFS)
        add(n)
        kernels = recs['chelotropic_nonrigid']['kernels']
        b1 = kernels.get('block_screen.block_keep_f64', {})
        b1w = kernels.get('block_screen.block_write_f64', {})
        check(rep['clash_entry_launches']['compenetration_mask_kernel'] == 1
              and names.get('block_screen', 0) == rep['b1_launches'] > 0
              and b1.get('events') == rep['b1_launches']
              and names.get('block_survivors', 0) ==
              rep['b1_write_launches'] == b1w.get('events') > 0
              and 'angular_dedup' not in names, f'[22 trace] chelotropic: '
              f'launches {rep["clash_entry_launches"]}, B1 '
              f'{rep["b1_launches"]} ({b1}) and its write '
              f'{rep["b1_write_launches"]} ({b1w}), spans {sorted(names)}')
        d = os.path.join(tmp, 'xl')
        os.makedirs(d)
        rep, _, _, secs = run_cli(d, suite_input('da_cyclical_xl', d,
                                                 CYC_CONFS), 'float64')
        add((rep['clash_entry_launches']['clash_ok'], 0, 0, 0, 0,
             rep['tfd_launches'], rep['b1_launches']))
        print(f'[22 trace] da_cyclical_xl at {CYC_CONFS}, REFINE\'s input, '
              f'untraced in {secs:.3f} s [{card}]')
        d2 = os.path.join(tmp, 'refine_xl')
        os.makedirs(d2)
        inp = refine_input(os.path.join(
            d, f'tscode_unoptimized_smoke_{DEV}_float64.xyz'), d2)
        rep, recs['refine_xl'], names, n = traced_route(card, 'refine_xl',
                                                        d2, inp)
        add(n)
        got = refine_counts(rep)
        check(got[:2] + got[3:] == REFINE_XL_F64 and n[2] > 0 and
              'prune_conformers_rmsd_device' in names, f'[22 trace] '
              f'refine_xl: {got} (JAX x64 {REFINE_XL_F64}), K3 {n[2]}, '
              f'spans {sorted(names)}')
        # the small traces before the dimer graph's: a trace taken after
        # a large one may lose device events
        recs['thread'] = traced_thread(card, os.path.join(tmp, 'thread'))
        recs['backoff'] = traced_backoff(card, os.path.join(tmp, 'backoff'))
        d3 = os.path.join(tmp, 'fire')
        os.makedirs(d3)
        recs['fire'] = traced_fire(card, d3)
        launches[4] += 2
        launches[7] += 2
        launches[8] += 4
        launches[9] += 2
        recs['tfd'] = traced_tfd(card, os.path.join(tmp, 'tfd'))
        launches[5] += recs['tfd']['launches']
    print(f'[22 trace] launches in the traced and untraced runs: K1 '
          f'{launches[0]}, K2 {launches[1]}, K3 {launches[2]}, ff_fire '
          f'{launches[4]}, T1 {launches[5]}, B1 {launches[6]}, D1 '
          f'{launches[7]}, N1 {launches[8]}, I1 {launches[9]}; every launch '
          f'of a traced run found in its trace [{card}]')
    return recs, launches


def trace_process(card):
    '''Phase 22 in a process of its own (`chip_smoke.py --trace`), as
    --trace profiles a CLI process from its start: a trace taken after
    phases 1 to 21 in this process lost device events (4,176 kernel
    events for 4,196 kernel launch calls on sn2_string), and one taken
    after a 2.6 GB trace lost more. Its lines are printed here; returns
    its (records, launches K1, K2, K3, torsion_backoff, ff_fire, T1,
    B1, D1, N1, I1).'''
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--trace'], capture_output=True, text=True,
                       timeout=900)
    sys.stdout.write(r.stdout)
    check(r.returncode == 0, f'phase 22 (chip_smoke.py --trace): exit code '
          f'{r.returncode}: {r.stderr[-2000:]}')
    out = json.loads(r.stdout.strip().splitlines()[-1])
    return out['trace'], out['launches']


def qcp_plan_sweep(card, out):
    '''K3's launch plans timed at every headline pass in float32 and on
    the long chunks (the measurement behind qcp.launch_plan): each
    lanes-per-row count with phase-1 budgets of 1 to 64 steps and
    unbounded, beside the thread-per-row kernel. Prints one line per
    pass and writes every time as JSON to the file `out`.'''
    import torch
    from tscode_tpu_torch.ops.kernels import qcp
    from tscode_tpu_torch.pipeline import (build_workload, clash_survivors,
                                           inputs_from_numpy)
    _, hs = clash_survivors(inputs_from_numpy(*build_workload(), DEV,
                                              torch.float32))
    passes, _ = schedule_passes(hs)
    cases = [(f'k={k}', hs, act, end) for k, act, end in passes] + \
        [(f'long N={N}',) + long_chunk(N, torch.float32) for N in (4, 8)]
    table = []
    for what, h, act, end in cases:
        act, end = act.int().contiguous(), end.int().contiguous()
        want = qcp.qcp_kill_thread(h, act, end, THR)
        row = {'pass': what, 'M': act.numel(), 'default': list(
            qcp.launch_plan(act.numel())), 'thread_ms': device_ms(
                lambda: qcp.qcp_kill_thread(h, act, end, THR)), 'ms': {},
               'rows_unlike_thread': {}}
        for lanes in range(6):
            for steps in (1, 2, 4, 8, 16, 64, None):
                plan = (lanes, (steps << lanes) if steps else 1 << 30)
                got = qcp.qcp_kill(h, act, end, THR, plan=plan)
                key = f'{lanes}/{steps}'
                row['ms'][key] = device_ms(
                    lambda: qcp.qcp_kill(h, act, end, THR, plan=plan))
                row['rows_unlike_thread'][key] = int((got != want).sum())
        best = min(row['ms'], key=row['ms'].get)
        default = row['ms'][f'{row["default"][0]}/{qcp.BUDGET_STEPS}']
        print(f'[qcp plans] {what}: M={row["M"]}, thread-per-row '
              f'{row["thread_ms"]:.4f} ms, best lanes_log2/steps {best} '
              f'{row["ms"][best]:.4f} ms, default plan {row["default"]} '
              f'{default:.4f} ms; rows unlike the thread-per-row kernel at '
              f'most {max(row["rows_unlike_thread"].values())} [{card}]')
        table.append(row)
    with open(out, 'w') as f:
        json.dump({'card': card, 'qcp_plans': table}, f, indent=1)


def cyclical_profile(card, out):
    '''The rigid cyclical route's float32 CLI run on da_cyclical_xl
    under torch.profiler, after one warm-up run and with the split's
    syncs off: its wall, the device's busy share (kernel time over
    wall) and the kernels with the most device time. Prints them and
    writes them as JSON to the file `out`.'''
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.environ['TSCODE_EMBED_TRACE'] = '0'
    with tempfile.TemporaryDirectory(prefix='smoke_prof_') as tmp:
        inp = suite_input('da_cyclical_xl', tmp, CYC_CONFS)
        run_cli(tmp, inp, 'float32')
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            report, _, _, wall = run_cli(tmp, inp, 'float32')
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda a: -a.self_device_time_total)
    busy = sum(a.self_device_time_total for a in kernels) / 1e6
    top = [{'name': a.key, 'calls': a.count,
            'device_ms': a.self_device_time_total / 1e3} for a in kernels[:25]]
    print(f'[profile cyclical float32] wall {wall:.3f} s, device busy '
          f'{busy:.4f} s ({busy / wall:.1%}), {sum(a.count for a in kernels)}'
          f' kernel launches; stages: {cli_stages(report)} [{card}]')
    for t in top[:12]:
        print(f'[profile cyclical float32] {t["device_ms"]:10.3f} ms '
              f'{t["calls"]:6d} calls  {t["name"][:90]}')
    with open(out, 'w') as f:
        json.dump({'card': card, 'wall_s': wall, 'device_busy_s': busy,
                   'stages': report['stages'],
                   'split': report['cyclical_embed'], 'top': top}, f,
                  indent=1)


def k1_plan_sweep(card, out):
    '''--k1 OUT.json: K1's thread regime on its own. The checks of phase
    3 (thread_kernel_checks, backoff_phase3, crossover_sweep), then the
    ring kernel's launch plans of RING_VARIANTS (tile, stages) on
    N_POSES random poses of N = 11, 12 and 15 atoms (two fragments:
    P = 30, 36, 56) and of N = 8 and 16 (P = 16 and 64; 8- and 16-way
    bank conflicts in float32), float32 and float64, device ms, each
    beside the v1 kernel and the bound, and the default plan on the
    slice poses[1:] (the granule path): the measurement behind
    THREAD_TILE and THREAD_STAGES. Written to OUT.'''
    import torch
    from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask
    from tscode_tpu_torch.ops.kernels import clash
    rec = {'card': card, 'max_abs_err': thread_kernel_checks(card),
           'backoff_err': backoff_phase3(card),
           'crossover': crossover_sweep(card), 'plans': []}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split('.')[-1]
        for N in (11, 12, 15, 8, 16):
            pm = cross_fragment_pair_mask((N // 2, N - N // 2))
            pairs = torch.as_tensor(clash.static_pairs(pm), device=DEV)
            gen = torch.Generator(device=DEV).manual_seed(N)
            full = (torch.randn((N_POSES + 1, N, 3), generator=gen,
                                dtype=torch.float64, device=DEV)
                    * 2.2).to(dtype)
            poses = full[:N_POSES]
            row = {'dtype': name, 'N': N, 'P': int(pairs.shape[0]),
                   'bound_ms': k1_bytes(poses, pairs) / HBM_BYTES_PER_S * 1e3,
                   'v1_ms': device_ms(lambda: clash.launch(
                       poses, pairs, CLASH, 0, 'v1')),
                   'offset_ms': device_ms(lambda: clash.launch(
                       full[1:], pairs, CLASH, 0, 'thread')),
                   'warp_ms': device_ms(lambda: clash.launch(
                       poses, pairs, CLASH, 0, 'warp')), 'ring_ms': {}}
            n_sm = torch.cuda.get_device_properties(
                poses.device).multi_processor_count
            for tile, stages in RING_VARIANTS:
                plan = clash.thread_plan(N_POSES, N, row['P'],
                                         poses.element_size(), n_sm=n_sm,
                                         tile=tile, stages=stages)
                row['ring_ms'][f'{tile}/{stages}'] = device_ms(
                    lambda: clash.launch(poses, pairs, CLASH, 0, 'thread',
                                         plan=plan))
            best = min(row['ring_ms'].items(), key=lambda kv: kv[1])
            print(f'[k1 plans {name} N={N} P={row["P"]}] bound '
                  f'{row["bound_ms"]:.4f} ms, v1 kernel {row["v1_ms"]:.4f},'
                  f' warp {row["warp_ms"]:.4f}, default plan on poses[1:] '
                  f'{row["offset_ms"]:.4f}; ring by tile/stages: '
                  + ', '.join(f'{k} {v:.4f}' for k, v in
                              row['ring_ms'].items())
                  + f'; best {best[0]} {best[1]:.4f} ms [{card}]')
            rec['plans'].append(row)
            del full, poses
    with open(out, 'w') as f:
        json.dump(rec, f, indent=1)


GUARD_ORDER = ('none', 'always', 'skip', 'skip', 'always', 'none')


def guard_modes():
    """The ways a launch may treat the current device: `none` (no
    switch, the launch as it was before the mesh), `always`
    (torch.cuda.device around every launch and graph run) and `skip`
    (_build.device_guard: a switch only to another card)."""
    import contextlib
    import torch
    from tscode_tpu_torch.ops.kernels import _build
    return {'none': lambda d: contextlib.nullcontext(),
            'always': torch.cuda.device, 'skip': _build.device_guard}


def guard_overhead(card, out):
    """--guard OUT.json: the host's cost of the launch's device guard on
    one card, in each of guard_modes, in the order GUARD_ORDER twice:
    the wall per launch of K1's back-off entry torsion_backoff (3
    candidates of 8 atoms, float64, 24 steps: phase 16's shape) and of K3 on a k = 1 pass of 41 rows
    (the headline's last pass), 2,000 launches each; the wall per
    fire_minimize_batch call of one 15-atom structure over 50 steps (a
    captured graph's run, phase 13's loop), 200 calls; and the
    csearch_string search of phase 17 through the CLI, float64, whose
    back-off launches torsion_backoff 8 times and whose TFD prune
    launches no hand kernel (the control for the host's speed)."""
    import tempfile
    import torch
    from tscode_tpu_torch import capture, optimizers
    from tscode_tpu_torch.ops.kernels import _build, clash, qcp
    modes, real = guard_modes(), _build.device_guard
    dev = torch.device('cuda', 0)
    rng = np.random.default_rng(0)
    poses = torch.as_tensor(rng.normal(size=(3, 8, 3)) * 2, device=dev)
    move = np.arange(8) < 4
    turns = torch.as_tensor([120.0, 240.0, 0.0], device=dev)
    hs = torch.as_tensor(rng.normal(size=(41, 4, 3)), device=dev)
    act = torch.arange(41, device=dev)
    end = torch.full((41,), 41, device=dev)
    x = torch.as_tensor(rng.normal(size=(1, 15, 3)) * 2, device=dev)
    center = torch.as_tensor(rng.normal(size=(15, 3)), device=dev)

    def energy(c, center):
        return torch.sum((c - center) ** 2 * (1 + c ** 2), dim=(-2, -1))

    def per_call(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    rec = {m: {'k1_us': [], 'k3_us': [], 'fire_graph_ms': [],
               'backoff_s': [], 'tfd_s': [], 'search_s': []} for m in modes}
    try:
        with tempfile.TemporaryDirectory(prefix='smoke_guard_') as tmp:
            inp = suite_input('csearch_string', tmp, SEARCH_CONFS)
            run_cli(tmp, inp, 'float64')           # warm-up, not kept
            for mode in GUARD_ORDER * 2:
                _build.device_guard = capture.device_guard = modes[mode]
                r = rec[mode]
                r['k1_us'].append(1e6 * per_call(
                    lambda: clash.torsion_backoff(poses, (0, 4, 3, 7), move,
                                                  turns, ~move, 24),
                    2000))
                r['k3_us'].append(1e6 * per_call(
                    lambda: qcp.qcp_kill(hs, act, end, 0.5), 2000))
                r['fire_graph_ms'].append(1e3 * per_call(
                    lambda: optimizers.fire_minimize_batch(
                        x, energy, n_steps=50, energy_args=(center,)),
                    200))
                report = run_cli(tmp, inp, 'float64')[0]
                cs = report['csearch'][0]
                check(report['clash_entry_launches']['torsion_backoff']
                      == 8, f'guard {mode}: back-off launches '
                      f'{report["clash_entry_launches"]}')
                for k in ('backoff_s', 'tfd_s'):
                    r[k].append(cs[k])
                r['search_s'].append(cs['seconds'])
    finally:
        _build.device_guard = capture.device_guard = real
    for mode, r in rec.items():
        print(f'[guard {mode}] ' + ', '.join(
            f'{k} {np.median(v):.4g} (of {len(v)}: '
            f'{" ".join(f"{t:.4g}" for t in v)})' for k, v in r.items())
            + f' [{card}]')
    with open(out, 'w') as f:
        json.dump({'card': card, 'order': GUARD_ORDER * 2, 'modes': rec}, f,
                  indent=1)


def b1_kernel_line(routes, sharded):
    '''B1's entry of the kernels line: phase 8's record (da_cyclical_xl,
    float64, its one chunk) for the times (its screen and its write) and
    the bound, B1's first design (every pose written) and its full-write
    bound beside them, each route's record beside it (the non-rigid
    trimolecular input's a group), its screen launches on the main path
    by phase and on phase 21's shards.'''
    main = routes['da_cyclical_xl']
    recs = [r for k, r in routes.items() if k != 'trimolecular_nonrigid']
    recs += list(routes.get('trimolecular_nonrigid', []))
    return {'name': 'block_screen', 'route': 'cuda',
            'source': 'tscode_tpu_torch/csrc/block_screen.cu',
            'replaces': 'tscode_tpu/embeds/cyclical.py:255',
            'launches': sum(B1_LAUNCHES.values()),
            'max_abs_err': max(r['max_pose_diff_A'] for r in recs),
            'ms': main['ms'], 'plain_ms': main['plain_ms'],
            'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
            'library_ms': None, 'screen_ms': main['screen_ms'],
            'write_ms': main['write_ms'],
            'first_design': {'source':
                            'tscode_tpu_torch/csrc/block_screen_row.cu',
                            'ms': main['row_ms'],
                            'bound_ms': main['row_bound_ms'],
                            'bound_by': main['row_bound_by']},
            'launches_by_phase': dict(B1_LAUNCHES),
            'mesh': {'launches': sharded}, 'routes': routes}


def d1_kernel_line(d1):
    '''D1's entry of the kernels line: phase 18's record on the SADDLE
    scan's sub-peak guess (the rule's form, the staged form beside it,
    its twin, the graph path's replayed step x the steps taken, the bound,
    the latency figure), its launches on the main path by phase, the
    other inputs' records beside it.'''
    return {'name': 'dimer', 'route': 'cuda',
            'source': 'tscode_tpu_torch/csrc/dimer.cu',
            'replaces': 'tscode_tpu/saddle.py:21',
            'launches': sum(DIMER_LAUNCHES.values()),
            'launches_by_phase': dict(DIMER_LAUNCHES),
            'max_abs_err': max([d1['plain_diff_A'], d1['graph_diff_A']] +
                               [r['plain_diff_A']
                                for r in d1['cases'].values()]),
            'ms': d1['ms'], 'plain_ms': d1['plain_ms'],
            'graph_ms': d1['graph_ms'], 'bound_ms': d1['bound_ms'],
            'bound_by': d1['bound_by'], 'library_ms': None,
            'latency_ms': d1['latency_ms'], 'staged_ms': d1['staged_ms'],
            'us_per_step': d1['us_per_step'], 'steps': d1['steps'],
            'form': d1['form'], 'cases': d1['cases'], 'record': d1}


def n1_kernel_line(rec):
    '''N1's entry of the kernels line: phase 19b's record of phase 19's
    band (the ring, 7 images, the rule's form): the two launches of one
    neb> (the plain phase and the climbing one) summed, beside the twin,
    the graph path's replayed step x the steps taken, the bound and the
    latency figure; its launches on the main path by phase; every band's
    record beside it.'''
    ring = rec['ring']
    phases = [ring['plain'], ring['climbing']]

    def total(key):
        return sum(p[key] for p in phases)
    bounds = [p['bound_ms'] for p in phases]
    return {'name': 'neb_band', 'route': 'cuda',
            'source': 'tscode_tpu_torch/csrc/neb_band.cu',
            'replaces': 'tscode_tpu/neb.py:220',
            'launches': sum(NEB_LAUNCHES.values()),
            'launches_by_phase': dict(NEB_LAUNCHES),
            'max_abs_err': max(r['plain_diff_A']
                               for case in NEB_CASES
                               for phase in ('plain', 'climbing')
                               for r in rec[case][phase]['forms'].values()),
            'ms': total('ms'), 'plain_ms': total('plain_ms'),
            'graph_ms': total('graph_ms'), 'bound_ms': sum(bounds),
            'bound_by': phases[bounds.index(max(bounds))]['bound_by'],
            'library_ms': None, 'latency_ms': total('latency_ms'),
            'form': ring['climbing']['form'], 'v1_ms': total('v1_ms'),
            'steps': [p['steps'] for p in phases],
            'near_ties': max(p['near_ties'] for case in NEB_CASES
                             for p in (rec[case]['plain'],
                                       rec[case]['climbing'])),
            'cases': {k: v for k, v in rec.items() if k in NEB_CASES},
            'neb_route': rec['neb_route'], 'crossover': rec['crossover']}


def i1_kernel_line(rec):
    '''I1's entry of the kernels line: phase 19b's record of phase 19's
    IDPP band (the ring, 7 images, 300 steps) beside the twin,
    fire_run_graph, the bound and the latency figure; its launches on the
    main path by phase; every band's record beside it.'''
    ring = rec['ring']['idpp']
    return {'name': 'idpp_fire', 'route': 'cuda',
            'source': 'tscode_tpu_torch/csrc/idpp_fire.cu',
            'replaces': 'tscode_tpu/optimizers.py:41',
            'launches': sum(IDPP_LAUNCHES.values()),
            'launches_by_phase': dict(IDPP_LAUNCHES),
            'max_abs_err': max(rec[case]['idpp']['plain_diff_A']
                               for case in NEB_CASES),
            'ms': ring['ms'], 'plain_ms': ring['plain_ms'],
            'graph_ms': ring['graph_ms'], 'bound_ms': ring['bound_ms'],
            'bound_by': ring['bound_by'], 'library_ms': None,
            'latency_ms': ring['latency_ms'], 'steps': ring['steps'],
            'form': ring['form'], 'v1_ms': ring['v1_ms'],
            'cases': {k: rec[k]['idpp'] for k in NEB_CASES}}


def timed_phase(name, phase, *args):
    '''phase(*args), its seconds printed; PHASE holds its number while
    it runs.'''
    PHASE[0] = name.split()[0]
    t0 = time.perf_counter()
    out = phase(*args)
    print(f'[seconds] {name}: {time.perf_counter() - t0:.1f} s')
    return out


def main():
    t0 = time.perf_counter()
    card = phase_env()
    if sys.argv[1:2] == ['--qcp-plans']:     # --qcp-plans OUT.json
        phase_build()
        qcp_plan_sweep(card, sys.argv[2])
        return
    if sys.argv[1:2] == ['--profile-cyclical']:  # --profile-cyclical OUT.json
        phase_build()
        cyclical_profile(card, sys.argv[2])
        return
    if sys.argv[1:2] == ['--k1']:            # --k1 OUT.json
        phase_build()
        k1_plan_sweep(card, sys.argv[2])
        return
    if sys.argv[1:2] == ['--guard']:         # --guard OUT.json
        phase_build()
        guard_overhead(card, sys.argv[2])
        return
    if sys.argv[1:2] == ['--scans']:         # phases 18 and 19 alone
        phase_build()
        _, _, scan = timed_phase('18 dihedral_scan', phase_dihedral_scan,
                                 card)
        ops = timed_phase('19 ff_operators', phase_ff_operators, card)
        print(f'[dimer] launches of D1 by phase {DIMER_LAUNCHES} [{card}]')
        print(f'[neb] launches of N1 by phase {NEB_LAUNCHES}, of I1 '
              f'{IDPP_LAUNCHES} [{card}]')
        print(json.dumps({'ff_routes': {'dihedral_scan': scan,
                                        'ff_operators': ops}}))
        return
    if sys.argv[1:2] == ['--neb']:           # --neb OUT.json
        phase_build()
        rec = timed_phase('19b neb kernels', phase_neb, card)
        with open(sys.argv[2], 'w') as f:
            json.dump({'card': card, **rec}, f, indent=1)
        print(json.dumps({'neb_band': n1_kernel_line(rec),
                          'idpp_fire': i1_kernel_line(rec)}))
        return
    if sys.argv[1:2] == ['--opt']:           # phase 20 alone
        phase_build()
        _, _, opt = timed_phase('20 opt_route', phase_opt_route, card)
        opt.pop('k3_passes')
        print(json.dumps({'opt_route': opt}))
        return
    if sys.argv[1:2] == ['--search']:        # phases 16 and 17 alone
        phase_build()
        drive = timed_phase('16 torsion_drive', phase_torsion_drive, card)
        chain = timed_phase('17 csearch_string', phase_search_string, card)
        print(json.dumps({'torsion_backoff': {
            'torsion_drive': drive[3], 'csearch_string': chain[3]},
            'tfd_first_successor': chain[4]}))
        return
    if sys.argv[1:2] == ['--sweep']:         # phases 8, 10 to 12, 14 alone
        import tempfile
        phase_build()
        routes = {}
        with tempfile.TemporaryDirectory(prefix='smoke_cyc_') as tmp:
            routes['da_cyclical_xl'] = timed_phase(
                '8 cyclical', phase_cyclical_route, card, tmp)[4]
        routes['multiembed'] = timed_phase(
            '10 multiembed', phase_multiembed_route, card)[5]
        routes['chelotropic'] = timed_phase(
            '11 chelotropic', phase_chelotropic_route, card)[5]
        routes['trimolecular_rigid'] = timed_phase(
            '12 trimolecular', phase_trimol_route, card)[3]
        routes['trimolecular_nonrigid'] = timed_phase(
            '14 bend trimolecular', phase_bend_trimol_route,
            card)[2]['b1_groups']
        print(json.dumps({'block_screen': b1_kernel_line(routes, 0)}))
        return
    if sys.argv[1:2] == ['--mesh']:          # phase 21 alone
        phase_build()
        mesh, _, _ = timed_phase('21 mesh', phase_mesh, card)
        print(json.dumps({'mesh': mesh}))
        return
    if sys.argv[1:2] == ['--trace']:         # phase 22 alone
        phase_build()
        trace, launches = timed_phase('22 trace', phase_trace, card)
        print(json.dumps({'trace': trace, 'launches': launches}))
        return
    if sys.argv[1:2] == ['--dimer']:         # --dimer OUT.json
        phase_build()
        dimer_sweep(card, sys.argv[2])
        return
    if sys.argv[1:2] == ['--fire']:          # --fire OUT.json
        phase_build()
        with open(sys.argv[2], 'w') as f:
            json.dump(phase_ff_fire(card), f, indent=1)
        return
    import tempfile
    import torch
    from tscode_tpu_torch.pipeline import build_workload
    phase_build()
    errs, crossover = timed_phase('3 kernels', phase_kernels, card)
    mols = build_workload()
    recs64, errs['qcp_f64'], main64, captured64 = timed_phase(
        '4 main f64', phase_main_f64, card, mols)
    phase_small_parity()
    kernels = timed_phase('5 main f32', phase_main_f32, card, mols)
    kernels[1]['passes'] += recs64
    kernels[1]['launches'] += main64['qcp_kill']
    kernels[2]['launches'] += main64['qcp_kill_dev']
    kernels[2]['captured']['float64'] = captured64
    errs['qcp_kill'] = max(errs['qcp_kill'], errs.pop('qcp_f64'))
    PHASE[0] = '6-9'
    kernels[0]['launches'] += phase_string_route(card)
    with tempfile.TemporaryDirectory(prefix='smoke_keep_') as keep:
        route = phase_large_route(card, keep)
        grid, errs['clash7'] = phase_large_grid(card)
        kernels[0]['launches'] += sum(route.values()) + sum(grid.values())
        print(f'[7 large_n] clash launches by regime: CLI runs {route}, '
              f'76-conformer grids {grid}')
        errs['clash'] = max(errs['clash'], errs.pop('clash7'))
        with tempfile.TemporaryDirectory(prefix='smoke_cyc_') as tmp:
            PHASE[0] = '8'
            k1, e8, chunk8, xl_path, b1_8 = phase_cyclical_route(card, tmp)
            PHASE[0] = '9'

            k3, recs9, e9 = phase_refine_route(
                card, xl_path, os.path.join(keep, 'large_n_f64.xyz'))
    print(f'[seconds] phases 1 to 9: {time.perf_counter() - t0:.1f} s')
    k1_10, k2_10, e10, k2_rec, e10_k2, b1_10 = timed_phase(
        '10 multiembed', phase_multiembed_route, card)
    k1_11, k2_11, e11, k2_rec11, e11_k2, b1_11 = timed_phase(
        '11 chelotropic', phase_chelotropic_route, card)
    k1_12, e12, chunk12, b1_12 = timed_phase(
        '12 trimolecular', phase_trimol_route, card)
    fire = timed_phase('13 ff and fire', phase_ff_fire, card)
    k1_14, e14, bend14 = timed_phase('14 bend trimolecular',
                                     phase_bend_trimol_route, card)
    k1_15, k2_15 = timed_phase('15 small bend routes',
                               phase_small_bend_routes, card)
    k1_16, nb_16, e16, drive = timed_phase('16 torsion_drive',
                                           phase_torsion_drive, card)
    k1_17, nb_17, e17, backoff, t1 = timed_phase('17 csearch_string',
                                                 phase_search_string, card)
    k3_18, e18, scan = timed_phase('18 dihedral_scan', phase_dihedral_scan,
                                   card)
    ops = timed_phase('19 ff_operators', phase_ff_operators, card)
    neb_rec = timed_phase('19b neb kernels', phase_neb, card)
    k3_20, e20, opt = timed_phase('20 opt_route', phase_opt_route, card)
    mesh, sharded, e21 = timed_phase('21 mesh', phase_mesh, card)
    trace, (k1_22, k2_22, k3_22, nb_22, ff_22, t1_22, b1_22, d1_22, n1_22,
            i1_22) = timed_phase('22 trace', trace_process, card)
    FIRE_LAUNCHES['22'] = ff_22
    DIMER_LAUNCHES['22'] = d1_22
    NEB_LAUNCHES['22'] = n1_22
    IDPP_LAUNCHES['22'] = i1_22
    TFD_LAUNCHES['22'] = t1_22
    B1_LAUNCHES['22'] = b1_22
    check(all(B1_LAUNCHES.get(p, 0) > 0 for p in
              ('8', '10', '11', '12', '14', '15', '21', '22')),
          f'B1 launches by phase {B1_LAUNCHES}: a phase that runs a block '
          f'sweep on the card did not launch it')
    print(f'[block_screen] launches of B1 by phase {B1_LAUNCHES} [{card}]')
    check(all(TFD_LAUNCHES.get(p, 0) > 0 for p in ('16', '17', '21', '22')),
          f'T1 launches by phase {TFD_LAUNCHES}: a phase that runs the TFD '
          f'prune on the card did not launch it')
    print(f'[tfd_first] launches of T1 by phase {TFD_LAUNCHES} [{card}]')
    check(all(FIRE_LAUNCHES.get(p, 0) > 0 for p in
              ('13', '14', '16', '18', '21', '22')), f'ff_fire launches by '
          f'phase {FIRE_LAUNCHES}: a phase that runs FIRE on the force '
          f'field did not launch it')
    print(f'[ff_fire] launches of the force field\'s FIRE kernel by phase '
          f'{FIRE_LAUNCHES} [{card}]')
    check(all(DIMER_LAUNCHES.get(p, 0) > 0 for p in ('18', '19', '22')),
          f'D1 launches by phase {DIMER_LAUNCHES}: a phase that runs the '
          f'dimer on the force field did not launch it')
    print(f'[dimer] launches of D1 by phase {DIMER_LAUNCHES} [{card}]')
    check(all(NEB_LAUNCHES.get(p, 0) > 0 and IDPP_LAUNCHES.get(p, 0) > 0
              for p in ('19', '22')), f'N1 launches by phase {NEB_LAUNCHES}, '
          f'I1 {IDPP_LAUNCHES}: a phase that runs neb> on the card did not '
          f'launch them')
    print(f'[neb] launches of N1 by phase {NEB_LAUNCHES}, of I1 '
          f'{IDPP_LAUNCHES} [{card}]')
    kernels[0]['launches'] += k1 + k1_10 + k1_11 + k1_12 + k1_14 + k1_15 + \
        k1_16 + k1_17 + sharded['clash_ok'] + k1_22
    kernels[0]['chunks'] = {'cyclical': chunk8, 'trimolecular': chunk12}
    kernels[0]['crossover'] = crossover
    kernels[1]['launches'] += k3 + k3_18 + k3_20 + sharded['qcp_kill'] + \
        k3_22
    kernels[0]['mesh'] = {'launches': sharded['clash_ok'],
                          **mesh['kernels']['clash_ok']}
    kernels[1]['mesh'] = {'launches': sharded['qcp_kill'],
                          **mesh['kernels']['qcp_kill']}
    kernels[1]['passes'] += recs9 + scan['k3_passes'] + opt.pop('k3_passes')
    kernels[1]['routes'] = {'opt_route': {'launches': k3_20,
                                          'pools': opt['k3_pools']}}
    errs['clash'] = max(errs['clash'], e8, e10, e11, e12, e14, e21)
    errs['qcp_kill'] = max(errs['qcp_kill'], e9, e18, e20, e21)
    for k, key in zip(kernels, ('clash', 'qcp_kill')):
        k['max_abs_err'] = max(k['max_abs_err'], errs[key])
    check(k2_10 > 0 and k2_11 > 0 and k2_15 > 0, f'K2 launches: multiembed '
          f'{k2_10}, chelotropic {k2_11}, non-rigid chelotropic {k2_15}')
    kernels.insert(1, {
        'name': 'compenetration_mask_kernel', 'route': 'cuda',
        'source': 'tscode_tpu_torch/csrc/clash.cu',
        'replaces': 'tscode_tpu/ops/pallas/clash.py:55',
        'launches': k2_10 + k2_11 + k2_15 +
        sharded['compenetration_mask_kernel'] + k2_22,
        'max_abs_err': max(e10_k2, e11_k2, e21),
        'ms': k2_rec['float64']['ms'],
        'plain_ms': k2_rec['float64']['plain_ms'],
        'bound_ms': k2_rec['float64']['bound_ms'], 'bound_by': 'bytes',
        'library_ms': None,
        'routes': {'multiembed': dict(k2_rec, launches=k2_10),
                   'chelotropic': dict(k2_rec11, launches=k2_11)},
        'mesh': {'launches': sharded['compenetration_mask_kernel'],
                 **mesh['kernels']['compenetration_mask_kernel']}})
    kernels.insert(2, {
        'name': 'torsion_backoff', 'route': 'cuda',
        'source': 'tscode_tpu_torch/csrc/clash.cu',
        'replaces': 'tscode_tpu/ops/pallas/clash.py:119',
        'launches': nb_16 + nb_17 + sharded['torsion_backoff'] + nb_22,
        'max_abs_err': max(errs['backoff'], e16, e17), 'ms': backoff['ms'],
        'entry_ms': backoff['entry_ms'],
        'plain_ms': backoff['plain_ms'], 'bound_ms': backoff['bound_ms'],
        'bound_by': backoff['bound_by'], 'library_ms': None,
        'routes': {'torsion_drive': drive, 'csearch_string': backoff},
        'mesh': {'launches': sharded['torsion_backoff']}})
    whole, one = fire['kernel']
    kernels.append({
        'name': 'ff_fire', 'route': 'cuda',
        'source': 'tscode_tpu_torch/csrc/ff_fire.cu',
        'replaces': 'tscode_tpu/optimizers.py:41',
        'launches': sum(FIRE_LAUNCHES.values()),
        'max_abs_err': max([r['plain_diff_A'] for r in fire['kernel']] +
                           [fire['large_n']['plain_diff_A']]),
        'ms': whole['ms'], 'plain_ms': whole['plain_ms'],
        'bound_ms': whole['bound_ms'], 'bound_by': whole['bound_by'],
        'library_ms': None, 'form': whole['form'],
        'block_ms': whole['block_ms'], 'graph_ms': whole['graph_ms'],
        'one_structure': {k: one[k] for k in (
            'form', 'ms', 'block_ms', 'us_per_step', 'plain_ms', 'bound_ms',
            'bound_by', 'n_steps', 'force_evaluations')},
        'large_n': fire['large_n'],
        'launches_by_phase': dict(FIRE_LAUNCHES),
        'records': fire['kernel'] + fire['kernel_f32']})
    kernels.append({
        'name': 'tfd_first_successor', 'route': 'cuda',
        'source': 'tscode_tpu_torch/csrc/tfd_first.cu',
        'replaces': 'tscode_tpu/ops/tfd.py:75',
        'launches': sum(TFD_LAUNCHES.values()),
        'max_abs_err': t1['max_abs_err'], 'ms': t1['ms'],
        'plain_ms': t1['plain_ms'], 'bound_ms': t1['bound_ms'],
        'bound_by': t1['bound_by'], 'library_ms': None,
        'first_design': {'source': 'tscode_tpu_torch/csrc/tfd_first_warp.cu',
                        'ms': t1['warp_ms'],
                        'bound_ms_first_count': t1['first_count_bound_ms']},
        'launches_by_phase': dict(TFD_LAUNCHES),
        'mesh': {'launches': sharded['tfd_first']},
        'csearch_string': t1})
    kernels.append(d1_kernel_line(scan['d1']))
    kernels.append(n1_kernel_line(neb_rec))
    kernels.append(i1_kernel_line(neb_rec))
    kernels.append(b1_kernel_line(
        {'da_cyclical_xl': b1_8, 'multiembed': b1_10, 'chelotropic': b1_11,
         'trimolecular_rigid': b1_12,
         'trimolecular_nonrigid': bend14['b1_groups']},
        sharded['block_screen']))
    check('jax' not in sys.modules, 'jax was imported')
    check('sklearn' not in sys.modules, 'scikit-learn was imported')
    jax_pkg = sorted(m for m in sys.modules
                     if m == 'tscode_tpu' or m.startswith('tscode_tpu.'))
    check(not jax_pkg, f'modules of the JAX package were imported: '
          f'{jax_pkg[:5]}')
    print(f'[done] {time.perf_counter() - t0:.1f} s')
    print(f'nvidia-smi: {card}')
    print(json.dumps({'bending': {'fire': fire, 'trimolecular': bend14}}))
    print(json.dumps({'ff_routes': {
        'dihedral_scan': {k: v for k, v in scan.items() if k != 'k3_passes'},
        'ff_operators': ops, 'neb_route': neb_rec['neb_route']}}))
    print(json.dumps({'opt_route': opt}))
    print(json.dumps({'mesh': mesh}))
    print(json.dumps({'trace': trace}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'chip_smoke FAILED: {e}', file=sys.stderr)
        sys.exit(1)
