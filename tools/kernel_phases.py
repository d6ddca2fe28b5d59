#!/usr/bin/env python3
'''
Where B1's and T1's cycles go, on the card: the kernels' own sources
built with -DTT_PHASES (csrc/phases.cuh: clock64() laps and counts a
phase, compiled in only then) beside the real libraries, and run on the
route inputs that chip_smoke.py's phases build. The real libraries are
timed beside the instrumented builds.

B1 (its first design csrc/block_screen_row.cu and its screen
csrc/block_screen.cu), float64, on the first chunk of da_cyclical_xl at
62, chelotropic at 62 and trimolecular RIGID at 256: per block row the
mean cycles of its warp in each phase (build, the first design's pose
write, clash screen, norms, dedup), the dedup steps a row and the
lanes with a live angle a step, and the kernels' device ms
(instrumented and not); and B1's screen built with its register cap for
other block counts an SM (-DB1_MIN_BLOCKS; 0: no cap), timed.

T1 (csrc/tfd_first.cu), csearch_string's TFD prune's passes on a 3^8
torsion grid (chip_smoke.tfd_grid) at k = 1 and 2: per block its cycles,
its tile loads' and its walk's, with the pass's windows and with one
window; the longest block against the mean.

D1 (csrc/dimer.cu), float64, every form that fits, on chip_smoke's
DIMER_CASES (the SADDLE scan's sub-peak guess, 27 atoms, 300 steps;
saddle>'s C2F2H4, 8 atoms, 300 steps; 150- and 2,500-atom
suite_inputs.chain_ff chains, 100 and 10 steps): a structure's cycles a
step by phase (the term pass, the atom sums or the large form's walk,
the reductions, the vector algebra, the staged form's separate pass of
the force at c, set-up), its force passes a step, and each form's
device ms.

N1 (csrc/neb_band.cu) and I1 (csrc/idpp_fire.cu), float64, and their
first designs (csrc/neb_band_v1.cu, csrc/idpp_fire_v1.cu), on
chip_smoke's NEB_CASES bands (phase 19's ring, HCOOH, 150- and
2,500-atom chains): I1 on each band's linear chain (IDPP_STEPS steps;
the chains 10 at fmax 0), an image's cycles a step by phase (the pair
loop, the two reductions, the velocity update, the move) for the image
that takes the most steps; N1's plain phase from the IDPP band (the
case's steps) in each form (the rule's, lone where it fits, large on
min(I - 2, 8) blocks, grid), a step's cycles by phase of block 0 (an
owner of an image in every form) and the mean over the blocks: the
term pass (the first design: the energy chunks and the walk), the atoms'
sums and energies, the band algebra C, the controls D, the move E and
the wait at each barrier; each form's device ms.

    python3 tools/kernel_phases.py OUT.json           # on the card, ~4 min
    python3 tools/kernel_phases.py OUT.json --d1      # D1 alone
    python3 tools/kernel_phases.py OUT.json --n1 --i1 # N1 and I1 alone
    python3 tools/kernel_phases.py OUT.json --n1 --i1 --v1  # their first
                                                      # designs alone

Needs a card and nvcc; run from the root of a checkout.
'''

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs                                      # noqa: E402
from tscode_tpu_torch.embeds import cyclical as cyc         # noqa: E402
from tscode_tpu_torch.ops.kernels import _build             # noqa: E402
from tscode_tpu_torch.ops.kernels import block_screen as b1  # noqa: E402
from tscode_tpu_torch import neb                             # noqa: E402
from tscode_tpu_torch.ops.kernels import dimer as kd        # noqa: E402
from tscode_tpu_torch.ops.kernels import idpp as ki         # noqa: E402
from tscode_tpu_torch.ops.kernels import neb as kn          # noqa: E402
from tscode_tpu_torch.ops.kernels import tfd as kt          # noqa: E402

OUT_DIR = os.path.join(_build.BUILD_DIR, 'phases')
# B1's record a row (csrc/phases.cuh slots): cycles by phase, then counts
B1_SLOTS = ('build', 'write', 'clash', 'norm', 'dedup', 'steps', 'lanes',
            'rows')
# D1's record a structure (csrc/dimer.cu Lap): cycles by phase, then
# counts
D1_SLOTS = ('term', 'atom', 'reduce', 'algebra', 'force', 'setup', 'steps',
            'passes')
# N1's record a block (csrc/neb_band.cu Lap; the first design's
# csrc/neb_band_v1.cu Lap): cycles by phase, then the steps
N1_SLOTS = ('term', 'atom', 'C', 'D', 'E', 'sync_A', 'sync_B', 'sync_C',
            'sync_D', 'sync_E', 'setup', 'steps')
N1_V1_SLOTS = ('energy', 'walk', 'esum', 'C', 'D', 'E', 'sync_A', 'sync_B',
               'sync_C', 'sync_D', 'sync_E', 'setup', 'steps')
# I1's record an image (csrc/idpp_fire.cu and idpp_fire_v1.cu Lap)
I1_SLOTS = ('pairs', 'red1', 'update', 'red2', 'move', 'setup', 'steps')


def build(name, lib_name, *defines):
    '''nvcc csrc/<name>.cu as the real libraries are built, with the
    given -D defines, into OUT_DIR/lib<lib_name>.so; returns its path.'''
    os.makedirs(OUT_DIR, exist_ok=True)
    lib = os.path.join(OUT_DIR, f'lib{lib_name}.so')
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                        *(f'-D{d}' for d in defines), '-I', _build.CSRC_DIR,
                        '-o', lib, os.path.join(_build.CSRC_DIR,
                                                name + '.cu')],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f'nvcc {name}.cu {defines}: {r.stderr[-3000:]}')
    return lib


class Swapped:
    '''`module.attr` (a CudaKernel) served by the library `lib` while
    inside; yields the ctypes library.'''

    def __init__(self, module, attr, lib):
        self.module, self.attr, self.lib = module, attr, lib

    def __enter__(self):
        real = getattr(self.module, self.attr)
        k = _build.CudaKernel(real.name, real.symbols)
        lib = ctypes.CDLL(self.lib)
        for sym, argtypes in k.symbols.items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        lib.tt_error_string.argtypes = [ctypes.c_int]
        lib.tt_error_string.restype = ctypes.c_char_p
        if hasattr(lib, 'set_prof'):
            lib.set_prof.argtypes = [ctypes.c_void_p]
        k._lib = lib
        self.real = real
        setattr(self.module, self.attr, k)
        return lib

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


def profiled(lib, n_slots, fn):
    '''fn() once with the record hook on; returns the records.'''
    prof = torch.zeros(n_slots, dtype=torch.int64, device=cs.DEV)
    torch.cuda.synchronize()
    lib.set_prof(ctypes.c_void_p(prof.data_ptr()))
    fn()
    torch.cuda.synchronize()
    lib.set_prof(None)
    return prof.cpu().numpy()


def route_chunk(name, n_confs, tmp):
    '''The first chunk of a route's block sweep, float64: B1's packed
    inputs.'''
    emb = cs.embedder_setup(cs.suite_input(name, tmp, n_confs),
                            torch.float64)
    if name == 'trimolecular_rigid':
        blk = cyc.trimol_rigid_blocks(emb.objects, emb.pairing_ok_fn())
        blk['dirs'], _ = cyc.adjust_chain(*(blk[k] for k in cyc._ADJUST),
                                          device=cs.DEV)
    else:
        blk = cyc.bimol_rigid_blocks(*emb.objects, 5, emb.pairing_ok_fn())
    coords, grid, pairs, rows = cyc.sweep_inputs(
        blk, emb.objects, emb.systematic_angles, torch.device(cs.DEV),
        torch.float64)
    confs, *geo = rows(0, cyc._card_chunk(len(blk['ids']), grid.shape[0],
                                          len(coords), 8))
    conf, packed = b1.pack_rows(confs, cyc.block_geometry(*geo))
    return coords, conf, packed, b1.half_angles(grid), pairs


def b1_phases(out):
    libs = {name: build(name, name + '_phases', 'TT_PHASES')
            for name in ('block_screen', 'block_screen_row')}
    caps = {mb: build('block_screen', f'block_screen_cap{mb}',
                      f'B1_MIN_BLOCKS={mb}') for mb in (0, 4, 6)}
    gates = (cyc.DEDUP_RMSD, cyc.DEDUP_MAXDEV)
    with tempfile.TemporaryDirectory() as tmp:
        for route, n in (('da_cyclical_xl', cs.CYC_CONFS),
                         ('chelotropic', cs.CHEL_CONFS),
                         ('trimolecular_rigid', cs.TRI_CONFS)):
            coords, conf, packed, half, pairs = route_chunk(route, n, tmp)
            rows, A = conf.shape[0], half.shape[0]
            N = sum(c.shape[1] for c in coords)
            keep = torch.empty((rows, A), dtype=torch.bool, device=cs.DEV)
            counts = torch.empty(rows, dtype=torch.int32, device=cs.DEV)
            poses = torch.empty((rows, A, N, 3), dtype=torch.float64,
                                device=cs.DEV)

            def run_new():
                b1.launch(coords, conf, packed, half, pairs, cs.CLASH,
                          gates, keep, counts)

            def run_row():
                b1.launch_row(coords, conf, packed, half, pairs, cs.CLASH,
                              gates, poses, keep)
            rec = {'rows': rows, 'A': A, 'N': N,
                   'ms': cs.device_ms(run_new, reps=5),
                   'row_ms': cs.device_ms(run_row, reps=5)}
            for name, mod_attr, run in (
                    ('block_screen', 'KERNEL', run_new),
                    ('block_screen_row', 'ROW_KERNEL', run_row)):
                with Swapped(b1, mod_attr, libs[name]) as lib:
                    ms = cs.device_ms(run, reps=5)
                    p = profiled(lib, rows * 8, run).reshape(rows, 8)
                tot = p.sum(axis=0).astype(float)
                per = {k: tot[i] / tot[7] for i, k in enumerate(B1_SLOTS)
                       if i < 5}
                rec[name] = {'instrumented_ms': ms,
                             'cycles_per_row': per,
                             'steps_per_row': tot[5] / tot[7],
                             'live_lanes_per_step': tot[6] / max(tot[5], 1)}
            rec['cap_ms'] = {}
            for mb, lib_path in caps.items():
                with Swapped(b1, 'KERNEL', lib_path):
                    rec['cap_ms'][mb] = cs.device_ms(run_new, reps=5)
            rec['cap_ms'][5] = cs.device_ms(run_new, reps=5)
            print(f'[phases B1] {route} register cap, blocks an SM: ms '
                  + ', '.join(f'{mb or "none"} {ms:.4f}' for mb, ms in
                              sorted(rec['cap_ms'].items())), flush=True)
            print(f'[phases B1] {route} float64, {rows} rows x {A} angles, '
                  f'N = {N}: B1 {rec["ms"]:.4f} ms, first design '
                  f'{rec["row_ms"]:.4f} ms; cycles a row '
                  + '; '.join(f'{k} ' + ', '.join(
                      f'{s} {v:.0f}' for s, v in rec[k][
                          'cycles_per_row'].items())
                      for k in ('block_screen_row', 'block_screen'))
                  + f'; dedup steps a row '
                  f'{rec["block_screen"]["steps_per_row"]:.3f}, live '
                  f'lanes a step '
                  f'{rec["block_screen"]["live_lanes_per_step"]:.2f}',
                  flush=True)
            out['b1'][route] = rec


def t1_phases(out):
    lib_path = build('tfd_first', 'tfd_first_phases', 'TT_PHASES')
    fps = cs.tfd_grid(np.random.default_rng(22), 8)
    tf = torch.as_tensor(fps, device=cs.DEV)
    n, Q = fps.shape
    for k, m in ((1, 4936), (2, n)):
        d = n // k
        rec = {}
        for label, plan in (('windows', kt.pass_plan(Q, d, k, m)),
                            ('one window', kt.launch_plan(Q, segment=0))):
            _, w = kt.windows(plan, d, k, m)
            blocks = -(-n // kt.BLOCK_WARPS) * w

            def run():
                return kt.first_successor_pass(tf, d, k, m, cs.TFD_THRESH,
                                               plan=plan)
            ms = cs.device_ms(run)
            with Swapped(kt, 'KERNEL', lib_path) as lib:
                p = profiled(lib, blocks * 4, run).reshape(blocks, 4)
            # a block's cycles: outside the tiles, loading, walking
            busy = p[p[:, 3] > 0]
            cycles = busy[:, :3].sum(axis=1)
            top = busy[cycles.argmax()]
            rec[label] = {
                'ms': ms, 'windows': w, 'blocks': blocks,
                'blocks_walking': len(busy),
                'mean_block_cycles': float(cycles.mean()),
                'max_block_cycles': int(cycles.max()),
                'max_block_load_cycles': int(top[1]),
                'max_block_walk_cycles': int(top[2]),
                'max_block_tiles': int(top[3])}
            r = rec[label]
            print(f'[phases T1] k = {k} ({label}: {w} windows) '
                  f'{ms:.4f} ms; blocks {blocks}, walking '
                  f'{len(busy)}; a block {r["mean_block_cycles"]:.0f} '
                  f'cycles on average, the longest {r["max_block_cycles"]} '
                  f'({r["max_block_tiles"]} tiles: loads '
                  f'{r["max_block_load_cycles"]}, walk '
                  f'{r["max_block_walk_cycles"]})', flush=True)
        out['t1'][f'k{k}'] = rec


def d1_phases(out):
    lib_path = build('dimer', 'dimer_phases', 'TT_PHASES')
    with tempfile.TemporaryDirectory() as tmp:
        inputs = cs.dimer_inputs(tmp)
    for name, (x, _, terms) in inputs.items():
        n = cs.DIMER_CASES[name]
        rec = {'atoms': int(x.shape[1]), 'n_steps': n}
        for form in kd.FORMS:
            try:
                plan = kd.plan_for(x, terms, form)
            except ValueError:
                continue

            def run():
                return kd.launch(x, terms, n, form=form)
            reps = 1 if x.shape[1] > 1000 else 3
            ms = cs.device_ms(run, reps=reps)
            steps = int(run()[2].max())
            with Swapped(kd, 'KERNEL', lib_path) as lib:
                p = profiled(lib, len(D1_SLOTS), run).astype(float)
            per = {k: p[i] / steps for i, k in enumerate(D1_SLOTS[:6])}
            r = {'plan': plan._asdict(), 'ms': ms,
                 'us_per_step': 1e3 * ms / steps, 'steps': steps,
                 'cycles_per_step': per,
                 'passes_per_step': p[7] / steps,
                 **kd.kernel_info(plan, x.dtype, x.device)}
            rec[form] = r
            print(f'[phases D1] {name} ({rec["atoms"]} atoms, {steps} '
                  f'steps) {form}: {ms:.4f} ms, {r["us_per_step"]:.2f} us '
                  f'a step, {r["registers"]} registers; cycles a step '
                  + ', '.join(f'{k} {v:.0f}' for k, v in per.items())
                  + f'; {r["passes_per_step"]:.1f} force passes a step',
                  flush=True)
        out['d1'][name] = rec


def neb_bands():
    '''chip_smoke's NEB_CASES bands: name -> (the linear chain (I, N, 3)
    and its IDPP tables on the card, I1's steps and fmax, the IDPP band,
    ff.FireTerms).'''
    bands = {}
    for name, (start, end, _, terms) in cs.neb_inputs().items():
        chain = neb.interpolate_chain(start, end, cs.NEB_IMAGES)
        x = torch.as_tensor(chain, device=cs.DEV)
        tables = [torch.as_tensor(t, device=cs.DEV)
                  for t in neb.idpp_tables(chain)]
        n, fmax = (cs.IDPP_STEPS, 0.05) if name in ('ring', 'hcooh') \
            else (10, 0.0)
        band = ki.launch_v1(x, *tables, n, fmax=fmax)[0]
        bands[name] = (x, tables, n, fmax, band, terms)
    return bands


def i1_phases(out, bands, designs):
    libs = {d: build(f'idpp_fire{"_v1" if d == "v1" else ""}',
                     f'idpp_fire{"_v1" if d == "v1" else ""}_phases',
                     'TT_PHASES') for d in designs}
    for name, (x, tables, n, fmax, _, _) in bands.items():
        I, N = x.shape[0], x.shape[1]
        rec = {'atoms': N}
        runs = {}
        if 'v1' in designs:
            runs['v1'] = ('V1_KERNEL', lambda: ki.launch_v1(
                x, *tables, n, fmax=fmax))
        if 'new' in designs:
            plan = ki.launch_plan(N)
            runs[plan.form] = ('KERNEL', lambda: ki.launch(
                x, *tables, n, fmax=fmax))
        for label, (attr, run) in runs.items():
            reps = 1 if N > 1000 else 3
            ms = cs.device_ms(run, reps=reps)
            with Swapped(ki, attr, libs['v1' if label == 'v1' else 'new']) \
                    as lib:
                p = profiled(lib, I * len(I1_SLOTS), run).reshape(
                    I, len(I1_SLOTS)).astype(float)
            img = int(p[:, -1].argmax())
            steps = p[img, -1]
            per = {k: p[img, i] / steps for i, k in enumerate(I1_SLOTS[:-1])}
            r = {'ms': ms, 'image': img, 'steps': int(steps),
                 'cycles_per_step': per}
            rec[label] = r
            print(f'[phases I1] {name} ({I} x {N} atoms) {label}: '
                  f'{ms:.4f} ms; image {img}, {int(steps)} steps; cycles '
                  f'a step ' + ', '.join(f'{k} {v:.0f}'
                                         for k, v in per.items()),
                  flush=True)
        out['i1'][name] = rec


def n1_plans(x, terms, design):
    '''{label: plan} of N1's forms timed by phase: the rule's, lone where
    it fits, large on min(I - 2, 8) blocks, grid (its first design's or
    the redesign's).'''
    plan_for = kn.plan_for_v1 if design == 'v1' else kn.plan_for
    plans = {'rule': plan_for(x, terms)}
    for form in kn.FORMS:
        try:
            plans[form] = plan_for(x, terms, form)
        except ValueError:
            continue
    return plans


def n1_phases(out, bands, designs):
    libs = {d: build(f'neb_band{"_v1" if d == "v1" else ""}',
                     f'neb_band{"_v1" if d == "v1" else ""}_phases',
                     'TT_PHASES') for d in designs}
    for name, (_, _, _, _, band, terms) in bands.items():
        n = cs.NEB_CASES[name]
        rec = {'atoms': int(band.shape[1])}
        for design in designs:
            slots = N1_V1_SLOTS if design == 'v1' else N1_SLOTS
            launch = kn.launch_v1 if design == 'v1' else kn.launch
            attr = 'V1_KERNEL' if design == 'v1' else 'KERNEL'
            for label, plan in n1_plans(band, terms, design).items():
                def run():
                    return launch(band, terms, n, plan=plan)
                reps = 1 if band.shape[1] > 1000 else 3
                ms = cs.device_ms(run, reps=reps)
                steps = int(run()[2])
                blocks = plan.cluster
                with Swapped(kn, attr, libs[design]) as lib:
                    p = profiled(lib, blocks * len(slots), run).reshape(
                        blocks, len(slots)).astype(float)
                first = {k: p[0, i] / steps
                         for i, k in enumerate(slots[:-2])}
                mean = {k: p[:, i].mean() / steps
                        for i, k in enumerate(slots[:-2])}
                r = {'plan': plan._asdict(), 'ms': ms, 'steps': steps,
                     'us_per_step': 1e3 * ms / steps,
                     'cycles_per_step_block0': first,
                     'cycles_per_step_mean': mean}
                rec[f'{design} {label}'] = r
                print(f'[phases N1] {name} ({band.shape[0]} x '
                      f'{band.shape[1]} atoms, {steps} steps) {design} '
                      f'{label} ({plan.form}, {plan.cluster} blocks): '
                      f'{ms:.4f} ms, {r["us_per_step"]:.2f} us a step; '
                      f'block 0 cycles a step ' + ', '.join(
                          f'{k} {v:.0f}' for k, v in first.items()) +
                      '; mean ' + ', '.join(f'{k} {v:.0f}'
                                            for k, v in mean.items()),
                      flush=True)
        out['n1'][name] = rec


def main():
    if not torch.cuda.is_available():
        sys.exit('kernel_phases.py needs a card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    out = {'card': smi, 'b1': {}, 't1': {}, 'd1': {}, 'n1': {}, 'i1': {}}
    flags = sys.argv[2:]
    nebs = [f for f in ('--n1', '--i1') if f in flags]
    if '--d1' not in flags and not nebs:
        b1_phases(out)
        t1_phases(out)
    if '--d1' in flags or not nebs:
        d1_phases(out)
    if nebs:
        designs = ['v1'] if '--v1' in flags else ['v1', 'new']
        bands = neb_bands()
        if '--i1' in flags:
            i1_phases(out, bands, designs)
        if '--n1' in flags:
            n1_phases(out, bands, designs)
    print(f'[phases] {smi}')
    with open(sys.argv[1], 'w') as f:
        json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
