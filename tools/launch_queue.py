#!/usr/bin/env python3
'''
Whether chip_smoke.device_ms can time a call of many small launches, on
the card: G1 with its rotation tables (ops/kernels/string_grid: keep,
which builds the tables in PyTorch, then write) and the route before it
with its tables (chip_smoke.route_before: the broadcast block, K1, the
compaction), on the headline's grid in float32 and float64. For each:
the kernels one call launches and their summed device time (the
profiler), then device_ms behind chip_smoke.TABLES_SLEEP over 1, 3 and
10 calls. Where the calls' launches pass the stream's queue of pending
launches the host waits, the sleep ends early and the host clock leaks
into the time: the 10-call figure rises above the 1- and 3-call ones.

    python3 tools/launch_queue.py
'''

import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tscode_tpu_torch.ops.kernels import string_grid as g1  # noqa: E402
from tscode_tpu_torch.pipeline import (_angles, build_workload,  # noqa: E402
                                       inputs_from_numpy)


def kernels_a_call(fn):
    '''(kernels, summed device ms) of one call of fn, warm.'''
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == 'CUDA']
    return len(events), sum(e.device_time for e in events) / 1e3


def main():
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    for dtype in (torch.float32, torch.float64):
        inp = inputs_from_numpy(*build_workload(), cs.DEV, dtype)
        angles = _angles(inp, 36)
        n2c = inp.coords2.shape[0]
        kept, _ = g1.string_grid(inp, angles, 0, n2c, cs.CLASH, True)
        out = torch.empty_like(kept)
        dump = torch.empty((kept.shape[0] + 1,) + kept.shape[1:],
                           dtype=dtype, device=cs.DEV)
        calls = {
            'G1 with its tables': lambda: g1.write(
                g1.keep(inp, angles, 0, n2c, cs.CLASH), out, inp.heavy_idx),
            'route before with its tables': lambda: cs.route_before(
                inp, angles, True, dump)}
        for name, fn in calls.items():
            n, ms = kernels_a_call(fn)
            times = {reps: cs.device_ms(fn, reps=reps,
                                        sleep=cs.TABLES_SLEEP)
                     for reps in (1, 3, 10)}
            print(f'{dtype} {name}: {n} kernels a call, {ms:.4f} ms summed; '
                  f'device_ms over 1, 3, 10 calls: ' +
                  ', '.join(f'{t:.4f}' for t in times.values()))


if __name__ == '__main__':
    main()
