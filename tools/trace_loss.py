#!/usr/bin/env python
'''How often the CLI's trace (backend.DeviceTrace: torch.profiler with
CUPTI) loses the device event of a kernel launched in a short traced
window, on one card.

Each trial opens a DeviceTrace, launches one K1 kernel (the clash
screen, 256 poses of 11 atoms) and closes the trace, then counts the
kernel's events in the Chrome trace written; a trial whose trace holds
no device activity at all (DeviceTrace raises) counts as lost too.
The variants, run in turns:

    nowait   DeviceTrace with no wait after the profiler starts
             (backend.TRACE_START_S set to 0, as DeviceTrace was before
             it waited), the launch on the main thread at once; the
             trace stopped as soon as the device is synchronised
    thread   as nowait, the launch on a worker thread (chip_smoke.py
             phase 22's traced_thread)
    start    as nowait, with 50 ms waited inside the window before the
             launch
    end      as nowait, with the device synchronised and 50 ms waited
             after the launch, before the trace closes
    main     DeviceTrace as it ships (TRACE_START_S waited after the
             profiler starts), the launch on the main thread
    large    as main, right after a trace of 4,000 small kernels (a
             large trace, as phase 22 takes before its small ones)

    python tools/trace_loss.py OUT.json [TRIALS [VARIANT ...]]

Prints and writes, per variant, the trials, the lost ones and the
seconds. TRIALS (default 100) is per variant; `large` runs a tenth of
them.
'''

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

VARIANTS = ('nowait', 'thread', 'start', 'end', 'main', 'large')


def trial(variant, tmp, poses, pairs, start_s):
    '''One traced window: (kernel events in its trace, whether the trace
    held no device activity).'''
    import torch
    from tscode_tpu_torch import backend
    from tscode_tpu_torch.backend import DeviceTrace
    from tscode_tpu_torch.ops.kernels import clash
    backend.TRACE_START_S = start_s if variant in ('main', 'large') else 0.0
    if variant == 'large':
        x = torch.zeros(64, device='cuda')
        with DeviceTrace(os.path.join(tmp, 'large'), 'cuda'):
            for _ in range(4000):
                x.add_(1.0)
    d = os.path.join(tmp, variant)
    empty = False
    try:
        with DeviceTrace(d, 'cuda') as trace:
            if variant == 'start':
                time.sleep(0.05)
            if variant == 'thread':
                with ThreadPoolExecutor(1) as pool:
                    pool.submit(clash.clash_ok, poses, pairs, 1.5).result()
            else:
                clash.clash_ok(poses, pairs, 1.5)
            if variant == 'end':
                torch.cuda.synchronize()
                time.sleep(0.05)
    except RuntimeError as e:
        if 'recorded no activity' not in str(e):
            raise
        empty = True
    with open(trace.path) as f:
        events = json.load(f)['traceEvents']
    os.remove(trace.path)
    return sum(e.get('cat') == 'kernel' and 'clash_ok' in e['name']
               for e in events), empty


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    out, trials = sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 \
        else 100
    variants = sys.argv[3:] or VARIANTS
    from tscode_tpu_torch import backend
    start_s = backend.TRACE_START_S
    rng = np.random.default_rng(22)
    poses = torch.as_tensor(rng.normal(size=(256, 11, 3)) * 3,
                            device='cuda')
    pairs = torch.as_tensor([[i, j] for i in range(4) for j in range(4, 11)],
                            dtype=torch.int32, device='cuda')
    from tscode_tpu_torch.ops.kernels import clash
    clash.clash_ok(poses, pairs, 1.5)          # build and load K1
    torch.cuda.synchronize()
    rec = {v: {'trials': 0, 'lost': 0, 'empty': 0, 'seconds': 0.0}
           for v in variants}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(trials):
            for v in variants:
                if v == 'large' and i % 10:
                    continue
                t0 = time.perf_counter()
                n, empty = trial(v, tmp, poses, pairs, start_s)
                r = rec[v]
                r['seconds'] += time.perf_counter() - t0
                r['trials'] += 1
                r['lost'] += int(n != 1)
                r['empty'] += int(empty)
    card = torch.cuda.get_device_name(0)
    for v, r in rec.items():
        print(f'[trace_loss] {v}: {r["lost"]} of {r["trials"]} windows '
              f'lost the kernel event ({r["empty"]} with no device activity '
              f'at all), {r["seconds"]:.1f} s [{card}]')
    with open(out, 'w') as f:
        json.dump({'card': card, 'start_s': start_s, 'variants': rec}, f,
                  indent=1)


if __name__ == '__main__':
    main()
