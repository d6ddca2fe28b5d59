'''
Proc/thread tuning benchmark: `python -m tscode_tpu_torch input.xyz -b
[--device cpu]` (counterpart of tscode_tpu/concurrent_test.py).

The reference grid-searches procs x threads for xtb jobs under a process
pool (TSCoDe's concurrent_test.py:16-105). The same idea runs here over
the threaded dispatch queue; without xtb on PATH it times the internal
force field's batched FIRE instead (optimizers.fire_minimize_batch,
float64 on the device), the optimiser that replaces per-structure
force-field jobs on the device.
'''

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tscode_tpu_torch.settings import XTB_AVAILABLE


def run_concurrent_test(filename, n_structures=8, *, device):
    from tscode_tpu_torch.io_xyz import read_xyz
    data = read_xyz(filename)
    coords, atomnos = data.atomcoords[0], data.atomnos
    print(f'--> Concurrency benchmark on {filename} '
          f'({len(atomnos)} atoms, {n_structures} jobs per point)\n')

    rng = np.random.default_rng(0)
    jobs = [coords + rng.normal(size=coords.shape) * 0.05
            for _ in range(n_structures)]

    if XTB_AVAILABLE:
        from tscode_tpu_torch.calculators.xtb import xtb_opt
        results = {}
        for procs in (1, 2, 4):
            for threads in (1, 2, 4, 8):
                t0 = time.perf_counter()
                with ThreadPoolExecutor(max_workers=threads) as ex:
                    futs = [ex.submit(xtb_opt, j, atomnos,
                                      method='GFN-FF', procs=procs,
                                      title=f'bench_{i}')
                            for i, j in enumerate(jobs)]
                    for f in futs:
                        f.result()
                dt = time.perf_counter() - t0
                results[(procs, threads)] = dt
                print(f'    procs={procs} threads={threads}: '
                      f'{dt / n_structures:.2f} s/structure')
        best = min(results, key=results.get)
        print(f'\n--> Recommended: --procs {best[0]} --threads {best[1]}')
    else:
        print('    xtb not found: benchmarking the internal-FF batched '
              'optimizer instead\n')
        import torch

        from tscode_tpu_torch.backend import get_device, synchronize
        from tscode_tpu_torch.ff import (build_ff_params, ff_energy,
                                         params_to_device)
        from tscode_tpu_torch.graphs import graphize
        from tscode_tpu_torch.optimizers import fire_minimize_batch

        device = get_device(device)
        graph = graphize(coords, atomnos)
        params = params_to_device(build_ff_params(coords, atomnos, graph),
                                  device, torch.float64)

        for batch in (8, 64, 512):
            batch_jobs = torch.as_tensor(
                np.array([coords + rng.normal(size=coords.shape) * 0.05
                          for _ in range(batch)]), dtype=torch.float64,
                device=device)
            # warm-up: on the card this captures the step's CUDA graph
            fire_minimize_batch(batch_jobs, ff_energy, n_steps=200,
                                energy_args=(params,))
            synchronize(device)
            t0 = time.perf_counter()
            fire_minimize_batch(batch_jobs, ff_energy, n_steps=200,
                                energy_args=(params,))
            synchronize(device)
            dt = time.perf_counter() - t0
            print(f'    batch={batch:4}: {dt:.2f} s total, '
                  f'{dt / batch * 1000:.1f} ms/structure')
        print(f'\n--> Larger batches amortize better on the device '
              f'({device}); size to your ensemble.')
