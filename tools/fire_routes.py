#!/usr/bin/env python
'''Wall times of the routes that relax on the internal force field, for
comparing two checkouts of the port on one card.

Runs the port's CLI in process, float64, on the card, on
bench_suite's trimolecular input at 16 (non-rigid: 5 bends),
torsion_drive at 16 (4 searches, then 12 bends; the searches' draws
seeded with 0, as chip_smoke.py seeds them) and the port's dihedral
scan at 9 carbons (SADDLE + scan>: 112 constrained relaxations), each
twice in a row; prints and writes, for each run, its wall seconds and,
where the run writes a report (the embeds; the scan's data run does
not), the report's total seconds, the bends' seconds, FIRE calls and
counts and the stage counts.

    python tools/fire_routes.py ROOT OUT.json [ROUTE ...]

ROOT is the checkout whose tscode_tpu_torch is imported (its kernels
build into ROOT/build/ at first use). To compare two checkouts, run
the script once per checkout, in turns, in one call on one card.
'''

import contextlib
import json
import os
import sys
import tempfile
import time

ROUTES = {'trimolecular': 16, 'torsion_drive': 16, 'dihedral_scan': 9}
RUNS = 2


def run(name, n, seed=0):
    '''One CLI run of `name` at n in a directory of its own: the report
    and the process's wall seconds.'''
    import numpy as np
    from tscode_tpu_torch import embedder
    from tscode_tpu_torch.__main__ import main as cli
    from tscode_tpu_torch.suite_inputs import config_files
    seeded = embedder.Embedder

    class Seeded(seeded):
        def __init__(self, *args, **kw):
            super().__init__(*args, rng=np.random.RandomState(seed), **kw)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix='fire_routes_') as tmp:
        inp = config_files(name, tmp, n)
        embedder.Embedder = Seeded
        t0 = time.perf_counter()
        try:
            with open(os.path.join(tmp, 'run.out'), 'w') as out, \
                    contextlib.redirect_stdout(out):
                rc = cli([inp, '--dtype', 'float64', '-n', 'routes'])
        finally:
            os.chdir(cwd)
            embedder.Embedder = seeded
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f'{name}: the CLI exited with {rc}')
        report = os.path.join(tmp, 'tscode_report_routes.json')
        if not os.path.exists(report):        # a data run writes none
            return {}, wall
        with open(report) as f:
            return json.load(f), wall


def summary(report, wall):
    out = {'wall_s': wall, 'total_seconds': report.get('total_seconds'),
           'final': report.get('final_structures'),
           'stages': [(s['stage'], s['structures_in'], s['structures_out'])
                      for s in report.get('stages', [])]}
    for key in ('cyclical_embed', 'monomolecular_embed'):
        if key in report:
            ce = report[key]
            out.update({k: ce.get(k) for k in (
                'bends', 'bend_relaxations', 'bend_hits', 'bend_reverts',
                'bends_s')})
    return out


def main():
    root, path = os.path.abspath(sys.argv[1]), sys.argv[2]
    names = sys.argv[3:] or list(ROUTES)
    sys.path.insert(0, root)
    import torch
    card = torch.cuda.get_device_name(0)
    rec = {'root': root, 'card': card, 'routes': {}}
    for name in names:
        rec['routes'][name] = []
        for k in range(RUNS):
            s = summary(*run(name, ROUTES[name]))
            rec['routes'][name].append(s)
            print(f'[fire_routes] {root}: {name} run {k + 1}: wall '
                  f'{s["wall_s"]:.3f} s, total {s["total_seconds"]} s, '
                  f'bends {s.get("bends")} in {s.get("bends_s")} s '
                  f'({s.get("bend_relaxations")} FIRE calls), final '
                  f'{s["final"]} [{card}]', flush=True)
    with open(path, 'w') as f:
        json.dump(rec, f, indent=1)


if __name__ == '__main__':
    main()
