'''
The record of an optimising route, as the card check (chip_smoke.py
phase 20) and the parity tests compare it.

`record` runs one suite input (`sn2_string_opt`, `da_cyclical_opt`:
the string or the rigid cyclical embed, then the force-field and the
calculator's stages) through an Embedder, with the calculator stages
answered by the stand-in xtb of tests/torch_standin, and spies on the
route's functions: each refine stage of calculators.dispatch (its
energies and exit status in submission order, its seconds) and each
similarity prune (its counts; the RMSD prune's pools are kept too, for
the card's kernel check). It returns the counts, the final structures
and energies, the rows of the final `tscode_poses_<stamp>.xyz`, the
number of stand-in calls and the seconds. `same_records` holds two
records to each other; `energy_ties` marks the stage energies that a
last-digit difference could reorder.

The stand-in runs either as the executable, its folder put first on
PATH for the run (`standin='path'`; the card and the reference record),
or in process (`standin='inprocess'`): the calculator modules'
`subprocess` is replaced by one whose check_call runs the stand-in's
`main` in the job's directory, with no process start.
'''

import io
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np

OPT_ATOL = 1e-6            # A on frames, kcal/mol on energies
ENERGY_TIE = 1e-6          # kcal/mol: energies this close are a tie
STANDIN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tests', 'torch_standin')


def Package(dispatch, calc_modules, embedder, embed_kw, stamp, prunes):
    '''What `record` runs: the dispatch module whose _refine_stage it
    spies on, the calculator modules that start subprocesses, the
    Embedder class and its keyword arguments, the run's stamp, and the
    prunes as (module, attribute, label) triples.'''
    return SimpleNamespace(dispatch=dispatch, calc_modules=calc_modules,
                           embedder=embedder, embed_kw=embed_kw, stamp=stamp,
                           prunes=prunes)


def port_package(device, dtype=None):
    '''This package on `device` (the run's dtype: float64 unless given).'''
    import torch

    from tscode_tpu_torch import embedder
    from tscode_tpu_torch.calculators import (dispatch, gaussian, gradients,
                                              mopac, orca, xtb)
    return Package(
        dispatch, (xtb, gradients, orca, gaussian, mopac), embedder.Embedder,
        dict(device=device, dtype=dtype or torch.float64), 'port',
        [(embedder, 'prune_conformers_tfd', 'tfd'),
         (embedder, 'prune_by_moment_of_inertia', 'moi'),
         (embedder, 'prune_conformers_rmsd', 'rmsd'),
         (embedder, 'prune_conformers_rmsd_rot_corr', 'rmsd_rot_corr')])


class InProcessSubprocess:
    '''A stand-in for the `subprocess` module of the calculator
    adapters: check_call(['xtb', ...]) runs the stand-in's main in the
    job's directory and counts the call; `programs` maps other program
    names to functions of the same form, main(argv, cwd, out, err) ->
    exit status; any other program is not found.'''
    CalledProcessError = subprocess.CalledProcessError
    STDOUT = subprocess.STDOUT
    DEVNULL = subprocess.DEVNULL

    def __init__(self, programs=None):
        if STANDIN_DIR not in sys.path:
            sys.path.insert(0, STANDIN_DIR)
        from standin_xtb import main
        self.programs = dict(programs or {}, xtb=main)
        self.calls = 0
        self._lock = threading.Lock()

    def check_call(self, cmd, stdout=None, stderr=None, cwd=None):
        main = self.programs.get(cmd[0])
        if main is None:
            raise FileNotFoundError(cmd[0])
        with self._lock:
            self.calls += 1
        out = stdout if hasattr(stdout, 'write') else io.StringIO()
        rc = main(cmd[1:], cwd, out=out, err=out)
        if rc:
            raise subprocess.CalledProcessError(rc, cmd)
        return 0


class StandinOnPath:
    '''The stand-in executable first on PATH, its calls counted through
    STANDIN_XTB_CALLS; both restored on exit.'''

    def __init__(self, workdir):
        self.log = os.path.join(workdir, 'standin_calls.txt')
        self.calls = 0

    def __enter__(self):
        self.saved = {k: os.environ.get(k)
                      for k in ('PATH', 'STANDIN_XTB_CALLS')}
        os.environ['PATH'] = STANDIN_DIR + os.pathsep + \
            os.environ.get('PATH', '')
        os.environ['STANDIN_XTB_CALLS'] = self.log
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if os.path.isfile(self.log):
            with open(self.log) as f:
                self.calls = len(f.readlines())
        return False


def read_poses(path):
    '''(titles, frames (F, N, 3)) of an .xyz file, with the standard
    library and numpy only.'''
    with open(path) as f:
        lines = f.read().splitlines()
    titles, frames, i = [], [], 0
    while i < len(lines) and lines[i].strip():
        n = int(lines[i])
        titles.append(lines[i + 1])
        frames.append([[float(v) for v in row.split()[1:4]]
                       for row in lines[i + 2:i + 2 + n]])
        i += n + 2
    return titles, np.array(frames)


def record(pkg, name, n_confs, workdir, standin='inprocess', keywords='',
           programs=None):
    '''One optimising route of `pkg` in workdir (suite input `name` at
    n_confs conformers). Returns the record: `stages` ([stage, in, out]
    of the run report), `prunes` ([label, in, out] in call order),
    `refine` (each refine stage's jobs), `status` (each stage's exit
    status, in submission order), `final`, `titles` (the final poses
    file's comment lines), `calls` (stand-in calls), `exit_status`,
    `seconds`, `times` (each refine stage's and each prune's seconds),
    `pools` (the RMSD prune's input structures, float64 numpy) and
    `arrays`: stage_energies (every stage's energies, concatenated),
    final_energies, final_frames, poses_frames. `keywords` are added to
    the input's keyword line, each in place of one of the same name; `programs` answers other calculators in
    process (InProcessSubprocess).'''
    import json

    from tscode_tpu_torch.suite_inputs import config_files

    rec = {'name': name, 'n_confs': n_confs, 'prunes': [], 'refine': [],
           'status': []}
    stage_energies, pools = [], []
    times = {'refine': [], 'prunes': []}

    def refine_spy(fn):
        def run(embedder, *args, **kw):
            t0 = time.perf_counter()
            out = fn(embedder, *args, **kw)
            times['refine'].append(time.perf_counter() - t0)
            rec['refine'].append(len(embedder.energies))
            rec['status'].append([bool(s) for s in embedder.exit_status])
            stage_energies.append(np.array(embedder.energies, dtype=float))
            return out
        return run

    def prune_spy(fn, label):
        def run(structures, *args, **kw):
            n_in = len(structures)
            if label == 'rmsd':
                pools.append(np.array(structures, dtype=float))
            t0 = time.perf_counter()
            out = fn(structures, *args, **kw)
            times['prunes'].append(time.perf_counter() - t0)
            rec['prunes'].append([label, n_in, int(np.count_nonzero(out[1]))])
            return out
        return run

    patches = [(pkg.dispatch, '_refine_stage',
                refine_spy(pkg.dispatch._refine_stage))]
    patches += [(m, attr, prune_spy(getattr(m, attr), label))
                for m, attr, label in pkg.prunes]
    if standin == 'inprocess':
        fake = InProcessSubprocess(programs)
        patches += [(m, 'subprocess', fake) for m in pkg.calc_modules]
        context = None
    else:
        context = StandinOnPath(workdir)

    inp = config_files(name, workdir, n_confs)
    if keywords:
        # a keyword given replaces the input's keyword of the same name
        with open(inp) as f:
            lines = f.read().split('\n')
        names = {k.split('=')[0] for k in keywords.split()}
        lines[0] = ' '.join([k for k in lines[0].split()
                             if k.split('=')[0] not in names]
                            + keywords.split())
        with open(inp, 'w') as f:
            f.write('\n'.join(lines))
    saved = [(m, attr, getattr(m, attr)) for m, attr, _ in patches]
    cwd = os.getcwd()
    for m, attr, value in patches:
        setattr(m, attr, value)
    t0 = time.perf_counter()
    try:
        if context is not None:
            with context:
                run = pkg.embedder(inp, stamp=pkg.stamp,
                                   **pkg.embed_kw).run()
        else:
            run = pkg.embedder(inp, stamp=pkg.stamp, **pkg.embed_kw).run()
    finally:
        os.chdir(cwd)
        for m, attr, value in saved:
            setattr(m, attr, value)
    rec['seconds'] = time.perf_counter() - t0
    rec['calls'] = fake.calls if context is None else context.calls
    with open(os.path.join(workdir, f'tscode_report_{pkg.stamp}.json')) as f:
        rec['stages'] = [[s['stage'], s['structures_in'], s['structures_out']]
                         for s in json.load(f)['stages']]
    rec['final'] = len(run.structures)
    rec['exit_status'] = [bool(s) for s in run.exit_status]
    titles, poses = read_poses(
        os.path.join(workdir, f'tscode_poses_{pkg.stamp}.xyz'))
    rec['titles'] = titles
    rec['times'] = times
    rec['pools'] = pools
    rec['arrays'] = {
        'stage_energies': np.concatenate(stage_energies) if stage_energies
        else np.zeros(0),
        'final_energies': np.array(run.energies, dtype=float),
        'final_frames': np.array(run.structures, dtype=float),
        'poses_frames': poses}
    return rec


def energy_ties(rec, kcal=None, tie=ENERGY_TIE):
    '''The stage energies that a difference in their last digits could
    reorder or mask otherwise: per stage, the energies within `tie` of
    another energy of the stage, and, given the KCAL window, the
    relative energies within `tie` of it or of a wider window that
    dynamic_energy_thr could choose (kcal + 5 j). Returns the indices
    into arrays['stage_energies'].'''
    marked, lo = [], 0
    energies = rec['arrays']['stage_energies']
    for n in rec['refine']:
        e = energies[lo:lo + n]
        ok = e < 1e10
        order = np.argsort(e, kind='stable')
        gaps = np.diff(e[order])
        near = np.zeros(n, dtype=bool)
        near[order[1:][gaps < tie]] = True
        near[order[:-1][gaps < tie]] = True
        if kcal is not None and ok.any():
            rel = e - e[ok].min()
            for thr in np.arange(kcal, rel[ok].max() + 5.0, 5.0):
                near |= np.abs(rel - thr) < tie
        marked += (lo + np.flatnonzero(near & ok)).tolist()
        lo += n
    return marked


def same_records(got, want, atol=OPT_ATOL, marked=()):
    '''Every count, stage, prune, status, title and call count equal;
    the stage energies within atol away from the `marked` indices, the
    final energies and frames and the poses file's frames within atol.
    Returns the largest array difference.'''
    got, want = dict(got), dict(want)
    a, b = got.pop('arrays'), want.pop('arrays')
    for rec in (got, want):
        for key in ('seconds', 'times', 'pools'):
            rec.pop(key, None)
    assert got == want, {k: (got.get(k), want.get(k)) for k in want
                         if got.get(k) != want.get(k)}
    assert a.keys() == b.keys()
    worst = 0.0
    keep = np.ones(len(b['stage_energies']), dtype=bool)
    keep[list(marked)] = False
    for key in b:
        x, y = a[key], b[key]
        assert x.shape == y.shape, (key, x.shape, y.shape)
        if key == 'stage_energies':
            x, y = x[keep], y[keep]
        err = float(np.abs(x - y).max()) if y.size else 0.0
        assert err <= atol, (key, err)
        worst = max(worst, err)
    return worst
