'''
The record of a force-field route, as the card check (chip_smoke.py
phases 18 and 19) and the parity tests compare it.

`record` runs one input through an Embedder with spies on the route's
functions (the dihedral sweeps, the peak picker, the dihedral and
distance scans, the dimer and the band) and returns their counts and
indices, the seconds of each call and the frames and energies in call
order. The frequencies of every refined maximum are taken after the
route has returned, and timed apart from it: the scan> route itself
computes none. `same_records` holds two records to each other.

The modules recorded come from a `Package`: `port_package(device)` for
this package, float64 on `device`; a test builds the same namespace over
the JAX package's modules to record the reference.

    dihedral_scan  SADDLE + scan> of the ring torsion C3-C4-C5-C6 of
                   suite_inputs.chlorocycloalkane(n_carbons): every
                   sweep's points, the peaks and sub-peaks, each dimer's
                   flag, the imaginary modes of every refined maximum and
                   the maxima that survive the RMSD prune
    ff_operators   neb>, saddle> and the C0-Cl distance scan on the same
                   ring, their inputs from a dihedral_scan record
                   (`operator_frames`): the band's TS image, the dimer's
                   flag and the distance scan's points and peak
'''

import os
import time
from types import SimpleNamespace

import numpy as np

from tscode_tpu_torch.suite_inputs import config_files, ff_operators_input

FF_ATOL = 1e-6             # A, and kcal/mol on energies


def Package(neb, saddle, scans, embedder, embed_kw, stamp, frequencies):
    '''What `record` runs: the modules whose functions it spies on, the
    Embedder class and its keyword arguments, the run's stamp, and
    frequencies(x, atomnos, graph, guess) -> (freqs, n_imag) on the
    force field built from guess.'''
    return SimpleNamespace(neb=neb, saddle=saddle, scans=scans,
                           embedder=embedder, embed_kw=embed_kw, stamp=stamp,
                           frequencies=frequencies)


def port_package(device):
    '''This package, float64 on `device`.'''
    import torch
    from tscode_tpu_torch import ff, neb, saddle, scans, vibrations
    from tscode_tpu_torch.embedder import Embedder

    def frequencies(x, atomnos, graph, guess):
        params = ff.params_to_device(ff.build_ff_params(guess, atomnos, graph),
                                     device, torch.float64)
        return vibrations.frequencies(x, atomnos,
                                      lambda c: ff.ff_energy(c, params),
                                      device=device)

    return Package(neb, saddle, scans, Embedder,
                   dict(device=device, dtype=torch.float64), 'port',
                   frequencies)


def operator_frames(scan):
    '''The ff_operators inputs from a dihedral_scan record: the first
    clockwise coarse point, the point 120 degrees on, and the highest
    clockwise coarse point.'''
    n = scan['sweeps'][0]
    frames = scan['arrays']['sweep_frames'][:n]
    energies = scan['arrays']['sweep_energies'][:n]
    return frames[0], frames[n // 3], frames[int(np.argmax(energies))]


def record(pkg, name, n_carbons, workdir, scan=None):
    '''One force-field route of `pkg` in workdir: `dihedral_scan` at
    n_carbons ring carbons, or `ff_operators` on the inputs taken from
    `scan`, the reference's dihedral_scan record. Returns the record:
    counts and indices, `seconds` (the Embedder's run), `times` (the
    seconds of each call of a spied function, by name, and of each
    refined maximum's frequencies) and `arrays`, a dict of the frames
    and energies in call order.'''
    rec = {'name': name, 'n_confs': n_carbons}
    arrays = {}

    def keep(key, value):
        arrays.setdefault(key, []).append(np.asarray(value, dtype=float))

    times = {}
    refined = []

    def spy(module, fname, after):
        fn = getattr(module, fname)

        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times.setdefault(fname, []).append(time.perf_counter() - t0)
            after(out, *args)
            return out
        return module, fname, fn, run

    def on_sweep(out, *args):
        rec.setdefault('sweeps', []).append(len(out[1]))
        for e, x in zip(out[1], out[2]):
            keep('sweep_energies', e)
            keep('sweep_frames', x)

    def on_peaks(out, *args):
        rec.setdefault('peaks', []).append([int(i) for i in out])

    def on_saddle(out, coords, atomnos, graph, *args):
        rec.setdefault('saddle_converged', []).append(bool(out[2]))
        keep('saddle_guess', coords)
        keep('saddle_frames', out[0])
        keep('saddle_energies', out[1])
        refined.append((np.array(out[0]), atomnos, graph, np.array(coords)))

    def on_neb(out, *args):
        rec.setdefault('neb_ts', []).append(int(out[2]))
        keep('neb_frames', out[0])
        keep('neb_energies', out[1])

    def on_distance(out, *args):
        rec['distance_points'] = len(out[0])
        rec['distance_peak'] = int(out[3])
        keep('distance_frames', out[2])
        keep('distance_energies', out[1])

    def on_dihedral(out, *args):
        rec['maxima'] = len(out[0])
        keep('maxima_frames', out[0])
        keep('maxima_energies', out[1])

    spies = [spy(pkg.scans, '_dihedral_sweep', on_sweep),
             spy(pkg.scans, 'atropisomer_peaks', on_peaks),
             spy(pkg.scans, 'dihedral_scan', on_dihedral),
             spy(pkg.scans, 'distance_scan', on_distance),
             spy(pkg.saddle, 'saddle_refine_structure', on_saddle),
             spy(pkg.neb, 'run_neb', on_neb)]
    if name == 'dihedral_scan':
        inp = config_files(name, workdir, n_carbons)
    else:
        inp = ff_operators_input(workdir, n_carbons, *operator_frames(scan))
    cwd = os.getcwd()
    for module, fname, _, run in spies:
        setattr(module, fname, run)
    t0 = time.perf_counter()
    try:
        pkg.embedder(inp, stamp=pkg.stamp, **pkg.embed_kw).run()
    finally:
        os.chdir(cwd)
        for module, fname, fn, _ in spies:
            setattr(module, fname, fn)
    rec['seconds'] = time.perf_counter() - t0
    for x, atomnos, graph, guess in refined:
        t0 = time.perf_counter()
        _, n_imag = pkg.frequencies(x, atomnos, graph, guess)
        times.setdefault('frequencies', []).append(time.perf_counter() - t0)
        rec.setdefault('n_imag', []).append(int(n_imag))
    rec['times'] = times
    rec['arrays'] = {k: np.array(v) for k, v in arrays.items()}
    return rec


def same_records(got, want, atol=FF_ATOL):
    '''Every count and index equal, every array within atol; returns
    the largest array difference.'''
    got, want = dict(got), dict(want)
    a, b = got.pop('arrays'), want.pop('arrays')
    for rec in (got, want):
        rec.pop('seconds')
        rec.pop('times', None)
    assert got == want, (got, want)
    assert a.keys() == b.keys()
    worst = 0.0
    for key in b:
        assert a[key].shape == b[key].shape, key
        err = float(np.abs(a[key] - b[key]).max()) if b[key].size else 0.0
        assert err <= atol, (key, err)
        worst = max(worst, err)
    return worst
