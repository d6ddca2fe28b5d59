'''
Host utilities: structure sanity checks, timing, text helpers.
(behavioral parity with TSCoDe's utils.py — scramble and
saturation checks at :341-387, :469-499; misc helpers throughout)
'''

import os
import time

import numpy as np

from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.pt import SYMBOLS


def time_to_string(total_time, verbose=False):
    '''Seconds -> compact "1h 2m 3.4s"-style string.'''
    timings = []
    if total_time > 3600:
        h = int(total_time // 3600)
        timings.append(f'{h} hour{"s" if h != 1 else ""}' if verbose else f'{h}h')
        total_time %= 3600
    if total_time > 60:
        m = int(total_time // 60)
        timings.append(f'{m} minute{"s" if m != 1 else ""}' if verbose else f'{m}m')
        total_time %= 60
    timings.append(f'{total_time:.1f} second{"s" if round(total_time, 1) != 1 else ""}'
                   if verbose else f'{total_time:.1f}s')
    return ' '.join(timings)


def pretty_num(n):
    '''Thousands-separated integer string.'''
    return f'{int(n):,}'.replace(',', "'")


def flatten(array, typefunc=float):
    out = []

    def rec(l):
        for e in l:
            if type(e) in (list, tuple, np.ndarray):
                rec(e)
            else:
                out.append(typefunc(e))
    rec(array)
    return out


from contextlib import contextmanager, redirect_stderr, redirect_stdout


@contextmanager
def suppress_stdout_stderr():
    '''Silence console output of a block (reference utils.py uses an
    os-level devnull dup; Python-level redirection covers every print
    this package makes).'''
    with open(os.devnull, 'w') as null, \
            redirect_stdout(null), redirect_stderr(null):
        yield


def loadbar(done, total, prefix='', width=50):
    '''In-place terminal progress bar (reference utils.py:171-178).'''
    total = max(int(total), 1)
    frac = min(done / total, 1.0)
    n_fill = int(width * frac)
    bar = '#' * n_fill + '-' * (width - n_fill)
    print(f'\r{prefix} |{bar}| {100 * frac:.1f}%', end='\r')
    if done >= total:
        print()


def auto_newline(string, max_line_len=50, padding=2):
    string = str(string)
    out = [' ' * padding]
    line_len = 0
    for word in string.split():
        out.append(word)
        line_len += len(word) + 1
        if line_len >= max_line_len:
            out.append('\n' + ' ' * padding)
            line_len = 0
    return ' '.join(out)


def timing_wrapper(function, *args, payload=None, **kwargs):
    '''Run function, appending elapsed seconds (and optional payload).'''
    start = time.perf_counter()
    ret = function(*args, **kwargs)
    elapsed = time.perf_counter() - start
    if payload is None:
        return ret, elapsed
    return ret, payload, elapsed


def clean_directory(to_remove=()):
    '''Remove scratch files from the cwd (reference utils.py cleanup).'''
    for name in to_remove:
        try:
            os.remove(name)
        except FileNotFoundError:
            pass
    import shutil as _shutil
    for name in os.listdir():
        if name.split('.')[0] == 'temp':
            if os.path.isdir(name):
                # scratch DIRECTORIES named temp* (the reference falls
                # back to rmtree here too, utils.py:73-88)
                _shutil.rmtree(name, ignore_errors=True)
            else:
                os.remove(name)
        elif name.startswith('temp_') and os.path.isfile(name):
            os.remove(name)


def molecule_check(old_coords, new_coords, atomnos, max_newbonds=0):
    '''True when the bond sets of two geometries differ by at most
    max_newbonds (reference utils.py:341-353).'''
    old_bonds = {(a, b) for a, b in graphize(old_coords, atomnos).edges if a != b}
    new_bonds = {(a, b) for a, b in graphize(new_coords, atomnos).edges if a != b}
    delta = (old_bonds | new_bonds) - (old_bonds & new_bonds)
    return len(delta) <= max_newbonds


def scramble_check(ts_structure, ts_atomnos, excluded_atoms, mols_graphs,
                   max_newbonds=0, logfunction=None, title=None):
    '''
    True when a multimolecular pose kept its molecular identities: bond
    set delta vs the molecule graphs, ignoring bonds through excluded
    (constrained) atoms (reference utils.py:355-387).
    '''
    assert len(ts_structure) == sum(len(g.nodes) for g in mols_graphs)

    bonds = set()
    pos = 0
    for graph in mols_graphs:
        for a, b in graph.edges:
            if a != b:
                bonds.add(tuple(sorted((a + pos, b + pos))))
        pos += len(graph.nodes)

    new_bonds = {tuple(sorted((a, b)))
                 for a, b in graphize(ts_structure, ts_atomnos).edges if a != b}
    delta = (bonds | new_bonds) - (bonds & new_bonds)

    for bond in delta.copy():
        for a in excluded_atoms:
            if a in bond:
                delta -= {bond}

    if len(delta) > max_newbonds:
        if logfunction is not None:
            logfunction(f'{title}, scramble_check - found {len(delta)} '
                        f'extra bonds: {delta}')
        return False
    return True


_TRANSITION_METALS = frozenset((
    'Sc', 'Ti', 'V', 'Cr', 'Mn', 'Fe', 'Co', 'Ni', 'Cu', 'Zn', 'Y', 'Zr',
    'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag', 'Cd', 'La', 'Ce', 'Pr', 'Nd',
    'Pm', 'Sm', 'Eu', 'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Tm', 'Yb', 'Lu', 'Hf',
    'Ta', 'W', 'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg', 'Th', 'Pa', 'U', 'Np',
    'Pu', 'Am'))

_ODD_VALENT = frozenset((
    'H', 'Li', 'Na', 'K', 'Rb', 'Cs', 'F', 'Cl', 'Br', 'I', 'At',
    'N', 'P', 'As', 'Sb', 'Bi', 'B', 'Al', 'Ga', 'In', 'Tl'))


def saturation_check(atomnos, charge=0):
    '''Even-saturation-index sanity check; transition-metal systems pass
    unconditionally (reference utils.py:469-499).'''
    symbols = [SYMBOLS[int(a)] for a in atomnos]
    if any(s in _TRANSITION_METALS for s in symbols):
        return True
    n_odd = sum(1 for s in symbols if s in _ODD_VALENT)
    return ((n_odd + charge) / 2) % 1 < 0.001


def get_scan_peak_index(energies, max_thr=50, min_thr=0.1):
    '''Index of the most prominent peak of a scan energy profile
    (reference utils.py:316-339).'''
    energies = list(energies)
    _l = len(energies)
    peaks = [i for i in range(_l)
             if energies[i - 1] < energies[i] >= energies[(i + 1) % _l]
             and max_thr > energies[i] > min_thr]
    if not peaks:
        return energies.index(max(energies))
    if len(peaks) == 1:
        return peaks[0]
    return energies.index(max(energies[i] for i in peaks))


def pyplot():
    '''matplotlib.pyplot on the file-only Agg backend, or None where
    matplotlib is not installed: every plot of the port is optional, no
    number depends on one, and its caller logs the skip.'''
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt
