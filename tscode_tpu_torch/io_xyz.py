'''
Self-contained multi-frame .xyz reader/writer.

Replaces the reference's cclib dependency (`read_xyz`,
TSCoDe's utils.py:128-135) with a small parser that handles
conformer ensembles (repeated frames with constant atom count) and the
reference's output format (`write_xyz`, utils.py:114-126).
'''

from dataclasses import dataclass, field

import numpy as np

from tscode_tpu_torch.errors import CCReadError
from tscode_tpu_torch.pt import SYMBOL_TO_Z, SYMBOLS

try:
    from tscode_tpu_torch import native as native_io
except Exception:
    native_io = None


@dataclass
class XYZData:
    '''Parsed ensemble: mirrors the cclib ccread object fields the reference uses.'''
    atomcoords: np.ndarray          # (n_confs, n_atoms, 3) float64
    atomnos: np.ndarray             # (n_atoms,) int
    comments: list = field(default_factory=list)


def _parse_symbol(token):
    '''Atomic number from an element symbol or a numeric string.'''
    if token.isdigit():
        return int(token)
    token = token.capitalize() if len(token) < 3 else token
    z = SYMBOL_TO_Z.get(token)
    if z is None:
        # try case-insensitive match ('CL' -> 'Cl')
        z = SYMBOL_TO_Z.get(token.capitalize())
    if z is None:
        raise CCReadError(f'Unknown element symbol: {token!r}')
    return z


def read_xyz(filename):
    '''
    Read a (multi-frame) .xyz file into an XYZData ensemble.
    Raises CCReadError on malformed input or inconsistent atom counts.

    Uses the native C++ parser (native/xyz_io.cpp) when it built; the
    pure-Python path below is the fallback and the semantic reference.
    '''
    if native_io is not None and native_io.available():
        with open(filename, 'rb') as f:
            data = f.read()
        try:
            coords, atomnos, comments = native_io.parse_ensemble(data)
        except native_io.XYZNativeError as e:
            raise CCReadError(f'{filename}: {e}') from e
        return XYZData(atomcoords=coords, atomnos=atomnos,
                       comments=comments)

    with open(filename) as f:
        lines = f.read().splitlines()

    frames, comments = [], []
    atomnos = None
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        try:
            n_atoms = int(line.split()[0])
        except ValueError as e:
            raise CCReadError(f'{filename}: expected atom count at line {i + 1}') from e

        if i + 1 + n_atoms >= len(lines):
            raise CCReadError(f'{filename}: truncated frame at line {i + 1}')

        comments.append(lines[i + 1] if i + 1 < len(lines) else '')
        coords = np.empty((n_atoms, 3), dtype=np.float64)
        nos = np.empty(n_atoms, dtype=np.int64)
        for j in range(n_atoms):
            parts = lines[i + 2 + j].split()
            if len(parts) < 4:
                raise CCReadError(f'{filename}: bad atom line {i + 3 + j}')
            nos[j] = _parse_symbol(parts[0])
            coords[j] = [float(parts[1]), float(parts[2]), float(parts[3])]

        if atomnos is None:
            atomnos = nos
        elif not np.array_equal(atomnos, nos):
            raise CCReadError(f'{filename}: inconsistent atoms across frames')

        frames.append(coords)
        i += 2 + n_atoms

    if not frames:
        raise CCReadError(f'{filename}: no frames found')

    return XYZData(atomcoords=np.array(frames), atomnos=atomnos, comments=comments)


def write_xyz(coords, atomnos, output, title='temp'):
    '''
    Append one frame to an open text file, in the reference's format
    (utils.py:114-126: symbol + "% .6f" coordinates).
    '''
    coords = np.asarray(coords)
    atomnos = np.asarray(atomnos)
    assert atomnos.shape[0] == coords.shape[0]
    assert coords.shape[1] == 3
    out = [str(len(coords)), title]
    for z, (x, y, zc) in zip(atomnos, coords):
        out.append('%s     % .6f % .6f % .6f' % (SYMBOLS[int(z)], x, y, zc))
    output.write('\n'.join(out) + '\n')


def write_ensemble(filename, structures, atomnos, titles=None):
    '''Write a whole ensemble to `filename`.'''
    structures = np.asarray(structures)
    if titles is None:
        titles = [f'structure {i + 1}' for i in range(len(structures))]

    if (native_io is not None and native_io.available()
            and len(structures)):
        blob = native_io.format_ensemble(structures, atomnos, titles)
        with open(filename, 'wb') as f:
            f.write(blob)
        return filename

    with open(filename, 'w') as f:
        for s, title in zip(structures, titles):
            write_xyz(s, atomnos, f, title=title)
    return filename
