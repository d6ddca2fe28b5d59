'''
MOPAC adapter (reference TSCoDe's calculators/_mopac.py):
mixed cartesian/internal coordinates let pair distances be frozen; atom
order is scrambled for the input and unscrambled on read.
'''

import os
import subprocess

import numpy as np

from tscode_tpu_torch.calculators.common import scratch_dir
from tscode_tpu_torch.errors import MopacReadError
from tscode_tpu_torch.pt import SYMBOLS
from tscode_tpu_torch.settings import COMMANDS
from tscode_tpu_torch.solvents import get_solvent_line


def _dihedral(p):
    p0, p1, p2, p3 = p
    b0 = -(p1 - p0)
    b1 = p2 - p1
    b1 = b1 / np.linalg.norm(b1)
    b2 = p3 - p2
    v = b0 - (b0 @ b1) * b1
    w = b2 - (b2 @ b1) * b1
    return np.degrees(np.arctan2(np.cross(b1, v) @ w, v @ w))


def _vec_angle(u, w):
    cos = np.clip(u @ w / np.linalg.norm(u) / np.linalg.norm(w), -1, 1)
    return np.degrees(np.arccos(cos))


def read_mop_out(filename):
    '''Optimized coordinates + heat of formation (kcal/mol)
    (reference _mopac.py:32-82).'''
    coords = []
    energy = None
    with open(filename) as f:
        while True:
            line = f.readline()
            if 'Too many variables. By definition, at least one force ' \
                    'constant is exactly zero' in line:
                return None, 1e10, False
            if not line:
                break
            if 'SCF FIELD WAS ACHIEVED' in line:
                while True:
                    line = f.readline()
                    if not line:
                        break
                    if 'FINAL HEAT OF FORMATION' in line:
                        energy = float(line.split()[5])
                    if 'CARTESIAN COORDINATES' in line:
                        f.readline()            # blank separator
                        line = f.readline()     # first data row
                        while line != '\n':
                            parts = line.split()
                            coords.append([float(parts[2]), float(parts[3]),
                                           float(parts[4])])
                            line = f.readline()
                            if not line:
                                break
                        break
                break

    coords = np.array(coords)
    if coords.shape[0] != 0:
        return coords, energy, True
    raise MopacReadError(
        f'Cannot read file {filename}: maybe a badly specified MOPAC keyword?')


def write_mopac_input(path, coords, atomnos, method='PM7',
                      constrained_indices=None, solvent=None, charge=0,
                      title='temp', rng=None):
    '''Build the mixed-coordinate input; returns the atom order used
    (needed to unscramble the output). Reference _mopac.py:100-212.'''
    rng = rng or np.random.default_rng(0)
    constrained_indices = constrained_indices \
        if constrained_indices is not None else []
    flat = np.asarray(constrained_indices).ravel()

    if int(charge) != 0:
        # the reference's mopac_opt swallows `charge` via **kwargs and
        # always computes the neutral species (_mopac.py:84-236) — a
        # bug, fixed here with the CHARGE keyword
        method = method + f' CHARGE={int(charge)}'
    if solvent is not None:
        method = method + ' ' + get_solvent_line(solvent, 'MOPAC', method)

    order = []
    s = [method + '\n' + title + '\n\n']
    for i, num in enumerate(atomnos):
        if i not in flat:
            order.append(i)
            s.append(' {} {} 1 {} 1 {} 1\n'.format(
                SYMBOLS[int(num)], coords[i][0], coords[i][1], coords[i][2]))

    free_indices = list(set(range(len(atomnos))) - set(flat.tolist()))

    if len(flat) == len(set(flat.tolist())):
        # independent pairs: freeze each distance via internal coords
        for a, b in constrained_indices:
            order.append(b)
            order.append(a)
            c, d = rng.choice(free_indices, 2, replace=False)

            dist = np.linalg.norm(coords[a] - coords[b])
            angle = _vec_angle(coords[a] - coords[b], coords[c] - coords[b])
            d_angle = _dihedral(np.array([coords[a], coords[b],
                                          coords[c], coords[d]]))
            d_angle += 360 if d_angle < 0 else 0

            list_len = len(s)
            s.append(' {} {} 1 {} 1 {} 1\n'.format(
                SYMBOLS[int(atomnos[b])], coords[b][0], coords[b][1],
                coords[b][2]))
            s.append(' {} {} 0 {} 1 {} 1 {} {} {}\n'.format(
                SYMBOLS[int(atomnos[a])], dist, angle, d_angle, list_len,
                free_indices.index(c) + 1, free_indices.index(d) + 1))
    elif len(set(flat.tolist())) == 3:
        # three atoms, the central bound to the other two (e.g. a
        # chelotropic embed): others[0] cartesian, central internal
        # w.r.t. others[0], others[1] internal w.r.t. central
        # (reference _mopac.py:147-207)
        flat_list = flat.tolist()
        central = max(set(flat_list), key=flat_list.count)
        others = list(set(flat_list) - {central})

        order.append(others[0])
        s.append(' {} {} 1 {} 1 {} 1\n'.format(
            SYMBOLS[int(atomnos[others[0]])], coords[others[0]][0],
            coords[others[0]][1], coords[others[0]][2]))

        for prev, cur in ((others[0], central), (central, others[1])):
            order.append(cur)
            c, d = rng.choice(free_indices, 2, replace=False)
            dist = np.linalg.norm(coords[cur] - coords[prev])
            # reference QUIRK reproduced: the two sub-branches use
            # DIFFERENT angle references — central measures against the
            # prev->c direction (_mopac.py:170), others[1] against its
            # own cur->c direction (_mopac.py:199)
            angle = _vec_angle(coords[cur] - coords[prev],
                               coords[prev] - coords[c]) \
                if cur == central else \
                _vec_angle(coords[cur] - coords[prev],
                           coords[cur] - coords[c])
            d_angle = _dihedral(np.array([coords[cur], coords[prev],
                                          coords[c], coords[d]]))
            # reference BUG fixed and noted: _mopac.py:204 wraps
            # d_angle1 by testing the FIRST branch's d_angle sign;
            # each dihedral must be wrapped on its own sign
            d_angle += 360 if d_angle < 0 else 0
            list_len = len(s)
            s.append(' {} {} 0 {} 1 {} 1 {} {} {}\n'.format(
                SYMBOLS[int(atomnos[cur])], dist, angle, d_angle,
                list_len - 1, free_indices.index(c) + 1,
                free_indices.index(d) + 1))
    else:
        # reference parity (_mopac.py:209-210)
        raise NotImplementedError(
            'The constraints provided for MOPAC optimization are not '
            'yet supported')

    with open(path, 'w') as f:
        f.write(''.join(s))
    return order


def mopac_opt(coords, atomnos, constrained_indices=None, method='PM7',
              solvent=None, charge=0, title='temp', read_output=True,
              **kwargs):
    '''Constrained MOPAC optimization. Returns (coords, E kcal/mol, ok).
    Reference _mopac.py:84-236 (scramble + inverse-order read-back).'''
    coords = np.asarray(coords)
    with scratch_dir(title) as cwd:
        order = write_mopac_input(
            os.path.join(cwd, f'{title}.mop'), coords, atomnos,
            method=method, constrained_indices=constrained_indices,
            solvent=solvent, charge=charge, title=title)

        subprocess.check_call([COMMANDS['MOPAC'], f'{title}.mop'],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT, cwd=cwd)

        if not read_output:
            return None

        inv_order = [order.index(i) for i in range(len(order))]
        opt_coords, energy, success = read_mop_out(
            os.path.join(cwd, f'{title}.out'))
        opt_coords = opt_coords[inv_order] if opt_coords is not None \
            else coords
        return opt_coords, energy, success
