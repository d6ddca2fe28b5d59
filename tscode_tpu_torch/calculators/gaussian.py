'''
Gaussian adapter (reference TSCoDe's calculators/_gaussian.py).
'''

import os
import subprocess

import numpy as np

from tscode_tpu_torch.calculators.common import scratch_dir
from tscode_tpu_torch.pt import SYMBOLS
from tscode_tpu_torch.settings import COMMANDS, MEM_GB
from tscode_tpu_torch.solvents import get_solvent_line


def write_gaussian_input(path, coords, atomnos, method='PM6',
                         constrained_indices=None, procs=1, solvent=None,
                         charge=0, mem=MEM_GB, route=None):
    '''Route section + geometry + modredundant distance freezes
    (reference _gaussian.py:40-71; the reference inverts the route
    line order and drops its own %mem header — both fixed here).
    route: override the job keyword (e.g. 'force' for single-point
    gradients); default is the constrained/plain opt.'''
    s = ''
    if mem is not None:
        s += (f'%mem={int(1000 * mem)}MB\n' if mem < 1 else f'%mem={int(mem)}GB\n')
    if procs > 1:
        s += f'%nprocshared={procs}\n'

    if route is not None:
        s += f'# {route} '
    else:
        # constrained runs need modredundant sections
        s += '# opt=modredundant ' if constrained_indices is not None and \
            len(constrained_indices) else '# opt '
    s += method
    if solvent is not None:
        s += ' ' + get_solvent_line(solvent, 'GAUSSIAN', method)
    s += ('\n\nGaussian input generated by tscode_tpu\n\n'
          f'{int(charge)} 1\n')

    for i, atom in enumerate(coords):
        s += '%s     % .6f % .6f % .6f\n' % (
            SYMBOLS[int(atomnos[i])], atom[0], atom[1], atom[2])
    s += '\n'

    if constrained_indices is not None and len(constrained_indices):
        for a, b in constrained_indices:
            s += f'B {a + 1} {b + 1} F\n'
    s += '\n'

    with open(path, 'w') as f:
        f.write(s)


def read_gaussian_out(filename):
    '''Final standard-orientation geometry and SCF energy (kcal/mol) from
    a Gaussian .log/.out file (reference reads via cclib,
    _gaussian.py:74-92; the format itself dictates the markers).'''
    coords_blocks = []
    energy = None
    with open(filename) as f:
        lines = f.readlines()

    for i, line in enumerate(lines):
        if 'SCF Done' in line:
            energy = float(line.split()[4]) * 627.5096080305927
        if 'Standard orientation' in line or 'Input orientation' in line:
            block = []
            j = i + 5
            while j < len(lines) and '---' not in lines[j]:
                parts = lines[j].split()
                block.append((int(parts[1]), [float(parts[3]),
                                              float(parts[4]),
                                              float(parts[5])]))
                j += 1
            coords_blocks.append(block)

    if not coords_blocks or energy is None:
        # a geometry echo without any completed SCF (job died in the
        # first cycle) is a FAILED optimization: returning ok=True with
        # energy=None would poison the refinement energy table
        return None, None, False
    atomnos, coords = zip(*coords_blocks[-1])
    return np.array(coords), energy, True


def gaussian_opt(coords, atomnos, constrained_indices=None, method='PM6',
                 procs=1, solvent=None, charge=0, title='temp',
                 read_output=True, **kwargs):
    '''Constrained Gaussian optimization. Returns (coords, E, ok).
    Note: the reference's gaussian_opt swallows `charge` via **kwargs
    and always writes a neutral system (_gaussian.py:26-92) — a bug,
    fixed here by threading charge into the input's charge/mult line.'''
    with scratch_dir(title) as cwd:
        write_gaussian_input(os.path.join(cwd, f'{title}.com'), coords,
                             atomnos, method=method,
                             constrained_indices=constrained_indices,
                             procs=procs, solvent=solvent, charge=charge)
        try:
            subprocess.check_call([COMMANDS['GAUSSIAN'], f'{title}.com'],
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.STDOUT, cwd=cwd)
        except subprocess.CalledProcessError:
            pass

        if not read_output:
            return None
        for ext in ('log', 'out'):
            out = os.path.join(cwd, f'{title}.{ext}')
            if os.path.isfile(out):
                opt_coords, energy, ok = read_gaussian_out(out)
                if ok:
                    return opt_coords, energy, True
        return None, None, False
