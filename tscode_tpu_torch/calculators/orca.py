'''
ORCA adapter (reference TSCoDe's calculators/_orca.py).
'''

import os
import subprocess

from tscode_tpu_torch.calculators.common import EH_TO_KCAL, scratch_dir
from tscode_tpu_torch.pt import SYMBOLS
from tscode_tpu_torch.settings import COMMANDS, MEM_GB
from tscode_tpu_torch.solvents import get_solvent_line


def write_orca_input(path, coords, atomnos, method='PM3',
                     constrained_indices=None, charge=0, procs=1,
                     maxiter=None, mem=MEM_GB, solvent=None, task='Opt'):
    '''`! method <task>` route + %geom distance constraints + %pal
    (reference _orca.py:51-83). task: 'Opt' for optimizations,
    'EnGrad' for single-point gradients.'''
    s = f'! {method} {task}\n\n# ORCA input generated by tscode_tpu\n\n'
    if solvent is not None:
        s += '\n' + get_solvent_line(solvent, 'ORCA', method) + '\n'
    if procs > 1:
        s += f'%pal nprocs {procs} end\n\n'
    s += f'%maxcore {int(mem * 1000)}\n\n'

    if constrained_indices is not None and len(constrained_indices):
        s += '%geom\nConstraints\n'
        for a, b in constrained_indices:
            s += '  {B %s %s C}\n' % (a, b)
        s += '  end\nend\n\n'

    if maxiter is not None:
        s += f'%geom\n  MaxIter {maxiter}\nend\n'

    s += f'*xyz {charge} 1\n'
    for i, atom in enumerate(coords):
        s += '%s     % .6f % .6f % .6f\n' % (
            SYMBOLS[int(atomnos[i])], atom[0], atom[1], atom[2])
    s += '*\n'

    with open(path, 'w') as f:
        f.write(s)


def read_orca_property(filename):
    '''Last SCF energy from an ORCA property file
    (reference _orca.py:106-122). Returned in Hartree, like the
    reference (NOTE: the reference mixes Eh here with kcal/mol
    elsewhere; we convert at the call site).'''
    energy = None
    with open(filename) as f:
        for line in f:
            if 'SCF Energy:' in line:
                energy = float(line.split()[2])
    return energy


def orca_opt(coords, atomnos, constrained_indices=None, method='PM3',
             charge=0, procs=1, maxiter=None, mem=MEM_GB, solvent=None,
             title='temp', read_output=True, **kwargs):
    '''Constrained ORCA optimization. Returns (coords, E kcal/mol, ok).'''
    with scratch_dir(title) as cwd:
        write_orca_input(os.path.join(cwd, f'{title}.inp'), coords,
                         atomnos, method=method,
                         constrained_indices=constrained_indices,
                         charge=charge, procs=procs, maxiter=maxiter,
                         mem=mem, solvent=solvent)
        with open(os.path.join(cwd, f'{title}.out'), 'w') as f:
            subprocess.check_call(
                [COMMANDS['ORCA'], f'{title}.inp', '--oversubscribe'],
                stdout=f, stderr=subprocess.STDOUT, cwd=cwd)

        if not read_output:
            return None
        try:
            from tscode_tpu_torch.io_xyz import read_xyz
            opt_coords = read_xyz(os.path.join(cwd, f'{title}.xyz')).atomcoords[0]
            energy = read_orca_property(
                os.path.join(cwd, f'{title}_property.txt'))
            if energy is not None:
                energy *= EH_TO_KCAL
            return opt_coords, energy, True
        except FileNotFoundError:
            return None, None, False
