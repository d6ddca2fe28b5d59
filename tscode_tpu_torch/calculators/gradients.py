'''
External QM single-point gradients for in-process procedures.

The reference runs NEB/saddle/bend on real QM forces by wrapping
calculators in ASE objects (ase_manipulations.py:123-214 get_ase_calc;
consumed by ase_neb :382-526, ase_saddle :314-346, ase_bend :683-866).
This design needs no ASE: one `xtb --grad` subprocess per evaluation
yields (energy, gradient) from the Turbomole-format files xtb writes, a
chain of images is evaluated concurrently on the same thread pool as
the refinement dispatch queue, and the consumers (neb.run_neb_callback,
saddle.dimer_saddle_callback, the bend's relaxation) take the numbers as
numpy arrays (counterpart of tscode_tpu/calculators/gradients.py).
'''

import os
import subprocess
import tempfile

import numpy as np

from tscode_tpu_torch.calculators.xtb import _xtb_flags
from tscode_tpu_torch.io_xyz import write_xyz

EH_TO_KCAL = 627.5094740631          # Hartree -> kcal/mol
BOHR_TO_A = 0.529177210903           # Bohr -> Angstrom
# gradient file: Hartree/Bohr -> kcal/mol/A
GRAD_TO_KCAL_A = EH_TO_KCAL / BOHR_TO_A


def parse_turbomole_gradient(text, n_atoms):
    '''
    Parse a Turbomole-format `gradient` file (what `xtb --grad` writes):

        $grad
          cycle = 1  SCF energy = -5.070544  |dE/dxyz| = 0.000298
          <n_atoms coordinate lines: x y z element, Bohr>
          <n_atoms gradient lines: gx gy gz, Hartree/Bohr>
        $end

    Returns (energy_hartree, gradient (n_atoms, 3) Hartree/Bohr) from
    the LAST cycle present. Fortran D-exponents are handled.
    '''
    lines = [ln.strip() for ln in text.splitlines()]
    cycle_starts = [i for i, ln in enumerate(lines)
                    if ln.startswith('cycle')]
    if not cycle_starts:
        raise ValueError('no $grad cycle found in gradient file')
    start = cycle_starts[-1]

    header = lines[start]
    try:
        energy = float(header.split('energy =')[1].split()[0]
                       .replace('D', 'E').replace('d', 'e'))
    except (IndexError, ValueError) as e:
        raise ValueError(f'unparsable gradient header: {header!r}') from e

    grad_lines = lines[start + 1 + n_atoms:start + 1 + 2 * n_atoms]
    if len(grad_lines) < n_atoms:
        raise ValueError(f'gradient file truncated: expected {n_atoms} '
                         f'gradient rows, found {len(grad_lines)}')
    grad = np.array([[float(x.replace('D', 'E').replace('d', 'e'))
                      for x in ln.split()[:3]] for ln in grad_lines])
    return energy, grad


def xtb_gradient(coords, atomnos, method='GFN2-xTB', solvent=None,
                 charge=0, procs=1, title='grad_sp'):
    '''
    Single-point energy + gradient via `xtb --grad` in a scratch dir.
    Returns (energy kcal/mol, gradient (N, 3) kcal/mol/Angstrom).
    Reference capability: the ASE calculator force call inside
    ase_neb/ase_saddle/ase_bend (ase_manipulations.py:123-214).
    '''
    coords = np.asarray(coords, dtype=float)
    with tempfile.TemporaryDirectory(prefix='tscode_grad_') as cwd:
        with open(os.path.join(cwd, f'{title}.xyz'), 'w') as f:
            write_xyz(coords, atomnos, f, title=title)
        flags = ['--grad'] + _xtb_flags(method, opt=False, conv_thr=None,
                                        charge=charge, procs=procs,
                                        solvent=solvent)
        with open(os.path.join(cwd, 'out.log'), 'w') as f:
            subprocess.check_call(['xtb', f'{title}.xyz'] + flags,
                                  stdout=f, stderr=subprocess.STDOUT,
                                  cwd=cwd)
        with open(os.path.join(cwd, 'gradient')) as f:
            e_h, grad_hb = parse_turbomole_gradient(f.read(), len(coords))
    return e_h * EH_TO_KCAL, grad_hb * GRAD_TO_KCAL_A


def parse_orca_engrad(text):
    '''
    Parse an ORCA `.engrad` file (written by `! method EnGrad`):
    comment blocks introduced by '#' separate three data sections —
    atom count, total energy (Eh), then 3N gradient components
    (Eh/Bohr, x/y/z per atom). Returns (energy_Eh, grad (N, 3) Eh/Bohr).
    Reference capability: ORCA forces through ASE's calculator in
    get_ase_calc (ase_manipulations.py:123-214).
    '''
    # data lines in the count/energy/gradient sections hold exactly one
    # value; the trailing atoms-and-coordinates section (4 tokens/row)
    # and '#' comment lines are skipped
    values = []
    for ln in text.splitlines():
        tokens = ln.split()
        if len(tokens) != 1 or tokens[0].startswith('#'):
            continue
        try:
            values.append(float(tokens[0]))
        except ValueError:
            continue
    if len(values) < 2:
        raise ValueError('engrad file has no data sections')
    n_atoms = int(values[0])
    energy = values[1]
    flat = values[2:2 + 3 * n_atoms]
    if len(flat) < 3 * n_atoms:
        raise ValueError(f'engrad file truncated: expected {3 * n_atoms} '
                         f'gradient components, found {len(flat)}')
    return energy, np.array(flat).reshape(n_atoms, 3)


def parse_gaussian_forces(text, n_atoms):
    '''
    Energy + gradient from a Gaussian single-point `force` log: the last
    'SCF Done:' (or semiempirical 'Energy=') line gives the energy (Eh);
    the last 'Forces (Hartrees/Bohr)' table gives per-atom FORCES, which
    we negate into a gradient. Returns (energy_Eh, grad (N, 3) Eh/Bohr).
    '''
    lines = text.splitlines()
    energy = None
    forces = None
    for i, line in enumerate(lines):
        if 'SCF Done' in line:
            energy = float(line.split()[4])
        elif line.lstrip().startswith('Energy=') and 'NIter' in line:
            energy = float(line.split()[1])
        elif 'Forces (Hartrees/Bohr)' in line:
            block = []
            for row in lines[i + 3:i + 3 + n_atoms]:
                parts = row.split()
                block.append([float(x) for x in parts[2:5]])
            forces = np.array(block)
    if energy is None or forces is None:
        raise ValueError('Gaussian force output missing energy or '
                         'forces table')
    if len(forces) != n_atoms:
        raise ValueError(f'Gaussian forces table truncated: expected '
                         f'{n_atoms} rows, found {len(forces)}')
    return energy, -forces


def parse_mopac_gradients(text):
    '''
    Energy + gradient from a MOPAC `1SCF GRADIENTS` output: the FINAL
    POINT AND DERIVATIVES table lists one CARTESIAN X/Y/Z row per
    coordinate with the gradient in kcal/mol/Angstrom (already our
    units); FINAL HEAT OF FORMATION gives kcal/mol directly.
    Returns (energy_kcal, grad (N, 3) kcal/mol/A).
    '''
    energy = None
    rows = []
    in_table = False
    for line in text.splitlines():
        if 'FINAL HEAT OF FORMATION' in line:
            energy = float(line.split('=')[1].split()[0])
        if 'FINAL  POINT  AND  DERIVATIVES' in line:
            in_table = True
            rows = []
            continue
        if in_table:
            parts = line.split()
            if 'CARTESIAN' in line and len(parts) >= 7:
                rows.append(float(parts[6]))
            elif rows and not line.strip():
                in_table = False
    if energy is None or not rows or len(rows) % 3:
        raise ValueError('MOPAC gradient output missing energy or a '
                         'complete derivative table')
    return energy, np.array(rows).reshape(-1, 3)


def orca_gradient(coords, atomnos, method='PM3', solvent=None, charge=0,
                  procs=1, title='grad_sp'):
    '''Single-point energy + gradient via `! method EnGrad`.
    Returns (energy kcal/mol, gradient (N, 3) kcal/mol/Angstrom).'''
    from tscode_tpu_torch.calculators.orca import write_orca_input
    from tscode_tpu_torch.settings import COMMANDS

    coords = np.asarray(coords, dtype=float)
    with tempfile.TemporaryDirectory(prefix='tscode_grad_') as cwd:
        write_orca_input(os.path.join(cwd, f'{title}.inp'), coords,
                         atomnos, method=method, task='EnGrad',
                         charge=charge, procs=procs, solvent=solvent)
        with open(os.path.join(cwd, 'out.log'), 'w') as f:
            subprocess.check_call(
                [COMMANDS['ORCA'], f'{title}.inp', '--oversubscribe'],
                stdout=f, stderr=subprocess.STDOUT, cwd=cwd)
        with open(os.path.join(cwd, f'{title}.engrad')) as f:
            e_h, grad_hb = parse_orca_engrad(f.read())
    return e_h * EH_TO_KCAL, grad_hb * GRAD_TO_KCAL_A


def gaussian_gradient(coords, atomnos, method='PM6', solvent=None,
                      charge=0, procs=1, title='grad_sp'):
    '''Single-point energy + gradient via a `# force method` route.
    Returns (energy kcal/mol, gradient (N, 3) kcal/mol/Angstrom).'''
    from tscode_tpu_torch.calculators.gaussian import write_gaussian_input
    from tscode_tpu_torch.settings import COMMANDS

    coords = np.asarray(coords, dtype=float)
    with tempfile.TemporaryDirectory(prefix='tscode_grad_') as cwd:
        write_gaussian_input(os.path.join(cwd, f'{title}.com'), coords,
                             atomnos, method=method, route='force',
                             charge=charge, procs=procs, solvent=solvent)
        subprocess.check_call([COMMANDS['GAUSSIAN'], f'{title}.com'],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT, cwd=cwd)
        for ext in ('log', 'out'):
            path = os.path.join(cwd, f'{title}.{ext}')
            if os.path.isfile(path):
                with open(path) as f:
                    e_h, grad_hb = parse_gaussian_forces(f.read(),
                                                         len(coords))
                break
        else:
            raise FileNotFoundError('no Gaussian output written')
    return e_h * EH_TO_KCAL, grad_hb * GRAD_TO_KCAL_A


def mopac_gradient(coords, atomnos, method='PM7', solvent=None, charge=0,
                   procs=1, title='grad_sp'):
    '''Single-point energy + gradient via `1SCF GRADIENTS`.
    Returns (energy kcal/mol, gradient (N, 3) kcal/mol/Angstrom) — MOPAC
    already reports both in these units.'''
    from tscode_tpu_torch.pt import SYMBOLS
    from tscode_tpu_torch.settings import COMMANDS

    from tscode_tpu_torch.solvents import get_solvent_line

    coords = np.asarray(coords, dtype=float)
    keywords = f'{method} 1SCF GRADIENTS CHARGE={int(charge)}'
    if solvent is not None:
        # same keyword form as the optimization stages (calculators/
        # mopac.py): omitting it ran NEB/SADDLE gradients gas-phase
        # while the rest of the run was solvated
        keywords += ' ' + get_solvent_line(solvent, 'MOPAC', method)
    body = ''.join(
        f'{SYMBOLS[int(a)]} {x: .8f} 1 {y: .8f} 1 {z: .8f} 1\n'
        for a, (x, y, z) in zip(atomnos, coords))
    with tempfile.TemporaryDirectory(prefix='tscode_grad_') as cwd:
        with open(os.path.join(cwd, f'{title}.mop'), 'w') as f:
            f.write(f'{keywords}\n{title}\n\n{body}')
        subprocess.check_call([COMMANDS['MOPAC'], f'{title}.mop'],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT, cwd=cwd)
        with open(os.path.join(cwd, f'{title}.out')) as f:
            return parse_mopac_gradients(f.read())


# resolved by NAME at call time so tests can monkeypatch the per-engine
# adapters on this module
GRADIENT_FUNCS = {
    'XTB': 'xtb_gradient',
    'ORCA': 'orca_gradient',
    'GAUSSIAN': 'gaussian_gradient',
    'MOPAC': 'mopac_gradient',
}


def make_chain_gradient_fn(atomnos, calculator='XTB', method='GFN2-xTB',
                           solvent=None, charge=0, procs=1, maxthreads=4):
    '''
    Build `fn(chain (I, N, 3)) -> (energies (I,), grads (I, N, 3))`
    evaluating every image concurrently on a thread pool (the work is
    subprocess-bound, mirroring calculators/dispatch.py). Results are
    keyed by submission index — completion order never scrambles the
    band. Dispatches on the run calculator like the reference's
    get_ase_calc (ase_manipulations.py:123-214).
    '''
    if calculator not in GRADIENT_FUNCS:
        raise NotImplementedError(
            f'QM gradients are implemented for '
            f'{sorted(GRADIENT_FUNCS)}; {calculator} has no single-point '
            f'gradient adapter.')

    from concurrent.futures import ThreadPoolExecutor

    def chain_gradient(chain):
        grad_func = globals()[GRADIENT_FUNCS[calculator]]
        chain = np.asarray(chain)
        with ThreadPoolExecutor(max_workers=maxthreads) as pool:
            futures = [pool.submit(grad_func, image, atomnos,
                                   method=method, solvent=solvent,
                                   charge=charge, procs=procs,
                                   title=f'grad_im{i}')
                       for i, image in enumerate(chain)]
            results = [f.result() for f in futures]
        energies = np.array([r[0] for r in results])
        grads = np.stack([r[1] for r in results])
        return energies, grads

    return chain_gradient


def make_gradient_fn(atomnos, **kwargs):
    '''Single-structure form: fn(coords (N, 3)) -> (E, grad (N, 3)).'''
    chain_fn = make_chain_gradient_fn(atomnos, **kwargs)

    def gradient(coords):
        energies, grads = chain_fn(np.asarray(coords)[None])
        return float(energies[0]), grads[0]

    return gradient
