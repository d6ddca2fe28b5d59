'''The calculator adapters of the port (tscode_tpu_torch/calculators)
against the JAX package's: every input writer byte for byte, every
parser on the same canned files, dynamic_energy_thr, and the adapters
driven end to end through the stand-in xtb of tests/torch_standin (a
test double: no number it gives is chemistry), run in process in both
packages. Geometry within 1e-6 A, energies within 1e-6 kcal/mol, the
rest exact.'''

import io
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu.calculators import common as jcommon
from tscode_tpu.calculators import dispatch as jdispatch
from tscode_tpu.calculators import gaussian as jgaussian
from tscode_tpu.calculators import gradients as jgradients
from tscode_tpu.calculators import mopac as jmopac
from tscode_tpu.calculators import openbabel as jopenbabel
from tscode_tpu.calculators import orca as jorca
from tscode_tpu.calculators import xtb as jxtb
from tscode_tpu_torch.calculators import common, dispatch, gaussian
from tscode_tpu_torch.calculators import gradients, mopac, openbabel, orca
from tscode_tpu_torch.calculators import xtb
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.io_xyz import read_xyz
from tscode_tpu_torch.opt_records import STANDIN_DIR, InProcessSubprocess
from tscode_tpu_torch.pipeline import FIXTURE_DIR

sys.path.insert(0, STANDIN_DIR)
import standin_xtb  # noqa: E402

ATOL = 1e-6
PACKAGES = {'jax': (jxtb, jgradients, jorca, jgaussian, jmopac, jdispatch),
            'port': (xtb, gradients, orca, gaussian, mopac, dispatch)}


def fixture(name):
    data = read_xyz(os.path.join(FIXTURE_DIR, name))
    return np.asarray(data.atomcoords[0], dtype=float), np.asarray(data.atomnos)


def pose(seed=0):
    '''C2H4 + CH3Cl, the chlorinated carbon 3.2 A from a C2H4 carbon,
    jittered from a seed.'''
    rng = np.random.default_rng(seed)
    c1, n1 = fixture('C2H4.xyz')
    c2, n2 = fixture('CH3Cl.xyz')
    c2 = c2 - c2[0] + c1[0] + np.array([0.0, 0.0, 3.2])
    coords = np.concatenate([c1, c2]) + rng.normal(size=(11, 3)) * 0.02
    return coords, np.concatenate([n1, n2]), n1, n2, c1, c2


def both(write, tmp_path, *args, **kw):
    '''Bytes written by each package's `write(module, path, ...)`.'''
    out = {}
    for name, mods in PACKAGES.items():
        path = tmp_path / f'{name}.txt'
        write(mods, str(path), *args, **kw)
        out[name] = path.read_bytes()
    return out


# -------------------------------------------------------------- writers

@pytest.mark.parametrize('args', [
    ([(0, 5), (2, 7)], [2.2, None], None, None, 'GFN2-xTB', 500, 'log.xyz',
     'xtbopt.xyz', 1, None),
    (None, None, [(0, 1, 2, 3)], [120.0], 'GFN-FF', 0, 'l', 'o', 0.2,
     '$constrain\n  distance: 1, 2, auto\n$end'),
    ([(1, 4)], [None], [(0, 1, 2, 3), (1, 2, 3, 4)], [0, 180], 'GFN-xTB',
     50, 't.xyz', 'o.xyz', 0.25, None),
])
def test_xtb_input_writer_is_byte_equal(tmp_path, args):
    out = both(lambda m, p: m[0]._write_xtb_input(p, *args), tmp_path)
    assert out['port'] == out['jax'] and out['jax']


@pytest.mark.parametrize('args', [
    ('GFN-FF', True, 'loose', -1, 4, None),
    ('GFN2-xTB', True, 'tight', 0, 2, 'methanol'),
    ('GFN2-xTB', False, None, 1, None, 'water'),
])
def test_xtb_flags_are_equal(args):
    assert xtb._xtb_flags(*args) == jxtb._xtb_flags(*args)


def test_orca_gaussian_mopac_writers_are_byte_equal(tmp_path):
    coords, nos, *_ = pose(1)
    cases = [
        lambda m, p: m[2].write_orca_input(
            p, coords, nos, method='PM3', constrained_indices=[(0, 6)],
            charge=-1, procs=4, maxiter=10, solvent='water'),
        lambda m, p: m[2].write_orca_input(p, coords, nos, method='B97-3c',
                                           task='EnGrad'),
        lambda m, p: m[3].write_gaussian_input(
            p, coords, nos, method='PM6', constrained_indices=[(0, 6)],
            procs=2, solvent='water', charge=1),
        lambda m, p: m[4].write_mopac_input(
            p, coords, nos, method='PM7',
            constrained_indices=np.array([[0, 6]]), solvent='water',
            charge=0, title='t'),
    ]
    for write in cases:
        out = both(write, tmp_path)
        assert out['port'] == out['jax'] and out['jax']


# -------------------------------------------------------------- parsers

TRAJ = ('3\n energy: -5.070431 gnorm: 0.01 xtb: 6.5.1\n'
        'O 0.0 0.0 0.1\nH 0.7 0.0 -0.4\nH -0.7 0.0 -0.4\n'
        '3\n energy: -5.070544 gnorm: 0.002 xtb: 6.5.1\n'
        'O 0.0 0.0 0.12\nH 0.71 0.0 -0.41\nH -0.71 0.0 -0.41\n')
SCOORD = ('$coord\n 0.0 0.0 0.2 o\n 1.3 0.0 -0.8 h\n -1.3 0.0 -0.8 h\n'
          '$end\n')
MOPAC_OUT = '''
 SCF FIELD WAS ACHIEVED

          FINAL HEAT OF FORMATION =        -57.79972 KCAL/MOL =    -241.83403 KJ/MOL

          CARTESIAN COORDINATES

     1         O          0.00000000    0.00000000    0.11779500
     2         H          0.75545000    0.00000000   -0.47118000
     3         H         -0.75545000    0.00000000   -0.47118000

'''
GAUSSIAN_OUT = '''
                         Standard orientation:
 ---------------------------------------------------------------------
 Center     Atomic      Atomic             Coordinates (Angstroms)
 Number     Number       Type             X           Y           Z
 ---------------------------------------------------------------------
      1          8           0        0.000000    0.000000    0.117795
      2          1           0        0.755450    0.000000   -0.471180
      3          1           0       -0.755450    0.000000   -0.471180
 ---------------------------------------------------------------------
 SCF Done:  E(RPM6) = -0.0819499  A.U. after  9 cycles
'''
GRADIENT = '''$grad
  cycle =      1    SCF energy =    -5.07054444061   |dE/dxyz| =  0.000298
  cycle =      2    SCF energy =    -5.07054444297   |dE/dxyz| =  0.000172
      0.00000000000000      0.00000000000000      0.00000000000000      c
      2.05980000000000      0.00000000000000      0.00000000000000      h
 -1.7219232900000D-04  0.0000000000000D+00  0.0000000000000D+00
  1.7219232900000D-04  0.0000000000000D+00  0.0000000000000D+00
$end
'''
ENGRAD = '''#
# Number of atoms
#
 2
#
# The current total energy in Eh
#
     -5.070544442970
#
# The current gradient in Eh/bohr
#
      -0.000172192329
       0.000000000000
       0.000000000000
       0.000172192329
       0.000000000000
       0.000000000000
#
# The atomic numbers and current coordinates in Bohr
#
   6     0.0000000    0.0000000    0.0000000
   1     2.0598000    0.0000000    0.0000000
'''
GAUSSIAN_FORCE = ''' SCF Done:  E(RPM6) =  -5.07054444297     A.U. after    9 cycles
 -------------------------------------------------------------------
 Center     Atomic                   Forces (Hartrees/Bohr)
 Number     Number              X              Y              Z
 -------------------------------------------------------------------
      1        6           0.000172192    0.000000000    0.000000000
      2        1          -0.000172192    0.000000000    0.000000000
 -------------------------------------------------------------------
'''
MOPAC_GRAD = '''          FINAL HEAT OF FORMATION =        -12.34567 KCAL/MOL =     -51.654 KJ/MOL

          FINAL  POINT  AND  DERIVATIVES

   PARAMETER     ATOM    TYPE            VALUE       GRADIENT
      1          1  C    CARTESIAN X    -0.123456     1.234567  KCAL/ANGSTROM
      2          1  C    CARTESIAN Y     0.000000     0.000000  KCAL/ANGSTROM
      3          1  C    CARTESIAN Z     0.000000     0.000000  KCAL/ANGSTROM
      4          2  H    CARTESIAN X     1.089000    -1.234567  KCAL/ANGSTROM
      5          2  H    CARTESIAN Y     0.000000     0.000000  KCAL/ANGSTROM
      6          2  H    CARTESIAN Z     0.000000     0.000000  KCAL/ANGSTROM

'''


def assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_parsers_are_equal_on_canned_files(tmp_path):
    files = {'traj': TRAJ, 'scoord': SCOORD, 'mop': MOPAC_OUT,
             'gau': GAUSSIAN_OUT,
             'prop': 'stuff\n   SCF Energy:     -114.4380433\n',
             'out': 'x\n          | TOTAL ENERGY     -5.070544 Eh |\n'}
    for k, v in files.items():
        (tmp_path / k).write_text(v)
    p = {k: str(tmp_path / k) for k in files}
    pairs = [
        (lambda m: m.read_from_xtbtraj(p['traj']), xtb, jxtb),
        (lambda m: m.parse_xtb_scoord(p['scoord']), xtb, jxtb),
        (lambda m: m.energy_grepper(p['out'], 'TOTAL ENERGY', 3), common,
         jcommon),
        (lambda m: m.read_orca_property(p['prop']), orca, jorca),
        (lambda m: m.read_gaussian_out(p['gau']), gaussian, jgaussian),
        (lambda m: m.read_mop_out(p['mop']), mopac, jmopac),
        (lambda m: m.parse_turbomole_gradient(GRADIENT, 2), gradients,
         jgradients),
        (lambda m: m.parse_orca_engrad(ENGRAD), gradients, jgradients),
        (lambda m: m.parse_gaussian_forces(GAUSSIAN_FORCE, 2), gradients,
         jgradients),
        (lambda m: m.parse_mopac_gradients(MOPAC_GRAD), gradients,
         jgradients),
    ]
    for parse, port, ref in pairs:
        assert_same(parse(port), parse(ref))
    assert common.EH_TO_KCAL == jcommon.EH_TO_KCAL
    assert gradients.GRAD_TO_KCAL_A == jgradients.GRAD_TO_KCAL_A
    assert xtb._CREST_METHOD_FLAGS == jxtb._CREST_METHOD_FLAGS


def test_dynamic_energy_thr_equals_the_jax_package():
    rng = np.random.default_rng(3)
    for n in (0, 1, 5, 40, 300):
        rel = np.abs(rng.normal(size=n)) * rng.choice([2.0, 20.0, 200.0])
        for kcal in (0.5, 3.0, 10.0):
            for keep in (0.1, 0.5):
                assert dispatch.dynamic_energy_thr(rel, kcal, keep) == \
                    jdispatch.dynamic_energy_thr(rel, kcal, keep)


# ------------------------------------------------------------- stand-in

def run_standin(tmp_path, coords, nos, flags, inp=None):
    from tscode_tpu_torch.io_xyz import write_xyz
    with open(tmp_path / 'm.xyz', 'w') as f:
        write_xyz(coords, nos, f, title='m')
    if inp is not None:
        (tmp_path / 'm.inp').write_text(inp)
        flags = ['--input', 'm.inp'] + flags
    out = io.StringIO()
    assert standin_xtb.main(['m.xyz'] + flags, str(tmp_path), out=out) == 0
    (tmp_path / 'm.out').write_text(out.getvalue())
    return str(tmp_path / 'm.out')


def test_standin_round_trip_through_both_parsers(tmp_path):
    coords, nos, *_ = pose(2)
    inp = ('$opt\n   logfile=m_log.xyz\n   output=xtbopt.xyz\n   '
           'maxcycle=0\n\n$constrain\n   force constant=1\n   '
           'distance: 1, 7, 2.9\n\n$end')
    out = run_standin(tmp_path, coords, nos, ['--opt', 'tight'], inp)
    opt = [m.read_from_xtbtraj(str(tmp_path / 'm_log.xyz'))
           for m in (xtb, jxtb)]
    assert_same(opt[0], opt[1])
    first = [m.energy_grepper(out, 'TOTAL ENERGY', 3) for m in (common,
                                                                 jcommon)]
    assert first[0] == first[1]
    # the final frame's energy is the one printed, and below the start's
    assert opt[0][1] == pytest.approx(first[0] * common.EH_TO_KCAL,
                                      rel=0, abs=1e-9)
    start = standin_xtb.Model(
        *standin_xtb.read_xyz(str(tmp_path / 'm.xyz')),
        {'method': 'gfn2', 'charge': 0},
        standin_xtb.parse_input(str(tmp_path / 'm.inp'), {}))
    e0, _ = start.energy_gradient(coords.tolist())
    assert opt[0][1] < e0 * common.EH_TO_KCAL

    run_standin(tmp_path, coords, nos, ['--grad'])
    text = (tmp_path / 'gradient').read_text()
    grads = [m.parse_turbomole_gradient(text, len(nos))
             for m in (gradients, jgradients)]
    assert_same(grads[0], grads[1])
    # the written gradient is the model's derivative (central
    # differences on the stand-in's own energy, Eh/Bohr)
    model = standin_xtb.Model(nos_symbols(nos), coords.tolist(),
                              {'method': 'gfn2', 'charge': 0}, None)
    h = 1e-5
    for i, k in ((0, 0), (6, 2), (10, 1)):
        x = coords.copy()
        x[i, k] += h
        ep = model.energy_gradient(x.tolist())[0]
        x[i, k] -= 2 * h
        em = model.energy_gradient(x.tolist())[0]
        assert grads[0][1][i, k] == pytest.approx(
            (ep - em) / (2 * h) * standin_xtb.BOHR, abs=1e-7)

    out = run_standin(tmp_path, coords, nos, ['--ohess', '--chrg', '-1'])
    g = [m.energy_grepper(out, 'TOTAL FREE ENERGY', 4)
         for m in (common, jcommon)]
    assert g[0] == g[1] is not None


def nos_symbols(nos):
    from tscode_tpu_torch.pt import SYMBOLS
    return [SYMBOLS[int(z)] for z in nos]


def test_standin_refuses_what_it_does_not_serve(tmp_path):
    coords, nos, *_ = pose(0)
    from tscode_tpu_torch.io_xyz import write_xyz
    with open(tmp_path / 'm.xyz', 'w') as f:
        write_xyz(coords, nos, f)
    for argv in (['m.xyz', '--md'], ['m.xyz', '--gfn', '0'], ['--opt']):
        err = io.StringIO()
        assert standin_xtb.main(argv, str(tmp_path), out=io.StringIO(),
                                err=err) == 1
        assert 'stand-in xtb' in err.getvalue()


def in_process(monkeypatch):
    '''Both packages' xtb adapters on one in-process stand-in.'''
    fake = InProcessSubprocess()
    for m in (xtb, jxtb, gradients, jgradients):
        monkeypatch.setattr(m, 'subprocess', fake)
    return fake


def test_xtb_adapters_equal_the_jax_package(monkeypatch):
    '''xtb_opt (the step-wise approach of a pair 3.2 A apart to 2.2 A),
    xtb_pre_opt (every bond held), xtb_gradient and xtb_get_free_energy
    through the same stand-in in both packages.'''
    fake = in_process(monkeypatch)
    coords, nos, n1, n2, c1, c2 = pose(4)
    graphs = [graphize(c1, n1), graphize(c2, n2)]
    calls = {}
    results = {}
    for name, (mxtb, mgrad, *_) in PACKAGES.items():
        before = fake.calls
        results[name] = (
            mxtb.xtb_opt(coords, nos, constrained_indices=np.array([[0, 6]]),
                         constrained_distances=[2.2], method='GFN-FF',
                         conv_thr='loose', title='step'),
            mxtb.xtb_pre_opt(coords, nos, graphs=graphs,
                             constrained_indices=np.array([[0, 6]]),
                             constrained_distances=[2.9], method='GFN-FF',
                             conv_thr='loose', spring_constant=0.2),
            mxtb.xtb_opt(coords, nos, opt=False, title='sp'),
            mgrad.xtb_gradient(coords, nos, method='GFN2-xTB'),
            mxtb.xtb_get_free_energy(coords, nos, charge=-1, sph=True))
        calls[name] = fake.calls - before
    got, want = results['port'], results['jax']
    assert calls['port'] == calls['jax'] > 5       # the walk took steps
    for a, b in zip(got, want):
        assert_same(a, b)
    stepped = want[0][0]
    assert np.linalg.norm(stepped[6] - stepped[0]) == pytest.approx(2.2,
                                                                    abs=0.1)


def canned_engines(monkeypatch):
    '''ORCA, Gaussian and MOPAC answered from canned files in both
    packages: the 3-atom outputs of the parser tests.'''
    class Canned:
        CalledProcessError = subprocess.CalledProcessError
        STDOUT = subprocess.STDOUT
        DEVNULL = subprocess.DEVNULL

        @staticmethod
        def check_call(cmd, stdout=None, stderr=None, cwd=None):
            stem = os.path.splitext(cmd[1])[0]
            files = {'orca': {f'{stem}.xyz': '3\nopt\nO 0.0 0.0 0.12\n'
                              'H 0.76 0.0 -0.47\nH -0.76 0.0 -0.47\n',
                              f'{stem}_property.txt':
                              '   SCF Energy:     -76.3800433\n'},
                     'g16': {f'{stem}.log': GAUSSIAN_OUT},
                     'MOPAC2016.exe': {f'{stem}.out': MOPAC_OUT}}[cmd[0]]
            for name, text in files.items():
                with open(os.path.join(cwd, name), 'w') as f:
                    f.write(text)
            return 0

    for mods in PACKAGES.values():
        for m in mods[2:5]:
            monkeypatch.setattr(m, 'subprocess', Canned)


@pytest.mark.parametrize('calc', ['ORCA', 'GAUSSIAN', 'MOPAC'])
def test_optimize_on_canned_engines_equals_the_jax_package(monkeypatch,
                                                           calc):
    canned_engines(monkeypatch)
    coords = np.array([[0.0, 0.0, 0.1], [0.75, 0.0, -0.46],
                       [-0.75, 0.0, -0.46]])
    nos = np.array([8, 1, 1])
    got = dispatch.optimize(coords, nos, calc, title='w')
    want = jdispatch.optimize(coords, nos, calc, title='w')
    assert_same(got, want)
    assert got[2]


def test_probe_openbabel_raises_the_jax_packages_error():
    from tscode_tpu.errors import InputError as JaxInputError
    from tscode_tpu_torch.errors import InputError
    for method in ('UFF', 'NOPE'):
        with pytest.raises(JaxInputError) as want:
            jopenbabel.probe_openbabel(method)
        with pytest.raises(InputError) as got:
            openbabel.probe_openbabel(method)
        assert str(got.value) == str(want.value)


def test_metadynamics_on_the_standin_fails_in_both(monkeypatch):
    '''The stand-in serves no --md: xtb_metadyn_augmentation raises
    CalledProcessError in both packages (MTD is tested with mocks).'''
    in_process(monkeypatch)
    coords, nos, *_ = pose(0)
    for m in (xtb, jxtb):
        with pytest.raises(subprocess.CalledProcessError):
            m.xtb_metadyn_augmentation(coords, nos, new_structures=3)


@pytest.mark.parametrize('calc', ['ORCA', 'GAUSSIAN', 'MOPAC'])
def test_gradient_adapters_on_canned_engines(monkeypatch, calc):
    '''orca_gradient, gaussian_gradient and mopac_gradient of both
    packages, each engine answered by the parser tests' 2-atom canned
    output (and make_chain_gradient_fn dispatching to them), in kcal/mol
    and kcal/mol/A.'''
    class Canned:
        CalledProcessError = subprocess.CalledProcessError
        STDOUT = subprocess.STDOUT
        DEVNULL = subprocess.DEVNULL

        @staticmethod
        def check_call(cmd, stdout=None, stderr=None, cwd=None):
            stem = os.path.splitext(cmd[1])[0]
            name, text = {'orca': (f'{stem}.engrad', ENGRAD),
                          'g16': (f'{stem}.log', GAUSSIAN_FORCE),
                          'MOPAC2016.exe': (f'{stem}.out', MOPAC_GRAD)}[cmd[0]]
            with open(os.path.join(cwd, name), 'w') as f:
                f.write(text)
            return 0

    for m in (gradients, jgradients):
        monkeypatch.setattr(m, 'subprocess', Canned)
    coords = np.array([[0.0, 0.0, 0.0], [1.09, 0.0, 0.0]])
    nos = np.array([6, 1])
    fname = gradients.GRADIENT_FUNCS[calc]
    got = getattr(gradients, fname)(coords, nos, solvent='water')
    want = getattr(jgradients, fname)(coords, nos, solvent='water')
    assert_same(got, want)
    chain = np.stack([coords, coords + 0.1])
    assert_same(gradients.make_chain_gradient_fn(nos, calculator=calc)(chain),
                jgradients.make_chain_gradient_fn(nos, calculator=calc)(
                    chain))
