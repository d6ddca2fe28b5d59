'''The port imports torch and never jax, nor any module of the JAX
package tscode_tpu (it carries its own host modules), nor scikit-learn
(it clusters with its own cluster.py); on CPU tensors its kernel
wrappers run the plain twins; CUDA is never chosen silently.'''

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu_torch import backend
from tscode_tpu_torch.ops.kernels import clash, qcp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in the subprocesses after the port's work: neither jax nor any
# module of the JAX package (tscode_tpu_torch shares its name's prefix),
# nor scikit-learn
NO_JAX_PACKAGE = (
    'assert "jax" not in sys.modules, "jax imported"\n'
    'assert "sklearn" not in sys.modules, "sklearn imported"\n'
    'loaded = [m for m in sys.modules\n'
    '          if m == "tscode_tpu" or m.startswith("tscode_tpu.")]\n'
    'assert not loaded, loaded\n')


def test_port_imports_no_jax():
    '''Every module of the package, and building the headline workload
    through the port's host modules, leave jax and the JAX package out
    of sys.modules.'''
    code = (
        'import importlib, pkgutil, sys\n'
        'import tscode_tpu_torch\n'
        'names = [m.name for m in pkgutil.walk_packages(\n'
        '    tscode_tpu_torch.__path__, "tscode_tpu_torch.")]\n'
        'for name in names:\n'
        '    importlib.import_module(name)\n'
        + NO_JAX_PACKAGE +
        'from tscode_tpu_torch.pipeline import build_workload\n'
        'mols = build_workload(n_confs=2)\n'
        + NO_JAX_PACKAGE +
        'print("MODULES", len(names))\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'MODULES' in r.stdout
    assert int(r.stdout.split('MODULES')[1]) >= 10


def test_cpu_tensors_take_the_plain_twins():
    '''No kernel is built or launched for CPU tensors, and the wrappers
    return exactly what their plain twins return.'''
    rng = np.random.default_rng(0)
    poses = torch.as_tensor(rng.normal(size=(50, 9, 3)) * 2.0)
    pairs = clash.static_pairs(np.triu(np.ones((9, 9), dtype=bool), 1))
    before = (clash.KERNEL.launches, qcp.KERNEL.launches)

    got = clash.clash_ok(poses, pairs, 1.5, max_clashes=1)
    assert torch.equal(got, clash.clash_ok_plain(poses, pairs, 1.5, 1))

    hs = torch.as_tensor(rng.normal(size=(40, 5, 3)))
    hs[7] = hs[3] + 1e-3
    act = torch.arange(40)
    end = torch.full((40,), 40)
    kill = qcp.qcp_kill(hs, act, end, 0.5)
    assert torch.equal(kill, qcp.qcp_kill_plain(hs, act, end, 0.5))
    assert bool(kill[3]) and int(kill.sum()) == 1

    assert (clash.KERNEL.launches, qcp.KERNEL.launches) == before
    assert clash.KERNEL._lib is None and qcp.KERNEL._lib is None


def test_backend_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        backend.get_device('cuda')
    with pytest.raises(RuntimeError):
        backend.default_dtype('cuda:0')
    with pytest.raises(ValueError):
        backend.get_device('meta')
    assert backend.get_device('cpu') == torch.device('cpu')
    assert backend.default_dtype('cpu') == torch.float64


def test_kernel_sources_and_build_location():
    '''The CUDA sources ship in the package; libraries build into the
    git-ignored build/ tree beside it.'''
    for k in (clash.KERNEL, qcp.KERNEL, qcp.THREAD_KERNEL):
        assert os.path.isfile(k.source)
        assert k.library.startswith(os.path.join(REPO, 'build',
                                                 'tscode_tpu_torch'))
    with open(os.path.join(REPO, '.gitignore')) as f:
        assert 'build/' in f.read().split()


def sn2_input(d):
    import bench_suite
    n = bench_suite.N_CONFS
    bench_suite.N_CONFS = 4
    try:
        bench_suite._config_files('sn2_string', str(d))
    finally:
        bench_suite.N_CONFS = n


def test_cli_string_route_imports_no_jax(tmp_path):
    '''The whole string route through the CLI, --device cpu, in a fresh
    interpreter: it writes the ensemble and never imports jax or a
    module of the JAX package.'''
    sn2_input(tmp_path)
    code = (
        'import sys\n'
        'from tscode_tpu_torch.__main__ import main\n'
        'rc = main(["input.txt", "--device", "cpu", "-n", "nojax"])\n'
        'assert rc == 0, rc\n'
        + NO_JAX_PACKAGE +
        'print("NOJAX_OK")\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'NOJAX_OK' in r.stdout
    assert (tmp_path / 'tscode_unoptimized_nojax.xyz').exists()


def test_cli_search_operators_import_no_jax_or_sklearn(tmp_path):
    '''csearch>, csearch_hb> and rsearch> through the CLI with --device
    cpu in one fresh interpreter (the string route behind a search of
    the C6 chain; the clustered search selects its conformers by
    k-means at CONFS=40): each ends normally and neither jax, a module
    of the JAX package nor scikit-learn is imported.'''
    from tscode_tpu_torch.suite_inputs import chloroalkane, write_noisy
    from tscode_tpu_torch.io_xyz import write_xyz
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    for op in ('csearch', 'csearch_hb', 'rsearch'):
        d = tmp_path / op
        d.mkdir()
        write_noisy(os.path.join(FIXTURE_DIR, 'C2H4.xyz'), str(d / 'm1.xyz'),
                    2, np.random.default_rng(7))
        coords, nos = chloroalkane(6)
        with open(d / 'm2.xyz', 'w') as f:
            write_xyz(coords, nos, f, title='chain')
        (d / 'input.txt').write_text(f'NOOPT DIST(a=3.2) CONFS=40\n'
                                     f'm1.xyz 0a\n{op}> m2.xyz 0a\n')
    code = (
        'import os, sys\n'
        'from tscode_tpu_torch.__main__ import main\n'
        'for op in ("csearch", "csearch_hb", "rsearch"):\n'
        '    os.chdir(os.path.join(sys.argv[1], op))\n'
        '    assert main(["input.txt", "--device", "cpu", "-n", "s"]) == 0\n'
        + NO_JAX_PACKAGE +
        'assert "tscode_tpu_torch.cluster" in sys.modules\n'
        'print("NOJAX_OK")\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'NOJAX_OK' in r.stdout
    assert r.stdout.count('normal termination') == 3
    assert r.stdout.count('Selected the most diverse 40 conformers') == 2


def test_cli_cyclical_and_refine_routes_import_no_jax(tmp_path):
    '''The rigid cyclical route (da_cyclical at 4 conformers) and then
    REFINE on its output, through the CLI with --device cpu in one fresh
    interpreter: both write their ensembles (44 and 1 frames) and
    neither imports jax or a module of the JAX package.'''
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.suite_inputs import config_files
    for name in ('cyc', 'refine'):
        (tmp_path / name).mkdir()
    config_files('da_cyclical', str(tmp_path / 'cyc'), 4)
    code = (
        'import os, sys\n'
        'from tscode_tpu_torch.__main__ import main\n'
        'from tscode_tpu_torch.suite_inputs import refine_input\n'
        'root = sys.argv[1]\n'
        'os.chdir(os.path.join(root, "cyc"))\n'
        'assert main(["input.txt", "--device", "cpu", "-n", "nojax"]) == 0\n'
        'refine_input(os.path.join(root, "cyc", "tscode_unoptimized_nojax.xyz"),\n'
        '             os.path.join(root, "refine"))\n'
        'os.chdir(os.path.join(root, "refine"))\n'
        'assert main(["input.txt", "--device", "cpu", "-n", "nojax"]) == 0\n'
        + NO_JAX_PACKAGE +
        'print("NOJAX_OK")\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'NOJAX_OK' in r.stdout
    for name, n in (('cyc', 44), ('refine', 1)):
        out = tmp_path / name / 'tscode_unoptimized_nojax.xyz'
        assert read_xyz(str(out)).atomcoords.shape == (n, 11, 3)


def test_cli_multiembed_chelotropic_and_trimol_import_no_jax(tmp_path):
    '''The multiembed (4 conformers, 12 arrangements -> 110 frames), the
    rigid chelotropic (4 conformers -> 70) and the rigid three-molecule
    route (3 conformers of HCOOH -> 54) through the CLI with --device cpu
    in one fresh interpreter: each ends normally and writes its
    ensemble, none imports jax or a module of the JAX package, and the
    same inputs without --device ask for the card and raise here.'''
    from tscode_tpu_torch.io_xyz import read_xyz
    from tscode_tpu_torch.suite_inputs import config_files
    routes = (('multiembed', 4, (110, 11, 3)), ('chelotropic', 4, (70, 12, 3)),
              ('trimolecular_rigid', 12, (54, 15, 3)))
    for name, n, _ in routes:
        (tmp_path / name).mkdir()
        config_files(name, str(tmp_path / name), n)
    code = (
        'import os, sys\n'
        'from tscode_tpu_torch.__main__ import main\n'
        'root = sys.argv[1]\n'
        'for name in sys.argv[2:]:\n'
        '    os.chdir(os.path.join(root, name))\n'
        '    assert main(["input.txt", "--device", "cpu", "-n", "nojax"]) == 0\n'
        '    try:\n'
        '        main(["input.txt", "-n", "nocard"])\n'
        '    except RuntimeError as e:\n'
        '        assert "cuda" in str(e), e\n'
        '    else:\n'
        '        raise AssertionError("ran without a card")\n'
        '    os.chdir(root)\n'
        + NO_JAX_PACKAGE +
        'assert "tscode_tpu_torch.multiembed" in sys.modules\n'
        'print("NOJAX_OK")\n')
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    r = subprocess.run([sys.executable, '-c', code, str(tmp_path)]
                       + [name for name, _, _ in routes],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'NOJAX_OK' in r.stdout
    assert r.stdout.count('normal termination') == 3
    for name, _, shape in routes:
        out = tmp_path / name / 'tscode_unoptimized_nojax.xyz'
        assert read_xyz(str(out)).atomcoords.shape == shape
        assert not list((tmp_path / name).glob('tscode_*_nocard.xyz'))
        assert not list((tmp_path / name).glob('tscode_embed*/'))


def test_cli_cuda_without_a_card_fails_with_no_ensemble(tmp_path):
    sn2_input(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    r = subprocess.run([sys.executable, '-m', 'tscode_tpu_torch',
                        'input.txt', '--device', 'cuda', '-n', 'nocard'],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert 'torch.cuda.is_available() is False' in r.stderr
    assert not list(tmp_path.glob('tscode_*.xyz'))


@pytest.mark.parametrize('name', ['sn2_string', 'large_n_string',
                                  'da_cyclical', 'da_cyclical_xl',
                                  'multiembed', 'torsion_drive'])
def test_port_input_writer_matches_bench_suite(tmp_path, monkeypatch, name):
    '''The port's writer gives bench_suite._config_files' files byte for
    byte (the same rng calls, the port's io_xyz); da_cyclical_xl takes
    its conformer count from TSCODE_SUITE_XL_CONFS in bench_suite.'''
    import bench_suite
    from tscode_tpu_torch.suite_inputs import config_files
    (tmp_path / 'suite').mkdir()
    (tmp_path / 'port').mkdir()
    monkeypatch.setattr(bench_suite, 'N_CONFS', 3)
    monkeypatch.setenv('TSCODE_SUITE_XL_CONFS', '3')
    bench_suite._config_files(name, str(tmp_path / 'suite'))
    path = config_files(name, str(tmp_path / 'port'), 3)
    assert path == str(tmp_path / 'port' / 'input.txt')
    files = ('input.txt', 'm1.xyz') + \
        (() if name == 'torsion_drive' else ('m2.xyz',))
    for f in files:
        assert (tmp_path / 'port' / f).read_bytes() == \
            (tmp_path / 'suite' / f).read_bytes(), f
    with pytest.raises(ValueError):
        config_files('no_such_input', str(tmp_path / 'port'), 3)


def test_trimolecular_rigid_input_is_the_suites_plus_rigid(tmp_path,
                                                           monkeypatch):
    '''The port's trimolecular_rigid input: bench_suite's trimolecular
    molecule files byte for byte, and its input with RIGID added to the
    keyword line and nothing else changed.'''
    import bench_suite
    from tscode_tpu_torch.suite_inputs import config_files
    (tmp_path / 'suite').mkdir()
    (tmp_path / 'port').mkdir()
    monkeypatch.setattr(bench_suite, 'N_CONFS', 12)
    bench_suite._config_files('trimolecular', str(tmp_path / 'suite'))
    config_files('trimolecular_rigid', str(tmp_path / 'port'), 12)
    for f in ('m1.xyz', 'm2.xyz'):
        assert (tmp_path / 'port' / f).read_bytes() == \
            (tmp_path / 'suite' / f).read_bytes(), f
    suite = (tmp_path / 'suite' / 'input.txt').read_text()
    port = (tmp_path / 'port' / 'input.txt').read_text()
    assert 'RIGID' not in suite
    assert port == suite.replace('BYPASS ', 'BYPASS RIGID ', 1)


def test_native_builds_under_build_and_matches_numpy(monkeypatch):
    '''The port's native C++ helpers build into build/, never into a
    package directory, and the TFD novelty loop equals the numpy loop.'''
    from tscode_tpu_torch import native
    from tscode_tpu_torch.ops import tfd
    build = os.path.join(REPO, 'build', 'tscode_tpu_torch', 'native')
    assert native.BUILD_DIR == build
    assert native.available() and native.tfd_available()
    for lib in (native._LIB, native._TFD_LIB):
        assert os.path.dirname(lib) == build and os.path.isfile(lib)

    rng = np.random.default_rng(5)
    base = rng.uniform(-180, 180, size=(12, 6))
    fps = (base[rng.integers(0, 12, size=400)]
           + rng.normal(size=(400, 6)) * rng.choice([0.1, 5.0], size=(400, 1))
           ).astype(np.float32)
    fps = (fps + 180.0) % 360.0 - 180.0
    accept = rng.random(400) < 0.9
    got = tfd.is_new_structure_lru(fps, accept, 10.0)
    monkeypatch.setattr(native, 'tfd_available', lambda: False)
    want = tfd.is_new_structure_lru(fps, accept, 10.0)
    np.testing.assert_array_equal(got, want)
    assert 12 <= int(want.sum()) < int(accept.sum())


def test_cli_force_field_operators_import_no_jax(tmp_path):
    '''The data operators on the internal force field through the CLI
    with --device cpu in a fresh interpreter, one input line each
    (neb> on two HCOOH conformers, saddle> on HCOOH, scan> of the F-C-C-F
    torsion of C2F2H4 and of the O...H distance of HCOOH): every output
    is written, and neither jax, a module of the JAX package nor
    scikit-learn is imported.'''
    import shutil
    from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    for name in ('HCOOH.xyz', 'C2F2H4.xyz'):
        shutil.copy(os.path.join(FIXTURE_DIR, name), tmp_path)
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    rng = np.random.default_rng(1)
    with open(tmp_path / 'pair.xyz', 'w') as f:
        for _ in range(2):
            write_xyz(mol.atomcoords[0] + rng.normal(size=(5, 3)) * 0.1,
                      mol.atomnos, f, title='conf')
    (tmp_path / 'input.txt').write_text(
        'NOOPT\nneb> pair.xyz\nsaddle> HCOOH.xyz\nscan> C2F2H4.xyz 3 0 1 5\n'
        'scan> HCOOH.xyz 1 4\n')
    code = (
        'import sys\n'
        'from tscode_tpu_torch.__main__ import main\n'
        'assert main(["input.txt", "--device", "cpu", "-n", "ff"]) == 0\n'
        + NO_JAX_PACKAGE +
        'for m in ("neb", "saddle", "scans"):\n'
        '    assert "tscode_tpu_torch." + m in sys.modules, m\n'
        'print("NOJAX_OK")\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'NOJAX_OK' in r.stdout
    for name in ('pair_MEP.xyz', 'pair_NEB_TS.xyz', 'HCOOH_saddle.xyz',
                 'C2F2H4_torsion_scan_clockwise.xyz', 'HCOOH_scan.xyz'):
        assert (tmp_path / name).exists(), name


PORTED_15B = ('calculators.common', 'calculators.dispatch', 'calculators.xtb',
              'calculators.orca', 'calculators.gaussian', 'calculators.mopac',
              'calculators.openbabel', 'calculators.gradients',
              'optimization', 'automep', 'pka', 'nci', 'tests_install',
              'concurrent_test', 'opt_records')


def test_cli_optimisation_route_imports_no_jax(tmp_path):
    '''The optimisation route (sn2_string without NOOPT, the calculators
    chosen by keyword) and pka> through the CLI with --device cpu in one
    fresh interpreter whose PATH starts with the stand-in xtb of
    tests/torch_standin (a test double): both end normally, the route
    writes its optimised poses, and neither jax, a module of the JAX
    package nor scikit-learn is imported; every calculator module of
    the port imports alone.'''
    import shutil
    from tscode_tpu_torch.opt_records import STANDIN_DIR
    from tscode_tpu_torch.pipeline import FIXTURE_DIR
    from tscode_tpu_torch.suite_inputs import config_files
    (tmp_path / 'route').mkdir()
    (tmp_path / 'pka').mkdir()
    config_files('sn2_string_opt', str(tmp_path / 'route'), 4)
    shutil.copy(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'), tmp_path / 'pka')
    (tmp_path / 'pka' / 'input.txt').write_text('pka> HCOOH.xyz 4\n')
    code = (
        'import importlib, os, sys\n'
        'from tscode_tpu_torch.__main__ import main\n'
        'root = sys.argv[1]\n'
        'for name in ("route", "pka"):\n'
        '    os.chdir(os.path.join(root, name))\n'
        '    assert main(["input.txt", "--device", "cpu", "-n", "s"]) == 0\n'
        'for name in sys.argv[2:]:\n'
        '    importlib.import_module("tscode_tpu_torch." + name)\n'
        + NO_JAX_PACKAGE +
        'print("NOJAX_OK")\n')
    env = dict(os.environ, PYTHONPATH=REPO,
               PATH=STANDIN_DIR + os.pathsep + os.environ.get('PATH', ''))
    r = subprocess.run([sys.executable, '-c', code, str(tmp_path)]
                       + list(PORTED_15B), cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'NOJAX_OK' in r.stdout
    assert r.stdout.count('normal termination') == 2
    assert 'GFN2-xTB optimization took' in r.stdout
    assert 'pKa energetics' in r.stdout
    assert (tmp_path / 'route' / 'tscode_poses_s.xyz').exists()
