'''The port imports torch and never jax; on CPU tensors its kernel
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


def test_port_imports_no_jax():
    '''Every module of the package, and building the headline workload
    through the jax-free host modules, leave jax out of sys.modules.'''
    code = (
        'import importlib, pkgutil, sys\n'
        'import tscode_tpu_torch\n'
        'names = [m.name for m in pkgutil.walk_packages(\n'
        '    tscode_tpu_torch.__path__, "tscode_tpu_torch.")]\n'
        'for name in names:\n'
        '    importlib.import_module(name)\n'
        'from tscode_tpu_torch.pipeline import build_workload\n'
        'mols = build_workload(n_confs=2)\n'
        'assert "jax" not in sys.modules, "jax imported"\n'
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
    for k in (clash.KERNEL, qcp.KERNEL):
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
    interpreter: it writes the ensemble and never imports jax.'''
    sn2_input(tmp_path)
    code = (
        'import sys\n'
        'from tscode_tpu_torch.__main__ import main\n'
        'rc = main(["input.txt", "--device", "cpu", "-n", "nojax"])\n'
        'assert rc == 0, rc\n'
        'assert "jax" not in sys.modules, "jax imported"\n'
        'print("NOJAX_OK")\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'NOJAX_OK' in r.stdout
    assert (tmp_path / 'tscode_unoptimized_nojax.xyz').exists()


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
