'''The port's CLI flag -t (the installation smoke tests:
tscode_tpu_torch/tests_install.py) in a subprocess on the CPU, as the
JAX package's tests/test_cli.py runs its own: four embed inputs through
the CLI on --device (-b: tests/test_torch_opt_operators.py).'''

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli(args, cwd, path=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    if path is not None:
        env['PATH'] = path + os.pathsep + env.get('PATH', '')
    return subprocess.run([sys.executable, '-m', 'tscode_tpu_torch'] + args,
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=timeout)


def test_installation_smoke_runs(tmp_path):
    r = cli(['-t', '--device', 'cpu'], str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert 'All tests passed' in r.stdout
    assert r.stdout.count(' ok ') == 4
    assert 'device cpu' in r.stdout
