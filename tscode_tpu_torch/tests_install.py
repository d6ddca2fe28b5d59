'''
Installation smoke tests: `python -m tscode_tpu_torch -t [--device
cpu]` (counterpart of tscode_tpu/tests_install.py; reference TSCoDe's
tests.py:21-149, but hermetic: pure-geometry runs that need no external
binaries, each through the CLI in a subprocess on the given device).
'''

import os
import shutil
import subprocess
import sys
import tempfile
import time

from tscode_tpu_torch.settings import CALCULATOR, XTB_AVAILABLE


def run_tests(device='cuda'):
    '''Report the calculator and the torch device, then run four
    embed inputs through the CLI on `device`; raises SystemExit when
    one fails.'''
    t0 = time.perf_counter()
    print('--> tscode_tpu_torch installation test')
    print(f'    calculator: {CALCULATOR or "none found (geometry-only mode)"}')
    print(f'    xtb available: {XTB_AVAILABLE}\n')

    import torch

    from tscode_tpu_torch.backend import get_device
    dev = get_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'
    print(f'    torch {torch.__version__}, device {dev} ({name}), cuda '
          f'available: {torch.cuda.is_available()}\n', flush=True)

    scratch = tempfile.mkdtemp(prefix='tscode_tpu_torch_test_')
    fixtures = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tests', 'fixtures')

    for fname in ('C2H4.xyz', 'CH3Cl.xyz', 'HCOOH.xyz', 'HCOOOH.xyz'):
        src = os.path.join(fixtures, fname)
        if os.path.isfile(src):
            shutil.copy(src, scratch)

    inputs = {
        'string_noopt.txt': 'NOOPT\nC2H4.xyz 0\nCH3Cl.xyz 0\n',
        'cyclical_rigid.txt': 'NOOPT RIGID STEPS=2\nC2H4.xyz 0 3\nC2H4.xyz 0 3\n',
        'chelotropic.txt': 'NOOPT RIGID STEPS=2 DIST(A=2.5,B=2.5)\n'
                           'C2H4.xyz 0A 3B\nHCOOOH.xyz 4AB\n',
        'trimolecular.txt': 'BYPASS DIST(A=2.5,x=2,y=2.5,C=1) SHRINK '
                            'ROTRANGE=10 STEPS=1\nCH3Cl.xyz 0A 4y\n'
                            'HCOOH.xyz 1A 4x 0C 2C\nHCOOH.xyz 1x 4y\n',
    }

    for fname, content in inputs.items():
        path = os.path.join(scratch, fname)
        with open(path, 'w') as f:
            f.write(content)
        t = time.perf_counter()
        result = subprocess.run(
            [sys.executable, '-m', 'tscode_tpu_torch', path, '-n',
             fname.split('.')[0], '--device', str(device)],
            capture_output=True, text=True, cwd=scratch)
        seconds = time.perf_counter() - t
        status = 'ok' if result.returncode == 0 else 'FAILED'
        print(f'    {fname:<24} {status}  ({seconds:.1f}s)')
        if result.returncode != 0:
            print(result.stdout[-2000:])
            print(result.stderr[-2000:])
            raise SystemExit(f'Smoke test {fname} failed.')

    print(f'\n--> All tests passed in '
          f'{time.perf_counter() - t0:.1f}s. Scratch: {scratch}')
