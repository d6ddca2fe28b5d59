'''
Shared calculator plumbing: thread-safe scratch directories and output
parsing helpers.

The reference's adapters os.chdir into per-job directories
(TSCoDe's calculators/_xtb.py:101-105), which is unsafe
for in-process concurrency; here every job runs in its own scratch dir
passed to subprocess via cwd=, so the dispatch queue can be threaded
(subprocess jobs release the GIL).
'''

import shutil
import tempfile
from contextlib import contextmanager


@contextmanager
def scratch_dir(title='job', keep=False):
    '''Temporary per-job working directory.'''
    path = tempfile.mkdtemp(prefix=f'tscode_{title}_')
    try:
        yield path
    finally:
        if not keep:
            shutil.rmtree(path, ignore_errors=True)


def energy_grepper(filename, signal_string, position):
    '''Last float at `position` on lines containing signal_string
    (reference _xtb.py:427-438).'''
    energy = None
    with open(filename) as f:
        for line in f:
            if signal_string in line:
                energy = float(line.split()[position])
    return energy


EH_TO_KCAL = 627.5096080305927
EV_TO_KCAL = 23.060548867
