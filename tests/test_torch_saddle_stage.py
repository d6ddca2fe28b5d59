'''The SADDLE stage of an embed run (RunEmbedding.saddle_refining) of
the port against the JAX package's, float64 on the CPU, on the first
candidate of sn2_string at 4 conformers, in both branches: the
host-loop dimer on the calculator's gradients (XTB, answered in process
by the stand-in xtb of tests/torch_standin, a test double) and the
dimer on the internal force field (no calculator; float64 on the run's
device in the port). Coordinates within 1e-6 A, energies within 1e-6
kcal/mol, flags exactly.'''

import contextlib
import copy
import io
import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_qm_gradients import close, standin  # noqa: F401
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.suite_inputs import config_files


@pytest.fixture(scope='module')
def candidates(tmp_path_factory):
    '''Both packages' runs of sn2_string at 4 conformers (NOOPT), kept
    for the saddle stage.'''
    runs = {}
    cwd = os.getcwd()
    for key in ('jax', 'port'):
        d = tmp_path_factory.mktemp(f'saddle_{key}')
        inp = config_files('sn2_string', str(d), 4)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                runs[key] = (JaxEmbedder(inp, stamp='j').run() if key == 'jax'
                             else Embedder(inp, stamp='t',
                                           device='cpu').run())
        finally:
            os.chdir(cwd)
        runs[key].workdir = str(d)
    return runs


@pytest.mark.parametrize('calculator', ['XTB', None])
def test_saddle_refining_both_branches(candidates, standin, calculator):
    '''SADDLE's stage on the first candidate: the host-loop dimer on the
    stand-in's gradients (XTB), or the dimer on the internal force field
    (no calculator; float64 on the run's device in the port).'''
    out = {}
    cwd = os.getcwd()
    for key, done in candidates.items():
        run = copy.copy(done)
        run.options = copy.deepcopy(done.options)
        run.logfile = io.StringIO()        # the run closed its log
        run.options.calculator = calculator
        run.options.theory_level = 'GFN2-xTB' if calculator else None
        keep = np.arange(len(run.structures)) < 1
        run.apply_mask(run.MASKABLE, keep)
        os.chdir(run.workdir)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                run.saddle_refining()
        finally:
            os.chdir(cwd)
        out[key] = (np.array(run.structures), np.array(run.energies),
                    np.array(run.exit_status))
    close(out['port'][0], out['jax'][0])
    close(out['port'][1], out['jax'][1])
    np.testing.assert_array_equal(out['port'][2], out['jax'][2])
    assert (standin.calls > 0) == (calculator == 'XTB')
