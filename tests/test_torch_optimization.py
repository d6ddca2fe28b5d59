'''The optimisation route of the port (an input without NOOPT: the
embed, then the force-field and the calculator's stages, each followed
by the prunes) against the JAX package's, float64 on the CPU, every
calculator call answered in process by the stand-in xtb of
tests/torch_standin (a test double: no number it gives is chemistry)
in both packages: the counts after every stage and prune, every
stage's energies (1e-6 kcal/mol) and exit status, the final frames
(1e-6 A) and the poses file's rows, the number of stand-in calls.
Also ONLYREFINED and the KCAL window, and resume after each of the
seven stages (adjust_spacings_batch and the error without a calculator:
tests/test_torch_opt_schedules.py).'''

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_suite_counts import opt_counts
from tscode_tpu_torch import opt_records


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def records(tmp_path, name, n_confs, **kw):
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    want = quiet(opt_counts, 'jax', name, n_confs, str(tmp_path / 'jax'),
                 **kw)
    got = quiet(opt_counts, 'port', name, n_confs, str(tmp_path / 'port'),
                **kw)
    return got, want


@pytest.mark.parametrize('name,keywords', [
    ('sn2_string_opt', ''),
    ('sn2_string_opt', 'RMSD=0.02 ONLYREFINED'),
    ('sn2_string_opt', 'RMSD=0.02 KCAL=6'),
])
def test_route_equals_the_jax_package(tmp_path, name, keywords):
    '''At 4 conformers; with RMSD=0.02 enough candidates reach the
    calculator's stages for ONLYREFINED and the energy window to
    discard some (da_cyclical and ORCA's schedule:
    test_torch_opt_schedules.py).'''
    got, want = records(tmp_path, name, 4, keywords=keywords)
    kcal = 6.0 if 'KCAL' in keywords else 10.0
    marked = opt_records.energy_ties(want, kcal=kcal)
    assert not marked
    opt_records.same_records(got, want)
    assert want['final'] > 0 and len(want['refine']) == 5
    assert want['calls'] > sum(want['refine']) - 1
    stages = [s[0] for s in want['stages']]
    assert stages.count('force_field_refining') == 3
    assert stages.count('optimization_refining') == 2
    if keywords:
        # the calculator's stages start with >= 10 candidates
        assert want['refine'][3] >= 10
    if 'ONLYREFINED' in keywords:
        assert all(want['exit_status'])
    if 'KCAL' in keywords:
        # the window discards some at the tight stage
        opt_tight = [s for s in want['stages']
                     if s[0] == 'optimization_refining'][-1]
        log = (tmp_path / 'port' / 'tscode_port.log').read_text()
        assert 'candidates for energy' in log
        assert opt_tight[2] < opt_tight[1]


@pytest.fixture(scope='module')
def resumable(tmp_path_factory):
    '''The JAX package's run of sn2_string_opt at 4 conformers
    (RMSD=0.02), its resume file copied after each stage.'''
    from tscode_tpu.embedder import RunEmbedding
    d = tmp_path_factory.mktemp('resume')
    (d / 'jax').mkdir()
    saved = RunEmbedding.save_resume

    def save(self, stage):
        saved(self, stage)
        shutil.copy(f'tscode_resume_{self.stamp}.pkl',
                    str(d / f'after_{stage}.pkl'))

    RunEmbedding.save_resume = save
    try:
        want = quiet(opt_counts, 'jax', 'sn2_string_opt', 4,
                     str(d / 'jax'), keywords='RMSD=0.02')
    finally:
        RunEmbedding.save_resume = saved
    return d, want


@pytest.mark.parametrize('stage', ['generated', 'pruned', 'ff_pre',
                                   'ff_loose', 'ff_tight', 'opt_loose',
                                   'opt_tight'])
def test_resume_after_each_stage(resumable, stage):
    '''The port resumed from the JAX package's state after `stage`
    ends where the JAX run ended, and runs only the later stages.'''
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.suite_inputs import config_files
    d, want = resumable
    work = d / f'port_{stage}'
    work.mkdir()
    inp = config_files('sn2_string_opt', str(work), 4)
    with open(inp) as f:
        lines = f.read().split('\n')
    lines[0] += ' RMSD=0.02'
    with open(inp, 'w') as f:
        f.write('\n'.join(lines))
    fake = opt_records.InProcessSubprocess()
    from tscode_tpu_torch.calculators import gradients, xtb
    saved = xtb.subprocess, gradients.subprocess
    xtb.subprocess = gradients.subprocess = fake
    cwd = os.getcwd()
    try:
        run = quiet(Embedder(inp, stamp='resumed', device='cpu').run,
                    resume_from=str(d / f'after_{stage}.pkl'))
    finally:
        os.chdir(cwd)
        xtb.subprocess, gradients.subprocess = saved
    np.testing.assert_allclose(run.structures, want['arrays']['final_frames'],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(run.energies,
                               want['arrays']['final_energies'], rtol=0,
                               atol=1e-6)
    log = (work / 'tscode_resumed.log').read_text()
    assert f'completed stage: {stage}' in log
    assert 'Performing string embed' not in log
    order = ['ff_pre', 'ff_loose', 'ff_tight', 'opt_loose', 'opt_tight']
    done = order.index(stage) + 1 if stage in order else 0
    # each refine stage calls the stand-in once per structure at least
    assert (fake.calls == 0) == (stage == 'opt_tight')
    assert log.count('optimization took') == len(order) - done
