'''The optimisation route of the port against the JAX package's,
float64 on the CPU (as tests/test_torch_optimization.py): on
da_cyclical, whose DIST letters set target distances (2.2 and 2.3 A)
that the xtb adapter walks toward step by step, and with CALC=ORCA,
whose three-step schedule (3 and 5 iterations before the loose and
tight stages) runs ORCA answered in process by the stand-in xtb's
model (tests/torch_standin: a test double, no number it gives is
chemistry); MTD and the csearch augmentation routine on an embed run;
adjust_spacings_batch; and the JAX package's error when an input that
optimises finds no calculator.'''

import os
import shutil
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_optimization import quiet, records
from tscode_tpu_torch import opt_records
from tscode_tpu_torch.opt_records import STANDIN_DIR
from tscode_tpu_torch.pipeline import FIXTURE_DIR

sys.path.insert(0, STANDIN_DIR)
import standin_xtb  # noqa: E402


def test_da_cyclical_route_equals_the_jax_package(tmp_path):
    got, want = records(tmp_path, 'da_cyclical_opt', 4)
    assert not opt_records.energy_ties(want)
    opt_records.same_records(got, want)
    assert want['final'] > 0 and len(want['refine']) == 5
    # the step-wise approach: more calls than jobs
    assert want['calls'] > sum(want['refine']) + 20


def orca_standin(argv, cwd, out=None, err=None):
    '''ORCA answered by the stand-in's model: reads the job's .inp
    (coordinates, MaxIter), takes MaxIter steps (10 without), writes
    the optimised .xyz and the property file.'''
    stem = os.path.splitext(argv[0])[0]
    with open(os.path.join(cwd, argv[0])) as f:
        lines = f.read().splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith('*xyz'))
    rows = [ln.split() for ln in lines[start + 1:]
            if ln.strip() and ln.strip() != '*']
    steps = next((int(ln.split()[1]) for ln in lines
                  if ln.strip().startswith('MaxIter')), 10)
    symbols = [r[0] for r in rows]
    coords = [[float(v) for v in r[1:4]] for r in rows]
    model = standin_xtb.Model(symbols, coords, {'method': 'gfn1',
                                                'charge': 0}, None)
    c, e, _ = standin_xtb.descend(model, coords, steps, [])
    with open(os.path.join(cwd, f'{stem}.xyz'), 'w') as f:
        f.write(standin_xtb.xyz_text(symbols, c, 'orca stand-in'))
    with open(os.path.join(cwd, f'{stem}_property.txt'), 'w') as f:
        f.write(f'   SCF Energy:   {e:.12f}\n')
    return 0


def test_orca_three_step_schedule_equals_the_jax_package(tmp_path):
    '''CALC=ORCA: 3 and 5 iterations before the loose and tight
    stages, seven refine stages in all.'''
    got, want = records(tmp_path, 'sn2_string_opt', 4,
                        keywords='CALC=ORCA RMSD=0.02',
                        programs={'orca': orca_standin})
    assert not opt_records.energy_ties(want)
    opt_records.same_records(got, want)
    assert len(want['refine']) == 7
    log = (tmp_path / 'port' / 'tscode_port.log').read_text()
    for step in ('3 iterations, step 1/3', '5 iterations, step 2/3',
                 'convergence, step 3/3'):
        assert step in log


def metadynamics(coords, atomnos, constrained_indices=None,
                 new_structures=5, title=0, **kwargs):
    '''xtb's metadynamics mocked (the stand-in serves no --md): the
    input and new_structures - 1 jittered copies, seeded by the
    candidate's index.'''
    rng = np.random.default_rng(int(title))
    return np.concatenate([np.asarray(coords)[None], np.asarray(coords)[None]
                           + rng.normal(size=(new_structures - 1,)
                                        + np.shape(coords)) * 0.05])


def test_mtd_and_csearch_augmentation_equal_the_jax_package(tmp_path,
                                                            monkeypatch):
    '''MTD (metadynamics mocked, then the calculator's stage and the
    prunes again) and the csearch augmentation routine (random
    torsional conformers of every candidate, each round followed by the
    force-field stage; no keyword sets it, so the Options of both
    packages start with it on), the searches seeded with 0 in both.'''
    import tscode_tpu.calculators.xtb as jxtb
    import tscode_tpu.embedder as jembedder
    from test_torch_suite_counts import jax_opt_package
    from tscode_tpu_torch import embedder
    from tscode_tpu_torch.calculators import xtb
    for m in (xtb, jxtb):
        monkeypatch.setattr(m, 'xtb_metadyn_augmentation', metadynamics)
    for m in (embedder, jembedder):
        class Augmenting(m.Options):
            def __init__(self):
                super().__init__()
                self.csearch_aug = True
        monkeypatch.setattr(m, 'Options', Augmenting)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    np.random.seed(0)
    want = quiet(opt_records.record, jax_opt_package(), 'sn2_string_opt', 4,
                 str(tmp_path / 'jax'), keywords='MTD')
    port = opt_records.port_package('cpu')
    port.embed_kw['rng'] = np.random.RandomState(0)
    got = quiet(opt_records.record, port, 'sn2_string_opt', 4,
                str(tmp_path / 'port'), keywords='MTD')
    # the metadynamics' first structure is its input: equal energies,
    # marked as ties and ordered alike by the stable sorts of both
    opt_records.same_records(got, want,
                             marked=opt_records.energy_ties(want))
    log = (tmp_path / 'port' / 'tscode_port.log').read_text()
    assert 'Metadynamics augmentation completed' in log
    assert 'Performing conformational augmentation' in log
    # five stages, then MTD's calculator stage, then a force-field
    # stage per augmentation round
    assert len(want['refine']) >= 7


def test_adjust_spacings_batch_equals_the_jax_package(tmp_path):
    '''The case of tests/test_vibrations.py: C2H4 and CH3Cl 6 A apart,
    DIST(a=2.8) pulls the pairing to 2.8 A on the internal force field
    (float64, 700 FIRE steps), in both packages.'''
    from tscode_tpu.embedder import Embedder as JaxEmbedder
    from tscode_tpu.optimization import adjust_spacings_batch as jax_adjust
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.optimization import adjust_spacings_batch
    for name in ('C2H4.xyz', 'CH3Cl.xyz'):
        shutil.copy(os.path.join(FIXTURE_DIR, name), tmp_path)
    inp = tmp_path / 'input.txt'
    inp.write_text('NOOPT DIST(a=2.8)\nC2H4.xyz 0a\nCH3Cl.xyz 0a\n')
    cwd = os.getcwd()
    try:
        je = quiet(JaxEmbedder, str(inp), stamp='jax')
        te = quiet(Embedder, str(inp), stamp='port', device='cpu')
    finally:
        os.chdir(cwd)
    rng = np.random.default_rng(5)
    poses = np.stack([np.concatenate([
        te.objects[0].atomcoords[0],
        te.objects[1].atomcoords[0] + np.array([6.0, 0, 0])
        + rng.normal(size=3)]) for _ in range(3)])
    atomnos = np.concatenate([te.objects[0].atomnos, te.objects[1].atomnos])
    got = adjust_spacings_batch(te, poses, atomnos)
    want = jax_adjust(je, poses, atomnos)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    pair = list(te.pairings_table.values())[0]
    d = np.linalg.norm(got[0][:, pair[0]] - got[0][:, pair[1]], axis=-1)
    np.testing.assert_allclose(d, 2.8, atol=0.1)
    assert got[2].all()


def test_without_a_calculator_the_jax_packages_error(tmp_path, monkeypatch):
    '''An input without NOOPT and no calculator on the machine: after
    the embed and the prunes, the JAX package's InputError, word for
    word (python -m tscode_tpu on the same input).'''
    from tscode_tpu.embedder import Embedder as JaxEmbedder
    from tscode_tpu.errors import InputError as JaxInputError
    from tscode_tpu_torch import options
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.errors import InputError
    import tscode_tpu.options as joptions
    for m in (options, joptions):
        monkeypatch.setattr(m, 'CALCULATOR', None)
        monkeypatch.setattr(m, 'FF_CALC', None)
        monkeypatch.setattr(m, 'FF_OPT_BOOL', False)
    for name in ('C2H4.xyz', 'CH3Cl.xyz'):
        shutil.copy(os.path.join(FIXTURE_DIR, name), tmp_path)
    inp = tmp_path / 'input.txt'
    inp.write_text('C2H4.xyz 0\nCH3Cl.xyz 0\n')
    cwd = os.getcwd()
    try:
        with pytest.raises(JaxInputError) as want:
            quiet(JaxEmbedder(str(inp), stamp='jax').run)
        with pytest.raises(InputError) as got:
            quiet(Embedder(str(inp), stamp='port', device='cpu').run)
    finally:
        os.chdir(cwd)
    assert str(got.value) == str(want.value)
    assert 'Structure optimization requires an external calculator' in \
        str(got.value)
    # the embed and the prunes ran first
    assert (tmp_path / 'tscode_embedded_port.xyz').exists()


def test_openbabel_force_field_stage_raises_the_jax_packages_error(
        tmp_path, monkeypatch):
    '''FFCALC=OB with no OpenBabel bindings or CLI: the force-field
    stage's probe raises the JAX package's InputError after the embed,
    word for word.'''
    from tscode_tpu.embedder import Embedder as JaxEmbedder
    from tscode_tpu.errors import InputError as JaxInputError
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.errors import InputError
    for name in ('C2H4.xyz', 'CH3Cl.xyz'):
        shutil.copy(os.path.join(FIXTURE_DIR, name), tmp_path)
    inp = tmp_path / 'input.txt'
    inp.write_text('CALC=XTB FFCALC=OB FFOPT=ON\nC2H4.xyz 0\nCH3Cl.xyz 0\n')
    cwd = os.getcwd()
    try:
        with pytest.raises(JaxInputError) as want:
            quiet(JaxEmbedder(str(inp), stamp='jax').run)
        with pytest.raises(InputError) as got:
            quiet(Embedder(str(inp), stamp='port', device='cpu').run)
    finally:
        os.chdir(cwd)
    assert str(got.value) == str(want.value)
    assert 'FFCALC=OB needs OpenBabel' in str(got.value)
