'''The operators of the port (tscode_tpu_torch.operators) against the
JAX package's, float64 on the CPU: the dispatcher's names, the three
conformer searches on a molecule and through the CLI, DRYRUN, the
csearch augmentation of a candidate, and K1's back-off entry as its
plain twin. The searches draw from numpy's global generator seeded with
0 in the JAX package and from np.random.RandomState(0) in the port.'''

import contextlib
import inspect
import io
import json
import os
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_suite_counts import STRING_SLACK, stage_list
from tscode_tpu import operators as jops
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.embedder import RunEmbedding as JaxRun
from tscode_tpu.molecule import Molecule as JaxMolecule
from tscode_tpu.ops.clash import torsion_clash_ok as jax_torsion_clash_ok
from tscode_tpu_torch import embedder as port_embedder
from tscode_tpu_torch import operators
from tscode_tpu_torch.embedder import Embedder, RunEmbedding
from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
from tscode_tpu_torch.molecule import Molecule
from tscode_tpu_torch.ops.kernels import clash
from tscode_tpu_torch.options import Options
from tscode_tpu_torch.pipeline import FIXTURE_DIR
from tscode_tpu_torch.suite_inputs import chloroalkane

SEARCHES = ('csearch', 'csearch_hb', 'rsearch')


def jax_operator_names():
    '''The names the JAX package's dispatcher knows.'''
    return set(re.findall(r"'(\w+)': _\w+_operator",
                          inspect.getsource(jops.operate)))


FF_OPERATORS = ('neb', 'saddle', 'scan', 'mep_relax')
CALC_OPERATORS = ('automep', 'mtd', 'mtd_search', 'opt', 'pka')


def test_dispatcher_knows_the_jax_packages_names():
    '''The port's handlers are every name of the JAX package's
    dispatcher: refine>, the three searches, the four force-field
    operators and the five that need a calculator.'''
    ported = set(re.findall(r"'(\w+)': _\w+_operator",
                            inspect.getsource(operators.operate)))
    assert ported == {'refine'} | set(SEARCHES) | set(FF_OPERATORS) | \
        set(CALC_OPERATORS)
    assert ported == jax_operator_names()


@pytest.mark.parametrize('name', CALC_OPERATORS)
def test_item_15_operators_raise_not_ported(name):
    '''Without a calculator, opt>, mtd>, mtd_search>, automep> and pka>
    raise the JAX package's InputError, word for word (run on the
    stand-in xtb: tests/test_torch_opt_operators.py).'''
    emb = SimpleNamespace(options=SimpleNamespace(calculator=None),
                          objects=[])
    mol = SimpleNamespace(name='m.xyz')
    with pytest.raises(jops.InputError) as want:
        jops.operate(f'{name}>', emb, mol)
    with pytest.raises(InputError) as got:
        operators.operate(f'{name}>', emb, mol)
    assert str(got.value) == str(want.value)


def test_unknown_operator_raises_input_error():
    with pytest.raises(InputError):
        operators.operate('frobnicate>', None, None)
    with pytest.raises(jops.InputError):
        jops.operate('frobnicate>', None, None)


def test_refine_operator_returns_the_molecule():
    mol = object()
    assert operators.operate('refine>', None, mol) is mol


def chain_file(path, n_confs, seed=1):
    '''n_confs jittered conformers of the C6 chain (four rotors) at
    path.'''
    coords, nos = chloroalkane(6)
    rng = np.random.default_rng(seed)
    with open(path, 'w') as f:
        for c in range(n_confs):
            write_xyz(coords + rng.normal(size=coords.shape) * 0.03, nos, f,
                      title=f'conf {c}')
    return str(path)


def fake_embedder(mol, **extra):
    '''What the search operators read from an Embedder.'''
    options = Options()
    return SimpleNamespace(options=options, objects=[mol], pairings_dict={},
                           log=lambda *a, **k: None, **extra)


@pytest.mark.parametrize('name', SEARCHES)
def test_search_operators_equal_the_jax_package(tmp_path, name):
    '''Each search operator on a two-conformer chain: one search from
    each conformer (max_confs split between them keeps every conformer
    of the chain's 81 candidates here), the new molecule's conformers
    frame for frame and its orbitals rebuilt.'''
    path = chain_file(tmp_path / 'chain.xyz', 2)
    jmol = JaxMolecule(path, reactive_indices=(0,))
    np.random.seed(0)
    want = jops.operate(f'{name}>', fake_embedder(jmol), jmol)
    mol = Molecule(path, reactive_indices=(0,))
    emb = fake_embedder(mol, rng=np.random.RandomState(0), device='cpu')
    got = operators.operate(f'{name}>', emb, mol)
    assert got is not mol and got.atomcoords.shape == want.atomcoords.shape
    np.testing.assert_allclose(got.atomcoords, want.atomcoords, rtol=0,
                               atol=1e-6)
    assert [r['torsions'] for r in emb.search_info] == [4, 4]
    assert sum(r['conformers'] for r in emb.search_info) == \
        len(got.atomcoords) > 2
    assert sorted(got.reactive_atoms) == list(range(len(got.atomcoords)))
    assert mol.atomcoords.shape[0] == 2           # the input is untouched


def string_input(d, op, dryrun=False):
    """csearch_string's input with the C6 chain in place of the C10
    one, `op`> in place of csearch> and large_n_string's docking
    distance: two noisy conformers of C2H4 on the chain's chlorinated
    carbon, 3.2 A apart."""
    from tscode_tpu_torch.suite_inputs import write_noisy
    write_noisy(os.path.join(FIXTURE_DIR, 'C2H4.xyz'),
                os.path.join(d, 'm1.xyz'), 2, np.random.default_rng(7))
    chain_file(os.path.join(d, 'm2.xyz'), 1)
    keywords = 'NOOPT DIST(a=3.2)' + (' DRYRUN' if dryrun else '')
    path = os.path.join(d, 'input.txt')
    with open(path, 'w') as f:
        f.write(f'{keywords}\nm1.xyz 0a\n{op + "> " if op else ""}'
                'm2.xyz 0a\n')
    return path


class SeededEmbedder(Embedder):
    '''The Embedder the CLI builds, drawing from RandomState(0).'''

    def __init__(self, *args, **kw):
        super().__init__(*args, rng=np.random.RandomState(0), **kw)


@pytest.mark.parametrize('name', SEARCHES)
def test_cli_runs_the_search_operators(tmp_path, monkeypatch, name):
    """python -m tscode_tpu_torch input.txt --device cpu with each
    search operator on the string route: the JAX package's searched
    conformers frame for frame, and its stage counts. The chlorine of
    the chain lies on the reactive axis, so the torsion quadruplet that
    ends on it is collinear and the novelty counts rest on rounding
    noise (ROADMAP.md section 3): they agree within 10%."""
    from tscode_tpu import torsions as jt
    from tscode_tpu_torch import torsions
    from tscode_tpu_torch.__main__ import main
    searched = {'jax': [], 'port': []}

    def spy(entry, key):
        def run(*args, **kw):
            out = entry(*args, **kw)
            searched[key].append(np.asarray(out))
            return out
        return run

    monkeypatch.setattr(jt, 'csearch', spy(jt.csearch, 'jax'))
    monkeypatch.setattr(torsions, 'csearch', spy(torsions.csearch, 'port'))
    monkeypatch.setattr(port_embedder, 'Embedder', SeededEmbedder)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    cwd = os.getcwd()
    try:
        inp = string_input(str(tmp_path / 'jax'), name)
        np.random.seed(0)
        with contextlib.redirect_stdout(io.StringIO()):
            JaxEmbedder(inp, stamp='jax').run()
        inp = string_input(str(tmp_path / 'port'), name)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main([inp, '--device', 'cpu', '-n', 'port']) == 0
    finally:
        os.chdir(cwd)
    (want,), (got,) = searched['jax'], searched['port']
    assert got.shape == want.shape and len(got) > 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    reports = [json.load(open(tmp_path / d / f'tscode_report_{d}.json'))
               for d in ('jax', 'port')]
    assert [r['conformers'] for r in reports[1]['csearch']] == [len(got)]
    for a, b in zip(stage_list(reports[1]), stage_list(reports[0]),
                    strict=True):
        assert a[0] == b[0] and abs(a[2] - b[2]) <= STRING_SLACK * b[2]
    frames = read_xyz(str(tmp_path / 'port' / 'tscode_unoptimized_port.xyz'))
    assert frames.atomcoords.shape == (reports[1]['final_structures'], 26, 3)


def test_dryrun_skips_every_operator(tmp_path):
    '''DRYRUN: no operator runs, an unknown one included, in both
    packages; the molecule keeps its one conformer.'''
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    cwd = os.getcwd()
    try:
        for d, make in (('jax', lambda p: JaxEmbedder(p, stamp='jax')),
                        ('port', lambda p: Embedder(p, stamp='port',
                                                    device='cpu'))):
            inp = string_input(str(tmp_path / d), 'frobnicate> csearch',
                                dryrun=True)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                emb = make(inp)
            emb.logfile.close()
            assert emb.objects[1].atomcoords.shape == (1, 20, 3)
            assert out.getvalue().count('Dry run requested: skipping') == 2
    finally:
        os.chdir(cwd)


def augmentation_runs(tmp_path):
    '''A string-route candidate of C2H4 on the C6 chain (the port's
    first structure of string_input without an operator) as the only
    structure of a run of each package, set up on the same input.'''
    from tscode_tpu.graphs import get_sum_graph as jax_sum_graph
    from tscode_tpu_torch.graphs import get_sum_graph
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    cwd = os.getcwd()
    try:
        inp = string_input(str(tmp_path / 'port'), None)
        with contextlib.redirect_stdout(io.StringIO()):
            port = Embedder(inp, stamp='port', device='cpu',
                            rng=np.random.RandomState(0))
            run = port.run()
        jinp = string_input(str(tmp_path / 'jax'), None)
        with contextlib.redirect_stdout(io.StringIO()):
            jax = JaxEmbedder(jinp, stamp='jax')
    finally:
        os.chdir(cwd)
    candidate = np.array(run.structures[:1])
    cons = np.array(run.constrained_indices[:1])
    runs = []
    for emb, cls, sum_graph in ((jax, JaxRun, jax_sum_graph),
                                (port, RunEmbedding, get_sum_graph)):
        r = cls(emb)
        r.structures, r.constrained_indices = candidate.copy(), cons.copy()
        r.atomnos = np.concatenate([m.atomnos for m in emb.objects])
        r.energies = np.zeros(1)
        r.exit_status = np.ones(1, dtype=bool)
        r.embed_graph = sum_graph([m.graph for m in emb.objects], cons[0])
        r.log = lambda *a, **k: None
        runs.append(r)
    return runs


def test_csearch_augmentation_equals_the_jax_package(tmp_path):
    '''One candidate augmented by the hydrogen-bond-keeping random
    search (mode 2, up to 100 new conformers), then pruned by TFD and
    MOI: the same structures in the same order.'''
    jax_run, port_run = augmentation_runs(tmp_path)
    np.random.seed(0)
    jax_run.csearch_augmentation()
    port_run.rng = np.random.RandomState(0)
    port_run.csearch_augmentation()
    assert len(port_run.structures) == len(jax_run.structures) > 1
    np.testing.assert_allclose(port_run.structures, jax_run.structures,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port_run.energies, jax_run.energies)
    assert port_run.energies[0] == 0 and port_run.energies[-1] == 1e10


def test_torsion_clash_ok_plain_twin_equals_the_jax_package():
    '''K1's back-off entry on CPU tensors (its plain twin, direct
    differences) against tscode_tpu/ops/clash.torsion_clash_ok (matmul
    form) on random poses, off threshold ties, at max_clashes 0 and 2.'''
    rng = np.random.default_rng(8)
    poses = rng.normal(size=(300, 12, 3)) * 2.0
    move = np.zeros(12, dtype=bool)
    move[[0, 1, 2, 5]] = True
    other = ~move
    other[[3, 4]] = False
    d = poses[:, other][:, :, None] - poses[:, move][:, None]
    tie = (np.abs(np.sum(d * d, -1) - 2.25) < 1e-6).any(axis=(1, 2))
    for mc in (0, 2):
        got = clash.torsion_clash_ok(torch.as_tensor(poses), move, other,
                                     max_clashes=mc).numpy()
        want = np.asarray(jax_torsion_clash_ok(
            jnp.asarray(poses), jnp.asarray(move), jnp.asarray(other),
            max_clashes=mc))
        np.testing.assert_array_equal(got[~tie], want[~tie])
        assert 0 < int(want.sum()) < len(poses)
    assert clash.KERNEL._lib is None
