'''The rigid multi-arrangement route on the CPU, float64: the port
(tscode_tpu_torch) against the JAX package: the union of block dicts,
the fitness stage, and the whole route on the input of the JAX package's
golden (HCOOH 0 1 3 + C2H4 0 1, 6 jittered conformers each, 12
arrangements) against tests/golden/multiembed_embed.npz.'''

import json
import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.embedder import RunEmbedding as JaxRunEmbedding
from tscode_tpu.embeds import cyclical as jc
from tscode_tpu_torch import multiembed
from tscode_tpu_torch.embedder import Embedder, RunEmbedding
from tscode_tpu_torch.embeds import cyclical as tc
from tscode_tpu_torch.errors import ZeroCandidatesError
from tscode_tpu_torch.suite_inputs import config_files

HERE = os.path.dirname(os.path.abspath(__file__))


def set_up(cls, path, **kw):
    cwd = os.getcwd()
    try:
        emb = cls(path, stamp='setup', **kw)
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    return emb


@pytest.fixture(scope='module')
def da4(tmp_path_factory):
    '''da_cyclical at 4 conformers (two pairings with imposed
    distances), set up by both packages.'''
    d = tmp_path_factory.mktemp('da4')
    path = config_files('da_cyclical', str(d), 4)
    return set_up(JaxEmbedder, path), set_up(Embedder, path, device='cpu')


# ---------------------------------------------------------- concat_blocks


@pytest.mark.parametrize('form', ['compact', 'expanded', 'mixed'])
def test_concat_blocks_matches_jax(da4, form):
    '''The union of three block dicts (different gates, so different row
    counts): every field equal to the JAX package's union; the compact
    tables survive, their indices offset per dict, only when every dict
    has them.'''
    _, te = da4
    m1, m2 = te.objects
    fast = [tc.bimol_rigid_blocks_fast(m1, m2, delta, te.pairing_ok_fn())
            for delta in (5, 0.05, 0.2)]
    loop = [tc.bimol_rigid_blocks_loop(m1, m2, delta, te.pairing_ok_fn())
            for delta in (5, 0.05, 0.2)]
    blks = {'compact': fast, 'expanded': loop,
            'mixed': [fast[0], loop[1], fast[2]]}[form]
    assert len({len(b['ids']) for b in blks}) == 3
    got, want = tc.concat_blocks(blks), jc._concat_blocks(blks)
    assert set(got) == set(want)
    assert ('tidx' in got) == (form == 'compact')
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got['ids']) == sum(len(b['ids']) for b in blks)
    if form == 'compact':
        # a row of the union gathers the same table rows as in its dict
        lo = len(blks[0]['ids'])
        row = got['tidx'][lo + 3]
        np.testing.assert_array_equal(got['tab1'][row[0]],
                                      blks[1]['tab1'][blks[1]['tidx'][3, 0]])
        np.testing.assert_array_equal(got['tab2'][row[1]],
                                      blks[1]['tab2'][blks[1]['tidx'][3, 1]])
        assert row[0] >= len(blks[0]['tab1'])


def test_union_sweep_equals_the_arrangements_own_sweeps(da4):
    '''One sweep over the union of two block dicts, sliced by the keep
    counts, gives each dict's own survivors bit for bit.'''
    import torch
    _, te = da4
    m1, m2 = te.objects
    blks = [tc.bimol_rigid_blocks(m1, m2, d, te.pairing_ok_fn())
            for d in (5, 0.1)]
    kw = dict(device='cpu', dtype=torch.float64)
    surv, keep = tc.screen_survivors(tc.concat_blocks(blks), (m1, m2),
                                     te.systematic_angles, 1.5,
                                     block_chunk=37, **kw)
    lo = s_lo = 0
    for blk in blks:
        own, own_keep = tc.screen_survivors(blk, (m1, m2),
                                            te.systematic_angles, 1.5, **kw)
        n = len(blk['ids'])
        np.testing.assert_array_equal(keep[lo:lo + n], own_keep)
        n_surv = int(own_keep.sum())
        assert torch.equal(surv[s_lo:s_lo + n_surv], own)
        lo, s_lo = lo + n, s_lo + n_surv
    assert s_lo == surv.shape[0] > 0


# ------------------------------------------------------- fitness_refining


def test_fitness_refining_matches_jax(da4):
    '''A perturbed ensemble (the embed's poses with the second fragment
    pushed away by 0 to 9 A) through both packages' fitness stage: the
    same structures survive, and every MASKABLE array is masked.'''
    je, te = da4
    poses, cons = tc.cyclical_embed_bimol_rigid(
        *te.objects, te.systematic_angles, max_norm_delta=5,
        pairing_ok=te.pairing_ok_fn(), log=lambda *a: None, device='cpu')
    rng = np.random.default_rng(4)
    n1 = te.objects[0].n_atoms
    s = poses.copy()
    push = rng.uniform(0, 9, size=len(s))
    direction = s[:, n1:].mean(axis=1) - s[:, :n1].mean(axis=1)
    direction /= np.linalg.norm(direction, axis=1)[:, None]
    s[:, n1:] += (push[:, None] * direction)[:, None]
    runs = []
    for cls, emb in ((JaxRunEmbedding, je), (RunEmbedding, te)):
        run = cls(emb)
        run.logfile = open(os.devnull, 'w')
        run.structures = s.copy()
        run.constrained_indices = cons.copy()
        run.energies = np.arange(len(s), dtype=float)
        run.exit_status = np.zeros(len(s), dtype=bool)
        run.fitness_refining()
        runs.append(run)
    rj, rt = runs
    np.testing.assert_array_equal(rt.energies, rj.energies)
    np.testing.assert_array_equal(rt.structures, rj.structures)
    np.testing.assert_array_equal(rt.constrained_indices,
                                  rj.constrained_indices)
    assert len(rt.exit_status) == len(rt.structures)
    assert 0 < len(rt.structures) < len(s)
    assert rt.stage_timings[-1]['stage'] == 'fitness_refining'
    # nothing within the 5 A threshold: the stage raises
    rt.structures = rt.structures.copy()
    rt.structures[:, n1:] += 50.0
    with pytest.raises(ZeroCandidatesError):
        rt.fitness_refining()


# ------------------------------------------------------------- the route


@pytest.fixture(scope='module')
def golden_run(tmp_path_factory):
    '''The golden's input (6 conformers, noise 0.12) run by the port:
    (run, directory, cwd before, cwd after).'''
    d = tmp_path_factory.mktemp('mgold')
    path = config_files('multiembed', str(d), 6)
    before = os.getcwd()
    os.environ['TSCODE_EMBED_TRACE'] = '1'
    try:
        run = Embedder(path, stamp='mgold', device='cpu').run()
        after = os.getcwd()
    finally:
        os.environ.pop('TSCODE_EMBED_TRACE')
        os.chdir(before)
    return run, d, str(d), after


def test_multiembed_setup_matches_jax(golden_run):
    _, d, _, _ = golden_run
    je = set_up(JaxEmbedder, str(d / 'input.txt'))
    te = set_up(Embedder, str(d / 'input.txt'), device='cpu')
    assert te.embed == je.embed == 'multiembed'
    assert te.candidates == je.candidates == 0
    np.testing.assert_array_equal(te.systematic_angles, je.systematic_angles)
    with open(d / 'tscode_setup.log') as f:
        assert 'Many candidates will be generated' in f.read()
    for mt, mj in zip(te.objects, je.objects):
        for c in range(mt.n_confs):
            for i, at in mt.reactive_atoms[c].items():
                np.testing.assert_allclose(
                    at.center, mj.reactive_atoms[c][i].center, rtol=0,
                    atol=1e-9)


def test_multiembed_route_matches_the_golden(golden_run):
    '''Shapes equal, structures within 1e-6 A, constraint ids equal; the
    child folders are gone and the working directory is restored.'''
    run, d, workdir, after = golden_run
    gold = np.load(os.path.join(HERE, 'golden', 'multiembed_embed.npz'))
    structures = np.asarray(run.structures)
    assert structures.shape == gold['structures'].shape
    np.testing.assert_allclose(structures, gold['structures'], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(run.constrained_indices),
                                  gold['cons'])
    assert after == workdir
    assert not [p for p in os.listdir(d) if p.startswith('tscode_embed')
                and os.path.isdir(d / p)]
    assert (d / 'tscode_unoptimized_mgold.xyz').exists()


def test_multiembed_run_report(golden_run):
    '''The report has the arrangements, the union sweep's split and each
    child's counts and seconds; the parent's stages follow the embed.'''
    run, d, _, _ = golden_run
    with open(d / 'tscode_report_mgold.json') as f:
        rep = json.load(f)
    me = rep['multiembed_embed']
    assert me['arrangements'] == 12 == len(me['children'])
    assert all(k in me for k in ('blocks_s', 'screen_s', 'dedup_s',
                                 'assemble_s', 'sweep_s'))
    assert me['union_blocks'] == sum(c['blocks'] for c in me['children'])
    assert me['union_candidates'] == 36 * me['union_blocks']
    assert me['union_survivors'] == sum(c['survivors']
                                        for c in me['children'])
    first = me['children'][0]
    assert first['arrangement'] == [[0, 0], [1, 1]]
    for c in me['children']:
        assert c['seconds'] >= 0 and c['candidates'] == 36 * c['blocks']
        if c['survivors']:
            assert [s[0] for s in c['stages']] == [
                'generate_candidates', 'compenetration_refining',
                'fitness_refining', 'similarity_refining']
            assert c['stages'][-1][2] == c['structures']
    assert sum(c['structures'] for c in me['children']) == \
        rep['stages'][0]['structures_out']
    assert [s['stage'] for s in rep['stages']] == [
        'generate_candidates', 'compenetration_refining',
        'similarity_refining']
    assert rep['final_structures'] == len(run.structures)


def test_arrangements_follow_permutations_order(golden_run, monkeypatch):
    '''The 12 arrangements in itertools.permutations order, as the JAX
    package enumerates them; when no arrangement gives a structure the
    embed raises ZeroCandidatesError.'''
    import types
    import tscode_tpu.multiembed as jm
    _, d, _, _ = golden_run
    seen = {}
    for mod, cls, kw in ((multiembed, Embedder, {'device': 'cpu'}),
                         (jm, JaxEmbedder, {})):
        emb = set_up(cls, str(d / 'input.txt'), **kw)
        emb.logfile = open(os.devnull, 'w')
        emb.embed_info = {}
        order = []

        def build(parent, arrangement, i, order=order):
            order.append([tuple(map(int, p)) for p in arrangement])
            return types.SimpleNamespace(systematic_angles=[0]), f'x{i}', None

        monkeypatch.setattr(mod, '_build_child', build)
        monkeypatch.setattr(mod, '_finish_child',
                            lambda *a: (np.array([]), np.array([])))
        with pytest.raises(Exception, match='Multiembed did not find any '
                                            'suitable disposition'):
            mod.multiembed_bifunctional(emb)
        seen[mod.__name__] = order
    order = seen['tscode_tpu_torch.multiembed']
    assert order == seen['tscode_tpu.multiembed'] and len(order) == 12
    assert order[:3] == [[(0, 0), (1, 1)], [(0, 0), (3, 1)],
                         [(1, 0), (0, 1)]]


def test_failed_child_leaves_no_folder_and_restores_cwd(golden_run,
                                                        monkeypatch):
    '''A child that fails while it is built (here: its block rows, after
    its Embedder changed directory) leaves the parent where it was, and
    the folders built so far are removed.'''
    _, d, workdir, _ = golden_run
    emb = set_up(Embedder, str(d / 'input.txt'), device='cpu')
    run = RunEmbedding(emb)
    run.logfile = open(os.devnull, 'w')
    calls = []
    real = multiembed.bimol_rigid_blocks

    def failing(*a, **k):
        calls.append(os.getcwd())
        if len(calls) == 3:
            raise RuntimeError('block rows')
        return real(*a, **k)

    monkeypatch.setattr(multiembed, 'bimol_rigid_blocks', failing)
    before = os.getcwd()
    os.chdir(workdir)
    try:
        with pytest.raises(RuntimeError, match='block rows'):
            multiembed.multiembed_bifunctional(run)
        assert os.getcwd() == workdir
    finally:
        os.chdir(before)
    assert len(calls) == 3 and calls[2].endswith('tscode_embed3')
    # the two children built before the failure are removed
    assert not (d / 'tscode_embed1').exists()
    assert not (d / 'tscode_embed2').exists()
