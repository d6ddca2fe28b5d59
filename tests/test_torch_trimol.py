'''The rigid three-molecule cyclical route on the CPU, float64: the port
(tscode_tpu_torch) against the JAX package, function by function (facing
directions, constraint ids, the facing matrix, the chained direction
adjustment, the block screen) and through the Embedder, on the suite's
trimolecular input with RIGID added, at 3 conformers of HCOOH (2,916
predicted and 1,458 generated candidates in 54 blocks -> 54 embedded).'''

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.embeds import cyclical as jc
from tscode_tpu.io_xyz import read_xyz
from tscode_tpu.ops import clash as jclash
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.embeds import cyclical as tc
from tscode_tpu_torch.ops import linalg as tl
from tscode_tpu_torch.pipeline import FIXTURE_DIR
from tscode_tpu_torch.suite_inputs import config_files, write_noisy
from torch_parity import to_np

COUNTS_3 = (2916, 1458, 54, 54)   # predicted, generated, blocks, embedded


def set_up(cls, path, **kw):
    cwd = os.getcwd()
    try:
        emb = cls(path, stamp='setup', **kw)
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    return emb


@pytest.fixture(scope='module')
def tri3(tmp_path_factory):
    '''trimolecular_rigid at 3 conformers of HCOOH, set up by both
    packages: (input path, JAX Embedder, port Embedder).'''
    d = tmp_path_factory.mktemp('tri3')
    path = config_files('trimolecular_rigid', str(d), 12)
    return (path, set_up(JaxEmbedder, path),
            set_up(Embedder, path, device='cpu'))


# ------------------------------------------------------------ directions


@pytest.mark.parametrize('norms,kind', [
    ([2.0, 2.2, 2.4], 'acute'), ([2.5, 2.5, 2.5], 'acute'),
    ([3.0, 4.0, 5.0], 'right'), ([5.0, 3.0, 4.0], 'right'),
    ([4.0, 5.0, 3.0], 'right'),
    ([2.0, 2.1, 3.9], 'obtuse'), ([3.9, 2.0, 2.1], 'obtuse'),
    ([2.1, 3.9, 2.0], 'obtuse'), ([1.3, 2.7], 'digon')])
def test_get_directions_matches_jax(norms, kind):
    '''Acute, right (the 1e-5 A perturbation of the first side) and
    obtuse triangles (the sign fix, the obtuse angle at each vertex in
    turn), and the two-molecule case: equal to the JAX function's.'''
    got = tc.get_directions(norms)
    np.testing.assert_array_equal(got, jc._get_directions(norms))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-12)
    if kind == 'right':
        perturbed = list(norms)
        perturbed[0] += 1e-5
        np.testing.assert_array_equal(got, jc._get_directions(perturbed))
    if kind == 'obtuse':
        # the direction of the side facing the obtuse angle points away
        # from the circumcentre: all three point into the triangle
        verts = tl.polygonize(norms)[0]
        centroid = verts[:, 0].mean(axis=0)
        for side, d in zip(verts, got):
            assert (centroid - side.mean(axis=0)) @ d > 0


class FakeAtom:
    def __init__(self, index):
        self.index = index


class FakePivot:
    def __init__(self, start, end):
        self.start_atom, self.end_atom = FakeAtom(start), FakeAtom(end)


@pytest.mark.parametrize('orientation', range(8))
def test_cyclical_ids_trimol_and_facing_matrix_match_jax(orientation):
    pivots = [FakePivot(0, 4), FakePivot(1, 3), FakePivot(2, 0)]
    offsets = (0, 5, 11)
    ids = tc.cyclical_ids_trimol(pivots, orientation, offsets)
    assert ids == jc._cyclical_ids_trimol(pivots, orientation, offsets)
    np.testing.assert_array_equal(tc.facing_matrix(ids, offsets),
                                  jc._facing_matrix(ids, offsets))


# ------------------------------------------------------ adjustment chain


def seeded_chain(seed, B):
    '''A block sequence with resets, made from a seed: random triangles,
    one of their 8 orientations each, random pivots of the sides'
    lengths, and random reactive-atom coordinates.'''
    rng = np.random.default_rng(seed)
    cols = {k: np.zeros((B, 3, 3)) for k in
            ('starts', 'ends', 'pvs', 'mds', 'mps', 'verts', 'dirs0')}
    cols['rc_src'] = rng.normal(size=(B, 6, 3)) * 1.2
    cols['reset'] = rng.random(B) < 0.3
    cols['reset'][0] = True
    for b in range(B):
        norms = rng.uniform(2.0, 3.0, size=3)
        polygon = tl.polygonize(norms)[rng.integers(0, 8)]
        cols['starts'][b], cols['ends'][b] = polygon[:, 0], polygon[:, 1]
        v = rng.normal(size=(3, 3))
        cols['pvs'][b] = v / np.linalg.norm(v, axis=1)[:, None] \
            * norms[:, None]
        cols['mds'][b] = rng.normal(size=(3, 3))
        cols['mps'][b] = rng.normal(size=(3, 3))
        cols['verts'][b] = tl.polygonize(norms)[0][:, 0]
        cols['dirs0'][b] = tc.get_directions(norms)
    return [cols[k] for k in tc._ADJUST]


def jax_chain(cols):
    return np.asarray(jc._adjust_chain(
        *(jnp.asarray(c) for c in cols), jnp.asarray(tc.adjust_grid())))


@pytest.mark.parametrize('seed', [0, 1])
def test_adjust_chain_matches_jax_on_a_seeded_sequence(seed):
    '''Directions within 1e-9 of the JAX scan's on 60 blocks whose
    chains are 1 to 12 long (longer than a real combination's 8), in one
    call and in chunks of 7 rows; no block's two best grid costs lie
    within 1e-9 degrees.'''
    cols = seeded_chain(seed, 60)
    want = jax_chain(cols)
    got, gap = tc.adjust_chain(*cols, device='cpu')
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert int((gap < tc.ADJ_TIE).sum()) == 0 and gap.min() > 1e-6
    chunked, _ = tc.adjust_chain(*cols, device='cpu', chunk=7)
    np.testing.assert_array_equal(chunked, got)
    assert np.abs(got).max() > 0.1


def test_adjust_chain_needs_a_reset_first_and_takes_an_empty_sequence():
    cols = seeded_chain(2, 4)
    cols[tc._ADJUST.index('reset')][0] = False
    with pytest.raises(ValueError):
        tc.adjust_chain(*cols, device='cpu')
    got, gap = tc.adjust_chain(*(c[:0] for c in seeded_chain(2, 4)),
                               device='cpu')
    assert got.shape == (0, 3, 3) and gap.shape == (0,)


def test_adjust_grid_matches_jax_order():
    '''343 triples in numpy's three-array meshgrid order.'''
    grid = tc.adjust_grid()
    assert grid.shape == (343, 3)
    np.testing.assert_array_equal(grid[:3], [[-30, -30, -30], [-30, -30, -20],
                                             [-30, -30, -10]])
    np.testing.assert_array_equal(grid[7], [-20, -30, -30])
    np.testing.assert_array_equal(grid[49], [-30, -20, -30])


# ---------------------------------------------------------------- set-up


def test_trimol_setup_matches_jax(tri3):
    _, je, te = tri3
    assert te.embed == je.embed == 'cyclical' and len(te.objects) == 3
    np.testing.assert_array_equal(te.systematic_angles, je.systematic_angles)
    assert te.systematic_angles.shape == (27, 3)
    assert te.candidates == je.candidates == COUNTS_3[0]
    assert te.options.rigid and te.options.bypass and te.options.shrink
    for mt, mj in zip(te.objects, je.objects):
        assert [len(p) for p in mt.pivots] == [len(p) for p in mj.pivots]
        for pt, pj in zip(mt.pivots[0], mj.pivots[0]):
            np.testing.assert_allclose(pt.pivot, pj.pivot, rtol=0, atol=1e-9)


@pytest.mark.parametrize('n_pairings,want', [(0, 8), (1, 2), (2, 1)])
def test_trimol_candidate_count_matches_jax(tmp_path, n_pairings, want):
    '''Three molecules: four times the two-molecule count, a quarter of
    it with one pairing and an eighth from two pairings up.'''
    tags = [('', '', '', '', '', ''), ('a', '', 'a', '', '', ''),
            ('a', 'c', 'a', 'b', 'b', 'c')][n_pairings]
    d = tmp_path
    for name in ('C2H4.xyz',):
        with open(os.path.join(os.path.dirname(__file__), 'fixtures',
                               name)) as f:
            (d / name).write_text(f.read())
    lines = [f'C2H4.xyz 0{tags[2 * m]} 3{tags[2 * m + 1]}' for m in range(3)]
    (d / 'input.txt').write_text('NOOPT RIGID STEPS=1\n'
                                 + '\n'.join(lines) + '\n')
    je = set_up(JaxEmbedder, str(d / 'input.txt'))
    te = set_up(Embedder, str(d / 'input.txt'), device='cpu')
    per = 8 * np.prod([len(m.pivots[0]) for m in te.objects])
    assert te.candidates == je.candidates == want * per


# ----------------------------------------------------------------- embed


def test_trimol_blocks_and_screen_match_jax(tri3):
    '''The port's 54 blocks, adjusted directions and sweep against the
    JAX embed: the JAX block screen on the port's block fields gives the
    same keep mask and poses within 1e-9 A; the embeds' survivors within
    1e-6 A, constraint ids equal. The port's K1 entry screens with
    direct differences where the JAX screen uses the Gram form.'''
    _, je, te = tri3
    blk = tc.trimol_rigid_blocks(te.objects, te.pairing_ok_fn())
    assert len(blk['ids']) == COUNTS_3[2]
    # the pairings leave one orientation of each combination: no chain
    assert blk['reset'].all() and blk['confs'].shape == (54, 3)
    # the reference takes the adjustment's atoms from conformer 0
    r = tc.facing_matrix(blk['ids'][-1], (0, 5, 10))
    np.testing.assert_array_equal(blk['rc_src'][-1, 2],
                                  te.objects[1].atomcoords[0][r[1, 0]])
    assert blk['confs'][-1, 1] != 0

    dirs, gap = tc.adjust_chain(*(blk[k] for k in tc._ADJUST), device='cpu')
    want_dirs = jax_chain([blk[k] for k in tc._ADJUST])
    np.testing.assert_allclose(dirs, want_dirs, rtol=0, atol=1e-9)
    assert int((gap < tc.ADJ_TIE).sum()) == 0
    blk['dirs'] = dirs

    angles = np.asarray(te.systematic_angles, dtype=float)
    mols = te.objects
    pm = jclash.cross_fragment_pair_mask(tuple(m.n_atoms for m in mols))
    poses_j, keep_j = jc._block_screen_multi(
        *(jnp.asarray(m.atomcoords) for m in mols),
        *(jnp.asarray(blk['confs'][:, m]) for m in range(3)),
        *(jnp.asarray(blk[k]) for k in tc._GEOMETRY),
        jnp.asarray(angles), jnp.asarray(pm), 1.5)
    coords, grid, pairs, rows = tc.sweep_inputs(
        blk, mols, angles, torch.device('cpu'), torch.float64)
    assert pairs.shape == (75, 2)
    confs, *geo = rows(0, 54)
    poses_t, keep_t = tc.block_screen_plain(coords, confs, geo, grid, pairs,
                                            1.5)
    np.testing.assert_allclose(to_np(poses_t), np.asarray(poses_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(to_np(keep_t), np.asarray(keep_j))
    surv_t, keep_c = tc.block_screen(coords, confs, geo, grid, pairs, 1.5)
    np.testing.assert_array_equal(to_np(keep_c), np.asarray(keep_j))
    np.testing.assert_allclose(
        to_np(surv_t), np.asarray(poses_j)[np.asarray(keep_j)], rtol=0,
        atol=1e-9)

    kw = dict(clash_thresh=1.5, log=lambda *a: None)
    want_p, want_c = jc.cyclical_embed_trimol_rigid(
        je.objects, je.systematic_angles, pairing_ok=je.pairing_ok_fn(),
        **kw)
    info = {}
    got_p, got_c = tc.cyclical_embed_trimol_rigid(
        te.objects, te.systematic_angles, pairing_ok=te.pairing_ok_fn(),
        block_chunk=20, device='cpu', info=info, **kw)
    assert got_p.shape == want_p.shape == (COUNTS_3[3], 15, 3)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_c, want_c)
    assert (info['candidates'], info['blocks'], info['survivors'],
            info['chunks'], info['adjust_near_ties']) == (
                COUNTS_3[1], COUNTS_3[2], COUNTS_3[3], 3, 0)
    assert info['adjust_s'] > 0
    assert int(to_np(keep_t).sum()) == COUNTS_3[3]


def test_trimol_embed_without_pairings_matches_jax(tmp_path):
    '''Three jittered C2H4 (the symmetric fixture itself ties the grid
    search exactly) without pairings, STEPS=1: all 8 orientations of
    each pivot triple are kept, so every adjustment chain is 8 links
    long. Directions within 1e-9 of the JAX scan's, no near tie,
    survivors within 1e-6 A and ids equal.'''
    rng = np.random.default_rng(3)
    for m in (1, 2, 3):
        write_noisy(os.path.join(FIXTURE_DIR, 'C2H4.xyz'),
                    str(tmp_path / f'm{m}.xyz'), 1, rng)
    (tmp_path / 'input.txt').write_text(
        'NOOPT RIGID STEPS=1\nm1.xyz 0 3\nm2.xyz 0 3\nm3.xyz 0 3\n')
    je = set_up(JaxEmbedder, str(tmp_path / 'input.txt'))
    te = set_up(Embedder, str(tmp_path / 'input.txt'), device='cpu')
    blk = tc.trimol_rigid_blocks(te.objects, te.pairing_ok_fn())
    Bb = len(blk['ids'])
    assert Bb == 8 * blk['reset'].sum() == te.candidates // 8
    cols = [blk[k] for k in tc._ADJUST]
    dirs, gap = tc.adjust_chain(*cols, device='cpu')
    np.testing.assert_allclose(dirs, jax_chain(cols), rtol=0, atol=1e-9)
    assert int((gap < tc.ADJ_TIE).sum()) == 0
    # the three ethylenes overlap at the default 1.5 A: screen at 1.0 A
    kw = dict(clash_thresh=1.0, log=lambda *a: None)
    want_p, want_c = jc.cyclical_embed_trimol_rigid(
        je.objects, je.systematic_angles, pairing_ok=None, **kw)
    got_p, got_c = tc.cyclical_embed_trimol_rigid(
        te.objects, te.systematic_angles, pairing_ok=None, device='cpu',
        **kw)
    assert got_p.shape == want_p.shape and len(got_p) > 0
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_c, want_c)


def blocks_loop(mols, pairing_ok=None):
    '''Scalar-loop block construction of the three-molecule embed, which
    follows the JAX package's loop line by line: the oracle of
    trimol_rigid_blocks.'''
    offsets = (0, mols[0].n_atoms, mols[0].n_atoms + mols[1].n_atoms)
    blocks = []   # (confs, pivots, norms, polygon, dirs0, ids, first)
    for c2 in range(mols[1].n_confs):
        for c1 in range(mols[0].n_confs):
            for c3 in range(mols[2].n_confs):
                conf_ids = (c1, c2, c3)
                pl = [m.pivots[conf_ids[i]] for i, m in enumerate(mols)]
                for q2 in range(len(pl[1])):
                    for q1 in range(len(pl[0])):
                        for q3 in range(len(pl[2])):
                            pivots = [pl[0][q1], pl[1][q2], pl[2][q3]]
                            norms = np.array([np.linalg.norm(p.pivot)
                                              for p in pivots])
                            if not all(norms[i] < norms[i - 1] + norms[i - 2]
                                       for i in (0, 1, 2)):
                                continue       # the sides close no triangle
                            polygon = tl.polygonize(norms)      # (8, 3, 2, 3)
                            dirs0 = tc.get_directions(norms)
                            first = True
                            for v in range(8):
                                arr_ids = tc.cyclical_ids_trimol(pivots, v,
                                                              offsets)
                                if pairing_ok is not None and \
                                        not pairing_ok(arr_ids):
                                    continue
                                blocks.append((conf_ids, pivots, norms,
                                               polygon[v], dirs0, arr_ids,
                                               first))
                                first = False
    if not blocks:
        return None

    Bb = len(blocks)
    blk = {k: np.zeros((Bb, 3, 3)) for k in
           ('starts', 'ends', 'pvs', 'mds', 'apms', 'mps', 'rc_axes', 'verts',
            'dirs0')}
    blk['rc_src'] = np.zeros((Bb, 6, 3))
    blk['reset'] = np.zeros(Bb, dtype=bool)
    blk['confs'] = np.zeros((Bb, 3), dtype=np.int32)
    blk['ids'] = np.zeros((Bb, 3, 2), dtype=np.int64)
    for b, (conf_ids, pivots, norms, polygon, dirs0, arr_ids,
            first) in enumerate(blocks):
        blk['confs'][b] = conf_ids
        blk['ids'][b] = arr_ids
        blk['reset'][b] = first
        blk['dirs0'][b] = dirs0
        # the triangle's vertices in the plane z = 0
        a, b2, c = norms[0] ** 2, norms[1] ** 2, norms[2] ** 2
        x = (a - b2 + c) / (2 * a ** 0.5)
        blk['verts'][b, 1, 0] = norms[0]
        blk['verts'][b, 2, :2] = [x, (c - x ** 2) ** 0.5]
        for i, mol in enumerate(mols):
            blk['starts'][b, i], blk['ends'][b, i] = polygon[i]
            rc = mol.atomcoords[conf_ids[i]][mol.reactive_indices]
            apm = rc.mean(axis=0)
            md = pivots[i].meanpoint - apm
            if np.all(md == 0.):
                md = pivots[i].meanpoint
            blk['pvs'][b, i] = pivots[i].pivot
            blk['mps'][b, i] = pivots[i].meanpoint
            blk['apms'][b, i] = apm
            blk['mds'][b, i] = md
            blk['rc_axes'][b, i] = (rc[0] - rc[1]) if len(rc) == 2 \
                else pivots[i].pivot
        r = tc.facing_matrix(arr_ids, offsets)
        for k, (m, partner) in enumerate(tc._FACES):
            blk['rc_src'][b, k] = mols[m].atomcoords[0][r[m, partner]]
    return blk


def test_trimol_fast_blocks_equal_the_loop(tri3):
    '''The vectorised block construction against the scalar loop: every
    field equal, but verts and dirs0 within 1e-12 (array square roots
    where the loop raises scalars to the power 0.5); no block and no
    pivot give None; conformers that disagree on their pivots are
    refused; rows of side lengths give get_directions' rows.'''
    _, _, te = tri3
    fast = tc.trimol_rigid_blocks(te.objects, te.pairing_ok_fn())
    loop = blocks_loop(te.objects, te.pairing_ok_fn())
    assert set(fast) == set(loop)
    for k in loop:
        assert fast[k].dtype == loop[k].dtype and fast[k].shape == loop[k].shape
        if k in ('verts', 'dirs0'):
            np.testing.assert_allclose(fast[k], loop[k], rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(fast[k], loop[k], err_msg=k)
    assert tc.trimol_rigid_blocks(te.objects, lambda ids: False) is None
    assert blocks_loop(te.objects, lambda ids: False) is None

    import copy
    ragged = [copy.copy(m) for m in te.objects]
    ragged[1].pivots = list(ragged[1].pivots)
    ragged[1].pivots[1] = ragged[1].pivots[1][:1]
    with pytest.raises(ValueError, match='different pivots'):
        tc.trimol_rigid_blocks(ragged, te.pairing_ok_fn())
    ragged[1].pivots = [p[:0] for p in ragged[1].pivots]
    assert tc.trimol_rigid_blocks(ragged, te.pairing_ok_fn()) is None
    assert blocks_loop(ragged, te.pairing_ok_fn()) is None

    rng = np.random.default_rng(5)
    n = rng.uniform(1, 4, size=(400, 3))
    n = n[(n[:, 0] < n[:, 1] + n[:, 2]) & (n[:, 1] < n[:, 0] + n[:, 2])
          & (n[:, 2] < n[:, 0] + n[:, 1])]
    n = np.concatenate([n, [[3, 4, 5], [5, 3, 4], [4, 5, 3], [2, 2.1, 3.9],
                            [3.9, 2, 2.1]]])
    np.testing.assert_allclose(
        tc.get_directions_rows(n),
        np.array([tc.get_directions(x) for x in n]), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        tc.triangle_sides(n[:5]), [tl.polygonize(x)[0] for x in n[:5]])


def test_trimol_run_matches_jax(tri3):
    '''Embedder.run() on the input (BYPASS: embed and write): the
    embedded frames within 1e-6 A of the JAX run's, and the adjustment's
    seconds in the run report.'''
    path, _, _ = tri3
    d = os.path.dirname(path)
    cwd = os.getcwd()
    try:
        JaxEmbedder(path, stamp='jax').run()
        run = Embedder(path, stamp='port', device='cpu').run()
    finally:
        os.chdir(cwd)
    assert len(run.structures) == COUNTS_3[3]
    for tag in ('embedded', 'unoptimized'):
        got = read_xyz(os.path.join(d, f'tscode_{tag}_port.xyz')).atomcoords
        want = read_xyz(os.path.join(d, f'tscode_{tag}_jax.xyz')).atomcoords
        assert got.shape == want.shape == (COUNTS_3[3], 15, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with open(os.path.join(d, 'tscode_report_port.json')) as f:
        ce = json.load(f)['cyclical_embed']
    assert ce['blocks'] == COUNTS_3[2] and ce['adjust_near_ties'] == 0
    assert all(k in ce for k in ('blocks_s', 'adjust_s', 'screen_s',
                                 'dedup_s', 'assemble_s'))


def test_auto_chunk_at_the_default_three_molecule_grid():
    '''A = 216 (STEPS = 5, three molecules), N = 15: the (rows, A, A, N,
    3) gate intermediate of a chunk stays within GATE_BYTES in float64
    and float32.'''
    for itemsize in (8, 4):
        rows = tc._auto_chunk(10 ** 5, 216, 15, itemsize)
        assert rows >= 1
        assert rows * 216 * 216 * 15 * 3 * itemsize <= tc.GATE_BYTES
        assert (rows + 1) * 216 * 216 * 15 * 3 * itemsize > tc.GATE_BYTES
