'''The refine route on the CPU, float64: the port (tscode_tpu_torch)
against the JAX package. The graph part of torsions, the
symmetry-corrected RMSD prune (rot_rmsd) and ops/score module by module,
then REFINE through the CLI on the rigid cyclical route's 44-structure
output (44 -> 1, the RMSD stage), and REFINE on twisted copies of a
CF3-CH2-Cl rotor, which reach the symmetry-corrected stage.'''

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu import rot_rmsd as jrot
from tscode_tpu import torsions as jtor
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.graphs import graphize as jgraphize
from tscode_tpu.io_xyz import read_xyz
from tscode_tpu.ops import score as jscore
from tscode_tpu_torch import rot_rmsd as trot
from tscode_tpu_torch import torsions as ttor
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.io_xyz import write_xyz
from tscode_tpu_torch.ops import score as tscore
from tscode_tpu_torch.suite_inputs import chloroalkane, config_files, \
    refine_input
from torch_parity import t64, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, 'tests', 'fixtures')


def cf3_ch2_cl():
    '''The synthetic CF3-CH2-Cl rotor of tests/test_rot_rmsd.py: atom
    order chosen so the torsion representative is all-heavy
    (F-C-C-Cl).'''
    c1 = np.zeros(3)
    c2 = np.array([1.54, 0.0, 0.0])

    def tet(base, axis, r, phase):
        out = []
        axis = axis / np.linalg.norm(axis)
        perp = np.array([0.0, 1.0, 0.0])
        perp = perp - (perp @ axis) * axis
        perp /= np.linalg.norm(perp)
        third = np.cross(axis, perp)
        for k in range(3):
            ang = np.radians(phase + 120 * k)
            direction = (-axis * np.cos(np.radians(70.5))
                         + (perp * np.cos(ang) + third * np.sin(ang))
                         * np.sin(np.radians(70.5)))
            out.append(base + r * direction)
        return out

    f1, f2, f3 = tet(c1, c2 - c1, 1.33, 0.0)
    cl_and_hs = tet(c2, c1 - c2, 1.2, 60.0)
    cl = c2 + (cl_and_hs[0] - c2) / 1.2 * 1.77
    h1, h2 = cl_and_hs[1], cl_and_hs[2]
    return (np.array([f1, f2, f3, c1, c2, cl, h1, h2]),
            np.array([9, 9, 9, 6, 6, 17, 1, 1]))


def molecules():
    '''(name, coords, atomnos) of the graph-parity cases: the rotor, the
    fixtures with O-H and C=O groups, and a C8 chloroalkane chain.'''
    out = [('rotor',) + cf3_ch2_cl()]
    for name in ('C2F2H4.xyz', 'C2H4.xyz', 'HCOOH.xyz', 'HCOOOH.xyz'):
        ens = read_xyz(os.path.join(FIX, name))
        out.append((name, ens.atomcoords[0], ens.atomnos))
    out.append(('C8H17Cl',) + chloroalkane(8))
    return out


def torsion_rows(torsions):
    return [(t.torsion, t.n_fold) for t in torsions]


# --------------------------------------------------------------- torsions


@pytest.mark.parametrize('case', molecules(), ids=lambda c: c[0])
def test_torsion_graph_helpers_match_jax(case):
    '''Double bonds, hydrogen bonds, rotable torsions (with and without
    dummy rotors), n-fold, dummy flags and rotation masks: equal.'''
    _, coords, atomnos = case
    gt, gj = graphize(coords, atomnos), jgraphize(coords, atomnos)
    dbs = ttor.get_double_bonds_indices(coords, atomnos)
    assert dbs == jtor.get_double_bonds_indices(coords, atomnos)
    hbs = ttor.get_hydrogen_bonds(coords, atomnos, gt)
    assert hbs == jtor.get_hydrogen_bonds(coords, atomnos, gj)
    for keep in (False, True):
        got = ttor.get_torsions(gt, hbs, dbs, keepdummy=keep)
        want = jtor.get_torsions(gj, hbs, dbs, keepdummy=keep)
        assert torsion_rows(got) == torsion_rows(want)
    for t in ttor.get_torsions(gt, hbs, dbs, keepdummy=True):
        assert ttor._is_nondummy(t.i2, t.i3, gt) == \
            jtor._is_nondummy(t.i2, t.i3, gj)
        assert ttor._is_free(t.i2, gt) == jtor._is_free(t.i2, gj)
        np.testing.assert_array_equal(ttor.get_rotation_mask(gt, t.torsion),
                                      jtor.get_rotation_mask(gj, t.torsion))


def test_torsion_cases_are_not_trivial():
    rows = {name: ttor.get_torsions(graphize(c, a), [],
                                    ttor.get_double_bonds_indices(c, a),
                                    keepdummy=True)
            for name, c, a in molecules()}
    assert len(rows['C8H17Cl']) >= 5 and len(rows['rotor']) == 1
    assert rows['C2H4.xyz'] == []


# ---------------------------------------------------------------- rot_rmsd


def twisted_rotors(seed=1, noise=0.03, copies=2):
    '''Copies of the rotor with its CH2Cl end turned by multiples of 60
    degrees (0/120/240 are the CF3's symmetry twins) plus seeded noise.'''
    coords, atomnos = cf3_ch2_cl()
    mask = np.zeros(8, dtype=bool)
    mask[[5, 6, 7]] = True
    rng = np.random.default_rng(seed)
    frames = [trot._rotate(coords, (0, 3, 4, 5), ang, mask)
              + rng.normal(size=(8, 3)) * noise
              for _ in range(copies) for ang in (0, 120, 240, 60, 180, 300)]
    return np.array(frames), atomnos


def test_dummy_rotor_setup_matches_jax():
    '''Quads, angles, masks and local nodes equal; the hydrogen-bond
    edges are taken out of the graph again by both.'''
    coords, atomnos = cf3_ch2_cl()
    got = trot._dummy_torsion_setup(np.array([coords]), atomnos,
                                    graphize(coords, atomnos))
    want = jrot._dummy_torsion_setup(np.array([coords]), atomnos,
                                     jgraphize(coords, atomnos))
    quads, angles, masks, nodes, hbs = got
    assert quads == want[0] and [tuple(a) for a in angles] == \
        [tuple(a) for a in want[1]] == [(0, 120, 240)]
    for m_t, m_j in zip(masks, want[2]):
        np.testing.assert_array_equal(m_t, m_j)
    assert [sorted(n) for n in nodes] == [sorted(n) for n in want[3]]
    assert hbs == want[4] == []


def test_rotationally_corrected_rmsd_matches_jax():
    '''Corrected and plain rmsds within 1e-12 A over every pair of the
    twisted ensemble; the twins fall under 0.3 A only once corrected.'''
    frames, atomnos = twisted_rotors()
    frames = frames - frames.mean(axis=1, keepdims=True)
    setup = trot._dummy_torsion_setup(frames, atomnos,
                                      graphize(frames[0], atomnos))[:4]
    got = np.array([[trot.rotationally_corrected_rmsd(
        a, b.copy(), atomnos, *setup) for b in frames[:6]]
        for a in frames[:6]])
    want = np.array([[jrot.rotationally_corrected_rmsd(
        a, b.copy(), atomnos, *setup) for b in frames[:6]]
        for a in frames[:6]])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    heavy = atomnos != 1
    plain = trot._kabsch_rmsd(frames[0][heavy], frames[1][heavy])
    assert got[0, 1] < 0.3 < plain
    assert got[0, 3] > 0.3


@pytest.mark.parametrize('max_rmsd', [0.25, 0.3, 0.5])
def test_prune_rot_corr_mask_matches_jax(max_rmsd):
    frames, atomnos = twisted_rotors()
    _, got = trot.prune_conformers_rmsd_rot_corr(
        frames, atomnos, graphize(frames[0], atomnos), max_rmsd=max_rmsd)
    _, want = jrot.prune_conformers_rmsd_rot_corr(
        frames, atomnos, jgraphize(frames[0], atomnos), max_rmsd=max_rmsd)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_prune_rot_corr_skips_past_750_and_without_rotors():
    frames, atomnos = twisted_rotors(copies=126)
    g = graphize(frames[0], atomnos)
    assert trot.prune_conformers_rmsd_rot_corr(frames, atomnos,
                                               g)[1].all()
    ens = read_xyz(os.path.join(FIX, 'C2H4.xyz'))
    s = np.array([ens.atomcoords[0], ens.atomcoords[0] + 0.01])
    assert trot.prune_conformers_rmsd_rot_corr(
        s, ens.atomnos, graphize(s[0], ens.atomnos))[1].all()


# ------------------------------------------------------------------ score


def test_score_matches_jax():
    '''Scores within 1e-6 (both cast to float32), distances and fitness
    within 1e-12 A.'''
    rng = np.random.default_rng(4)
    s = rng.normal(size=(30, 11, 3)) * 2
    ci = rng.integers(0, 11, size=(30, 2, 2))
    dist = rng.uniform(1.5, 3.0, size=(30, 2))
    valid = rng.random((30, 2)) < 0.7
    ci_t = torch.as_tensor(ci)
    got = tscore.score_embed_poses(t64(s), ci_t, t64(dist))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        to_np(got), np.asarray(jscore.score_embed_poses(
            jnp.asarray(s), jnp.asarray(ci), jnp.asarray(dist))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        to_np(tscore.constrained_distances(t64(s), ci_t)),
        np.asarray(jscore.constrained_distances(jnp.asarray(s),
                                                jnp.asarray(ci))),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        to_np(tscore.fitness_scores(t64(s), ci_t, t64(dist),
                                    torch.as_tensor(valid))),
        np.asarray(jscore.fitness_scores(jnp.asarray(s), jnp.asarray(ci),
                                         jnp.asarray(dist),
                                         jnp.asarray(valid))),
        rtol=0, atol=1e-12)


# ------------------------------------------------------------ the route


def jax_run(path, stamp):
    cwd = os.getcwd()
    try:
        JaxEmbedder(path, stamp=stamp).run()
    finally:
        os.chdir(cwd)
    with open(os.path.join(os.path.dirname(path),
                           f'tscode_{stamp}.log')) as f:
        return f.read()


def port_cli(d, stamp):
    r = subprocess.run([sys.executable, '-m', 'tscode_tpu_torch',
                        'input.txt', '--device', 'cpu', '-n', stamp],
                       cwd=d, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(os.path.join(d, f'tscode_report_{stamp}.json')) as f:
        return json.load(f)


def frames_of(d, stamp):
    return read_xyz(os.path.join(d, f'tscode_unoptimized_{stamp}.xyz')
                    ).atomcoords


def test_cli_refine_on_the_cyclical_output_matches_jax(tmp_path):
    '''da_cyclical at 4 conformers through the port's CLI (44 frames),
    then REFINE on that file by both packages: 44 -> 44 after the
    compenetration check -> 1, the RMSD stage discarding 43; the frame
    within 1e-6 A of the JAX run's.'''
    (tmp_path / 'cyc').mkdir()
    (tmp_path / 'refine').mkdir()
    config_files('da_cyclical', str(tmp_path / 'cyc'), 4)
    port_cli(str(tmp_path / 'cyc'), 'cyc')
    d = str(tmp_path / 'refine')
    path = refine_input(os.path.join(str(tmp_path / 'cyc'),
                                     'tscode_unoptimized_cyc.xyz'), d)
    log = jax_run(path, 'jax')
    rep = port_cli(d, 'port')
    assert [(s['stage'], s['structures_in'], s['structures_out'])
            for s in rep['stages']] == [
        ('generate_candidates', 44, 44), ('compenetration_refining', 44, 44),
        ('similarity_refining', 44, 1)]
    assert rep['embed'] == 'refine' and rep['final_structures'] == 1
    assert [(s['stage'], s['structures_out']) for s in rep['similarity']] \
        == [('moi', 44), ('rmsd', 1), ('rmsd_rot_corr', 1)]
    assert 'Discarded 43 candidates for RMSD similarity (1 left' in log
    np.testing.assert_allclose(frames_of(d, 'port'), frames_of(d, 'jax'),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize('line', ['NOOPT REFINE RMSD=0.3\nens.xyz\n',
                                  'NOOPT RMSD=0.3\nrefine> ens.xyz\n'])
def test_refine_reaches_the_symmetry_corrected_stage(tmp_path, line):
    '''Twelve twisted rotor copies, by REFINE or the refine> operator:
    12 -> 10 (MOI) -> 6 (RMSD) -> 2 (symmetry-corrected RMSD), the same
    survivors as the JAX package within 1e-6 A.'''
    frames, atomnos = twisted_rotors()
    with open(tmp_path / 'ens.xyz', 'w') as f:
        for s in frames:
            write_xyz(s, atomnos, f, title='rotor')
    (tmp_path / 'input.txt').write_text(line)
    log = jax_run(str(tmp_path / 'input.txt'), 'jax')
    rep = port_cli(str(tmp_path), 'port')
    assert [(s['stage'], s['structures_in'], s['structures_out'])
            for s in rep['similarity']] == [
        ('moi', 12, 10), ('rmsd', 10, 6), ('rmsd_rot_corr', 6, 2)]
    assert re.search(r'Discarded 4 candidates for symmetry-corrected RMSD '
                     r'similarity \(2 left', log)
    np.testing.assert_allclose(frames_of(str(tmp_path), 'port'),
                               frames_of(str(tmp_path), 'jax'), rtol=0,
                               atol=1e-6)
