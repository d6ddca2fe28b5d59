'''The string embed on large molecules, CPU, float64: tscode_tpu_torch
against tscode_tpu on bench_suite's large_n_string (two C24H49Cl chains,
148-atom poses, P = 5,476 cross pairs) at 4 conformers: 576 candidates
-> 82 clash survivors.

It also pins down a flaw of the reference's semantics. The torsion
quadruplet [1, 0, 74, 75] (Cl-C0...C74-Cl across the reactive bond) has
both end bonds on the bond's axis (the sp3 orbital is built anti to Cl,
and the string embed aligns the two orbitals), so its dihedral is
rounding noise: the two packages give different angles for it, and the
novelty counts that rest on it differ. Every other fingerprint entry
agrees, and without the collinear quadruplets the novelty masks are
identical. The port keeps the reference's semantics (every quadruplet
stays in the fingerprints); the full novel count is not asserted.'''

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_suite
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.embeds.common import MaskedPullAccumulator, stacked_lobes
from tscode_tpu.embeds.string import _string_bcast_block
from tscode_tpu.graphs import get_quadruplets, get_sum_graph
from tscode_tpu.ops.clash import cross_fragment_pair_mask
from tscode_tpu.ops.tfd import is_new_structure_lru as jax_novelty
from tscode_tpu_torch.embeds.common import DeviceSurvivors, inputs_from_numpy
from tscode_tpu_torch.embeds.string import bcast_tiles, spin_angles
from tscode_tpu_torch.ops.tfd import (is_new_structure_lru,
                                      torsion_end_sines,
                                      torsion_fingerprints)

N_CONFS = 4
COUNTS = (576, 82)          # candidates, clash survivors (both packages)
COLLINEAR = [[1, 0, 74, 75]]
SINE_TOL = 1e-8             # end-angle sine at or below it: collinear
NOVEL_WITHOUT_COLLINEAR = 16


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    '''The input's molecules, set up by the JAX package's Embedder
    (DIST(a=3.2) rebuilds the orbitals), its spin angles and torsion
    quadruplets.'''
    d = tmp_path_factory.mktemp('large_n_string')
    saved = bench_suite.N_CONFS
    bench_suite.N_CONFS = N_CONFS
    try:
        inp = bench_suite._config_files('large_n_string', str(d))
    finally:
        bench_suite.N_CONFS = saved
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            emb = JaxEmbedder(inp, stamp='large_n')
        emb.logfile.close()
    finally:
        os.chdir(cwd)
    m1, m2 = emb.objects
    quads = np.asarray(get_quadruplets(get_sum_graph(
        (m1.graph, m2.graph), [[0, m1.n_atoms]])))
    return m1, m2, emb.systematic_angles, quads


@pytest.fixture(scope='module')
def jax_side(setup):
    '''The JAX package's broadcast grid block and device compaction:
    (survivor poses, survivor fingerprints, clash mask) as numpy.'''
    m1, m2, angles, quads = setup
    c1, v1 = stacked_lobes(m1)
    c2, v2 = stacked_lobes(m2)
    poses, ok, tfps = _string_bcast_block(
        jnp.asarray(m1.atomcoords), jnp.asarray(m2.atomcoords),
        jnp.asarray(c1), jnp.asarray(v1), jnp.asarray(c2), jnp.asarray(v2),
        jnp.asarray(cross_fragment_pair_mask((m1.n_atoms, m2.n_atoms))),
        jnp.asarray(quads, dtype=jnp.int32),
        jnp.asarray(np.asarray(angles, dtype=np.float64)), 1.5)
    acc = MaskedPullAccumulator(pull=False)
    acc.add((poses, tfps), ok, ok.shape[0])
    (kept, fps), mask = acc.finish()
    return np.asarray(kept), np.asarray(fps), np.asarray(mask)


@pytest.fixture(scope='module')
def port_side(setup):
    '''The port's broadcast tiles and device survivors, same outputs.'''
    m1, m2, angles, quads = setup
    inp = inputs_from_numpy(m1, m2, 'cpu', torch.float64)
    acc = DeviceSurvivors()
    for poses, ok in bcast_tiles(inp, spin_angles(angles, torch.float64,
                                                  'cpu'), 1.5):
        acc.add((poses,), ok)
    (kept,), mask = acc.finish()
    return kept, torsion_fingerprints(kept, quads).numpy(), np.asarray(mask)


def end_sines_np(poses, quads):
    '''numpy twin of torsion_end_sines: the smaller end-angle sine of
    each quadruplet, (S, Q).'''
    p = poses[:, quads]

    def sine(u, v):
        return np.linalg.norm(np.cross(u, v), axis=-1) / (
            np.linalg.norm(u, axis=-1) * np.linalg.norm(v, axis=-1))

    b, c = p[..., 1, :], p[..., 2, :]
    return np.minimum(sine(p[..., 0, :] - b, c - b),
                      sine(b - c, p[..., 3, :] - c))


def test_clash_survivors_match_jax(jax_side, port_side):
    '''The same 82 survivors of 576 candidates, in the same order.'''
    kept_j, _, mask_j = jax_side
    kept_t, _, mask_t = port_side
    assert (len(mask_t), int(mask_t.sum())) == COUNTS
    np.testing.assert_array_equal(mask_t, mask_j)
    assert kept_t.shape == (COUNTS[1], 148, 3)
    np.testing.assert_allclose(kept_t.numpy(), kept_j, rtol=0, atol=1e-6)


def test_collinear_quadruplet_is_the_cross_bond(setup, jax_side, port_side):
    '''Exactly one quadruplet has an end angle of 180 degrees in every
    survivor: [1, 0, 74, 75], Cl-C0...C74-Cl across the reactive bond.
    Every other end angle is far from straight.'''
    quads = setup[3]
    s_t = torsion_end_sines(port_side[0], quads).numpy()
    s_j = end_sines_np(jax_side[0], quads)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-12)
    col = (s_t <= SINE_TOL).any(axis=0)
    assert quads[col].tolist() == COLLINEAR
    assert s_t[:, col].max() < 1e-12
    assert s_t[:, ~col].min() > 0.5


def test_fingerprints_agree_off_the_axis(setup, jax_side, port_side):
    '''Within 1e-9 degrees wherever the end angles have a sine above
    1e-8: that is every entry except the collinear quadruplet's.'''
    quads = setup[3]
    fps_t, fps_j = port_side[1], jax_side[1]
    good = torsion_end_sines(port_side[0], quads).numpy() > SINE_TOL
    assert fps_t.shape == fps_j.shape == (COUNTS[1], len(quads))
    assert good.sum() == COUNTS[1] * (len(quads) - 1)
    diff = np.abs(fps_t.astype(np.float64) - fps_j.astype(np.float64))
    assert diff[good].max() <= 1e-9


def test_novelty_equal_without_collinear_quadruplets(setup, jax_side,
                                                     port_side):
    '''With the collinear quadruplets dropped from both sides, the two
    novelty replays keep the same rows.'''
    quads = setup[3]
    keep = ~(torsion_end_sines(port_side[0], quads).numpy()
             <= SINE_TOL).any(axis=0)
    rows = np.ones(COUNTS[1], dtype=bool)
    got = is_new_structure_lru(port_side[1][:, keep], rows, thresh=10)
    want = jax_novelty(jax_side[1][:, keep], rows, thresh=10)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == NOVEL_WITHOUT_COLLINEAR
