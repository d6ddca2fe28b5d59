'''The small helpers no route calls, float64 on the CPU, against the JAX
package's: linalg's safe_normalize, vec_angle, point_angle,
kabsch_align, transform_coords and triangle_sides_ok, clash's
count_intra_clashes and rmsd_prune's rmsd_similarity_sequential.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu.ops import clash as jclash
from tscode_tpu.ops import linalg as jL
from tscode_tpu.ops import rmsd_prune as jprune
from tscode_tpu_torch.ops import clash as tclash
from tscode_tpu_torch.ops import linalg as tL
from tscode_tpu_torch.ops import rmsd_prune as tprune
from torch_parity import t64, to_np

rng = np.random.default_rng(17)


def close(got, want, atol=1e-12):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_safe_normalize_matches_jax_and_maps_zero_to_zero():
    v = rng.normal(size=(5, 4, 3))
    v[0, 0] = 0.0
    close(tL.safe_normalize(t64(v)), jL.safe_normalize(jnp.asarray(v)))
    assert not torch.isnan(tL.safe_normalize(t64(v))).any()
    assert float(tL.safe_normalize(t64(v))[0, 0].abs().sum()) == 0.0


def test_vec_angle_and_point_angle_match_jax():
    v1, v2 = rng.normal(size=(2, 50, 3))
    v2[0] = 2.5 * v1[0]                      # parallel: the clip holds
    v2[1] = -v1[1]                           # antiparallel
    close(tL.vec_angle(t64(v1), t64(v2)), jL.vec_angle(v1, v2), atol=1e-9)
    p1, p2, p3 = rng.normal(size=(3, 50, 3))
    close(tL.point_angle(t64(p1), t64(p2), t64(p3)),
          jL.point_angle(p1, p2, p3), atol=1e-9)


@pytest.mark.parametrize('masked', [False, True])
def test_kabsch_align_matches_jax(masked):
    p = rng.normal(size=(20, 9, 3))
    q = rng.normal(size=(20, 9, 3))
    mask = rng.uniform(size=(20, 9)) > 0.3 if masked else None
    want = jL.kabsch_align(p, q, None if mask is None else jnp.asarray(mask))
    got = tL.kabsch_align(t64(p), t64(q),
                          None if mask is None else torch.as_tensor(mask))
    close(got, want, atol=1e-10)
    eye = got @ got.transpose(-1, -2)
    close(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-12)


def test_transform_coords_matches_jax():
    coords = rng.normal(size=(6, 10, 3))
    rot = np.asarray(jL.rot_mat_from_pointer(rng.normal(size=(6, 3)),
                                             rng.uniform(0, 360, 6)))
    pos = rng.normal(size=(6, 3))
    close(tL.transform_coords(t64(coords), t64(rot), t64(pos)),
          jL.transform_coords(coords, rot, pos))


def test_triangle_sides_ok_matches_jax():
    sides = rng.uniform(0.5, 3.0, size=(200, 3))
    sides[0] = (1.0, 1.0, 2.0)               # degenerate: not a triangle
    got = tL.triangle_sides_ok(t64(sides)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jL.triangle_sides_ok(sides)))
    assert 0 < got.sum() < len(got) and not got[0]


def test_count_intra_clashes_matches_jax():
    coords = rng.normal(size=(12, 15, 3)) * 1.2
    coords[0, 1] = coords[0, 0]              # coincident: excluded
    mask = rng.uniform(size=15) > 0.2
    for m in (None, mask):
        want = jclash.count_intra_clashes(
            coords, None if m is None else jnp.asarray(m), thresh=0.5)
        got = tclash.count_intra_clashes(t64(coords), m, thresh=0.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tclash.count_intra_clashes(t64(coords)).numpy(),
        tclash.count_intra_clashes_np(coords))
    assert got.sum() > 0


def test_rmsd_similarity_sequential_matches_jax():
    base = rng.normal(size=(9, 3)) * 2
    poses = base + rng.normal(size=(30, 9, 3)) * \
        rng.choice([0.05, 0.3, 0.8], size=(30, 1, 1))
    for i in range(10):
        for thr in (0.3, 0.5, 1.0):
            want = jprune.rmsd_similarity_sequential(poses[i], poses[i + 1:],
                                                     thr)
            got = tprune.rmsd_similarity_sequential(t64(poses[i]),
                                                    t64(poses[i + 1:]), thr)
            assert got == want
    assert tprune.rmsd_similarity_sequential(poses[0], poses[:0], 0.5) is \
        False
