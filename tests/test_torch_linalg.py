'''Geometry core parity, float64: tscode_tpu_torch.ops.linalg against
tscode_tpu.ops.linalg on the same numpy inputs, atol 1e-9.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu.ops import linalg as jl
from tscode_tpu_torch.ops import linalg as tl
from torch_parity import t64, to_np

ATOL = 1e-9
rng = np.random.default_rng(2024)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_normalize_and_quaternion_rotation():
    v = rng.normal(size=(40, 3))
    close(tl.normalize(t64(v)), jl.normalize(jnp.asarray(v)))
    q = rng.normal(size=(40, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    close(tl.quaternion_to_rotation_matrix(t64(q)),
          jl.quaternion_to_rotation_matrix(jnp.asarray(q)))


def test_rot_mat_from_pointer():
    ptr = rng.normal(size=(5, 7, 3))
    ang = rng.uniform(-360, 360, size=(5, 7))
    close(tl.rot_mat_from_pointer(t64(ptr), t64(ang)),
          jl.rot_mat_from_pointer(jnp.asarray(ptr), jnp.asarray(ang)))
    # a scalar angle broadcasts over the pointers
    close(tl.rot_mat_from_pointer(t64(ptr[0]), 90.0),
          jl.rot_mat_from_pointer(jnp.asarray(ptr[0]), 90.0))


@pytest.mark.parametrize('case', ['random', 'parallel', 'antiparallel',
                                  'near_antiparallel', 'axes'])
def test_rotation_matrix_from_vectors(case):
    a = rng.normal(size=(30, 3))
    if case == 'random':
        b = rng.normal(size=(30, 3))
    elif case == 'parallel':
        b = a * rng.uniform(0.5, 3.0, size=(30, 1))
    elif case == 'antiparallel':
        b = -a * rng.uniform(0.5, 3.0, size=(30, 1))
    elif case == 'near_antiparallel':
        b = -a + rng.normal(size=(30, 3)) * 1e-7
    else:   # the coordinate axes flipped (the fixed-z flip bug case)
        a = np.concatenate([np.eye(3), -np.eye(3)])
        b = -a
    R = tl.rotation_matrix_from_vectors(t64(a), t64(b))
    close(R, jl.rotation_matrix_from_vectors(jnp.asarray(a), jnp.asarray(b)))
    # and it really maps a onto b's direction with a proper rotation
    an = a / np.linalg.norm(a, axis=1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=1, keepdims=True)
    np.testing.assert_allclose(np.einsum('bij,bj->bi', to_np(R), an), bn,
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(to_np(R)), 1.0, atol=1e-9)


def test_rotation_matrix_from_vectors_broadcasts():
    a = rng.normal(size=(4, 1, 3))
    b = rng.normal(size=(1, 6, 3))
    close(tl.rotation_matrix_from_vectors(t64(a), t64(b)),
          jl.rotation_matrix_from_vectors(
              jnp.broadcast_to(jnp.asarray(a), (4, 6, 3)),
              jnp.broadcast_to(jnp.asarray(b), (4, 6, 3))))


def _pairs(n, N, noise):
    p = rng.normal(size=(n, N, 3)) * 1.5
    q = p + rng.normal(size=(n, N, 3)) * noise
    return p, q


def test_qcp_lambda_max_and_key_matrix():
    p, q = _pairs(64, 6, 0.3)
    S = np.einsum('bni,bnk->bik', p, q)
    GA = np.sum(p * p, axis=(-2, -1))
    GB = np.sum(q * q, axis=(-2, -1))
    lam_t = tl._qcp_lambda_max(t64(S), t64(GA), t64(GB))
    lam_j = jl._qcp_lambda_max(jnp.asarray(S), jnp.asarray(GA),
                               jnp.asarray(GB))
    close(lam_t, lam_j)
    close(tl._horn_key_matrix(t64(S)), jl._horn_key_matrix(jnp.asarray(S)))
    # it is the largest eigenvalue of Horn's key matrix
    K = to_np(tl._horn_key_matrix(t64(S)))
    np.testing.assert_allclose(to_np(lam_t), np.linalg.eigvalsh(K)[:, -1],
                               rtol=1e-10)


def test_qcp_lambda_max_float32_uses_12_newton_steps():
    p, q = _pairs(64, 4, 0.1)
    S = np.einsum('bni,bnk->bik', p, q).astype(np.float32)
    GA = np.sum(p * p, axis=(-2, -1)).astype(np.float32)
    GB = np.sum(q * q, axis=(-2, -1)).astype(np.float32)
    assert tl.newton_iters_for(torch.float32) == 12
    assert tl.newton_iters_for(torch.float64) == 30
    lam_t = tl._qcp_lambda_max(torch.as_tensor(S), torch.as_tensor(GA),
                               torch.as_tensor(GB))
    lam_j = jl._qcp_lambda_max(jnp.asarray(S), jnp.asarray(GA),
                               jnp.asarray(GB))
    assert lam_t.dtype == torch.float32
    np.testing.assert_allclose(to_np(lam_t), np.asarray(lam_j), rtol=1e-5)


def test_quaternion_from_key():
    p, q = _pairs(64, 5, 0.4)
    S = np.einsum('bni,bnk->bik', p, q)
    S[0] = 0.0                           # degenerate: identity fallback
    GA = np.sum(p * p, axis=(-2, -1))
    GB = np.sum(q * q, axis=(-2, -1))
    GA[0] = GB[0] = 0.0
    K = np.asarray(jl._horn_key_matrix(jnp.asarray(S)))
    lam = np.asarray(jl._qcp_lambda_max(jnp.asarray(S), jnp.asarray(GA),
                                        jnp.asarray(GB)))
    got = tl._quaternion_from_key(t64(K), t64(lam))
    close(got, jl._quaternion_from_key(jnp.asarray(K), jnp.asarray(lam)))
    np.testing.assert_array_equal(to_np(got)[0], [1.0, 0.0, 0.0, 0.0])


def test_rmsd_and_max():
    p, q = _pairs(50, 7, 0.5)
    r_t, m_t = tl.rmsd_and_max(t64(p), t64(q))
    r_j, m_j = jl.rmsd_and_max(jnp.asarray(p), jnp.asarray(q))
    close(r_t, r_j)
    close(m_t, m_j)

    mask = rng.uniform(size=(50, 7)) > 0.3
    r_t, m_t = tl.rmsd_and_max(t64(p), t64(q), mask=torch.as_tensor(mask))
    r_j, m_j = jl.rmsd_and_max(jnp.asarray(p), jnp.asarray(q),
                               mask=jnp.asarray(mask))
    close(r_t, r_j)
    close(m_t, m_j)


def test_dihedral():
    p = rng.normal(size=(300, 4, 3)) * 1.5
    close(tl.dihedral(t64(p)), jl.dihedral(jnp.asarray(p)))


def test_inertia_moments_and_eigvalsh3():
    coords = rng.normal(size=(40, 9, 3)) * 1.5
    masses = rng.uniform(1.0, 35.0, size=9)
    close(tl.center_of_mass(t64(coords), t64(masses)),
          jl.center_of_mass(jnp.asarray(coords), jnp.asarray(masses)))
    close(tl.inertia_tensor(t64(coords), t64(masses)),
          jl.inertia_tensor(jnp.asarray(coords), jnp.asarray(masses)))
    moments = tl.get_inertia_moments(t64(coords), t64(masses))
    close(moments, jl.get_inertia_moments(jnp.asarray(coords),
                                          jnp.asarray(masses)))
    I = to_np(tl.inertia_tensor(t64(coords), t64(masses)))
    np.testing.assert_allclose(to_np(moments), np.linalg.eigvalsh(I),
                               rtol=1e-10)

    # symmetric matrices, one isotropic (p = 0). (At an exact double
    # root the Newton polish divides by a vanishing derivative in both
    # packages, and the two round differently there.)
    A = rng.normal(size=(30, 3, 3))
    A = A + np.swapaxes(A, -1, -2)
    A[0] = 2.5 * np.eye(3)
    close(tl.det3(t64(A)), jl.det3(jnp.asarray(A)))
    close(tl.eigvalsh3(t64(A)), jl.eigvalsh3(jnp.asarray(A)))


def test_cartesian_product():
    arrays = (np.arange(3), np.arange(2) + 10, np.arange(4) * 2)
    got = tl.cartesian_product(*arrays)
    np.testing.assert_array_equal(got, jl.cartesian_product(*arrays))
    pair = tl.cartesian_product(np.arange(3), np.arange(2))
    assert pair[:, 0].tolist() == [0, 1, 2, 0, 1, 2]    # first fastest


@pytest.mark.parametrize('batch', [(), (6,), (3, 4)])
def test_rotate_dihedral(batch):
    '''A masked rotation about a torsion's central bond, batched over
    the leading axes of the coordinates and the angles.'''
    coords = rng.normal(size=batch + (9, 3)) * 1.5
    angles = rng.uniform(-360, 360, size=batch)
    quad = np.array([1, 3, 4, 7])
    move = np.zeros(9, dtype=bool)
    move[[4, 5, 7, 8]] = True
    got = tl.rotate_dihedral(t64(coords), quad, t64(angles), move)
    close(got, jl.rotate_dihedral(jnp.asarray(coords), jnp.asarray(quad),
                                  jnp.asarray(angles), jnp.asarray(move)))
    # the unmasked atoms stay exactly where they were
    np.testing.assert_array_equal(to_np(got)[..., ~move, :], coords[..., ~move, :])
