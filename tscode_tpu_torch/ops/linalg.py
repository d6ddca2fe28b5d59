'''
Batched geometry core in PyTorch: the part of tscode_tpu/ops/linalg.py
that the ported routes run (the embed -> clash -> RMSD-prune slice and
the string route's torsion fingerprints and moments of inertia).

Every function is batched over leading axes and keeps the JAX package's
operation order, so float64 results agree with it to roundoff.
Conventions as there: angles in degrees, coordinates in Angstrom,
rotation matrices act on column vectors (R @ x), quaternions fed to
quaternion_to_rotation_matrix are scalar-LAST (x, y, z, w) and Horn's
eigenvectors are scalar-first (w, x, y, z).
'''

import math

import numpy as np
import torch

from tscode_tpu_torch.errors import TriangleError


def norm_of(vec, dim=-1):
    '''Euclidean norm along `dim`.'''
    return torch.sqrt(torch.sum(vec * vec, dim=dim))


def normalize(vec, dim=-1):
    '''Unit vector(s) along `dim`.'''
    return vec / norm_of(vec, dim=dim).unsqueeze(-1)


def safe_normalize(vec, dim=-1, eps=1e-30):
    '''Unit vector(s); zero vectors map to zero instead of NaN.'''
    return vec / torch.clamp(norm_of(vec, dim=dim), min=eps).unsqueeze(-1)


def vec_angle(v1, v2):
    '''Angle between vectors in degrees, batched.'''
    cos = torch.sum(normalize(v1) * normalize(v2), dim=-1)
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def point_angle(p1, p2, p3):
    '''Angle p1-p2-p3 in degrees, batched.'''
    return vec_angle(p1 - p2, p3 - p2)


def dihedral(p):
    '''Praxeolitic dihedral angle in degrees from 4 points.
    p: (..., 4, 3) -> (...,).'''
    p0, p1, p2, p3 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]

    b0 = -(p1 - p0)
    b1 = normalize(p2 - p1)
    b2 = p3 - p2

    v = b0 - torch.sum(b0 * b1, dim=-1, keepdim=True) * b1
    w = b2 - torch.sum(b2 * b1, dim=-1, keepdim=True) * b1

    x = torch.sum(v * w, dim=-1)
    y = torch.sum(torch.linalg.cross(b1, v, dim=-1) * w, dim=-1)
    return torch.atan2(y, x) * (180.0 / math.pi)


def quaternion_to_rotation_matrix(q):
    '''Quaternion (scalar-LAST: x, y, z, w) -> rotation matrix, batched.
    q: (..., 4) -> (..., 3, 3).'''
    q1, q2, q3, q0 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    r00 = 2 * (q0 * q0 + q1 * q1) - 1
    r01 = 2 * (q1 * q2 - q0 * q3)
    r02 = 2 * (q1 * q3 + q0 * q2)
    r10 = 2 * (q1 * q2 + q0 * q3)
    r11 = 2 * (q0 * q0 + q2 * q2) - 1
    r12 = 2 * (q2 * q3 - q0 * q1)
    r20 = 2 * (q1 * q3 - q0 * q2)
    r21 = 2 * (q2 * q3 + q0 * q1)
    r22 = 2 * (q0 * q0 + q3 * q3) - 1

    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_mat_from_pointer(pointer, angle_deg):
    '''Axis-angle rotation matrix, batched: pointer (..., 3),
    angle_deg (...,) tensor or number -> (..., 3, 3).'''
    pointer = normalize(pointer)
    angle = torch.as_tensor(angle_deg, dtype=pointer.dtype,
                            device=pointer.device)
    half = torch.deg2rad(angle) / 2.0
    s, c = torch.sin(half), torch.cos(half)
    xyz = s.unsqueeze(-1) * pointer
    w = c.unsqueeze(-1).expand(xyz.shape[:-1] + (1,))
    return quaternion_to_rotation_matrix(torch.cat([xyz, w], dim=-1))


def rotate_dihedral(coords, quad, angle_deg, move_mask):
    """Rotate the masked atoms of a molecule by `angle_deg` about the
    i2-i3 bond of a torsion quadruplet, batched over the leading axes of
    coords (..., N, 3) and angle_deg (...,); quad (4,) ints, move_mask
    (N,) bool."""
    i2, i3 = int(quad[1]), int(quad[2])
    mat = rot_mat_from_pointer(coords[..., i2, :] - coords[..., i3, :],
                               angle_deg)
    center = coords[..., i3, :].unsqueeze(-2)
    moved = torch.einsum('...ij,...nj->...ni', mat, coords - center) + center
    mask = torch.as_tensor(move_mask, dtype=torch.bool, device=coords.device)
    return torch.where(mask[..., None], moved, coords)


def rotation_matrix_from_vectors(vec1, vec2, eps=1e-12):
    '''Rotation aligning vec1 onto vec2 (Rodrigues), batched with
    broadcasting and branch-free. The parallel case gives the identity;
    the antiparallel case a 180 degree turn about an axis perpendicular
    to vec1, split on the sign of the dot product (the JAX package's
    fix of the reference's fixed-z flip).'''
    a = normalize(vec1)
    b = normalize(vec2)
    a, b = torch.broadcast_tensors(a, b)
    v = torch.linalg.cross(a, b, dim=-1)
    c = torch.sum(a * b, dim=-1)
    s2 = torch.sum(v * v, dim=-1)

    zeros = torch.zeros_like(v[..., 0])
    kmat = torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
    ], dim=-2)

    # built on the device, with no copy from the host, so that a CUDA
    # graph can capture this function (the headline program)
    eye3 = torch.eye(3, dtype=v.dtype, device=v.device)
    eye = eye3.expand(kmat.shape)
    factor = (1 - c) / torch.clamp(s2, min=eps)
    general = eye + kmat + (kmat @ kmat) * factor[..., None, None]

    helper = torch.where(torch.abs(a[..., :1]) < 0.9, eye3[0], eye3[1])
    perp = normalize(torch.linalg.cross(a, helper, dim=-1))
    antiparallel = rot_mat_from_pointer(
        perp, torch.full(v.shape[:-1], 180.0, dtype=v.dtype,
                         device=v.device))
    degenerate = torch.where((c < 0.0)[..., None, None], antiparallel, eye)
    return torch.where((s2 > eps)[..., None, None], general, degenerate)


# ------------------------------------------- QCP quaternion Kabsch engine


def _horn_key_matrix(S):
    '''Horn's symmetric 4x4 key matrix (quaternion order w, x, y, z)
    from the 3x3 correlation S = sum_i p_i q_i^T. (..., 3, 3) ->
    (..., 4, 4).'''
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]

    k00 = Sxx + Syy + Szz
    k01 = Syz - Szy
    k02 = Szx - Sxz
    k03 = Sxy - Syx
    k11 = Sxx - Syy - Szz
    k12 = Sxy + Syx
    k13 = Szx + Sxz
    k22 = -Sxx + Syy - Szz
    k23 = Syz + Szy
    k33 = -Sxx - Syy + Szz

    row0 = torch.stack([k00, k01, k02, k03], dim=-1)
    row1 = torch.stack([k01, k11, k12, k13], dim=-1)
    row2 = torch.stack([k02, k12, k22, k23], dim=-1)
    row3 = torch.stack([k03, k13, k23, k33], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def newton_iters_for(dtype):
    '''Newton steps of the QCP lambda_max iteration: 30 in float64,
    12 in float32 (quadratic convergence from the upper-bound seed).'''
    return 30 if dtype == torch.float64 else 12


def _qcp_lambda_max(S, GA, GB, newton_iters=None):
    '''Largest eigenvalue of Horn's key matrix by Theobald's QCP: Newton
    on the characteristic quartic, seeded at (GA + GB)/2, denominator
    guarded at 1e-30. S (..., 3, 3); GA, GB (...,) squared norms.'''
    if newton_iters is None:
        newton_iters = newton_iters_for(S.dtype)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]

    Sxx2, Syy2, Szz2 = Sxx * Sxx, Syy * Syy, Szz * Szz
    Sxy2, Syz2, Sxz2 = Sxy * Sxy, Syz * Syz, Sxz * Sxz
    Syx2, Szy2, Szx2 = Syx * Syx, Szy * Szy, Szx * Szx

    SyzSzymSyySzz2 = 2.0 * (Syz * Szy - Syy * Szz)
    Sxx2Syy2Szz2Syz2Szy2 = Syy2 + Szz2 - Sxx2 + Syz2 + Szy2

    # characteristic quartic: x^4 + C2 x^2 + C1 x + C0
    C2 = -2.0 * (Sxx2 + Syy2 + Szz2 + Sxy2 + Syx2 + Sxz2 + Szx2 + Syz2
                 + Szy2)
    C1 = 8.0 * (Sxx * Syz * Szy + Syy * Szx * Sxz + Szz * Sxy * Syx
                - Sxx * Syy * Szz - Syz * Szx * Sxy - Szy * Syx * Sxz)

    SxzpSzx = Sxz + Szx
    SyzpSzy = Syz + Szy
    SxypSyx = Sxy + Syx
    SyzmSzy = Syz - Szy
    SxzmSzx = Sxz - Szx
    SxymSyx = Sxy - Syx
    SxxpSyy = Sxx + Syy
    SxxmSyy = Sxx - Syy
    Sxy2Sxz2Syx2Szx2 = Sxy2 + Sxz2 - Syx2 - Szx2

    C0 = Sxy2Sxz2Syx2Szx2 * Sxy2Sxz2Syx2Szx2 \
        + (Sxx2Syy2Szz2Syz2Szy2 + SyzSzymSyySzz2) \
        * (Sxx2Syy2Szz2Syz2Szy2 - SyzSzymSyySzz2) \
        + (-(SxzpSzx) * SyzmSzy + SxymSyx * (SxxmSyy - Szz)) \
        * (-(SxzmSzx) * SyzpSzy + SxymSyx * (SxxmSyy + Szz)) \
        + (-(SxzpSzx) * SyzpSzy - SxypSyx * (SxxpSyy - Szz)) \
        * (-(SxzmSzx) * SyzmSzy - SxypSyx * (SxxpSyy + Szz)) \
        + (SxypSyx * SyzpSzy + SxzpSzx * (SxxmSyy + Szz)) \
        * (-(SxymSyx) * SyzmSzy + SxzpSzx * (SxxpSyy + Szz)) \
        + (SxypSyx * SyzmSzy + SxzmSzx * (SxxmSyy - Szz)) \
        * (-(SxymSyx) * SyzpSzy + SxzmSzx * (SxxpSyy - Szz))

    lam = 0.5 * (GA + GB)
    for _ in range(newton_iters):
        lam2 = lam * lam
        b = (lam2 + C2) * lam
        a = b + C1
        num = a * lam + C0
        den = 2.0 * lam2 * lam + b + a
        lam = lam - num / torch.where(torch.abs(den) > 1e-30, den, 1e-30)
    return lam


def _quaternion_from_key(K, lam):
    '''Unit quaternion (w, x, y, z): eigenvector of K for eigenvalue lam,
    taken from the adjugate of (K - lam I). Of its four rows the FIRST
    one of largest squared norm is used; when that norm is <= 1e-22 the
    identity quaternion is returned. K (..., 4, 4), lam (...,) ->
    (..., 4).'''
    a = [[K[..., i, j] - lam if i == j else K[..., i, j]
          for j in range(4)] for i in range(4)]

    def minor3(rows, cols):
        m = [[a[i][j] for j in cols] for i in rows]
        return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
                - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
                + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))

    idx = [0, 1, 2, 3]
    cands, norms2 = [], []
    for r in range(4):
        rows = [i for i in idx if i != r]
        comps = [(-1.0) ** (r + c) * minor3(rows, [j for j in idx if j != c])
                 for c in range(4)]
        cands.append(comps)
        norms2.append(comps[0] * comps[0] + comps[1] * comps[1]
                      + comps[2] * comps[2] + comps[3] * comps[3])

    best_n2 = torch.maximum(torch.maximum(norms2[0], norms2[1]),
                            torch.maximum(norms2[2], norms2[3]))
    is_best = [norms2[0] == best_n2]
    taken = is_best[0]
    for r in range(1, 4):
        hit = (norms2[r] == best_n2) & ~taken
        is_best.append(hit)
        taken = taken | hit
    q = torch.stack(
        [sum(torch.where(is_best[r], cands[r][c], 0.0) for r in range(4))
         for c in range(4)], dim=-1)
    qn2 = torch.sum(q * q, dim=-1, keepdim=True)

    identity = torch.zeros_like(q)
    identity[..., 0] = 1.0
    return torch.where(qn2 > 1e-22,
                       q / torch.sqrt(torch.clamp(qn2, min=1e-30)), identity)


def rotation_from_key(S, lam):
    '''Optimal rotation (R p ~ q) from the correlation S and its
    lambda_max, through Horn's eigenvector.'''
    q_wxyz = _quaternion_from_key(_horn_key_matrix(S), lam)
    q_xyzw = torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)
    return quaternion_to_rotation_matrix(q_xyzw)


def kabsch_rotation_from_correlation(S, GA=None, GB=None):
    '''Proper rotation R maximising sum_i q_i . (R p_i) from the
    correlation S = sum_i p_i q_i^T, closed form and branch-free.
    Without the squared norms GA, GB, Newton is seeded at the bound
    sqrt(3) ||S||_F. Batched: S (..., 3, 3) -> R (..., 3, 3).'''
    if GA is None:
        GA = GB = math.sqrt(3.0) * torch.sqrt(torch.sum(S * S, dim=(-2, -1)))
    return rotation_from_key(S, _qcp_lambda_max(S, GA, GB))


def align_vec_pair(ref, tgt):
    '''Rotation R with R @ tgt_j ~ ref_j for the two vectors of each
    pair. Batched: ref, tgt (..., 2, 3) -> (..., 3, 3).'''
    S = torch.einsum('...ji,...jk->...ik', tgt, ref)
    GA = torch.sum(tgt * tgt, dim=(-2, -1))
    GB = torch.sum(ref * ref, dim=(-2, -1))
    return kabsch_rotation_from_correlation(S, GA, GB)


def kabsch_align(p, q, mask=None):
    '''Rotation R such that (R @ p_i) optimally overlays q_i (no
    centering), optionally over the atoms of `mask` (..., N) only.
    Batched: p, q (..., N, 3) -> (..., 3, 3).'''
    if mask is not None:
        m = mask[..., None].to(p.dtype)
        p, q = p * m, q * m
    S = torch.einsum('...ni,...nk->...ik', p, q)
    GA = torch.sum(p * p, dim=(-2, -1))
    GB = torch.sum(q * q, dim=(-2, -1))
    return kabsch_rotation_from_correlation(S, GA, GB)


def transform_coords(coords, rot, pos):
    '''Rotate and translate coordinate blocks, batched: coords
    (..., N, 3), rot (..., 3, 3), pos (..., 3) -> (..., N, 3).'''
    return torch.einsum('...ij,...nj->...ni', rot, coords) + pos[..., None, :]


def triangle_sides_ok(lengths):
    '''Triangle inequality mask for batched side lengths (..., 3).'''
    l0, l1, l2 = lengths[..., 0], lengths[..., 1], lengths[..., 2]
    return (l0 < l1 + l2) & (l1 < l2 + l0) & (l2 < l0 + l1)


def rmsd_and_max(p, q, mask=None):
    '''Kabsch RMSD and maximum per-atom deviation WITHOUT centering.
    Batched: p, q (..., N, 3), optional mask (..., N) for padded atoms.
    Returns (rmsd, maxdev), each (...,).'''
    if mask is not None:
        m = mask[..., None].to(p.dtype)
        p, q = p * m, q * m
        n = torch.sum(mask, dim=-1).to(p.dtype)
    else:
        n = torch.tensor(float(p.shape[-2]), dtype=p.dtype, device=p.device)

    S = torch.einsum('...ni,...nk->...ik', p, q)
    GA = torch.sum(p * p, dim=(-2, -1))
    GB = torch.sum(q * q, dim=(-2, -1))
    R = rotation_from_key(S, _qcp_lambda_max(S, GA, GB))

    diff = torch.einsum('...ij,...nj->...ni', R, p) - q
    if mask is not None:
        diff = diff * mask[..., None].to(p.dtype)
    msd = torch.sum(diff * diff, dim=(-2, -1)) / torch.clamp(n, min=1.0)
    rmsd = torch.sqrt(torch.clamp(msd, min=0.0))
    maxdev = torch.amax(norm_of(diff), dim=-1)
    return rmsd, maxdev


# ------------------------------------------------ inertia / mass properties


def det3(A):
    '''Closed-form determinant of batched 3x3 matrices.'''
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def center_of_mass(coords, masses):
    '''COM, batched: coords (..., N, 3), masses (N,) or (..., N).'''
    w = torch.sum(coords * masses[..., None], dim=-2)
    return w / torch.sum(masses, dim=-1)[..., None]


def eigvalsh3(A):
    '''Eigenvalues (ascending) of symmetric 3x3 matrices: the
    trigonometric closed form, two Newton polishes on the characteristic
    polynomial, then a sort. (..., 3, 3) -> (..., 3).'''
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    q = tr / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))

    safe_p = torch.where(p > 1e-30, p, torch.ones_like(p))
    C = B / safe_p[..., None, None]
    r = torch.clamp(det3(C) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    two_p = 2.0 * p
    e3 = q + two_p * torch.cos(phi)                            # largest
    e1 = q + two_p * torch.cos(phi + 2.0 * math.pi / 3.0)      # smallest
    e2 = 3.0 * q - e1 - e3
    evs = torch.stack([e1, e2, e3], dim=-1)

    # Newton on p(x) = x^3 - c2 x^2 + c1 x - c0
    c2 = tr
    c0 = det3(A)
    c1 = 0.5 * (c2 * c2 - torch.diagonal(A @ A, dim1=-2, dim2=-1).sum(-1))
    for _ in range(2):
        f = ((evs - c2[..., None]) * evs + c1[..., None]) * evs \
            - c0[..., None]
        df = (3.0 * evs - 2.0 * c2[..., None]) * evs + c1[..., None]
        evs = evs - f / torch.where(torch.abs(df) > 1e-30, df,
                                    torch.full_like(df, 1e-30))
    evs = torch.sort(evs, dim=-1).values
    return torch.where((p > 1e-30)[..., None], evs,
                       torch.stack([q, q, q], dim=-1))


def inertia_tensor(coords, masses):
    '''Inertia tensor about the COM. coords (..., N, 3), masses (N,).'''
    com = center_of_mass(coords, masses)
    x = coords - com[..., None, :]
    r2 = torch.sum(x * x, dim=-1)                              # (..., N)
    eye = torch.eye(3, dtype=coords.dtype, device=coords.device)
    term1 = torch.sum((masses * r2)[..., None, None] * eye, dim=-3)
    term2 = torch.einsum('...n,...ni,...nj->...ij',
                         masses * torch.ones_like(r2), x, x)
    return term1 - term2


def get_inertia_moments(coords, masses):
    '''Principal moments of inertia, ascending: (..., N, 3) -> (..., 3).
    Computed in the inputs' dtype; on CUDA, backend.get_device keeps
    float32 products out of TF32.'''
    return eigvalsh3(inertia_tensor(coords, masses))


# ----------------------------------------------------------- index helpers


def cartesian_product(*arrays):
    '''Host numpy: rows of the cartesian product, FIRST array varying
    fastest (the reference's generation order).'''
    return np.stack(np.meshgrid(*arrays), -1).reshape(-1, len(arrays))


def polygonize(lengths):
    '''Host numpy: polygon-side vertex couples of a cyclical embed.
    lengths (2,) -> (2, 2, 2, 3): two x-axis segments centred on the
    origin, orientation 1 reversing the second (antiparallel pivots).
    lengths (3,) -> (8, 3, 2, 3): the eight oriented triangles, in the
    reference's flip-set order; TriangleError when the sides cannot
    close.'''
    lengths = np.asarray(lengths, dtype=float)
    assert len(lengths) in (2, 3)

    if len(lengths) == 2:
        ends = np.outer(lengths / 2.0, [1.0, 0.0, 0.0])   # (2, 3)
        segments = np.stack([-ends, ends], axis=1)        # (mol, 2, 3)
        return np.stack([segments,
                         segments * [[[1]], [[-1]]]])     # (2, 2, 2, 3)

    if not np.all(lengths < np.roll(lengths, 1) + np.roll(lengths, 2)):
        raise TriangleError(
            f'Impossible to build a triangle with sides {lengths}')

    # base along +x, apex above it (law of cosines)
    base, flank, closing = lengths
    apex_x = (base * base - flank * flank + closing * closing) / (2 * base)
    apex = np.array([apex_x, np.sqrt(closing * closing - apex_x * apex_x), 0])
    vertices = np.array([[0.0, 0.0, 0.0], [base, 0.0, 0.0], apex])
    sides = vertices[[[0, 1], [1, 2], [2, 0]]]            # (side, 2, 3)

    flip_sets = [(), (2,), (1,), (1, 2), (0,), (0, 1), (0, 2), (0, 1, 2)]
    out = np.broadcast_to(sides, (8,) + sides.shape).copy()
    for orient, flips in enumerate(flip_sets):
        for side in flips:
            out[orient, side] = out[orient, side, ::-1]
    return out


def polygonize_digons(lengths):
    '''Batched two-molecule polygonize on tensors: lengths (..., 2) ->
    vertices (..., 2, 2, 2, 3) [orientation, molecule, start/end, xyz].'''
    half = lengths / 2.0
    zeros = torch.zeros_like(half[..., 0])

    def seg(h):
        start = torch.stack([-h, zeros, zeros], dim=-1)
        end = torch.stack([h, zeros, zeros], dim=-1)
        return torch.stack([start, end], dim=-2)

    m0 = seg(half[..., 0])
    m1 = seg(half[..., 1])
    orient0 = torch.stack([m0, m1], dim=-3)
    orient1 = torch.stack([m0, -m1], dim=-3)
    return torch.stack([orient0, orient1], dim=-4)
