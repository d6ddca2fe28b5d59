'''
Vibrational analysis and ideal-gas RRHO thermochemistry (counterpart of
tscode_tpu/vibrations.py).

The internal force field is differentiable, so the mass-weighted Hessian
of a structure, or of a whole batch of structures, comes from
torch.func.hessian (torch.func.vmap over the batch), and the RRHO
corrections are closed-form on top of the eigenvalues. A surface given
by a gradient callback gets its Hessian from central differences of the
gradient instead.

Frequencies are float64 always, on the `device` the caller names: in
float32 the eigensolve of the mass-weighted Hessian reports spurious
near-zero imaginary modes.

Conventions: coordinates in Angstrom, energies in kcal/mol, masses in
amu. Frequencies are returned in cm^-1, imaginary modes as negative
numbers, with the count of imaginary modes beside them.
'''

import numpy as np
import torch

from tscode_tpu_torch.backend import traced
from tscode_tpu_torch.pt import MASSES

# sqrt(kcal/mol / (amu * A^2)) -> cm^-1
# lambda_SI = lambda * 4184 / (N_A * amu_kg * 1e-20)  [s^-2]; amu_kg*N_A = 1e-3
_KCAL_PER_MOL = 4184.0                      # J/mol
_C_CM = 2.99792458e10                       # speed of light, cm/s
_FREQ_FACTOR = np.sqrt(_KCAL_PER_MOL / 1e-23) / (2.0 * np.pi * _C_CM)

# thermochemistry constants
_KB = 0.0019872042586408316                 # kcal/mol/K (R in kcal)
_H_PLANCK = 6.62607015e-34                  # J s
_KB_J = 1.380649e-23                        # J/K
_AMU = 1.66053906892e-27                    # kg
_NA = 6.02214076e23


def _f64(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def _hessian_of(energy_fn, n):
    '''x (3N,) -> the Hessian (3N, 3N) of energy_fn(x as (N, 3)).'''
    return torch.func.hessian(lambda x: energy_fn(x.reshape(n, 3)))


def mass_weighted_hessian(energy_fn, coords, masses):
    '''Dense mass-weighted Hessian (3N, 3N) of a differentiable
    energy_fn(coords (N, 3)) -> scalar at coords (N, 3) tensor; masses
    (N,) tensor in amu.'''
    n = coords.shape[-2]
    hess = _hessian_of(energy_fn, n)(coords.reshape(-1))
    w = 1.0 / torch.sqrt(torch.repeat_interleave(masses, 3))
    return hess * w[:, None] * w[None, :]


def _tr_rot_projector(coords, masses):
    '''Projector removing translations and infinitesimal rotations from a
    mass-weighted Hessian (Eckart frame): coords (..., N, 3), masses (N,)
    -> (..., 3N, 3N).'''
    n = coords.shape[-2]
    batch = coords.shape[:-2]
    sqm = torch.sqrt(masses)[:, None]
    com = torch.sum(coords * masses[:, None], dim=-2, keepdim=True) / \
        torch.sum(masses)
    x = coords - com
    eye = torch.eye(3, dtype=coords.dtype, device=coords.device)

    basis = []
    for ax in range(3):                               # translations
        basis.append((eye[ax] * sqm).expand_as(x).reshape(*batch, 3 * n))
    for ax in range(3):                               # rotations
        r = torch.linalg.cross(eye[ax].expand_as(x), x, dim=-1) * sqm
        basis.append(r.reshape(*batch, 3 * n))
    b = torch.stack(basis, dim=-1)                    # (..., 3N, 6)

    # orthonormalize, dropping near-null vectors (linear molecules)
    q, r = torch.linalg.qr(b)
    keep = torch.abs(torch.diagonal(r, dim1=-2, dim2=-1)) > 1e-8
    q = q * keep[..., None, :]
    return torch.eye(3 * n, dtype=coords.dtype, device=coords.device) - \
        q @ q.transpose(-1, -2)


def _wavenumbers(h, coords, masses, project):
    '''Symmetrized (..., 3N, 3N) mass-weighted Hessians -> frequencies
    (..., 3N) in cm^-1, the projected rigid-body modes zeroed.'''
    h = 0.5 * (h + h.transpose(-1, -2))
    if project:
        p = _tr_rot_projector(coords, masses)
        h = p @ h @ p
    evals = torch.linalg.eigvalsh(h)
    freqs = torch.sign(evals) * _FREQ_FACTOR * torch.sqrt(torch.abs(evals))
    return torch.where(torch.abs(freqs) < 1.0, 0.0, freqs)


@traced
def frequencies(coords, atomnos, energy_fn, project=True, *, device):
    '''Harmonic frequencies of one structure, float64 on `device`;
    energy_fn takes a (N, 3) tensor there and returns a scalar.

    Returns (freqs_cm (3N,) numpy, n_imag). Imaginary modes appear as
    negative wavenumbers; the six (five) projected rigid-body modes come
    out as ~0 and are zeroed.
    '''
    coords = _f64(coords, device)
    masses = _f64(MASSES[np.asarray(atomnos)], device)
    h = mass_weighted_hessian(energy_fn, coords, masses)
    freqs = _wavenumbers(h, coords, masses, project).cpu().numpy()
    return freqs, int(np.sum(freqs < -1e-3))


def frequencies_batch(coords_batch, atomnos, energy_fn, project=True, *,
                      device):
    '''frequencies over a (B, N, 3) batch, every Hessian in one vmapped
    program. Returns (freqs (B, 3N), n_imag (B,)), numpy.'''
    coords = _f64(coords_batch, device)
    masses = _f64(MASSES[np.asarray(atomnos)], device)
    B, n = coords.shape[:2]
    hess = torch.func.vmap(_hessian_of(energy_fn, n))(coords.reshape(B, -1))
    w = 1.0 / torch.sqrt(torch.repeat_interleave(masses, 3))
    freqs = _wavenumbers(hess * w[:, None] * w[None, :], coords, masses,
                         project).cpu().numpy()
    return freqs, np.sum(freqs < -1e-3, axis=1)


def _maps_onto_itself(coords, atomnos, rot, tol=0.15):
    '''True when `rot @ coords` is a same-element permutation of coords
    (each rotated atom lands within tol of exactly one original atom of
    the same element, bijectively).'''
    moved = coords @ rot.T
    taken = np.zeros(len(coords), dtype=bool)
    for i, (pos, a) in enumerate(zip(moved, atomnos)):
        dists = np.linalg.norm(coords - pos, axis=1)
        dists[(atomnos != a) | taken] = np.inf
        j = int(np.argmin(dists))
        if dists[j] > tol:
            return False
        taken[j] = True
    return True


def _axis_rotation(axis, angle):
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def detect_symmetry_number(coords, atomnos):
    '''External rotational symmetry number sigma from geometry: the
    order of the proper-rotation subgroup, found by testing Cn
    (n = 2,3,4,5,6) about each principal inertia axis and perpendicular
    C2 axes (through atoms and bond midpoints) for the Cn -> n,
    Dn -> 2n rule. Linear molecules: 1 (C-inf-v) or 2 (D-inf-h).
    Conservative by construction — an undetected symmetry only makes
    the rotational entropy slightly too positive, the same direction as
    the reference's sigma-blind free energies (_xtb.py:440-512).'''
    coords = np.asarray(coords, dtype=float)
    atomnos = np.asarray(atomnos)
    if len(coords) == 1:
        return 1

    masses = MASSES[atomnos]
    com = np.sum(coords * masses[:, None], axis=0) / np.sum(masses)
    x0 = coords - com

    inert = np.zeros((3, 3))
    for xi, mi in zip(x0, masses):
        inert += mi * (np.dot(xi, xi) * np.eye(3) - np.outer(xi, xi))
    moments, axes = np.linalg.eigh(inert)

    if moments[0] < 1e-3 * max(moments[2], 1e-12):      # linear
        axis = axes[:, 0]
        # D-inf-h iff a perpendicular C2 (end-over-end flip) holds
        perp = np.eye(3)[np.argmin(np.abs(axis))]
        perp = perp - np.dot(perp, axis) * axis
        flip = _axis_rotation(perp, np.pi)
        return 2 if _maps_onto_itself(x0, atomnos, flip) else 1

    # highest-order Cn about any principal axis
    best_n, best_axis = 1, axes[:, 2]
    for col in range(3):
        axis = axes[:, col]
        for n in (6, 5, 4, 3, 2):
            if n <= best_n:
                break
            if _maps_onto_itself(x0, atomnos,
                                 _axis_rotation(axis, 2 * np.pi / n)):
                best_n, best_axis = n, axis
                break

    # Dn: any C2 perpendicular to the main axis (axes through atoms,
    # bond midpoints, and the remaining principal axes)
    candidates = [axes[:, c] for c in range(3)]
    candidates += [xi for xi in x0 if np.linalg.norm(xi) > 1e-3]
    candidates += [x0[i] + x0[j]
                   for i in range(min(len(x0), 12))
                   for j in range(i + 1, min(len(x0), 12))]
    for cand in candidates:
        perp = cand - np.dot(cand, best_axis) * best_axis
        norm = np.linalg.norm(perp)
        if norm < 1e-3:
            continue
        if _maps_onto_itself(x0, atomnos,
                             _axis_rotation(perp / norm, np.pi)):
            return 2 * best_n
    return best_n


def thermochemistry(freqs_cm, atomnos, coords, temperature=298.15,
                    pressure=101325.0, symmetry_number=None):
    '''Ideal-gas RRHO corrections from harmonic frequencies.

    Returns a dict (kcal/mol unless noted): zpe, e_vib, e_rot, e_trans,
    h_corr (enthalpy correction incl. RT), s (entropy, kcal/mol/K),
    g_corr (Gibbs correction, add to the electronic energy). Imaginary
    and rigid-body modes are excluded, matching the convention of the
    reference's xtb `--ohess` free-energy route (_xtb.py:440-512).

    symmetry_number: external rotational sigma; None (default)
    auto-detects it from the geometry (detect_symmetry_number) so the
    -R*T*ln(sigma) rotational-entropy term (~0.4 kcal/mol at sigma=2,
    298 K) is included without the caller knowing the point group.
    '''
    if symmetry_number is None:
        symmetry_number = detect_symmetry_number(coords, atomnos)
    t = float(temperature)
    freqs = np.asarray(freqs_cm, dtype=float)
    freqs = freqs[freqs > 1.0]                  # real vibrational modes

    masses = MASSES[np.asarray(atomnos)]
    coords = np.asarray(coords, dtype=float)

    # vibrational: ZPE + thermal, entropy (harmonic oscillator)
    theta = _H_PLANCK * _C_CM * freqs / _KB_J          # K per mode
    x = theta / t
    zpe = float(np.sum(0.5 * _KB * theta))
    expm = np.expm1(x)
    e_vib = float(np.sum(_KB * theta / expm))
    s_vib = float(np.sum(_KB * (x / expm - np.log1p(-np.exp(-x)))))

    # translational
    m_kg = float(np.sum(masses)) * _AMU
    q_trans = ((2 * np.pi * m_kg * _KB_J * t / _H_PLANCK ** 2) ** 1.5
               * _KB_J * t / pressure)
    e_trans = 1.5 * _KB * t
    s_trans = _KB * (np.log(q_trans) + 2.5)

    # rotational (rigid rotor from the inertia tensor)
    com = np.sum(coords * masses[:, None], axis=0) / np.sum(masses)
    x0 = coords - com
    inert = np.zeros((3, 3))
    for xi, mi in zip(x0, masses):
        inert += mi * (np.dot(xi, xi) * np.eye(3) - np.outer(xi, xi))
    moments = np.sort(np.linalg.eigvalsh(inert))       # amu A^2
    moments_si = moments * _AMU * 1e-20
    linear = moments_si[0] < 1e-3 * moments_si[2] or len(atomnos) == 2
    if len(atomnos) == 1:
        e_rot = s_rot = 0.0
    elif linear:
        theta_r = _H_PLANCK ** 2 / (8 * np.pi ** 2 * _KB_J * moments_si[2])
        q_rot = t / (symmetry_number * theta_r)
        e_rot = _KB * t
        s_rot = _KB * (np.log(q_rot) + 1.0)
    else:
        theta_r = _H_PLANCK ** 2 / (8 * np.pi ** 2 * _KB_J * moments_si)
        q_rot = (np.sqrt(np.pi) / symmetry_number
                 * np.sqrt(t ** 3 / np.prod(theta_r)))
        e_rot = 1.5 * _KB * t
        s_rot = _KB * (np.log(q_rot) + 1.5)

    s_tot = s_vib + s_trans + s_rot
    h_corr = zpe + e_vib + e_trans + e_rot + _KB * t
    g_corr = h_corr - t * s_tot
    return {'zpe': zpe, 'e_vib': e_vib, 'e_rot': e_rot, 'e_trans': e_trans,
            'h_corr': h_corr, 's': s_tot, 'g_corr': g_corr}


def frequencies_from_gradients(coords, atomnos, gradient_fn, dx=0.01,
                               project=True, maxthreads=4, *, device):
    '''Harmonic frequencies from an external (energy, gradient) callback:
    central differences of the gradient build the Hessian (6N gradient
    calls, maxthreads at a time on a thread pool, since the intended
    callbacks are subprocess-bound), then the same mass weighting,
    Eckart projection and eigensolve as the analytic path, float64 on
    `device`. Returns (freqs_cm (3N,) numpy, n_imag).'''
    from concurrent.futures import ThreadPoolExecutor

    coords = np.asarray(coords, dtype=float)
    n = len(coords)
    flat = coords.reshape(-1)

    def displaced_grad(job):
        i, sign = job
        x = flat.copy()
        x[i] += sign * dx
        return np.asarray(gradient_fn(x.reshape(n, 3))[1]).reshape(-1)

    jobs = [(i, s) for i in range(3 * n) for s in (+1.0, -1.0)]
    with ThreadPoolExecutor(max_workers=maxthreads) as pool:
        grads = list(pool.map(displaced_grad, jobs))

    hess = np.zeros((3 * n, 3 * n))
    for i in range(3 * n):
        hess[i] = (grads[2 * i] - grads[2 * i + 1]) / (2.0 * dx)

    masses = np.asarray(MASSES[np.asarray(atomnos)], dtype=float)
    w = 1.0 / np.sqrt(np.repeat(masses, 3))
    freqs = _wavenumbers(_f64(hess * w[:, None] * w[None, :], device),
                         _f64(coords, device), _f64(masses, device),
                         project).cpu().numpy()
    return freqs, int(np.sum(freqs < -1e-3))


def ff_free_energy(coords, atomnos, energy_fn, temperature=298.15,
                   symmetry_number=None, *, device):
    '''Electronic (force-field) energy + RRHO Gibbs correction, the
    calculator-free analog of an xtb free energy, float64 on `device`.

    symmetry_number: external rotational symmetry sigma; None (default)
    detects it from the geometry, keeping the -R*T*ln(sigma) rotational
    entropy term.'''
    freqs, n_imag = frequencies(coords, atomnos, energy_fn, device=device)
    thermo = thermochemistry(freqs, atomnos, coords, temperature,
                             symmetry_number=symmetry_number)
    with torch.no_grad():
        e_el = float(energy_fn(_f64(coords, device)))
    return e_el + thermo['g_corr'], n_imag
