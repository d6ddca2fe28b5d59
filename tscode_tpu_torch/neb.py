'''
Nudged elastic band (NEB) with a climbing image (counterpart of
tscode_tpu/neb.py).

The whole chain is one tensor (I, N, 3): tangents, spring forces,
perpendicular projections and the climbing-image inversion are array
ops, and the band relaxes under FIRE. The potential is any
differentiable energy function (the internal force field, or a toy
surface), or a host callback that returns energies and gradients.

On a CUDA device the relaxation of a band on an energy of the force
field's family (one that carries `fire_terms(*energy_args) ->
ff.FireTerms`: ff.ff_energy among them) is one launch of the
hand-written kernel N1 (ops/kernels/neb.neb_band), every step inside;
on any other energy one band step (forces by torch.autograd, the band
composition, the FIRE update) is captured in a CUDA graph and replayed
(`capture.graph_loop`). On the CPU the steps run op by op and stop once
the band has converged, from where JAX's loop leaves the chain as it
is. The IDPP starting band relaxes on a CUDA device in one launch of the
kernel I1 (ops/kernels/idpp.idpp_fire), on the CPU under
`fire_minimize_batch`.
'''

import numpy as np
import torch

from tscode_tpu_torch.backend import traced
from tscode_tpu_torch.capture import graph_loop
from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.optimizers import (fire_band_init, fire_band_update,
                                         fire_minimize_batch)


def interpolate_chain(start, end, n_images):
    '''Linear interpolation including endpoints: (N, 3) x2 -> (I, N, 3).'''
    t = np.linspace(0.0, 1.0, n_images)[:, None, None]
    return (1 - t) * np.asarray(start)[None] + t * np.asarray(end)[None]


def _idpp_energy(chain, targets, weights):
    '''Per-image IDPP objective (Smidstrup et al., JCP 140, 214106):
    chain (I, N, 3), targets/weights (I, N, N) -> (I,).'''
    diff = chain[:, :, None, :] - chain[:, None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    return torch.sum(weights * (d - targets) ** 2, dim=(-2, -1))


def idpp_tables(chain):
    '''The IDPP objective's targets and weights (I, N, N) of a linear
    chain (I, N, 3) numpy: each image's pair distances interpolated
    linearly between the endpoints', weights 1 / max(target, 0.01)^4, 0
    on the diagonal.'''
    n_images, n = chain.shape[0], chain.shape[1]

    def dmat(c):
        diff = c[:, None, :] - c[None, :, :]
        return np.sqrt(np.sum(diff * diff, axis=-1))

    t = np.linspace(0.0, 1.0, n_images)[:, None, None]
    targets = (1 - t) * dmat(chain[0])[None] + t * dmat(chain[-1])[None]
    weights = 1.0 / np.maximum(targets, 1e-2) ** 4
    weights[:, np.arange(n), np.arange(n)] = 0.0
    return targets, weights


def band_tensor(a, device):
    '''A band, or its tables, as a float64 tensor on `device`.'''
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def idpp_interpolate(start, end, n_images, n_steps=300, *, device):
    '''Image-dependent pair potential interpolation: the linear chain,
    its interior images relaxed together under batched FIRE toward
    linearly interpolated pair-distance targets (weights 1/d^4), the
    endpoints frozen. float64 on `device` (a CUDA device: one launch of
    the kernel I1); returns numpy (I, N, 3).'''
    chain = interpolate_chain(start, end, n_images)
    if n_images <= 2:
        return chain
    targets, weights = idpp_tables(chain)
    freeze = np.zeros(chain.shape[:2], dtype=bool)
    freeze[0] = freeze[-1] = True

    c = band_tensor(chain, device)
    tables = (band_tensor(targets, device), band_tensor(weights, device))
    if c.is_cuda:
        from tscode_tpu_torch.ops.kernels.idpp import idpp_fire
        refined = idpp_fire(c, *tables, n_steps)[0]
    else:
        refined, _, _ = fire_minimize_batch(
            c, _idpp_energy, n_steps=n_steps, freeze_mask=freeze,
            energy_args=tables)
    return refined.cpu().numpy()


def interpolate_structures(structures, atomnos, n, method='idpp', *,
                           device):
    '''Expand m >= 2 structures into an n-image chain, keeping the input
    structures at proportional positions and filling each gap by linear
    or IDPP interpolation. Returns numpy (n, N, 3).'''
    structures = np.asarray(structures, dtype=float)
    m = len(structures)
    if method == 'idpp':
        def fill(a, b, k):
            return idpp_interpolate(a, b, k, device=device)
    else:
        fill = interpolate_chain

    if m == 2:
        return fill(structures[0], structures[-1], n)

    if n <= m:                      # nothing to expand: sample evenly
        idx = np.round(np.linspace(0, m - 1, n)).astype(int)
        return structures[idx]

    ratio = n / m
    mappings = [round(i * ratio) for i in range(m)]
    mappings[-1] = n - 1

    images = np.zeros((n, structures.shape[1], 3))
    for i, pos in enumerate(mappings):
        images[pos] = structures[i]

    group_ranges = [(mappings[i], mappings[i + 1])
                    for i in range(m - 1) if mappings[i + 1] - mappings[i] > 1]
    for r1, r2 in group_ranges:
        images[r1:r2 + 1] = fill(images[r1], images[r2], r2 - r1 + 1)
    return images


def _tangents(chain, energies):
    '''Improved upwind tangents (Henkelman & Jonsson 2000) of the
    interior images: (I, N, 3), (I,) -> (I - 2, N, 3).'''
    prev, mid, nxt = chain[:-2], chain[1:-1], chain[2:]
    t_plus = nxt - mid
    t_minus = mid - prev

    e_prev, e_mid, e_next = energies[:-2], energies[1:-1], energies[2:]
    up = (e_next > e_mid) & (e_mid > e_prev)
    down = (e_next < e_mid) & (e_mid < e_prev)

    dE_max = torch.maximum(torch.abs(e_next - e_mid),
                           torch.abs(e_prev - e_mid))[:, None, None]
    dE_min = torch.minimum(torch.abs(e_next - e_mid),
                           torch.abs(e_prev - e_mid))[:, None, None]
    higher_next = (e_next > e_prev)[:, None, None]

    t_mix_hi = t_plus * dE_max + t_minus * dE_min
    t_mix_lo = t_plus * dE_min + t_minus * dE_max

    tang = torch.where(up[:, None, None], t_plus,
                       torch.where(down[:, None, None], t_minus,
                                   torch.where(higher_next, t_mix_hi,
                                               t_mix_lo)))
    norm = torch.sqrt(torch.sum(tang * tang, dim=(-2, -1)))[:, None, None]
    return tang / torch.clamp(norm, min=1e-12)


def band_forces(chain, energies, grad, k_spring=1.0, climbing=False):
    '''
    NEB force on every image from per-image energies and gradients of
    the true potential: the true force perpendicular to the tangent plus
    the spring force along it; with `climbing`, the highest interior
    image takes the full force with its parallel part inverted.
    chain (I, N, 3), energies (I,), grad (I, N, 3) -> (I, N, 3), zero
    on the endpoints.
    '''
    f_mid = -grad[1:-1]
    tang = _tangents(chain, energies)                       # (I-2, N, 3)

    f_par = torch.sum(f_mid * tang, dim=(-2, -1))[:, None, None] * tang
    f_perp = f_mid - f_par

    d_next = torch.sqrt(torch.sum((chain[2:] - chain[1:-1]) ** 2,
                                  dim=(-2, -1)))
    d_prev = torch.sqrt(torch.sum((chain[1:-1] - chain[:-2]) ** 2,
                                  dim=(-2, -1)))
    f_spring = (k_spring * (d_next - d_prev))[:, None, None] * tang

    neb_f = f_perp + f_spring
    if climbing:
        # the first highest interior image, as argmax picks it
        i_max = torch.argmax(energies[1:-1])
        top = torch.arange(len(neb_f), device=chain.device) == i_max
        neb_f = torch.where(top[:, None, None], f_mid - 2.0 * f_par, neb_f)

    edge = torch.zeros_like(chain[:1])
    return torch.cat([edge, neb_f, edge])


def neb_forces(chain, energy_fn, k_spring=1.0, climbing=False,
               energy_args=()):
    '''NEB forces on a differentiable surface: the image energies
    energy_fn(chain, *energy_args) -> (I,) and their gradients by
    autograd, then band_forces.'''
    c = chain.detach().requires_grad_(True)
    with torch.enable_grad():
        energies = energy_fn(c, *energy_args)
    grad = torch.autograd.grad(energies.sum(), c)[0]
    return band_forces(chain, energies.detach(), grad, k_spring=k_spring,
                       climbing=climbing)


def _band_state(chain, dt0):
    '''A band at rest at chain, and dt0 as a tensor beside it (the
    FIRE band update takes it so).'''
    dt0 = chain.new_tensor(dt0)
    return fire_band_init(chain.clone(), dt0), dt0


def _band_body(energy_fn, k_spring, fmax, climbing):
    '''The band step as a loop body: (FIRE band state, (dt0 0-dim,
    energy_args)) -> state.'''
    def body(state, args):
        dt0, energy_args = args
        f = neb_forces(state[0], energy_fn, k_spring=k_spring,
                       climbing=climbing, energy_args=energy_args)
        return fire_band_update(state, f, dt0, fmax)

    return body


def _neb_relax(chain, energy_fn, n_steps, k_spring, dt0, fmax, climbing,
               energy_args=()):
    '''The chain after n_steps FIRE steps of the band from rest
    (endpoints fixed by band_forces). CUDA: an energy_fn with a
    `fire_terms` attribute in one launch of the kernel N1 on
    energy_fn.fire_terms(*energy_args); any other energy the step
    replayed from a CUDA graph. CPU: op by op, stopping once the band
    has converged (JAX's remaining steps leave the chain as it is).'''
    if n_steps <= 0:
        return chain
    terms = getattr(energy_fn, 'fire_terms', None)
    if chain.is_cuda and terms is not None:
        from tscode_tpu_torch.ops.kernels.neb import neb_band
        return neb_band(chain, terms(*energy_args), n_steps, k_spring, dt0,
                        fmax, climbing)[0]
    state, dt0_t = _band_state(chain, dt0)
    body = _band_body(energy_fn, k_spring, fmax, climbing)
    if chain.is_cuda:
        return graph_loop(body, state, (dt0_t, energy_args), n_steps)[0]
    for _ in range(n_steps):
        state = body(state, (dt0_t, energy_args))
        if bool(state[5]):
            break
    return state[0]


def _band_step(state, energies, grad, k_spring, dt0, fmax, climbing):
    '''One band step from energies and gradients supplied by the host
    (the callback path): band composition and FIRE update.'''
    f = band_forces(state[0], energies, grad, k_spring=k_spring,
                    climbing=climbing)
    return fire_band_update(state, f, dt0, fmax)


def _check_images(chain):
    if chain.shape[0] < 3:
        raise InputError(
            f'NEB needs at least 3 images (got {chain.shape[0]}): '
            f'a band without interior images cannot relax a path.')


def run_neb_callback(start, end, grad_chain_fn, n_images=7, k_spring=1.0,
                     n_steps=100, climb_after=50, dt0=0.01, fmax=0.05,
                     chain=None, checkpoint_fn=None, checkpoint_every=10,
                     with_status=False, *, device):
    '''
    Climbing-image NEB on a surface given by a host callback: per step
    `grad_chain_fn(chain numpy) -> (energies (I,), grads (I, N, 3))`;
    the band composition and the FIRE update run on `device` in float64.
    Returns (chain (I, N, 3), energies (I,), ts_index), numpy.

    checkpoint_fn(band numpy) is called with the latest evaluated band
    every `checkpoint_every` callback steps. with_status=True appends a
    4th return: True when the band converged rather than exhausting
    n_steps.
    '''
    if chain is None:
        chain = idpp_interpolate(start, end, n_images, device=device)
    chain = band_tensor(chain, device)
    _check_images(chain)

    # two phases, each from a fresh FIRE state, as run_neb's
    state, dt0_t = _band_state(chain, dt0)
    climbing = False
    converged = False
    energies = None
    coords_evaluated = None
    for step in range(n_steps):
        if not climbing and (step >= climb_after
                             or (energies is not None
                                 and bool(state[5]))):
            # pre-relax done (by schedule or convergence): climb when an
            # interior barrier exists (run_neb's guard)
            has_barrier = (energies is not None
                           and np.max(energies[1:-1])
                           > max(energies[0], energies[-1]) + 1e-6)
            if not has_barrier and bool(state[5]):
                converged = True
                break               # converged, nothing to climb
            if has_barrier:
                climbing = True
                state, _ = _band_state(state[0], dt0)
        elif climbing and bool(state[5]):
            converged = True
            break                   # climbing phase converged

        coords_evaluated = state[0].cpu().numpy()
        energies, grads = grad_chain_fn(coords_evaluated)
        if checkpoint_fn is not None and step % checkpoint_every == 0:
            checkpoint_fn(coords_evaluated)
        state = _band_step(state, band_tensor(energies, device),
                           band_tensor(grads, device), k_spring, dt0_t, fmax,
                           climbing)

    converged = converged or bool(state[5])
    final = state[0].cpu().numpy()
    if (coords_evaluated is None
            or not np.array_equal(final, coords_evaluated)):
        # another chain evaluation only when the band moved after its
        # last one
        energies, _ = grad_chain_fn(final)
    ts_index = int(1 + np.argmax(energies[1:-1]))
    if with_status:
        return final, np.asarray(energies), ts_index, converged
    return final, np.asarray(energies), ts_index


@traced
def run_neb(start, end, energy_fn, n_images=7, k_spring=1.0, n_steps=800,
            climb_after=400, dt0=0.01, fmax=0.05, chain=None,
            energy_args=(), *, device):
    '''
    Climbing-image NEB between two endpoint geometries on
    energy_fn(chain (I, N, 3), *energy_args) -> (I,), float64 on
    `device`: climb_after steps of the plain band, then, when the band
    has an interior barrier, n_steps - climb_after with the climbing
    image (each phase from a fresh FIRE state; on a CUDA device and the
    force field, each phase one launch of N1, the barrier tested on the
    host between them).
    Returns (chain (I, N, 3), energies (I,), ts_index), numpy.
    '''
    if chain is None:
        # IDPP starting band
        chain = idpp_interpolate(start, end, n_images, device=device)
    chain = band_tensor(chain, device)
    _check_images(chain)

    def energies_of(c):
        with torch.no_grad():
            return energy_fn(c, *energy_args).cpu().numpy()

    chain = _neb_relax(chain, energy_fn, climb_after, k_spring, dt0, fmax,
                       False, energy_args)

    # climb only when the band has an interior barrier: on a monotonic
    # profile the climbing image would run up the nearest repulsive wall
    energies = energies_of(chain)
    has_barrier = energies[1:-1].max() > max(energies[0], energies[-1]) + 1e-6
    chain = _neb_relax(chain, energy_fn, n_steps - climb_after, k_spring,
                       dt0, fmax, bool(has_barrier), energy_args)

    energies = energies_of(chain)
    ts_index = int(1 + np.argmax(energies[1:-1]))
    return chain.cpu().numpy(), energies, ts_index
