'''
First-order saddle refinement by the dimer method (counterpart of
tscode_tpu/saddle.py).

The lowest-curvature mode is found by shifted power iteration on the
finite-difference Hessian action, and the translation follows the force
with its component along the mode inverted: it converges to first-order
saddles without a Hessian. Runs on any differentiable energy (the
internal force field, analytic surfaces), or on a host callback of
gradients.

The finite-difference action with dr = 1e-3 cancels about three digits,
so the dimer runs in float64 on the run's device. On a CUDA device an
energy of the internal force field's family (one that carries
`fire_terms(*energy_args) -> ff.FireTerms`: ff.ff_energy, which the
SADDLE scan, saddle> and the SADDLE stage hand it) runs in one launch
of the hand-written kernel D1 (ops/kernels/dimer, `csrc/dimer.cu`),
every step inside, its forces analytic: the counterpart of the JAX
package's one jitted program. Any other energy (an analytic surface) is
chosen by what it is, not as a fallback: one dimer step (18 Hessian
actions, each the forces of two displaced copies in one autograd pass,
and a force) is captured in a CUDA graph and replayed n_steps times with
no host sync (`capture.graph_loop`). On the CPU every energy runs the
steps op by op through torch.autograd and stops once `done` has
latched, from where JAX's loop leaves the coordinates as they are.
'''

import numpy as np
import torch

from tscode_tpu_torch.backend import traced
from tscode_tpu_torch.capture import graph_loop
from tscode_tpu_torch.ff import build_ff_params, ff_energy, params_to_device
from tscode_tpu_torch.optimizers import forces


def _dimer_step(energy_fn, n_rot, dr, step_size, fmax):
    '''The dimer step as a loop body: ((c, v, done), energy_args) ->
    (c, v, done), c and v (N, 3), done a 0-dim bool.'''
    def project(v):
        # rigid translations are exact zero modes of any pairwise
        # energy; keep the mode search orthogonal to them (not for one
        # point on an analytic surface, which is not translation
        # invariant)
        if v.shape[0] > 1:
            v = v - torch.mean(v, dim=0, keepdim=True)
        return v

    def normalize(v):
        return v / torch.clamp(torch.linalg.norm(v), min=1e-12)

    def body(state, args):
        c, v, done = state

        def force(x):
            return forces(x, energy_fn, args)

        def hv(u):
            f = force(torch.stack([c + dr * u, c - dr * u]))
            return -(f[0] - f[1]) / (2 * dr)

        # shifted power iteration: v <- normalize((sigma I - H) v)
        # converges to the most negative curvature mode for any sigma
        # above lambda_max, which a few plain power steps estimate
        u = v
        for _ in range(4):
            u = normalize(project(hv(u)))
        sigma = 1.1 * torch.abs(torch.sum(u * hv(u))) + 1.0
        for _ in range(n_rot):
            v = normalize(project(sigma * v - hv(v)))
        curv = torch.sum(v * hv(v))

        f = force(c[None])[0]
        f_par = torch.sum(f * v) * v

        # negative curvature: the dimer translation (force with the mode
        # component inverted). Positive curvature near a stationary
        # point: climb the softest mode (reversed parallel force plus a
        # kick, so an exact minimum still moves). Positive curvature
        # under a large force: the inverted-force step, which keeps the
        # walker near the stationary region (convergence stays False).
        fmax_now = torch.amax(torch.linalg.norm(f, dim=-1))
        climbing = (curv >= 0.0) & (fmax_now < 10.0 * fmax)
        f_eff = torch.where(climbing, -f_par + fmax * v, f - 2.0 * f_par)

        done_new = done | ((fmax_now < fmax) & (curv < 0.0))

        step = step_size * f_eff
        max_disp = torch.amax(torch.linalg.norm(step, dim=-1))
        step = step * torch.clamp(0.1 / torch.clamp(max_disp, min=1e-12),
                                  max=1.0)
        return torch.where(done_new, c, c + step), v, done_new

    return body


def dimer_start(coords):
    '''The deterministic initial mode: sin(arange(3n) * 12.9898 +
    4.1414) as (n, 3), orthogonal to rigid translations and normalised
    (an all-ones mode would be a translation and carry no curvature).'''
    n = coords.shape[0]
    v0 = torch.sin(torch.arange(n * 3, dtype=coords.dtype,
                                device=coords.device) * 12.9898
                   + 4.1414).reshape(n, 3)
    if n > 1:
        v0 = v0 - torch.mean(v0, dim=0, keepdim=True)
    return v0 / torch.clamp(torch.linalg.norm(v0), min=1e-12)


@traced
def dimer_saddle(coords, energy_fn, n_steps=300, n_rot=12, dr=1e-3,
                 step_size=0.02, fmax=0.05, energy_args=()):
    '''
    coords (N, 3) tensor -> (coords (N, 3), energy 0-dim, converged 0-dim
    bool), on coords' device and in its dtype.
    energy_fn(x (B, N, 3), *energy_args) -> (B,), differentiable; pass
    per-call parameters (force-field tables) through energy_args, so one
    captured step serves every structure. On a CUDA tensor an energy_fn
    with a `fire_terms` attribute runs in one launch of
    ops/kernels/dimer.dimer on energy_fn.fire_terms(*energy_args); the
    returned energy is energy_fn's at the result.

    Convergence requires both |F| < fmax and negative curvature along
    the tracked mode: a minimum is never reported as a saddle; the dimer
    climbs out of it along the softest mode instead.
    '''
    terms = getattr(energy_fn, 'fire_terms', None)
    if coords.is_cuda and terms is not None:
        from tscode_tpu_torch.ops.kernels.dimer import dimer
        c, done, _ = dimer(coords[None], terms(*energy_args), n_steps,
                           n_rot, dr, step_size, fmax)
        c, done = c[0], done[0]
    else:
        body = _dimer_step(energy_fn, n_rot, dr, step_size, fmax)
        state = (coords.clone(), dimer_start(coords),
                 torch.zeros((), dtype=torch.bool, device=coords.device))
        if coords.is_cuda:
            state = graph_loop(body, state, energy_args, n_steps)
        else:
            for _ in range(n_steps):
                state = body(state, energy_args)
                if bool(state[2]):
                    break
        c, _, done = state
    with torch.no_grad():
        e = energy_fn(c[None], *energy_args)[0]
    return c, e, done


def dimer_saddle_callback(coords, gradient_fn, n_steps=60, n_rot=8,
                          dr=1e-3, step_size=0.02, fmax=0.05):
    '''
    Host-loop dimer for surfaces given by a callback (external QM):
    `gradient_fn(coords (N, 3)) -> (energy, grad (N, 3))`, numpy. The
    same mode tracking and translation rule as dimer_saddle, with a
    trimmed rotation budget because every Hessian action costs two
    gradient calls. Returns (coords, energy, converged).
    '''
    c = np.asarray(coords, dtype=float).copy()
    n = len(c)

    def force(x):
        return -gradient_fn(x)[1]

    def project(v):
        return v - v.mean(axis=0, keepdims=True) if n > 1 else v

    def normalize(v):
        return v / max(np.linalg.norm(v), 1e-12)

    def hv(x, v):
        return -(force(x + dr * v) - force(x - dr * v)) / (2 * dr)

    def lowest_mode(x, v):
        # one Hessian action (2 gradient calls) per v-update, reused
        # across the sigma estimate, shift and curvature lines
        hv_v = hv(x, v)
        for _ in range(2):                      # lambda_max estimate
            v = normalize(project(hv_v))
            hv_v = hv(x, v)
        sigma = 1.1 * abs(np.sum(v * hv_v)) + 1.0
        for _ in range(n_rot):
            v = normalize(project(sigma * v - hv_v))
            hv_v = hv(x, v)
        return v, float(np.sum(v * hv_v))

    v = normalize(project(np.sin(
        np.arange(n * 3, dtype=float) * 12.9898 + 4.1414).reshape(n, 3)))
    done = False
    for _ in range(n_steps):
        v, curv = lowest_mode(c, v)
        f = force(c)
        f_par = np.sum(f * v) * v
        fmax_now = float(np.max(np.linalg.norm(f, axis=-1)))
        if fmax_now < fmax and curv < 0.0:
            done = True
            break
        climbing = curv >= 0.0 and fmax_now < 10.0 * fmax
        f_eff = (-f_par + fmax * v) if climbing else (f - 2.0 * f_par)
        step = step_size * f_eff
        max_disp = float(np.max(np.linalg.norm(step, axis=-1)))
        c = c + step * min(1.0, 0.1 / max(max_disp, 1e-12))

    energy = float(gradient_fn(c)[0])
    return c, energy, done


def saddle_refine_structure(coords, atomnos, graph, fmax=0.05, *, device):
    '''Refine one structure to a first-order saddle on the internal
    force field built from it, float64 on `device` (one launch of D1 on
    a card). Returns (coords numpy, energy,
    converged).'''
    params = params_to_device(build_ff_params(coords, atomnos, graph),
                              device, torch.float64)
    c, e, done = dimer_saddle(
        torch.as_tensor(np.asarray(coords), dtype=torch.float64,
                        device=device), ff_energy, fmax=fmax,
        energy_args=(params,))
    return c.cpu().numpy(), float(e), bool(done)
