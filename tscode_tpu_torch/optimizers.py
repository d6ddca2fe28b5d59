'''
Batched first-order geometry optimisation (counterpart of
tscode_tpu/optimizers.py, and of the two FIRE helpers of tscode_tpu/neb.py
that the band and the bend's external-gradient relaxation use).

`fire_minimize_batch` advances every structure of a batch at once with
per-structure adaptive time steps, any differentiable energy function
(torch.autograd supplies the forces), and an optional mask of frozen
atoms. The loop runs a fixed number of steps, `done` is a mask on the
device and nothing inside the loop waits for the device.

On a CUDA device an energy of the internal force field's family (one
that carries `fire_terms(*energy_args) -> ff.FireTerms`: ff.ff_energy,
bending._bend_energy, scans._ff_spring_energy,
optimization._spacing_energy) is relaxed by one launch of the
hand-written kernel ops/kernels/ff_fire, every step inside, its forces
analytic: the counterpart of the JAX package's one jitted program. Any
other energy (neb._idpp_energy, a caller's own function) takes the
generic form, chosen by what the function is, not as a fallback: on the
CPU the steps run one after the other as they are written
(`fire_run_eager`, for every energy); on a CUDA device one step, forces
included, is captured once per problem shape in a CUDA graph and
replayed (`fire_run_graph`): a step is some two hundred small launches,
and a relaxation of one conformer is bound by their enqueue time
otherwise. `capture.graph_loop` captures and keeps such loop bodies; the
dimer step (saddle.py), the NEB band step (neb.py), the prune schedule
(ops/rmsd_prune.py) and the pipeline's program (pipeline.py) run through
it too.

`fire_minimize_batch_sharded` relaxes one contiguous slice of the batch
on each device of a mesh (parallel/sharding.py): the FIRE state and the
stop rule are per structure, so no collective is needed and the result
equals the unsharded one.
'''

import numpy as np
import torch

from tscode_tpu_torch.backend import traced
from tscode_tpu_torch.capture import graph_loop, map_tensors

# FIRE hyperparameters (standard values)
_ALPHA0 = 0.1
_F_INC = 1.1
_F_DEC = 0.5
_F_ALPHA = 0.99
_N_MIN = 5
_DT_MAX_FACTOR = 10.0
# the largest displacement of an atom in one step, A
_MAX_DISP = 0.2


def spring_energy(coords, pairs, targets, k=5.0):
    '''Harmonic pair-distance restraints: coords (..., N, 3),
    pairs (C, 2) int64, targets (C,) -> (...).'''
    if pairs.shape[0] == 0:
        return coords.new_zeros(coords.shape[:-2])
    d = torch.linalg.norm(coords.index_select(-2, pairs[:, 0])
                          - coords.index_select(-2, pairs[:, 1]), dim=-1)
    return k * torch.sum((d - targets) ** 2, dim=-1)


def forces(coords, energy_fn, energy_args=(), freeze_mask=None):
    '''Minus the gradient of the summed energy of the batch, zero on
    the frozen atoms (and everywhere, for an energy that does not depend
    on the coordinates): coords (B, N, 3) -> (B, N, 3).'''
    c = coords.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy_fn(c, *energy_args).sum()
    if not e.requires_grad:
        return torch.zeros_like(coords)
    f = -torch.autograd.grad(e, c)[0]
    if freeze_mask is not None:
        f = f.masked_fill(freeze_mask[..., None], 0.0)
    return f


def fire_init(coords, dt0):
    '''The FIRE state of a batch at rest: (coords, velocities, dt (B,),
    alpha (B,), steps since the last uphill one (B,) int32, done (B,)
    bool).'''
    B = coords.shape[0]
    return (coords.clone(), torch.zeros_like(coords),
            coords.new_full((B,), dt0), coords.new_full((B,), _ALPHA0),
            torch.zeros(B, dtype=torch.int32, device=coords.device),
            torch.zeros(B, dtype=torch.bool, device=coords.device))


def fire_step(state, f, dt0, fmax):
    '''One FIRE step of every structure given the forces f (B, N, 3):
    velocity mixing, the per-structure time step and mixing controls,
    a semi-implicit Euler step whose largest atomic displacement is
    capped (the velocity is rescaled by the same factor: an uncapped
    velocity would keep integrating upward while positions are clamped),
    and the stop of the structures whose largest atomic force is under
    fmax (their coordinates stay, their velocity is zeroed; their
    controls go on updating). Returns the new state.'''
    c, v, dt, alpha, n_pos, done = state
    power = torch.sum(f * v, dim=(-2, -1))                       # (B,)
    f_norm = torch.sqrt(torch.sum(f * f, dim=(-2, -1)))[:, None, None]
    v_norm = torch.sqrt(torch.sum(v * v, dim=(-2, -1)))[:, None, None]
    v_mixed = (1 - alpha)[:, None, None] * v + \
        alpha[:, None, None] * f * v_norm / torch.clamp(f_norm, min=1e-12)

    uphill = power <= 0.0
    v_new = torch.where(uphill[:, None, None], 0.0, v_mixed)
    n_pos_new = torch.where(uphill, 0, n_pos + 1)
    grow = n_pos_new > _N_MIN
    dt_new = torch.where(uphill, dt * _F_DEC, torch.where(
        grow, torch.clamp(dt * _F_INC, max=dt0 * _DT_MAX_FACTOR), dt))
    alpha_new = torch.where(uphill, _ALPHA0,
                            torch.where(grow, alpha * _F_ALPHA, alpha))

    v_stepped = v_new + dt_new[:, None, None] * f
    step = dt_new[:, None, None] * v_stepped
    max_disp = torch.amax(torch.linalg.norm(step, dim=-1),
                          dim=-1)[:, None, None]
    scale = torch.clamp(_MAX_DISP / torch.clamp(max_disp, min=1e-12),
                        max=1.0)
    step = step * scale
    v_stepped = v_stepped * scale

    fmax_now = torch.amax(torch.linalg.norm(f, dim=-1), dim=-1)    # (B,)
    done_new = done | (fmax_now < fmax)
    c_new = torch.where(done_new[:, None, None], c, c + step)
    v_out = torch.where(done_new[:, None, None], 0.0, v_stepped)
    return (c_new, v_out, dt_new, alpha_new, n_pos_new, done_new)


def fire_run_eager(coords, energy_fn, n_steps, dt0, fmax, freeze_mask,
                   energy_args):
    '''The FIRE state after n_steps steps from rest, each step's ops
    queued one by one. On the CPU, where looking at `done` waits for
    nothing, the loop ends once every structure has stopped: from then on
    the coordinates stay, the velocities are zero, so every further step
    would find no power and only halve dt and reset the other two
    controls, which is done here at once.'''
    state = fire_init(coords, dt0)
    for step in range(n_steps):
        if not coords.is_cuda and bool(state[5].all()):
            c, v, dt, alpha, n_pos, done = state
            return (c, v, dt * _F_DEC ** (n_steps - step),
                    torch.full_like(alpha, _ALPHA0),
                    torch.zeros_like(n_pos), done)
        f = forces(state[0], energy_fn, energy_args, freeze_mask)
        state = fire_step(state, f, dt0, fmax)
    return state


def fire_run_graph(coords, energy_fn, n_steps, dt0, fmax, freeze_mask,
                   energy_args):
    '''fire_run_eager on a CUDA device with the step (forces by
    autograd, then fire_step) replayed from a CUDA graph (graph_loop),
    one graph for each energy function, dt0, fmax and shapes.'''
    def body(state, args):
        energy_args, freeze = args
        f = forces(state[0], energy_fn, energy_args, freeze)
        return fire_step(state, f, dt0, fmax)

    return graph_loop(body, fire_init(coords, dt0),
                      (energy_args, freeze_mask), n_steps)


def fire_run(coords, energy_fn, n_steps=500, dt0=0.05, fmax=0.05,
             freeze_mask=None, energy_args=()):
    '''The FIRE state (fire_init's six fields) after n_steps steps from
    rest at coords (B, N, 3): the graph form on a CUDA device, the eager
    form on the CPU.'''
    if freeze_mask is not None:
        freeze_mask = torch.as_tensor(freeze_mask, dtype=torch.bool,
                                      device=coords.device)
    run = fire_run_graph if coords.is_cuda else fire_run_eager
    return run(coords, energy_fn, n_steps, dt0, fmax, freeze_mask,
               energy_args)


@traced
def fire_minimize_batch(coords, energy_fn, n_steps=500, dt0=0.05,
                        fmax=0.05, freeze_mask=None, energy_args=()):
    '''
    Batched FIRE relaxation.
    coords: (B, N, 3) tensor; energy_fn: (coords, *energy_args) -> (B,)
    differentiable. energy_args is a tuple of tensors (tuples of tensors
    allowed): pass changing parameters (spring targets, FF tables)
    through it rather than closures, so one captured step serves every
    value.
    freeze_mask: optional (N,) or (B, N) bool, True atoms do not move.
    Returns (coords, energies, converged (B,) bool), on coords' device.

    On a CUDA device an energy_fn with a `fire_terms` attribute (the
    force field's family) is relaxed in one launch of
    ops/kernels/ff_fire.ff_fire on energy_fn.fire_terms(*energy_args);
    the returned energies are energy_fn's at the result. Every other
    energy, and every CPU run, takes fire_run.
    '''
    terms = getattr(energy_fn, 'fire_terms', None)
    if terms is not None and coords.is_cuda:
        from tscode_tpu_torch.ops.kernels.ff_fire import ff_fire
        c, done, _ = ff_fire(coords, terms(*energy_args), n_steps, dt0,
                             fmax, freeze_mask)
    else:
        state = fire_run(coords, energy_fn, n_steps, dt0, fmax,
                         freeze_mask, energy_args)
        c, done = state[0], state[5]
    with torch.no_grad():
        e = energy_fn(c, *energy_args)
    return c, e, done


def fire_minimize_batch_sharded(coords, energy_fn, mesh, n_steps=500,
                                dt0=0.05, fmax=0.05, energy_args=()):
    '''fire_minimize_batch with the batch cut into contiguous slices in
    mesh order, one on each device of `mesh` (energy_args copied to
    each), every slice queued before any result is read; on CUDA each
    slice launches the force field's kernel, or replays its own graph,
    on its own card. The results are
    gathered, in order, on coords' device. freeze_mask is not taken:
    the ensemble callers do not use it (as in the JAX package).'''
    from tscode_tpu_torch.parallel.sharding import gather, shard_rows
    parts = []
    for dev, rows in shard_rows(coords, mesh):
        args = map_tensors(energy_args, lambda t: t.to(dev))
        parts.append(fire_minimize_batch(rows.to(dev), energy_fn,
                                         n_steps=n_steps, dt0=dt0,
                                         fmax=fmax, energy_args=args))
    return tuple(gather([p[i] for p in parts], coords.device)
                 for i in range(3))


def fire_minimize(coords, energy_fn, *, device, **kwargs):
    '''Single-structure convenience wrapper: coords (N, 3) array ->
    (coords (N, 3) numpy, energy, converged).'''
    c, e, done = fire_minimize_batch(
        torch.as_tensor(np.asarray(coords), device=device)[None], energy_fn,
        **kwargs)
    return c[0].cpu().numpy(), float(e[0]), bool(done[0])


# ------------------------------------------------- single-band helpers


def fire_band_update(state, f, dt0, fmax):
    '''One FIRE step of ONE band or structure given precomputed forces
    f (same shape as the coordinates), with scalar controls: the
    integrator of the relaxations whose forces come from a host callback.
    Its time step grows to at most 4 dt0 and its displacement cap is
    0.05 A, tighter than fire_step's: stiff bonded potentials make it
    prone to runaway otherwise.'''
    c, v, dt, alpha, n_pos, done = state

    # convergence: the largest per-atom force under fmax freezes the
    # band (remaining steps become no-ops)
    done = done | (torch.amax(torch.linalg.norm(f, dim=-1)) < fmax)

    power = torch.sum(f * v)
    f_norm = torch.sqrt(torch.sum(f * f))
    v_norm = torch.sqrt(torch.sum(v * v))
    v_mixed = (1 - alpha) * v + \
        alpha * f * v_norm / torch.clamp(f_norm, min=1e-12)

    uphill = power <= 0.0
    v_new = torch.where(uphill, 0.0, v_mixed)
    n_pos_new = torch.where(uphill, 0, n_pos + 1)
    grow = n_pos_new > 5
    dt_new = torch.where(uphill, dt * 0.5, torch.where(
        grow, torch.minimum(dt * 1.1, dt0 * 4), dt))
    alpha_new = torch.where(uphill, 0.1,
                            torch.where(grow, alpha * 0.99, alpha))

    v_stepped = v_new + dt_new * f
    step = dt_new * v_stepped
    max_disp = torch.amax(torch.linalg.norm(step, dim=-1))
    scale = torch.clamp(0.05 / torch.clamp(max_disp, min=1e-12), max=1.0)
    step = torch.where(done, 0.0, step * scale)
    v_capped = torch.where(done, 0.0, v_stepped * scale)
    return (c + step, v_capped, dt_new, alpha_new, n_pos_new, done)


def fire_band_init(chain, dt0):
    '''The state fire_band_update advances, at rest at `chain`; dt0 a
    0-dim tensor.'''
    return (chain, torch.zeros_like(chain), dt0.clone(),
            chain.new_tensor(0.1),
            torch.zeros((), dtype=torch.int32, device=chain.device),
            torch.zeros((), dtype=torch.bool, device=chain.device))
