'''
Device-mesh scale-out of the screening pipeline (counterpart of
tscode_tpu/parallel/sharding.py), in one process.

The JAX package drives every device of its mesh from one controller
with `shard_map`; here one process holds a `Mesh`, a tuple of torch
devices, and queues each shard's work on its own device:

 * pose generation and clash screening are embarrassingly parallel:
   each device takes a contiguous slice of the rows in mesh order, so
   global index = shard offset + local index and every order-dependent
   rule (TFD novelty, greedy dedup, first-match prune) sees the rows in
   generation order;
 * all-pairs similarity needs every row: the ensemble is copied to each
   device, and each device decides its own rows against all columns;
 * results are gathered on the mesh's first device in shard order, and
   every shard's work is queued before the first host sync, so several
   cards overlap. A count taken on the host replaces `psum`.

A mesh may name one device several times (`make_mesh(devices=['cpu'] *
8)`, `['cuda:0'] * 4`): the counterpart of the JAX tests' virtual
8-device CPU mesh, which runs every sharded path in one process on one
device. `default_mesh(mesh)` installs such a mesh for the call sites.
'''

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from tscode_tpu_torch.ops.kernels.clash import compenetration_mask_kernel
from tscode_tpu_torch.ops.kernels.qcp import pair_gate_hits
from tscode_tpu_torch.ops.kernels.tfd import first_successor_pass, pass_rows
from tscode_tpu_torch.ops.linalg import (get_inertia_moments,
                                         rot_mat_from_pointer,
                                         rotation_matrix_from_vectors)


@dataclass(frozen=True)
class Mesh:
    '''The devices a stage shards over, in shard order (a device may be
    named more than once), and the name of the sharded axis.'''
    devices: tuple
    axis_name: str = 'poses'

    @property
    def size(self):
        return len(self.devices)


def _mesh_device(device):
    '''torch.device of a mesh entry; raises when it names a card that
    does not exist.'''
    dev = torch.device(device)
    if dev.type == 'cuda':
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        index = 0 if dev.index is None else dev.index
        if index >= count:
            raise RuntimeError(f'mesh device {device!r}: only {count} CUDA '
                               f'device(s) are visible')
        return torch.device('cuda', index)
    if dev.type != 'cpu':
        raise ValueError(f'unsupported mesh device {device!r}: use cuda '
                         f'or cpu')
    return dev


def make_mesh(n_devices=None, *, devices=None, axis_name='poses'):
    '''Mesh over the first n CUDA devices (all visible by default), or
    over `devices` as given (repeats allowed: a virtual mesh). Raises
    when more devices are asked for than exist: a silently smaller mesh
    would invalidate any scaling claim downstream.'''
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        n = n_devices or count
        if n < 1 or count < n:
            raise RuntimeError(
                f'requested a {n}-device mesh but only {count} CUDA '
                f'device(s) are visible; name the devices '
                f'(make_mesh(devices=[...])) for a virtual mesh')
        devices = [f'cuda:{i}' for i in range(n)]
    devices = tuple(_mesh_device(d) for d in devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(f'requested a {n_devices}-device mesh from '
                               f'{len(devices)} device(s)')
        devices = devices[:n_devices]
    if not devices:
        raise ValueError('a mesh needs at least one device')
    return Mesh(devices, axis_name)


_INSTALLED = []
_CUDA_MESH = {}


@contextlib.contextmanager
def default_mesh(mesh):
    '''Within the block, get_default_mesh() returns `mesh` (unless
    TSCODE_DISABLE_MESH=1): the tests' and the smoke script's way to put
    a virtual mesh behind the call sites.'''
    _INSTALLED.append(mesh)
    try:
        yield mesh
    finally:
        _INSTALLED.pop()


def get_default_mesh(axis_name='poses', device=None):
    '''The mesh the production pipeline shards over: the one installed
    by default_mesh, else every visible CUDA device when there are at
    least two; None when neither, when the mesh has one device (it
    would shard nothing; so a call site that gets a mesh shards), or
    when TSCODE_DISABLE_MESH=1. With `device` given (the run's device),
    None as well when the mesh holds devices of another type: a CPU run
    does not shard onto cards.'''
    if os.environ.get('TSCODE_DISABLE_MESH') == '1':
        return None
    if _INSTALLED:
        mesh = _INSTALLED[-1]
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count < 2:
            return None
        key = (count, axis_name)
        if key not in _CUDA_MESH:
            _CUDA_MESH[key] = make_mesh(count, axis_name=axis_name)
        mesh = _CUDA_MESH[key]
    if mesh.size < 2:
        return None
    if device is not None and any(d.type != torch.device(device).type
                                  for d in mesh.devices):
        return None
    return mesh


def mesh_wants(n_items, threshold=4096):
    '''Shard when the workload is big enough to pay for the copies, or
    always when TSCODE_MESH=1 forces it (the identity tests and the
    smoke script, where small shapes must still take the sharded
    path). Read per call. threshold=math.inf: only when forced.'''
    if os.environ.get('TSCODE_MESH') == '1':
        return True
    return n_items >= threshold


def mesh_for(n_items, threshold=4096, axis_name='poses', device=None):
    '''The default mesh when there is one (for `device`'s type) and the
    workload clears the size gate (mesh_wants), else None.'''
    mesh = get_default_mesh(axis_name, device)
    if mesh is None or not mesh_wants(n_items, threshold):
        return None
    return mesh


# ------------------------------------------------------------ row slices


def shard_bounds(n, size):
    '''[lo, hi) of `size` contiguous slices of n rows, in order, the
    first n % size one row longer (torch.tensor_split's cut).'''
    q, r = divmod(int(n), int(size))
    return [(i * q + min(i, r), (i + 1) * q + min(i + 1, r))
            for i in range(size)]


def shard_slices(n, mesh):
    '''(device, lo, hi) of each non-empty slice of n rows over the mesh;
    one empty slice on the first device when n == 0.'''
    out = [(dev, lo, hi) for dev, (lo, hi) in
           zip(mesh.devices, shard_bounds(n, mesh.size)) if hi > lo]
    return out or [(mesh.devices[0], 0, 0)]


def shard_rows(x, mesh):
    '''(device, rows) of each slice of x's rows over the mesh, the rows
    copied to their device (contiguous).'''
    return [(dev, x[lo:hi].to(dev).contiguous())
            for dev, lo, hi in shard_slices(x.shape[0], mesh)]


def gather(parts, device):
    '''The shards' tensors joined in shard order on `device`. Copies
    between cards are queued (non_blocking); a copy to the host waits
    for its data.'''
    device = torch.device(device)
    return torch.cat([p.to(device, non_blocking=device.type == 'cuda')
                      for p in parts])


def replicated(x, mesh):
    '''{device: x on it} for each distinct device of the mesh.'''
    return {dev: x.to(dev) for dev in dict.fromkeys(mesh.devices)}


# --------------------------------------------------------- sharded ops


def sharded_compenetration_mask(poses, pair_mask, mesh, thresh=1.5,
                                max_clashes=0):
    '''compenetration_mask_kernel (K2 on CUDA) sharded over the pose
    axis: each slice screened on its device. poses (B, N, 3) tensor or
    array (its dtype is kept). Returns (B,) bool numpy.'''
    poses = torch.as_tensor(poses)
    oks = [compenetration_mask_kernel(rows, pair_mask, thresh=thresh,
                                      max_clashes=max_clashes)
           for _, rows in shard_rows(poses, mesh)]
    return gather(oks, 'cpu').numpy()


def sharded_moments(structures, masses, mesh):
    '''Principal inertia moments sharded over the structure axis,
    float64. Returns (B, 3) numpy.'''
    x = torch.as_tensor(structures, dtype=torch.float64)
    m = torch.as_tensor(np.asarray(masses), dtype=torch.float64)
    parts = [get_inertia_moments(rows, m.to(dev))
             for dev, rows in shard_rows(x, mesh)]
    return gather(parts, 'cpu').numpy()


def sharded_first_similar_successor(tf, thresh, mesh, d=None, k=1,
                                    num_active=None):
    '''Mesh-parallel form of ops/kernels/tfd.first_successor_pass: one
    pass of the TFD prune's search over fingerprints tf (n, Q), the
    pass's rows sharded, the columns replicated, global indices: each
    shard's slice is one call on its device (one T1 launch on a card),
    queued for every shard before the one gather and the one host read.
    The pass (d, k, num_active) defaults to one chunk of all n rows,
    i.e. ops.tfd._first_similar_successor of tf. Returns (n,) numpy
    int64: for each row the chunk-relative index of its first similar
    successor, or -1.'''
    tf = torch.as_tensor(tf).contiguous()
    n = tf.shape[0]
    k = int(k)
    d = n // k if d is None else int(d)
    num_active = n if num_active is None else int(num_active)
    cover = pass_rows(d, k, num_active)
    cols = replicated(tf, mesh)
    parts = [first_successor_pass(cols[dev], d, k, num_active, thresh,
                                  rows=(lo, hi))
             for dev, lo, hi in shard_slices(cover, mesh)]
    first = np.full(n, -1, dtype=np.int64)
    first[:cover] = gather(parts, mesh.devices[0]).cpu().numpy()
    return first


def _one_shot_keep(parts, oks, rmsd_thr):
    '''The one-shot rule over shards: pose i (global order) dies when a
    later clash-ok pose j passes rmsd < thr and maxdev < 2*thr. parts:
    (device, lo, rows) per shard, oks their clash masks. Returns each
    shard's keep mask on its device. The gathered ensemble is built once
    per distinct device.'''
    all_poses = {dev: gather([r for _, _, r in parts], dev)
                 for dev in dict.fromkeys(d for d, _, _ in parts)}
    all_ok = {dev: gather(oks, dev) for dev in all_poses}
    keeps = []
    for (dev, lo, rows), ok in zip(parts, oks):
        Q, q_ok = all_poses[dev], all_ok[dev]
        i_g = lo + torch.arange(rows.shape[0], device=dev)
        j_g = torch.arange(Q.shape[0], device=dev)
        cand = q_ok[None, :] & (j_g[None, :] > i_g[:, None])
        kill = pair_gate_hits(rows, Q, cand, rmsd_thr).any(dim=1)
        keeps.append(ok & ~kill)
    return keeps


def sharded_screen_pipeline(mesh, rmsd_thr=0.5, clash_thresh=1.5):
    '''(poses, pair_mask) -> (keep (B,) bool on the mesh's first device,
    n_survivors int): the clash screen per shard (K2 on CUDA), then the
    one-shot RMSD kill of each shard's rows against the gathered
    ensemble: pose i dies when any later clash-ok pose j has rmsd < thr
    and maxdev < 2*thr (the k = 1 pass of the reference pruner in one
    shot).'''
    def step(poses, pair_mask):
        poses = torch.as_tensor(poses)
        parts = [(dev, lo, poses[lo:hi].to(dev).contiguous())
                 for dev, lo, hi in shard_slices(poses.shape[0], mesh)]
        oks = [compenetration_mask_kernel(rows, pair_mask,
                                          thresh=clash_thresh)
               for _, _, rows in parts]
        keep = gather(_one_shot_keep(parts, oks, rmsd_thr),
                      mesh.devices[0])
        return keep, int(keep.sum())
    return step


def sharded_embed_screen_step(mesh, rmsd_thr=0.5, clash_thresh=1.5):
    '''The whole device step over the mesh: each device builds its own
    slice of the string-embed grid (alignment rotation, spin, pose
    assembly), clash-screens it (K2 on CUDA) and prunes it against the
    gathered ensemble. Inputs: coords1 (C1, N1, 3), coords2 (C2, N2, 3),
    centers / vecs (C, K, 3) per molecule (replicated); c1, c2, a1, a2
    (B,) int grid indices and angles (B,) degrees (sharded); pair_mask
    (N, N). Returns (poses (B, N, 3), keep (B,) bool, both on the mesh's
    first device, n_survivors int).'''
    def step(coords1, coords2, centers1, vecs1, centers2, vecs2,
             c1, c2, a1, a2, angles, pair_mask):
        rep = [torch.as_tensor(x) for x in
               (coords1, coords2, centers1, vecs1, centers2, vecs2)]
        idx = [torch.as_tensor(np.asarray(x)).long() for x in (c1, c2, a1,
                                                                a2)]
        ang = torch.as_tensor(angles)
        reps = {dev: [x.to(dev) for x in rep]
                for dev in dict.fromkeys(mesh.devices)}
        parts, oks = [], []
        for dev, lo, hi in shard_slices(ang.shape[0], mesh):
            x1, x2, p1s, v1s, p2s, v2s = reps[dev]
            i1, i2, j1, j2 = (x[lo:hi].to(dev) for x in idx)
            p1, p2 = p1s[i1, j1], p2s[i2, j2]
            ref_vec, mol_vec = v1s[i1, j1], v2s[i2, j2]
            align = rotation_matrix_from_vectors(mol_vec, -ref_vec)
            spin = rot_mat_from_pointer(ref_vec, ang[lo:hi].to(dev))
            R = torch.einsum('bij,bjk->bik', spin, align)
            t = p1 - torch.einsum('bij,bj->bi', R, p2)
            f2 = torch.einsum('bij,bnj->bni', R, x2[i2]) + t[:, None, :]
            poses = torch.cat([x1[i1], f2], dim=1).contiguous()
            parts.append((dev, lo, poses))
            oks.append(compenetration_mask_kernel(poses, pair_mask,
                                                  thresh=clash_thresh))
        keeps = _one_shot_keep(parts, oks, rmsd_thr)
        dev0 = mesh.devices[0]
        keep = gather(keeps, dev0)
        return gather([p for _, _, p in parts], dev0), keep, int(keep.sum())
    return step
