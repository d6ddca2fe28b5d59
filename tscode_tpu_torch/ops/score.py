'''
Pose scoring on tensors (counterpart of tscode_tpu/ops/score.py): the sum
of |distance - target| over constrained atom pairs, the constrained
distances themselves and the signed fitness error, batched.
'''

import torch


def _pair_distances(structures, constrained_indices):
    b = torch.arange(structures.shape[0],
                     device=structures.device)[:, None]
    d = structures[b, constrained_indices[..., 0]] - \
        structures[b, constrained_indices[..., 1]]
    return torch.sqrt(torch.sum(d * d, dim=-1))


def score_embed_poses(structures, constrained_indices, constrained_distances):
    '''Sum over constraints of |distance - target|: structures (B, N, 3),
    constrained_indices (B, C, 2), constrained_distances (B, C) -> (B,)
    float32.'''
    d = _pair_distances(structures, constrained_indices)
    return torch.sum(torch.abs(d - constrained_distances),
                     dim=-1).to(torch.float32)


def constrained_distances(structures, constrained_indices):
    '''Distance of each constrained pair: structures (B, N, 3),
    constrained_indices (B, C, 2) int -> (B, C).'''
    return _pair_distances(structures, constrained_indices)


def fitness_scores(structures, constrained_indices, targets, target_valid):
    '''Signed error sum over the constraints whose target is valid:
    structures (B, N, 3), constrained_indices (B, C, 2), targets (B, C),
    target_valid (B, C) bool -> (B,).'''
    d = _pair_distances(structures, constrained_indices)
    err = torch.where(target_valid, d - targets, torch.zeros_like(d))
    return torch.sum(err, dim=-1)
