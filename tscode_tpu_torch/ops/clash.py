'''
Batched clash / compenetration screening (counterpart of
tscode_tpu/ops/clash.py, the part the embed -> clash -> prune slice runs).

Kernel choice (replacing `use_pallas_clash`): a CUDA tensor goes through
the hand-written clash kernel, a CPU tensor through its plain matmul-form
twin. The TPU's 1024-pair unroll cap does not carry over: the CUDA
kernel takes its pair list at run time.
'''

import numpy as np
import torch

from tscode_tpu_torch.ops.kernels.clash import (clash_counts_plain,
                                                compenetration_mask_kernel,
                                                pairwise_dist2, static_pairs)

__all__ = ['fragment_labels', 'cross_fragment_pair_mask', 'static_pairs',
           'pairwise_dist2', 'count_cross_clashes', 'compenetration_mask',
           'count_intra_clashes', 'count_intra_clashes_np']


def fragment_labels(ids):
    '''Fragment id per atom from contiguous fragment lengths.
    ids: sequence of ints -> (N,) int array.'''
    return np.repeat(np.arange(len(ids)), np.asarray(ids, dtype=int))


def cross_fragment_pair_mask(ids, n_pad=None):
    '''(N, N) bool numpy mask, True for atom pairs of different fragments,
    each unordered pair once (f_i < f_j). Padding rows/cols are False.'''
    labels = fragment_labels(ids)
    n = len(labels)
    n_pad = n_pad or n
    full = np.zeros((n_pad, n_pad), dtype=bool)
    full[:n, :n] = labels[:, None] < labels[None, :]
    return full


def count_cross_clashes(poses, pair_mask, thresh=1.5):
    '''Number of masked atom pairs closer than `thresh`, per pose.
    poses (B, N, 3); pair_mask (N, N) bool -> (B,) int32.'''
    mask = torch.as_tensor(pair_mask, dtype=torch.bool, device=poses.device)
    return clash_counts_plain(poses, mask, thresh)


def compenetration_mask(poses, pair_mask, thresh=1.5, max_clashes=0):
    '''Accept mask of a pose batch: True when the pose shows at most
    `max_clashes` masked contacts below `thresh` Angstrom. CUDA tensors
    run the clash kernel, CPU tensors its plain twin.'''
    return compenetration_mask_kernel(poses, pair_mask, thresh, max_clashes)


def count_intra_clashes(coords, atom_mask=None, thresh=0.5):
    '''The same count on the device, plain PyTorch in the matmul form:
    per structure, the ordered atom pairs (of atom_mask's atoms, when
    given) with 1e-6 A^2 < d^2 < thresh^2, the diagonal left out.
    coords (..., N, 3) tensor -> (...,) int32.'''
    d2 = pairwise_dist2(coords, coords)
    n = coords.shape[-2]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=coords.device)
    hit = (d2 < thresh * thresh) & (d2 > 1e-6) & off_diag
    if atom_mask is not None:
        m = torch.as_tensor(atom_mask, dtype=torch.bool, device=coords.device)
        hit = hit & m[..., :, None] & m[..., None, :]
    return torch.sum(hit, dim=(-2, -1)).to(torch.int32)


def count_intra_clashes_np(coords, thresh=0.5):
    '''Host numpy sanity count for small inputs (the Embedder's check of
    its input conformers): per structure, the ordered atom pairs with
    1e-3 A < d < thresh, so each unordered pair counts twice and
    coincident atoms are excluded. coords (..., N, 3) -> (...,) int32.'''
    coords = np.asarray(coords)
    n = coords.shape[-2]
    off_diag = ~np.eye(n, dtype=bool)
    flat = coords.reshape(-1, n, 3)
    out = np.empty(flat.shape[0], dtype=np.int32)
    # chunk the batch axis so the (b, N, N) distance tensor stays small
    step = max(1, int(2e7) // (n * n))
    for b0 in range(0, flat.shape[0], step):
        c = flat[b0:b0 + step]
        d2 = np.sum((c[:, :, None, :] - c[:, None, :, :]) ** 2, axis=-1)
        hit = (d2 < thresh * thresh) & (d2 > 1e-6) & off_diag
        out[b0:b0 + step] = hit.sum(axis=(-2, -1))
    return out.reshape(coords.shape[:-2])
