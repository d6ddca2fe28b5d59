'''
Torsion fingerprint deviation (TFD) screening: counterpart of
tscode_tpu/ops/tfd.py.

Fingerprints are float32 dihedral vectors, as in the reference. Every
wrapped-L1 distance between two fingerprints is accumulated in float64,
torsion by torsion in index order, on every device: the same sums, in
the same order, as the native C++ replay (tscode_tpu/native/tfd_lru.cpp),
so the device novelty filter and the host replay decide alike on the
same fingerprints. (The JAX package accumulates in float32 on
accelerators and in its TFD prune; a decision can differ from it only
for a sum within float32 rounding of the threshold.) No (L, L, Q)
tensor is built: distances are accumulated over torsions.

Host side, as in the JAX package: the reference's bucketed prune
bookkeeping (first similar successor per structure, networkx
components, first node kept) and the sequential novelty replay.
'''

import networkx as nx
import numpy as np
import torch

from tscode_tpu_torch.ops.linalg import dihedral

K_SCHEDULE = (5e5, 2e5, 1e5, 5e4, 2e4, 1e4,
              5000, 2000, 1000, 500, 200, 100,
              50, 20, 10, 5, 2, 1)

_TFD_ROW_TILE = 512
_TFD_COL_TILE = 4096

# novelty filter: rows per block and accepted fingerprints the cache holds
_NOVELTY_BLOCK = 4096
_NOVELTY_CACHE = 1024
_ROUNDS_PER_SYNC = 4


def torsion_fingerprints(coords, quadruplets):
    '''Per-structure vector of dihedrals over torsion quadruplets.
    coords (..., N, 3) tensor; quadruplets (Q, 4) int -> (..., Q)
    float32 (computed in the coords' dtype, then cast).'''
    quads = torch.as_tensor(np.asarray(quadruplets, dtype=np.int64),
                            device=coords.device).reshape(-1, 4)
    return dihedral(coords[..., quads, :]).to(torch.float32)


def torsion_end_sines(coords, quadruplets):
    '''(..., Q) float64: for each torsion quadruplet (a, b, c, d), the
    smaller sine of its end angles a-b-c and b-c-d. Where it is ~0 the
    dihedral, and so that fingerprint entry, is rounding noise (an SN2
    leaving group on the axis of the reactive bond gives such a
    quadruplet). A diagnostic for tests and checks: the fingerprints
    keep every quadruplet, as the JAX package's do.'''
    quads = torch.as_tensor(np.asarray(quadruplets, dtype=np.int64),
                            device=coords.device).reshape(-1, 4)
    p = coords[..., quads, :].double()

    def sine(u, v):
        return torch.linalg.norm(torch.linalg.cross(u, v, dim=-1), dim=-1) \
            / (torch.linalg.norm(u, dim=-1) * torch.linalg.norm(v, dim=-1))

    b, c = p[..., 1, :], p[..., 2, :]
    return torch.minimum(sine(p[..., 0, :] - b, c - b),
                         sine(b - c, p[..., 3, :] - c))


def wrapped_l1(A, B):
    '''(R, Q) x (C, Q) -> (R, C) float64 total wrapped angle difference:
    per torsion |a - b|, or 360 - |a - b| past 180 degrees, summed in
    torsion order. With angles in [-180, 180] both differences are exact
    in float64, so min(d, |d - 360|) is the same number as the wrap.'''
    A, B = A.double(), B.double()
    acc = torch.zeros((A.shape[0], B.shape[0]), dtype=torch.float64,
                      device=A.device)
    for q in range(A.shape[1]):
        d = torch.abs(A[:, q, None] - B[None, :, q])
        acc += torch.minimum(d, torch.abs(d - 360.0))
    return acc


def _first_similar_successor(tf_chunk, thresh):
    '''For each row i of a chunk (L, Q) tensor, the smallest j > i with
    wrapped-L1 distance < thresh, or -1, as a numpy int64 array,
    computed in (512, 4096) tiles.'''
    L = tf_chunk.shape[0]
    dev = tf_chunk.device
    first = np.full(L, -1, dtype=np.int64)
    for r0 in range(0, L, _TFD_ROW_TILE):
        r1 = min(r0 + _TFD_ROW_TILE, L)
        i_g = torch.arange(r0, r1, device=dev)
        for c0 in range(r0, L, _TFD_COL_TILE):
            if (first[r0:r1] >= 0).all():
                break
            c1 = min(c0 + _TFD_COL_TILE, L)
            valid = ((wrapped_l1(tf_chunk[r0:r1], tf_chunk[c0:c1]) < thresh)
                     & (torch.arange(c0, c1, device=dev)[None, :]
                        > i_g[:, None]))
            firsts = torch.where(valid.any(dim=1),
                                 valid.to(torch.uint8).argmax(dim=1) + c0,
                                 -1).cpu().numpy()
            undecided = first[r0:r1] < 0
            first[r0:r1] = np.where(undecided, firsts, first[r0:r1])
    return first


def prune_conformers_tfd(structures, quadruplets, thresh=10, tf_mat=None,
                         device='cpu', dtype=torch.float64):
    '''Prune torsionally similar structures; returns (pruned, keep_mask)
    as numpy arrays. The reference's bucketed loop:
     * per k in the schedule, run only when k == 1 or 5k < #active;
     * chunk boundaries use the ORIGINAL array length, but the last chunk
       ends at the current active count (reference quirk);
     * within a chunk each structure gives an edge to its FIRST similar
       successor only; the matches go through a python set into a
       networkx graph, and each connected component keeps its first
       node in that graph's order.
    Fingerprints and distance tiles are computed on `device` (from
    structures in `dtype`); the bookkeeping stays on the host.'''
    structures = np.asarray(structures)
    n = len(structures)
    if n == 0 or len(quadruplets) == 0:
        return structures, np.ones(n, dtype=bool)

    if tf_mat is None:
        tf_mat = torsion_fingerprints(
            torch.as_tensor(structures, dtype=dtype, device=device),
            quadruplets)
    else:
        tf_mat = torch.as_tensor(np.asarray(tf_mat), dtype=torch.float32,
                                 device=device)

    final_mask = np.ones(n, dtype=bool)
    for k in K_SCHEDULE:
        num_active = int(np.count_nonzero(final_mask))
        if not (k == 1 or 5 * k < num_active):
            continue

        d = int(n // k)
        for step in range(int(k)):
            lo = d * step
            hi = num_active if step == k - 1 else int(d * (step + 1))
            _l = hi - lo
            if _l <= 1:
                continue

            first = _first_similar_successor(tf_mat[lo:lo + _l],
                                             float(thresh))
            matches = set()
            for i_rel in range(_l):
                if first[i_rel] >= 0:
                    matches.add((int(i_rel), int(first[i_rel])))
            if not matches:
                continue

            g = nx.Graph(matches)
            groups = [tuple(g.subgraph(c).nodes)
                      for c in nx.connected_components(g)]
            for group in groups:
                for i in set(group) - {group[0]}:
                    final_mask[i + lo] = False

    return structures[final_mask], final_mask


# ---------------------------------------------- device novelty filter
#
# Exact parallel replay of the string embed's sequential novelty rule
# (accept pose i iff its fingerprint is at least `thresh` from EVERY
# earlier accepted one), as in the JAX package's _tfd_novelty_scan:
#
#  * rejection only comes from an ACCEPTED earlier pose, so a block of
#    rows is first compared with the cache of accepted fingerprints;
#    the rows that no cached fingerprint rejects are the undecided ones;
#  * within the block, an undecided row is decidable once none of its
#    similar predecessors is undecided; each round decides at least the
#    first undecided row, so the rounds converge in chain-length rounds.
#
# The JAX scan is one program (lax.scan over blocks, lax.cond, a rounds
# while_loop). Here the blocks are a host loop, and the host syncs once
# per block (the undecided rows) plus once per four rounds (the
# undecided and accepted counts), so it knows the cache's fill: a block
# is compared with the accepted fingerprints only, not with the whole
# fixed-size cache. Only the undecided rows enter the within-block
# matrix: rows that the cache rejects can neither be accepted nor reject
# a later row, so this equals the JAX block matrix where it is read. The
# JAX scan pads the pool to a power of two; padded rows are never live,
# so the loop stops at the last real row instead.


def novelty_block(block):
    '''The JAX package's block rule: below 8, or not a power of two,
    rounds up to the next power of two (at least 8).'''
    block = int(block)
    if block < 8 or block & (block - 1):
        block = max(8, 1 << max(0, block - 1).bit_length())
    return block


def tfd_novelty_device(fingerprints, accept_mask=None, thresh=10,
                       block=_NOVELTY_BLOCK, cache_cap=_NOVELTY_CACHE,
                       stats=None):
    '''Device form of is_new_structure_lru over a fingerprint tensor
    (B, Q) on any device: only the novelty mask goes to the host.
    Returns (novel (B,) numpy bool, ok). ok=False (more than cache_cap
    accepted rows, or no rows or no torsions) means the caller must use
    the host replay instead. `stats`, a dict when given, receives the
    blocks run, the host syncs and the rounds.'''
    block = novelty_block(block)
    B = int(fingerprints.shape[0])
    Q = int(fingerprints.shape[1]) if fingerprints.dim() == 2 else 0
    if B == 0 or Q == 0:
        return np.zeros(B, dtype=bool), False
    dev = fingerprints.device
    fps = fingerprints.to(torch.float32).double()
    accept = (torch.ones(B, dtype=torch.bool, device=dev)
              if accept_mask is None
              else torch.as_tensor(accept_mask, device=dev).to(torch.bool))

    novel = torch.zeros(B, dtype=torch.bool, device=dev)
    # accepted fingerprints in acceptance order; the last row takes the
    # scatter of the rows that are not accepted
    cache = torch.zeros((cache_cap + 1, Q), dtype=torch.float64, device=dev)
    count = 0          # accepted so far, known on the host
    n_blocks = n_syncs = n_rounds = 0

    for lo in range(0, B, block):
        f = fps[lo:lo + block]
        n_blocks += 1
        live = accept[lo:lo + block]
        if count:
            live = live & ~torch.any(wrapped_l1(f, cache[:count]) < thresh,
                                     dim=1)
        und_idx = torch.nonzero(live)
        n_syncs += 1
        if und_idx.numel() == 0:
            continue
        und_idx = und_idx.squeeze(1)
        fu = f[und_idx]
        u = und_idx.numel()
        pos = torch.arange(u, device=dev)
        sim = (wrapped_l1(fu, fu) < thresh) & (pos[None, :] < pos[:, None])

        und = torch.ones(u, dtype=torch.bool, device=dev)
        acc = torch.zeros(u, dtype=torch.bool, device=dev)
        while True:
            # a round after the last decision changes nothing, so the
            # host reads the undecided and accepted counts every few
            # rounds only
            for _ in range(_ROUNDS_PER_SYNC):
                has_und_pred = torch.any(sim & und[None, :], dim=1)
                dec = und & ~has_und_pred
                rej = torch.any(sim & acc[None, :], dim=1)
                und, acc = und & ~dec, acc | (dec & ~rej)
            n_rounds += _ROUNDS_PER_SYNC
            n_syncs += 1
            n_und, n_acc = torch.stack([und.sum(), acc.sum()]).tolist()
            if n_und == 0:
                break

        novel[lo + und_idx] = acc
        if count + n_acc > cache_cap:
            count += n_acc
            break
        rank = torch.cumsum(acc, 0) - 1
        cache[torch.where(acc, count + rank, cache_cap)] = fu
        count += n_acc

    ok = count <= cache_cap
    if stats is not None:
        stats.update(blocks=n_blocks, host_syncs=n_syncs + 1,
                     rounds=n_rounds, block=block)
    if not ok:
        return np.zeros(B, dtype=bool), False
    return novel.cpu().numpy(), True


def is_new_structure_lru(fingerprints, accept_mask, thresh=10):
    '''Host replay of the string embed's sequential TFD novelty filter:
    in generation order, keep a pose if its fingerprint differs from
    every previously accepted one. (The reference's 5-entry cache trim
    never takes effect, so the comparison is against ALL accepted
    poses.) fingerprints (B, Q) float32 numpy; accept_mask (B,) bool.
    Returns (B,) bool. Runs through the native C++ loop when it built.'''
    fingerprints = np.asarray(fingerprints)
    if fingerprints.size:
        from tscode_tpu_torch import native
        if native.tfd_available():
            return native.tfd_lru_filter(fingerprints,
                                         np.asarray(accept_mask), thresh)
    out = np.zeros(len(fingerprints), dtype=bool)
    cache = np.empty((0, fingerprints.shape[1]), dtype=fingerprints.dtype)
    for i in np.nonzero(np.asarray(accept_mask))[0]:
        tfp = fingerprints[i]
        if len(cache):
            deltas = np.abs(tfp[None, :] - cache)
            deltas = np.abs(deltas - (deltas > 180) * 360.0)
            if np.any(deltas.sum(axis=1) < thresh):
                continue
        out[i] = True
        cache = np.concatenate([cache, tfp[None, :]])
    return out
