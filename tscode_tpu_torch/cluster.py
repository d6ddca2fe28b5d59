'''
The two clusterings of the conformer search, in numpy and torch (the JAX
package calls scikit-learn for them, tscode_tpu/torsions.py:278 and
:725; the port does not need it):

  dbscan_labels  DBSCAN with min_samples=1, which groups the torsions
                 whose bond centres lie close together;
  kmeans         k-means++ then Lloyd iterations, which picks the most
                 diverse conformers.

Random numbers come from an explicit np.random.RandomState, never from
numpy's global generator.
'''

import numpy as np
import torch

from tscode_tpu_torch.backend import get_device

# scikit-learn's KMeans defaults, which the JAX package's call keeps
N_INIT = 10
MAX_ITER = 300
TOL = 1e-4


def dbscan_labels(points, eps):
    '''Cluster labels of sklearn.cluster.dbscan(points, eps=eps,
    min_samples=1): with one sample enough for a core point, every
    point is a core point, so a cluster is a connected component of the
    graph joining points at most `eps` apart, and clusters are numbered
    in the order of their lowest index (the order in which DBSCAN
    meets them). points (n, d) -> (n,) int labels.'''
    points = np.asarray(points, dtype=float).reshape(len(points), -1)
    n = len(points)
    dist = np.sqrt(np.sum((points[:, None] - points[None, :]) ** 2, axis=-1))
    near = dist <= eps
    labels = np.full(n, -1, dtype=int)
    label = 0
    for seed in range(n):
        if labels[seed] >= 0:
            continue
        labels[seed] = label
        todo = [seed]
        while todo:
            i = todo.pop()
            new = np.nonzero(near[i] & (labels < 0))[0]
            labels[new] = label
            todo.extend(new.tolist())
        label += 1
    return labels


def _sq_dists(X, C, x2):
    '''(n, k) squared distances of the rows of X from the rows of C in
    matmul form (x2 = the rows' squared norms), clamped at 0.'''
    c2 = torch.sum(C * C, dim=1)
    return torch.clamp(x2[:, None] + c2[None, :] - 2.0 * (X @ C.T), min=0.0)


def _kmeans_plusplus(X, x2, k, rng):
    '''Greedy k-means++ seeding, as scikit-learn draws it: the first
    centre uniformly, each next one the best of 2 + log(k) candidates
    drawn in proportion to the squared distance from the nearest centre
    so far.'''
    n = X.shape[0]
    trials = 2 + int(np.log(k))
    ids = [int(rng.randint(n))]
    closest = _sq_dists(X, X[ids], x2)[:, 0]
    pot = float(closest.sum())
    for _ in range(1, k):
        draws = rng.uniform(size=trials) * pot
        cum = torch.cumsum(closest, dim=0).cpu().numpy()
        cand = np.minimum(np.searchsorted(cum, draws), n - 1)
        d = torch.minimum(closest[:, None], _sq_dists(X, X[cand], x2))
        pots = d.sum(dim=0)
        best = int(torch.argmin(pots))
        ids.append(int(cand[best]))
        closest, pot = d[:, best], float(pots[best])
    return X[ids].clone()


def _lloyd(X, x2, centers, tol):
    '''At most MAX_ITER Lloyd iterations from `centers`, until the
    centres move by at most `tol` (sum of squared shifts) or the labels
    stop changing. An empty
    cluster takes the point farthest from its own centre. Returns
    (labels, centres, inertia).'''
    n, k = X.shape[0], centers.shape[0]
    labels = None
    for _ in range(MAX_ITER):
        new = torch.argmin(_sq_dists(X, centers, x2), dim=1)
        counts = torch.bincount(new, minlength=k)
        sums = torch.zeros_like(centers).index_add_(0, new, X)
        moved = sums / torch.clamp(counts, min=1)[:, None].to(X.dtype)
        empty = torch.nonzero(counts == 0).flatten()
        if len(empty):
            far = torch.sum((X - centers[new]) ** 2, dim=1)
            moved[empty] = X[torch.argsort(far, descending=True)[:len(empty)]]
        shift = float(torch.sum((moved - centers) ** 2))
        centers = moved
        if labels is not None and torch.equal(new, labels):
            break
        labels = new
        if shift <= tol:
            break
    d = _sq_dists(X, centers, x2)
    labels = torch.argmin(d, dim=1)
    inertia = float(torch.gather(d, 1, labels[:, None]).sum())
    return labels, centers, inertia


def kmeans(features, k, rng, *, device):
    '''k-means of the rows of `features` into k clusters: N_INIT runs,
    each seeded by k-means++ from its own generator (their seeds drawn
    from `rng`, as scikit-learn's KMeans draws them from its
    random_state), Lloyd iterations in float64 on `device`, the run of
    lowest inertia kept. TOL is relative to the features' mean
    variance, as in scikit-learn. Returns (labels (n,), centres (k, d))
    as numpy arrays.

    It is not bit-equal to sklearn.cluster.KMeans: the seeding draws
    and the float summation orders differ, so the two may settle in
    different local minima where the clusters are not well separated.
    On well-separated data they find the same partition, up to the
    labels' order.'''
    device = get_device(device)
    X = torch.as_tensor(np.asarray(features, dtype=np.float64)
                        .reshape(len(features), -1), device=device)
    if not 1 <= k <= X.shape[0]:
        raise ValueError(f'k = {k} clusters for {X.shape[0]} samples')
    x2 = torch.sum(X * X, dim=1)
    tol = float(torch.mean(torch.var(X, dim=0, unbiased=False))) * TOL
    best = None
    for seed in rng.randint(np.iinfo(np.int32).max, size=N_INIT):
        init = _kmeans_plusplus(X, x2, k, np.random.RandomState(seed))
        run = _lloyd(X, x2, init, tol)
        if best is None or run[2] < best[2]:
            best = run
    return best[0].cpu().numpy(), best[1].cpu().numpy()
