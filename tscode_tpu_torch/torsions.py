'''
Torsional conformer search (counterpart of tscode_tpu/torsions.py).

Host side: rotable-bond discovery on the molecular graph (double bonds,
the Torsion class, the free/dummy-rotor rules, hydrogen bonds, rotation
masks, get_torsions; the symmetry-corrected RMSD prune uses them too)
and the grouping of torsions by DBSCAN (cluster.dbscan_labels).

Device side: every (starting point x angle set) candidate of a torsion
group is rotated in one batch, torsion after torsion, with the
reference's 5-degree clash back-off: on the card one launch of K1's
back-off entry `torsion_backoff` per torsion (every retreat step of
every candidate inside the kernel, the first clash-free retreat kept);
on the CPU the steps one by one on the rows still undecided. The search
runs in float64 on the run's device whatever the embed's dtype: one
flipped 1.5 A decision changes a whole conformer and every later random
draw.

Random draws (the shuffle of rsearch>, the diverse selection) come from
an explicit np.random.RandomState: seeded as numpy's global generator
is seeded before a JAX run, it draws the same stream.
'''

import time

import networkx as nx
import numpy as np
import torch

from tscode_tpu_torch.backend import get_device, synchronize, traced
from tscode_tpu_torch.cluster import dbscan_labels, kmeans
from tscode_tpu_torch.errors import SegmentedGraphError
from tscode_tpu_torch.graphs import (get_phenyl_ids, get_quadruplets,
                                     get_sp_n, graphize, is_amide_n,
                                     is_ester_o, is_sp_n, neighbors)
from tscode_tpu_torch.molecule import align_structures
from tscode_tpu_torch.ops.kernels.clash import (BACKOFF_STEP,
                                                backoff_retreat,
                                                backoff_terms, torsion_backoff,
                                                torsion_pairs)
from tscode_tpu_torch.ops.linalg import cartesian_product
from tscode_tpu_torch.ops.tfd import prune_conformers_tfd
from tscode_tpu_torch.parallel.sharding import gather, mesh_for, shard_slices
from tscode_tpu_torch.pt import SYMBOLS
from tscode_tpu_torch.utils import flatten, time_to_string

# --------------------------------------------------------- double bonds

# bond-length thresholds below which a bond counts as double (pair tag in
# alphabetical order). DELIBERATE EXTENSION of the reference table
# (utils.py:288-291 lists only CC and CN): the extra entries stop
# csearch from driving azo/carbonyl/thiocarbonyl and other pi bonds the
# reference would wrongly treat as rotable single bonds.
DOUBLE_BONDS_THRESHOLDS = {
    'CC': 1.4,
    'CN': 1.3,
    'CO': 1.29,
    'NN': 1.3,
    'NO': 1.25,
    'OO': 1.24,
    'CS': 1.6,
    'OS': 1.5,
    'NS': 1.58,
    'SS': 1.9,
}


def get_double_bonds_indices(coords, atomnos):
    '''Pairs of atom indices bonded more tightly than the double-bond
    threshold for their element pair (heavy atoms only).'''
    atomnos = np.asarray(atomnos)
    mask = atomnos != 1
    numbering = np.arange(len(atomnos))[mask]
    sub_coords = np.asarray(coords)[mask]
    sub_nos = atomnos[mask]

    out = []
    for a in range(len(sub_coords)):
        for b in range(a + 1, len(sub_coords)):
            tag = ''.join(sorted((SYMBOLS[int(sub_nos[a])],
                                  SYMBOLS[int(sub_nos[b])])))
            thr = DOUBLE_BONDS_THRESHOLDS.get(tag)
            if thr is not None and \
                    np.linalg.norm(sub_coords[a] - sub_coords[b]) < thr:
                out.append((int(numbering[a]), int(numbering[b])))
    return out


# -------------------------------------------------------------- Torsion

class Torsion:
    '''A rotable-bond candidate (reference torsion_module.py:41-132).'''

    def __init__(self, i1, i2, i3, i4):
        self.i1, self.i2, self.i3, self.i4 = i1, i2, i3, i4
        self.torsion = (i1, i2, i3, i4)

    def __repr__(self):
        if hasattr(self, 'n_fold'):
            return f'Torsion{self.torsion} {self.n_fold}-fold'
        return f'Torsion{self.torsion}'

    def in_cycle(self, graph):
        graph.remove_edge(self.i2, self.i3)
        cyclical = nx.has_path(graph, self.i1, self.i4)
        graph.add_edge(self.i2, self.i3)
        return cyclical

    def is_rotable(self, graph, hydrogen_bonds, keepdummy=False):
        if sorted((self.i2, self.i3)) in hydrogen_bonds:
            return False
        if _is_free(self.i2, graph) or _is_free(self.i3, graph):
            if keepdummy or (_is_nondummy(self.i2, self.i3, graph) and
                             _is_nondummy(self.i3, self.i2, graph)):
                self.n_fold = self.get_n_fold(graph)
                return True
        return False

    def get_n_fold(self, graph):
        nums = (graph.nodes[self.i2]['atomnos'],
                graph.nodes[self.i3]['atomnos'])
        if 1 in nums:
            return 6                      # H-N / H-O hydrogen-bond rotors
        if is_amide_n(self.i2, graph, mode=2) or \
                is_amide_n(self.i3, graph, mode=2):
            return 2                      # tertiary amides
        if 6 in nums or 7 in nums or 16 in nums:
            sp2 = get_sp_n(self.i2, graph)
            sp3 = get_sp_n(self.i3, graph)
            if 3 in (sp2, sp3):
                return 3
            if 2 in (sp2, sp3):
                return 2
        return 4

    def get_angles(self):
        return {2: (0, 180),
                3: (0, 120, 240),
                4: (0, 90, 180, 270),
                6: (0, 60, 120, 180, 240, 300)}[self.n_fold]

    def sort_torsion(self, graph, constrained_indices):
        '''Orient the quadruplet so rotation moves the side NOT containing
        constrained atoms (reference torsion_module.py:120-132).'''
        graph.remove_edge(self.i2, self.i3)
        for d in np.asarray(constrained_indices).flatten():
            if nx.has_path(graph, self.i2, int(d)):
                self.torsion = tuple(reversed(self.torsion))
        graph.add_edge(self.i2, self.i3)


def _is_free(index, graph):
    '''Whether a torsion hinged on this atom is conformationally free:
    conjugation locks carbonyl carbons, ester sp3 oxygens and
    secondary-amide nitrogens (reference torsion_module.py:134-156).'''
    carbonyl_like = (graph.nodes[index]['atomnos'] == 6
                     and is_sp_n(index, graph, 2)
                     and any(graph.nodes[n]['atomnos'] == 8
                             for n in neighbors(graph, index)))
    return not (carbonyl_like
                or is_amide_n(index, graph, mode=1)
                or is_ester_o(index, graph))


def _elements_match(n1, n2):
    return n1['atomnos'] == n2['atomnos']


def _is_nondummy(i, root, graph):
    '''A rotation about the (root, i) bond is "dummy" when every
    substituent branch on the far side of i is equivalent up to
    element-labeled isomorphism: spinning a methyl/CF3/tBu group or a
    symmetric flat ring (phenyl, N-pyrrolyl) yields no new conformer.
    Returns True when the rotation is worth sampling. Pinned to
    reference torsion_module.py:158-231, including its documented
    blind spots: only C/N hinge atoms are screened, and stereocenters
    are ignored (branches differing only by chirality count as equal,
    over-pruning in principle).'''
    if graph.nodes[i]['atomnos'] not in (6, 7):
        return True

    branches = [n for n in neighbors(graph, i) if n != root]

    # single linear continuation (that atom bonds only back to i and
    # one more): an alkyne/H-bond-like axis whose freedom some other
    # torsion already owns
    if len(branches) == 1 and len(neighbors(graph, branches[0])) == 2:
        return False

    if len(branches) == 2:
        ring = get_phenyl_ids(i, graph)
        if ring is not None:
            # cut the aromatic 6-ring along its para axis and compare
            # the ortho/meta halves (substituents included)
            r1, r2, r3, r4, r5, r6 = ring
            split = nx.restricted_view(
                graph, [], [(r3, r4), (r4, r5), (r1, r2), (r1, r6)])
            halves = [split.subgraph(c)
                      for c in nx.connected_components(split)
                      if r2 in c or r6 in c]
            if len(halves) == 2:
                return not nx.is_isomorphic(halves[0], halves[1],
                                            node_match=_elements_match)
            return True      # unexpected ring topology: keep sampling

    # general case: detach every branch from i and compare the
    # root-free components to each other
    pruned = nx.restricted_view(graph, [], [(i, n) for n in branches])
    detached = [c for c in nx.connected_components(pruned) if root not in c]
    if len(detached) == 1:
        # the branches reconnect away from i (e.g. tetramethylguanidyl
        # alanine's C(beta)-N bond): rotable
        return True
    parts = [pruned.subgraph(c) for c in detached]
    return not all(nx.is_isomorphic(parts[0], p,
                                    node_match=_elements_match)
                   for p in parts[1:])


def get_hydrogen_bonds(coords, atomnos, graph, d_min=2.5, d_max=3.3,
                       max_angle=45, fragments=None):
    '''Pairs of hydrogen-bonded atom indices
    (reference torsion_module.py:233-299).'''
    coords = np.asarray(coords)
    hbs = []
    het_idx = np.array([i for i, a in enumerate(atomnos) if a in (7, 8)],
                       dtype=int)

    def _angle(u, w):
        cos = np.clip(u @ w / np.linalg.norm(u) / np.linalg.norm(w), -1, 1)
        return np.degrees(np.arccos(cos))

    for a, i1 in enumerate(het_idx):
        for i2 in het_idx[a + 1:]:
            if fragments is not None:
                if any((i1 in f and i2 in f) for f in fragments):
                    continue
            d = np.linalg.norm(coords[i1] - coords[i2])
            if d_min < d < d_max:
                Hs = [i for i in (neighbors(graph, int(i1))
                                  + neighbors(graph, int(i2)))
                      if graph.nodes[i]['atomnos'] == 1]
                versor = (coords[i2] - coords[i1]) / d
                for iH in Hs:
                    v1 = coords[iH] - coords[i1]
                    v2 = coords[iH] - coords[i2]
                    d1, d2 = np.linalg.norm(v1), np.linalg.norm(v2)
                    l1 = v1 @ versor
                    l2 = v2 @ -versor
                    alfa = _angle(v1, versor) if l1 < l2 else _angle(v2, -versor)
                    if alfa < max_angle:
                        hbs.append(sorted((int(iH), int(i2 if d1 < d2 else i1))))
                        break
    return hbs


def get_rotation_mask(graph, torsion):
    '''Bool mask of atoms to move when rotating about the i2-i3 bond
    (reference torsion_module.py:301-325).'''
    i1, i2, i3, _ = torsion
    graph.remove_edge(i2, i3)
    reachable = nx.shortest_path(graph, i1).keys()
    graph.add_edge(i2, i3)
    mask = np.array([i in reachable for i in graph.nodes], dtype=bool)
    if np.count_nonzero(mask) > len(mask) // 2:
        mask = ~mask
    mask[i2] = False
    return mask


def get_torsions(graph, hydrogen_bonds, double_bonds, keepdummy=False):
    '''Rotable Torsion objects (reference torsion_module.py:352-371).'''
    torsions = []
    db_set = {tuple(sorted(db)) for db in double_bonds}
    for path in get_quadruplets(graph):
        _, i2, i3, _ = path
        if tuple(sorted((i2, i3))) in db_set:
            continue
        t = Torsion(*(int(x) for x in path))
        if (not t.in_cycle(graph)) and \
                t.is_rotable(graph, hydrogen_bonds, keepdummy=keepdummy):
            torsions.append(t)
    return torsions


def group_torsions_dbscan(coords, torsions, max_size=5):
    """Spatially group torsions so each group is <= max_size
    (reference torsion_module.py:373-397)."""
    centers = np.array([(coords[t.torsion[1]] + coords[t.torsion[2]]) / 2
                        for t in torsions])
    n_clusters = 1
    labels = np.zeros(len(torsions), dtype=int)
    for eps in np.arange(10, 1.5, -0.5):
        labels = dbscan_labels(centers, eps)
        n_clusters = max(labels) + 1
        biggest = max(np.count_nonzero(labels == i) for i in set(labels))
        if biggest <= max_size:
            break

    groups = [[] for _ in range(n_clusters)]
    for torsion, cluster in zip(torsions, labels):
        groups[cluster].append(torsion)
    return sorted(groups, key=len)


# ------------------------------------------------------ device hot loop

@traced
def rotate_batch_with_backoff(coords_batch, quad, move_mask, angles,
                              other_mask, max_steps):
    """Rotate one torsion by per-candidate angles with the reference's
    5-degree clash back-off (torsion_module.py:754-776): from the full
    rotation, retreat in 5-degree steps until the moved side no longer
    comes within 1.5 A of the static one or the rotation is undone. A
    retreat that reaches exactly zero and is clash-free still counts as
    rotated; angle-0 rows stay as they are and do not. Returns (new
    coords, rotated flags).

    coords_batch (B, N, 3) tensor; quad (4,) ints; move_mask and
    other_mask (N,) host bool arrays (other_mask leaves out i2 and i3);
    angles (B,) tensor of degrees; max_steps: retreat steps to try
    (steps past a row's own angle are invalid for it).

    On the card: one launch of K1's back-off entry `torsion_backoff`.
    On the CPU: the same arithmetic step by step (the Rodrigues terms
    fixed for the torsion, a step only takes the cosine and sine of its
    angle), each step on the rows still without a clash-free pose
    (`_pending_rows`)."""
    device = coords_batch.device
    if device.type != 'cpu':
        return torsion_backoff(coords_batch, quad, move_mask, angles,
                               other_mask, max_steps)
    retreat = backoff_retreat(coords_batch, backoff_terms(coords_batch, quad),
                              move_mask, angles,
                              torsion_pairs(move_mask, other_mask, device))
    best, found = _pending_rows(retreat, coords_batch, max_steps)
    rotated = found & (angles != 0.0)
    return torch.where(rotated[:, None, None], best, coords_batch), rotated


def _pending_rows(retreat, coords_batch, max_steps):
    """The back-off's loop on the CPU, where looking costs nothing: a
    step takes only the rows still without a clash-free pose, and the
    loop ends when none is left (an order of magnitude less back-off
    time than the plain twin's loop, clash.whole_batch, on the CPU for
    csearch_string's search: `python tests/test_torch_csearch.py`,
    PERF.md section 6)."""
    best = coords_batch.clone()
    found = torch.zeros(len(coords_batch), dtype=torch.bool)
    rows = torch.arange(len(coords_batch))
    for s in range(max_steps + 1):
        cand, ok = retreat(s, rows)
        best[rows[ok]] = cand[ok]
        found[rows[ok]] = True
        rows = rows[~ok]
        if not len(rows):
            break
    return best, found


def apply_torsion_group(coords_batch, torsions_group, graph, angle_sets):
    """Apply one angle-set column per torsion, torsion after torsion
    (the torsions of a group interact through their masks), each batched
    over the candidates. coords_batch (B, N, 3) tensor, angle_sets
    (B, T) host array. Returns (coords (B, N, 3), n_rotated (B,)).

    With a mesh for the batch (parallel.sharding.mesh_for, by the
    batch's device), the candidates are cut into contiguous slices, one
    per device, each rotated with its own back-off (one `torsion_backoff`
    launch per torsion and slice on CUDA), and joined in order on
    coords_batch's device (the JAX package's _rotate_backoff_sharded); a
    candidate's rotation depends on itself alone."""
    angle_sets = np.asarray(angle_sets)
    steps = [int(np.max(a) // BACKOFF_STEP) if len(a) and np.max(a) > 0
             else 0 for a in angle_sets.T]
    mesh = mesh_for(len(coords_batch), device=coords_batch.device)
    if mesh is None:
        return _rotate_group(coords_batch, torsions_group, graph,
                             angle_sets, steps)
    parts = [_rotate_group(coords_batch[lo:hi].to(dev), torsions_group,
                           graph, angle_sets[lo:hi], steps)
             for dev, lo, hi in shard_slices(len(coords_batch), mesh)]
    return tuple(gather([p[i] for p in parts], coords_batch.device)
                 for i in range(2))


def _rotate_group(coords_batch, torsions_group, graph, angle_sets, steps):
    """apply_torsion_group on one device, with max_steps[t] retreat
    steps for torsion t."""
    device = coords_batch.device
    n_rotated = torch.zeros(len(coords_batch), dtype=torch.int32,
                            device=device)
    if len(coords_batch) == 0:
        return coords_batch, n_rotated
    for t, torsion in enumerate(torsions_group):
        move_mask = get_rotation_mask(graph, torsion.torsion)
        other_mask = ~move_mask
        other_mask[list(torsion.torsion[1:3])] = False
        angles = np.asarray(angle_sets[:, t], dtype=float)
        coords_batch, rotated = rotate_batch_with_backoff(
            coords_batch, torsion.torsion, move_mask,
            torch.as_tensor(angles, dtype=coords_batch.dtype, device=device),
            other_mask, steps[t])
        n_rotated = n_rotated + rotated.to(torch.int32)
    return coords_batch, n_rotated


# ------------------------------------------------------------- csearch

def _new_stats(stats, **fields):
    """The search's record: counts and seconds of its parts (group,
    back-off, TFD prune, selection), in `stats` when one is given."""
    rec = stats if stats is not None else {}
    rec.update(fields)
    for k in ('group_s', 'backoff_s', 'tfd_s', 'select_s'):
        rec.setdefault(k, 0.0)
    return rec


def csearch(coords, atomnos, constrained_indices=None, keep_hb=False,
            ff_opt=False, n=100, n_out=100, mode=1, title='test',
            logfunction=print, *, rng, device, stats=None, calc=None,
            method=None, embedder=None):
    """Torsional conformer search (reference torsion_module.py:523-653).
    mode 0: clustered, keep the lowest-energy conformer of each cluster
            (needs ff_opt: every group's conformers are optimised on the
            calculator, `calc` and `method` or the embedder's force-field
            calculator, optimization.optimize_batch)
    mode 1: clustered, keep the most diverse
    mode 2: random angle sets
    rng: np.random.RandomState of the random draws; device: where the
    back-off, the TFD prune and the k-means run (in float64); stats: an
    optional dict that receives the search's counts and seconds.
    Returns the conformers (n, N, 3) as a numpy array."""
    t0 = time.perf_counter()
    device = get_device(device)
    coords = np.asarray(coords, dtype=float)
    rec = _new_stats(stats, title=title, mode=mode, torsions=0, groups=[],
                     candidates=0, conformers=1)
    if constrained_indices is not None and len(constrained_indices) > 0:
        logfunction(f'Constraining {len(constrained_indices)} distance'
                    f'{"s" if len(constrained_indices) > 1 else ""} - '
                    f'{constrained_indices}')
    else:
        logfunction('Free conformational search: no constraints provided.')
        constrained_indices = np.array([])

    graph = graphize(coords, atomnos)
    for i1, i2 in np.asarray(constrained_indices).reshape(-1, 2):
        graph.add_edge(int(i1), int(i2))

    if keep_hb:
        hydrogen_bonds = get_hydrogen_bonds(coords, atomnos, graph)
        for hb in hydrogen_bonds:
            graph.add_edge(*hb)
        logfunction(f'Preserving {len(hydrogen_bonds)} hydrogen bonds - '
                    f'{hydrogen_bonds}' if hydrogen_bonds
                    else 'No hydrogen bonds found.')
    else:
        hydrogen_bonds = []

    fragments = list(nx.connected_components(graph))
    if len(fragments) > 1:
        s = (f'{title} has a segmented connectivity graph: double check '
             'the input geometry.\nIf this is supposed to be a complex, '
             'no hydrogen bonds connecting the molecules were found, and '
             'the algorithm is not designed to reliably search loosely '
             'bound multimolecular arrangements.')
        if keep_hb:
            raise SegmentedGraphError(s)
        hydrogen_bonds.extend(get_hydrogen_bonds(coords, atomnos, graph,
                                                 fragments=fragments))
        if not hydrogen_bonds:
            raise SegmentedGraphError(s)
        for hb in hydrogen_bonds:
            graph.add_edge(*hb)
        if len(list(nx.connected_components(graph))) > 1:
            raise SegmentedGraphError(s)

    double_bonds = get_double_bonds_indices(coords, atomnos)
    torsions = get_torsions(graph, hydrogen_bonds, double_bonds)
    for t in torsions:
        t.sort_torsion(graph, np.asarray(constrained_indices))
    rec['torsions'] = len(torsions)

    if not torsions:
        logfunction(f'No rotable bonds found for {title}.')
        out = np.array([coords])
    elif mode in (0, 1):
        out = clustered_csearch(coords, atomnos, torsions, graph,
                                constrained_indices=constrained_indices,
                                ff_opt=ff_opt, n=n, n_out=n_out, mode=mode,
                                calc=calc, method=method, title=title,
                                logfunction=logfunction, embedder=embedder,
                                rng=rng, device=device, stats=rec)
    else:
        out = random_csearch(coords, atomnos, torsions, graph, n_out=n_out,
                             title=title, logfunction=logfunction, rng=rng,
                             device=device, stats=rec)
    rec.update(conformers=len(out), seconds=time.perf_counter() - t0)
    return out


def _log_torsions(torsions, atomnos, logfunction):
    logfunction('\n> Torsion list: (indices: n-fold)')
    for i, t in enumerate(torsions):
        logfunction(f' {i:2} - {str(t.torsion):21s} : {t.n_fold}-fold')
    central = set(flatten([t.torsion[1:3] for t in torsions], int))
    logfunction(f'\n> Rotable bonds ids: '
                f'{" ".join(str(int(i)) for i in sorted(central))}')


def _timed_backoff(rec, coords_batch, torsions, graph, angle_sets):
    """apply_torsion_group, its seconds (synced) added to the record;
    returns host arrays (coords, n_rotated)."""
    t0 = time.perf_counter()
    out, n_rotated = apply_torsion_group(coords_batch, torsions, graph,
                                         angle_sets)
    synchronize(coords_batch.device)
    rec['backoff_s'] += time.perf_counter() - t0
    rec['candidates'] += len(angle_sets)
    return out.cpu().numpy(), n_rotated.cpu().numpy()


# the reference's max_tries, which no caller of the search sets
MAX_TRIES = 10000


def random_csearch(coords, atomnos, torsions, graph, n_out=100,
                   title='test', logfunction=print, *, rng, device,
                   stats=None):
    """Random angle sets, batched on the device
    (reference torsion_module.py:399-521)."""
    t_start = time.perf_counter()
    rec = _new_stats(stats)
    _log_torsions(torsions, atomnos, logfunction)
    logfunction(f'\n--> Random dihedral CSearch on {title}\n    mode 2 '
                f'(random) - {len(torsions)} torsions')

    if len(torsions) == 0:
        logfunction('  No rotable bonds - returning no conformers')
        return np.zeros((0,) + coords.shape)
    angles = cartesian_product(*[np.array(t.get_angles())
                                 for t in torsions])
    if len(angles) == 0:
        logfunction('  No candidate angle sets - returning no conformers')
        return np.zeros((0,) + coords.shape)
    rng.shuffle(angles)

    # the reference walks the WHOLE shuffled pool, stopping when n_out
    # structures are accepted or when one is accepted at pool index ==
    # MAX_TRIES exactly (torsion_module.py:509-510: the bound check
    # lives inside the acceptance branch); here in device chunks with an
    # early exit between chunks
    accepted = []
    chunk = 8192
    start_coords = torch.as_tensor(coords, dtype=torch.float64,
                                   device=device)
    for start in range(0, len(angles), chunk):
        block = angles[start:start + chunk]
        new_coords, n_rotated = _timed_backoff(
            rec, start_coords.expand((len(block),) + coords.shape),
            torsions, graph, block)
        stop = False
        for j in np.nonzero(n_rotated > 0)[0]:
            accepted.append(new_coords[j])
            if len(accepted) == n_out or start + int(j) == MAX_TRIES:
                stop = True
                break
        if stop:
            break
    new_structures = np.array(accepted) if accepted else \
        np.zeros((0,) + coords.shape)

    exhaustiveness = len(new_structures) / np.prod(
        [t.n_fold for t in torsions])
    logfunction(f'  Generated {len(new_structures)} conformers, (est. '
                f'{round(100 * exhaustiveness, 2)} % of the total '
                f'conformational space) - CSearch time '
                f'{time_to_string(time.perf_counter() - t_start)}')
    return new_structures


def clustered_csearch(coords, atomnos, torsions, graph,
                      constrained_indices=None, ff_opt=False, n=100,
                      n_out=100, mode=1, calc=None, method=None,
                      title='test', logfunction=print, embedder=None, *,
                      rng, device, stats=None):
    """Grouped systematic rotation (reference torsion_module.py:655-847).
    With ff_opt every group's conformers are optimised on the calculator
    (optimization.optimize_batch, a thread pool of subprocesses) and the
    energies ride along: mode 0 keeps the most stable, mode 1 the most
    diverse (the lowest in energy of each cluster)."""
    assert mode != 0 or ff_opt, \
        'Either leave mode=1 or turn on force field optimization'
    assert mode in (0, 1)

    t_start_run = time.perf_counter()
    rec = _new_stats(stats)
    tag = ('stable', 'diverse')[mode]

    t0 = time.perf_counter()
    if len(torsions) < 9:
        grouped_torsions = [torsions]
    else:
        grouped_torsions = group_torsions_dbscan(
            coords, torsions, max_size=3 if ff_opt else 5)
    rec['group_s'] += time.perf_counter() - t0
    rec['groups'] = [len(t) for t in grouped_torsions]

    _log_torsions(torsions, atomnos, logfunction)
    logfunction(f'\n--> Clustered CSearch on {title}\n    mode {mode} '
                f'({"stability" if mode == 0 else "diversity"}) - '
                f'{len(torsions)} torsions in {len(grouped_torsions)} '
                f'group{"s" if len(grouped_torsions) != 1 else ""} - '
                f'{[len(t) for t in grouped_torsions]}')

    torsion_array = np.array([t.torsion for t in torsions])
    output_structures = []
    output_energies = []
    starting_points = np.array([coords])

    for tg, torsions_group in enumerate(grouped_torsions):
        angles = cartesian_product(*[np.array(t.get_angles())
                                     for t in torsions_group])
        candidates = len(angles) * len(starting_points)
        logfunction(f'\n> Group {tg + 1}/{len(grouped_torsions)} - '
                    f'{len(torsions_group)} bonds, '
                    f'{[t.n_fold for t in torsions_group]} n-folds, '
                    f'{len(starting_points)} starting point'
                    f'{"s" if len(starting_points) > 1 else ""} = '
                    f'{candidates} conformers')

        # (starting points x angle sets), the starting point varying
        # slowest to keep the reference's output order
        S, A = len(starting_points), len(angles)
        sp_batch = torch.as_tensor(np.repeat(starting_points, A, axis=0),
                                   dtype=torch.float64, device=device)
        rotated_coords, n_rotated = _timed_backoff(
            rec, sp_batch, torsions_group, graph, np.tile(angles, (S, 1)))

        # the reference emits each starting point, then its accepted
        # rotations (torsion_module.py:736-781)
        new_structures = []
        for s in range(S):
            new_structures.append(starting_points[s])
            block = slice(s * A, (s + 1) * A)
            new_structures.extend(rotated_coords[block][n_rotated[block] > 0])
        new_structures = np.array(new_structures)

        energies = None
        if ff_opt:
            from tscode_tpu_torch.optimization import optimize_batch
            new_structures, energies = optimize_batch(
                embedder, new_structures, atomnos, calc=calc, method=method,
                constrained_indices=constrained_indices,
                logfunction=logfunction)

        if tg + 1 != len(grouped_torsions):
            if n is not None and len(new_structures) > n:
                t0 = time.perf_counter()
                if mode == 0:
                    order = np.argsort(energies, kind='stable')
                    new_structures = new_structures[order][:n]
                    energies = np.asarray(energies)[order][:n]
                else:
                    new_structures, energies = most_diverse_conformers(
                        n, new_structures, torsion_array, energies=energies,
                        return_energies=True, rng=rng, device=device)
                rec['select_s'] += time.perf_counter() - t0
            logfunction(f'  Kept the most {tag} {len(new_structures)} '
                        f'starting points for next rotation cluster')

        # energies kept aligned with the aggregated structures (the
        # reference pairs the final selection against the last group's
        # energies through a truncating zip, torsion_module.py:830-840)
        output_structures.extend(new_structures)
        output_energies.extend(
            energies if energies is not None else [0.0] * len(new_structures))
        starting_points = new_structures

    t0 = time.perf_counter()
    output_structures, keep = prune_conformers_tfd(
        np.array(output_structures), torsion_array, device=device,
        mesh=mesh_for(len(output_structures), device=device))
    output_energies = np.array(output_energies)[keep]
    rec['tfd_s'] += time.perf_counter() - t0

    # gate on the LAST group's count, as the reference does (:829)
    if len(new_structures) > n_out:
        t0 = time.perf_counter()
        if mode == 0:
            order = np.argsort(output_energies, kind='stable')
            output_structures = output_structures[order][:n_out]
        else:
            output_structures = most_diverse_conformers(
                n_out, output_structures, torsion_array,
                energies=output_energies if ff_opt else None, rng=rng,
                device=device)
        rec['select_s'] += time.perf_counter() - t0

    exhaustiveness = len(output_structures) / np.prod(
        [t.n_fold for t in torsions])
    logfunction(f'  Selected the '
                f'{"best" if mode == 0 else "most diverse"} '
                f'{len(output_structures)} conformers, corresponding\n  to '
                f'about {round(100 * exhaustiveness, 2)} % of the total '
                f'conformational space - CSearch time '
                f'{time_to_string(time.perf_counter() - t_start_run)}')
    return output_structures


def most_diverse_conformers(n, structures, torsion_array, energies=None,
                            return_energies=False, *, rng, device):
    """TFD-prune then k-means-select the n most diverse structures
    (reference torsion_module.py:849-924). Above 300 the selection is n
    distinct structures drawn from `rng` (the reference draws with
    replacement; the JAX package fixed that, and so does the port).
    energies, when given, must be aligned with structures: each cluster
    then gives its lowest-energy member, and with return_energies=True
    the selected structures' energies come back too."""
    structures = np.asarray(structures)
    if energies is not None:
        energies = np.asarray(energies)
        assert len(energies) == len(structures)

    def ret(structs, ens):
        return (structs, ens) if return_energies else structs

    if len(structures) <= n:
        return ret(structures, energies)
    if n > 300:
        indices = np.sort(rng.choice(len(structures), size=n, replace=False))
        return ret(structures[indices],
                   energies[indices] if energies is not None else None)

    structures, keep = prune_conformers_tfd(structures, torsion_array,
                                            device=device)
    if energies is not None:
        energies = energies[keep]
    if len(structures) <= n:
        return ret(structures, energies)

    aligned = align_structures(structures)
    labels, centers = kmeans(aligned.reshape(len(aligned), -1), n, rng,
                             device=device)
    if energies is not None:
        clusters = [[] for _ in range(n)]
        for c_coords, energy, c in zip(aligned, energies, labels):
            clusters[c].append((c_coords, energy))
        picked = [sorted(group, key=lambda x: x[1])[0]
                  for group in clusters if group]
        return ret(np.array([p[0] for p in picked]),
                   np.array([p[1] for p in picked]))

    centers = centers.reshape((n, *aligned.shape[1:3]))
    clusters = [[] for _ in range(n)]
    for c_coords, c in zip(aligned, labels):
        clusters[c].append(c_coords)
    r = np.arange(n)
    output = []
    for ci, cluster in enumerate(clusters):
        if cluster:
            cumdists = [np.sum(np.linalg.norm(centers[r != ci] - ref, axis=2))
                        for ref in cluster]
            output.append(cluster[int(np.argmax(cumdists))])
    return ret(np.array(output), None)


def csearch_operator(embedder, mol, mode=1, keep_hb=False):
    """csearch>/csearch_hb>/rsearch> operator: a new Molecule whose
    ensemble is the searched conformers, one search from each input
    conformer with max_confs split between them (reference
    operators.py:158-224). Each search's record goes to
    embedder.search_info (the run report's `csearch`)."""
    from tscode_tpu_torch.molecule import Molecule
    embedder.log(f'--> {mol.rootname}: csearch operator (mode {mode})')

    keep_hb = keep_hb or embedder.options.keep_hb

    # internal constraints of this molecule (a letter used twice on it),
    # as the reference passes them (operators.py:187)
    mol_id = embedder.objects.index(mol) if mol in embedder.objects else None
    internal = None
    if mol_id is not None and mol_id in getattr(embedder, 'pairings_dict', {}):
        pairs = [tgt for tgt in embedder.pairings_dict[mol_id].values()
                 if isinstance(tgt, tuple)]
        internal = np.array(pairs) if pairs else None

    n_confs = len(mol.atomcoords)
    if n_confs > 1:
        embedder.log('    multimolecular file: individual search from '
                     'each conformer')
    if not hasattr(embedder, 'search_info'):
        embedder.search_info = []
    batches = []
    for i, start in enumerate(mol.atomcoords):
        # the operator searches without force-field optimisation, as the
        # reference's does (operators.py:184-194 passes no ff_opt)
        rec = {}
        batch = csearch(
            start, mol.atomnos, constrained_indices=internal,
            keep_hb=keep_hb, mode=mode,
            n_out=max(embedder.options.max_confs // n_confs, 1),
            title=f'{mol.rootname}_conf{i}' if n_confs > 1 else mol.rootname,
            logfunction=embedder.log, rng=embedder.rng,
            device=embedder.device, stats=rec)
        embedder.search_info.append(rec)
        if len(batch):
            batches.append(np.asarray(batch))
    conformers = np.concatenate(batches) if batches else mol.atomcoords[:1]

    new_mol = Molecule.__new__(Molecule)
    new_mol.__dict__.update(mol.__dict__)
    new_mol.atomcoords = np.asarray(conformers)
    new_mol.reactive_atoms = {}
    if len(mol.reactive_indices):
        new_mol.compute_orbitals()
    return new_mol
