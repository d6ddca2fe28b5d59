'''
Non-covalent interaction (NCI) guessing (counterpart of
tscode_tpu/nci.py; host numpy).

Given a multimolecular pose, guess the hydrogen bonds, pi-stacking and
halogen contacts acting BETWEEN fragments, from distance thresholds
(parameters.NCI_DICT) plus aromatic six-ring detection. Behavioral spec:
TSCoDe's nci.py:28-181 and print_nci at embedder.py:2053-2096.

Unlike the reference's per-atom double loop, everything here runs on
whole distance matrices: one (N, N) pair sweep for atomic contacts, one
batched planarity test over all candidate six-rings, and centroid
distance matrices for the ring terms. Results are emitted in ascending
(i, j) index order, matching the reference's loop order.
'''

from itertools import combinations

import numpy as np

from tscode_tpu_torch.parameters import NCI_DICT
from tscode_tpu_torch.pt import SYMBOLS


def _fragment_owners(n_atoms, ids):
    '''Owner fragment index for each of n_atoms atoms, given per-fragment
    atom counts `ids`.'''
    return np.repeat(np.arange(len(ids)), ids)[:n_atoms]


def _distance_matrix(a, b=None):
    b = a if b is None else b
    diff = np.asarray(a)[:, None, :] - np.asarray(b)[None, :, :]
    return np.sqrt((diff * diff).sum(-1))


def _pair_contacts(coords, symbols, constrained_flat, owners):
    '''Atomic-pair NCIs across fragments, one vectorized sweep per entry
    of NCI_DICT (reference nci.py:54-89, rewritten over a distance
    matrix). Returns ascending-(i, j)-ordered (prints, tuples).'''
    n = len(coords)
    dist = _distance_matrix(coords)

    free = np.ones(n, bool)
    free[np.asarray(constrained_flat, dtype=int)] = False

    # candidate pairs: i < j, different fragments, neither constrained
    eligible = (owners[:, None] != owners[None, :])
    eligible &= np.triu(np.ones((n, n), bool), k=1)
    eligible &= free[:, None] & free[None, :]

    # one boolean screen per two-element tag ('HO', 'FF', ...)
    sym_arr = np.asarray(symbols)
    hits = np.zeros((n, n), bool)
    pair_info = {}
    for tag, (threshold, nci_type) in NCI_DICT.items():
        if 'Ph' in tag:
            continue  # ring terms handled separately
        s1, s2 = tag[0], tag[1:]
        tag_mask = ((sym_arr[:, None] == s1) & (sym_arr[None, :] == s2))
        tag_mask |= ((sym_arr[:, None] == s2) & (sym_arr[None, :] == s1))
        found = eligible & tag_mask & (dist < threshold)
        hits |= found
        for i, j in zip(*np.nonzero(found)):
            pair_info[(int(i), int(j))] = (nci_type, dist[i, j])

    prints, tuples = [], []
    for i, j in sorted(pair_info):
        nci_type, d = pair_info[(i, j)]
        prints.append(f'{nci_type} ({round(d, 2)} A, indices {i}/{j})')
        tuples.append((nci_type, i, j))
    return prints, tuples


def _find_aromatic_rings(coords, symbols, owners):
    '''(owner, centroid) of every six-ring of C/N atoms within one
    fragment that passes the compactness + planarity test of
    graphs.is_phenyl (reference nci.py:141-181 / graph_manipulations.py:
    152-174), evaluated as one batched test over all candidate rings.'''
    coords = np.asarray(coords)
    sym_arr = np.asarray(symbols)
    ring_owners, ring_atom_sets = [], []
    for frag in range(int(owners.max()) + 1 if len(owners) else 0):
        members = np.nonzero((owners == frag)
                             & ((sym_arr == 'C') | (sym_arr == 'N')))[0]
        if len(members) < 6:
            continue
        for ring in combinations(members.tolist(), 6):
            ring_atom_sets.append(ring)
            ring_owners.append(frag)
    if not ring_atom_sets:
        return []

    rings = coords[np.asarray(ring_atom_sets)]          # (R, 6, 3)
    # compactness: every intra-ring pair within 3 A
    diff = rings[:, :, None, :] - rings[:, None, :, :]
    compact = np.sqrt((diff * diff).sum(-1)).max(axis=(1, 2)) <= 3.0
    # planarity: 0-1-2-3 dihedral within 10 degrees of 0/180
    b01 = rings[:, 1] - rings[:, 0]
    b12 = rings[:, 2] - rings[:, 1]
    b23 = rings[:, 3] - rings[:, 2]
    n1 = np.cross(b01, b12)
    n2 = np.cross(b12, b23)
    cos_d = (n1 * n2).sum(-1) / np.maximum(
        np.linalg.norm(n1, axis=-1) * np.linalg.norm(n2, axis=-1), 1e-300)
    flat = (1.0 - np.abs(np.clip(cos_d, -1.0, 1.0))
            ) < (1.0 - np.cos(np.radians(10)))

    keep = compact & flat
    centroids = rings.mean(axis=1)
    return [(ring_owners[r], centroids[r]) for r in np.nonzero(keep)[0]]


def _ring_contacts(coords, symbols, owners, rings):
    '''Ring-atom and ring-ring NCIs (reference nci.py:91-139). The
    reference mis-assigns every atom to fragment 0 here (a shadowed
    generator variable at nci.py:103); we use the true owner.'''
    prints, tuples = [], []
    if not rings:
        return prints, tuples

    centers = np.stack([c for _, c in rings])
    ring_own = np.asarray([o for o, _ in rings])
    sym_arr = np.asarray(symbols)

    atom_dist = _distance_matrix(centers, coords)        # (R, N)
    other_frag = ring_own[:, None] != np.asarray(owners)[None, :]
    for tag, (threshold, nci_type) in NCI_DICT.items():
        if 'Ph' not in tag or tag == 'PhPh':
            continue
        partner = tag.replace('Ph', '')
        found = other_frag & (sym_arr[None, :] == partner) \
            & (atom_dist < threshold)
        for r, i in zip(*np.nonzero(found)):
            prints.append(f'{nci_type} '
                          f'({round(atom_dist[r, i], 2)} A, atom {i}/ring)')
            tuples.append((nci_type, int(i), 'ring'))

    threshold, nci_type = NCI_DICT['PhPh']
    ring_dist = _distance_matrix(centers)
    stacked = (ring_own[:, None] != ring_own[None, :]) \
        & np.triu(np.ones(ring_dist.shape, bool), k=1) \
        & (ring_dist < threshold)
    for r1, r2 in zip(*np.nonzero(stacked)):
        prints.append(f'{nci_type} ({round(ring_dist[r1, r2], 2)} A, '
                      'ring/ring)')
        tuples.append((nci_type, 'ring', 'ring'))
    return prints, tuples


def _get_aromatic_centers(coords, symbols, ids):
    '''Kept as the test-facing name for ring detection.'''
    return _find_aromatic_rings(coords, symbols,
                                _fragment_owners(len(coords), ids))


def get_nci(coords, atomnos, constrained_indices, ids):
    '''Guessed intermolecular NCIs for one pose: (nci tuples, log lines)
    (reference nci.py:28-52).'''
    symbols = [SYMBOLS[int(a)] for a in atomnos]
    owners = _fragment_owners(len(coords), ids)
    constrained_flat = np.asarray(constrained_indices).ravel()

    prints, tuples = _pair_contacts(coords, symbols, constrained_flat,
                                    owners)
    rings = _find_aromatic_rings(coords, symbols, owners)
    ring_prints, ring_tuples = _ring_contacts(coords, symbols, owners,
                                              rings)
    return tuples + ring_tuples, prints + ring_prints


def print_nci(embedder):
    '''Log guessed NCIs per pose + a differential report
    (reference embedder.py:2053-2096).'''
    embedder.log('--> Non-covalent interactions spotting')
    embedder.nci = []

    if getattr(embedder, 'ids', None) is None:
        # refine>/REFINE runs carry no molecule partition, and NCIs here
        # are inter-fragment by definition (the reference crashes on
        # np.cumsum(None) in the same situation — fixed to a clear skip)
        embedder.log('    Skipped: no intermolecular partition available '
                     'for a refine run.\n')
        return

    for i, structure in enumerate(embedder.structures):
        nci, print_list = get_nci(structure, embedder.atomnos,
                                  embedder.constrained_indices[i],
                                  embedder.ids)
        embedder.nci.append(nci)
        if nci:
            embedder.log(f'Structure {i + 1}: {len(nci)} interactions')
            for p in print_list:
                embedder.log('    ' + p)

    # differential report: interactions not shared by every pose
    if len([_f for _f in embedder.nci if _f]) == 0:
        embedder.log('No particular NCIs spotted for these structures\n')
    else:
        unshared = []
        shared = set.intersection(*[set(map(repr, n))
                                    for n in embedder.nci]) \
            if all(embedder.nci) else set()
        for i, nci_list in enumerate(embedder.nci):
            extra = [n for n in nci_list if repr(n) not in shared]
            if extra:
                unshared.append((i + 1, extra))
        if unshared:
            embedder.log('\n--> Differential NCIs found - these are '
                         'the structure-specific ones:')
            for idx, extra in unshared:
                embedder.log(f'Structure {idx}: {extra}')
        embedder.log()
