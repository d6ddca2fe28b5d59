'''The TFD novelty kernel V1's plain twin on the CPU:
ops/kernels/tfd_novelty.novelty_plain against the JAX package's jitted
_tfd_novelty_scan (x64) and its host replay is_new_structure_lru, and
the port's CPU loop tfd_novelty_device: chains inside a block, the
180-degree wrap, accept masks, cache overflow at a small cache_cap and
several block sizes; the launch plan and the routing of a card tensor.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu.ops import tfd as jt
from tscode_tpu_torch.ops import tfd as tt
from tscode_tpu_torch.ops.kernels import tfd_novelty as v1
from test_torch_tfd import chain_fps, clustered_fps


def jax_scan(fps, accept, block, cache_cap):
    '''_tfd_novelty_scan on fps padded to whole blocks: (novel, ok,
    n_accepted).'''
    B = len(fps)
    Bp = -(-B // block) * block
    fp = np.zeros((Bp, fps.shape[1]), np.float32)
    fp[:B] = fps
    ac = np.zeros(Bp, bool)
    ac[:B] = accept
    novel, ok, n = jt._tfd_novelty_scan(jnp.asarray(fp), jnp.asarray(ac), B,
                                        10.0, block=block,
                                        cache_cap=cache_cap)
    return np.asarray(novel)[:B], bool(ok), int(n)


def wrap_fps():
    '''Rows across the +-180 seam: 179 and -179 lie 2 degrees apart; a
    row at 175 / -175 is 10 degrees from the first (not similar: the
    rule wants less than 10), one at 176 / -176 is within it.'''
    return np.array([[179.0, -179.0, 0.0], [-179.0, 179.0, 0.0],
                     [175.0, -175.0, 0.0], [176.0, 180.0, 1.0],
                     [-176.0, -180.0, -1.0]], np.float32)


# (name, fingerprints, accept probability, block, cache_cap)
CASES = [
    ('chain', chain_fps(), 1.0, 8, 1024),
    ('wrap', wrap_fps(), 1.0, 8, 1024),
    ('clustered_700_accept', clustered_fps(np.random.default_rng(0), 700),
     0.6, 8, 1024),
    ('clustered_2500_block64', clustered_fps(np.random.default_rng(1), 2500,
                                             n_clusters=30), 0.8, 64, 1024),
    ('clustered_3000_block4096', clustered_fps(np.random.default_rng(2), 3000,
                                               q=9, n_clusters=60), 1.0,
     4096, 1024),
    ('chains_in_blocks', clustered_fps(np.random.default_rng(4), 1500,
                                       n_clusters=12, spread=3.0), 1.0, 16,
     1024),
    ('overflow_block8', clustered_fps(np.random.default_rng(3), 64,
                                      n_clusters=64, spread=0.0), 1.0, 8, 4),
    ('overflow_block16', clustered_fps(np.random.default_rng(3), 64,
                                       n_clusters=64, spread=0.0), 1.0, 16,
     4),
]


@pytest.mark.parametrize('name,fps,accept_p,block,cache_cap', CASES,
                         ids=[c[0] for c in CASES])
def test_novelty_plain_matches_jax_scan_and_host_replay(name, fps, accept_p,
                                                        block, cache_cap):
    accept = np.random.default_rng(len(fps)).random(len(fps)) < accept_p
    novel, ok, n_acc, walked = v1.novelty_plain(
        torch.as_tensor(fps), torch.as_tensor(accept), 10.0, block,
        cache_cap)
    want = jt.is_new_structure_lru(fps, accept, thresh=10)
    j_novel, j_ok, j_n = jax_scan(fps, accept, block, cache_cap)
    assert ok == j_ok == (want.sum() <= cache_cap)
    if not ok:
        assert n_acc == cache_cap + 1 and j_n == cache_cap
        return
    np.testing.assert_array_equal(novel.numpy(), want)
    np.testing.assert_array_equal(j_novel, want)
    assert n_acc == j_n == want.sum()
    # a rejected row walks one comparison at least, each of one term
    assert walked.terms >= walked.comparisons >= accept.sum() - want.sum()
    got, dev_ok = tt.tfd_novelty_device(torch.as_tensor(fps), accept,
                                        block=block, cache_cap=cache_cap)
    assert dev_ok
    np.testing.assert_array_equal(got, want)


def test_walked_comparisons_on_the_chain():
    '''The chain (f0, f1 ~ f0, far, f2 ~ f1 only): f1 stops at its first
    comparison, far walks f0, f2 walks f0 and far: 4 comparisons; in
    blocks of one row each the cache comparisons are the same 4.'''
    fps = torch.as_tensor(chain_fps())
    for block in (8, 1):
        novel, ok, n, walked = v1.novelty_plain(fps, None, 10.0, block)
        assert ok and novel.tolist() == [True, False, True, True]
        assert (n, walked.comparisons) == (3, 4)
        assert walked == replay_walk(chain_fps(), np.ones(4, bool))


def replay_walk(fps, accept, thresh=10.0):
    '''(comparisons, terms) of the sequential rule in plain Python: each
    row that the mask lets through against the accepted rows in order,
    up to its first hit; each sum torsion by torsion, in float64, up to
    the torsion where it reaches thresh.'''
    kept, comparisons, terms = [], 0, 0
    for i in np.flatnonzero(accept):
        new = True
        for j in kept:
            comparisons += 1
            s = 0.0
            for a, b in zip(fps[i].tolist(), fps[j].tolist()):
                terms += 1
                d = abs(a - b)
                s += abs(d - 360.0) if d > 180.0 else d
                if s >= thresh:
                    break
            if s < thresh:
                new = False
                break
        if new:
            kept.append(i)
    return comparisons, terms


@pytest.mark.parametrize('name,fps,accept_p,block,cache_cap',
                         [c for c in CASES if c[4] == 1024],
                         ids=[c[0] for c in CASES if c[4] == 1024])
def test_walked_terms_match_a_python_replay(name, fps, accept_p, block,
                                            cache_cap):
    '''The comparisons and terms that novelty_plain counts, in blocks,
    are those of the rule walked row by row with its early stops (the
    cache holds the accepted rows in acceptance order, so the blocked
    walk meets them in the same order).'''
    accept = np.random.default_rng(len(fps)).random(len(fps)) < accept_p
    *_, walked = v1.novelty_plain(torch.as_tensor(fps),
                                  torch.as_tensor(accept), 10.0, block,
                                  cache_cap)
    assert walked == replay_walk(fps, accept)
    assert walked.terms <= walked.comparisons * fps.shape[1]


def test_launch_plan_stages_the_cache():
    '''The default cache of 1,024 entries lies whole in shared memory up
    to 11 torsions, at an odd stride; a longer fingerprint stages a
    part; a tile holds 4,096 rows at most, whatever the block, its list
    (16 bits a row) and rejected set (a bit a row) in shared memory
    beside the cache and the warps' rows, and two blocks fit an SM; the
    scratch holds two tiles' bit masks and a tile's bit matrix; the
    bytes are the kernel's.'''
    p = v1.launch_plan(10, 1024)
    assert p == {'staged': 1024, 'tile': 4096,
                 'smem': 1024 * 11 * 8 + 8 * 10 * 8 + 2 * 4096 + 4 * 128,
                 'bits': 2 * 128 + 4096 * 128}
    assert v1.launch_plan(11, 1024)['staged'] == 1024
    assert v1.launch_plan(12, 1024)['staged'] == 977
    p = v1.launch_plan(40, 1024)
    assert 0 < p['staged'] < 1024
    assert p['smem'] <= v1.STAGE_BYTES + 2 * 4096 + 4 * 128
    assert 2 * (p['smem'] + 1024) <= 228 * 1024
    assert v1.launch_plan(4, 10)['staged'] == 10
    assert v1.launch_plan(4, 10, 1 << 16)['tile'] == 4096
    p = v1.launch_plan(4, 10, 16)
    assert p == {'staged': 10, 'tile': 16,
                 'smem': 10 * 5 * 8 + 8 * 4 * 8 + 2 * 16 + 4, 'bits': 272}
    assert v1.launch_plan(4, 10, 9)['smem'] == 10 * 5 * 8 + 8 * 4 * 8 + \
        2 * 10 + 4


class OnCard(torch.Tensor):
    '''A CPU tensor that says it lies on the card.'''

    @property
    def is_cuda(self):
        return True


def test_card_tensor_reaches_the_kernel_and_never_the_cpu_loop(monkeypatch):
    '''tfd_novelty_device given fingerprints that say they lie on the
    card goes to V1's module, which raises here (no card): the CPU loop
    never runs.'''
    reached = []
    monkeypatch.setattr(tt, 'wrapped_l1',
                        lambda *a, **k: reached.append('wrapped_l1'))
    fps = torch.as_tensor(chain_fps()).as_subclass(OnCard)
    with pytest.raises(ValueError, match='CUDA'):
        tt.tfd_novelty_device(fps, thresh=10)
    assert reached == []
