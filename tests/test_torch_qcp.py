'''QCP pair-kill parity: the port's plain pair kill (what a CPU tensor
runs) against the Pallas K3 in interpret mode (float32) and the JAX
prune's pair math _gathered_kill_blocks (float64), exact kill bits.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu.ops.pallas.qcp import qcp_kill_blocks_pallas
from tscode_tpu.ops.rmsd_prune import _gathered_kill_blocks
from tscode_tpu_torch.ops.kernels.qcp import (blocks_as_pass, qcp_kill,
                                              qcp_kill_blocks)
from tscode_tpu_torch.ops.linalg import rmsd_and_max
from torch_parity import near_dup_blocks, to_np


def planted_blocks():
    rng = np.random.default_rng(3)
    blocks = (rng.normal(size=(4, 32, 8, 3)) * 2).astype(np.float32)
    blocks[0, 10] = blocks[0, 3] + 1e-3
    blocks[2, 20] = blocks[2, 5] + 1e-3
    blocks[2, 25] = blocks[2, 5] + 2e-3
    return blocks, np.array([32, 20, 32, 5], dtype=np.int32)


def test_plain_kill_matches_pallas_k3_planted():
    blocks, m_real = planted_blocks()
    want = np.asarray(qcp_kill_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(m_real), 0.5, interpret=True))
    got = qcp_kill_blocks(torch.as_tensor(blocks), torch.as_tensor(m_real),
                          0.5)
    np.testing.assert_array_equal(to_np(got), want)
    # p dies when a LATER q matches: p=3 (block 0), p=5 and p=20 (block 2)
    assert int(got.sum()) == 3
    assert bool(got[0, 3]) and bool(got[2, 5]) and bool(got[2, 20])


@pytest.mark.parametrize('N', [4, 8])
def test_plain_kill_matches_gathered_kill_blocks_f64(N):
    B, L = 24, 48
    P, m_real = near_dup_blocks(np.random.default_rng(N), B, L, N)
    pool = P.reshape(-1, N, 3)
    idx = np.arange(B * L, dtype=np.int32).reshape(B, L)
    want = np.asarray(_gathered_kill_blocks(
        jnp.asarray(pool), jnp.asarray(idx), jnp.asarray(m_real),
        jnp.asarray(0.5, jnp.float64)))
    got = qcp_kill_blocks(torch.as_tensor(P), torch.as_tensor(m_real), 0.5)
    np.testing.assert_array_equal(to_np(got), want)
    assert 0 < want.sum() < B * L

    # the fixture reaches every gate outcome: for N > 4, pairs inside
    # the sqrt(N) band that the maxdev gate decides both ways
    Pt = torch.as_tensor(P)
    rmsd, maxdev = rmsd_and_max(Pt[:, :, None], Pt[:, None, :])
    pos = torch.arange(L)
    valid = (pos[None, None, :] > pos[None, :, None]) & \
        (pos[None, None, :] < torch.as_tensor(m_real)[:, None, None])
    passed = valid & (rmsd < 0.5)
    assert bool(passed.any()) and bool((valid & (rmsd >= 0.5)).any())
    if N > 4:
        band = passed & (np.sqrt(N) * rmsd >= 1.0)
        assert bool((band & (maxdev < 1.0)).any())
        assert bool((band & (maxdev >= 1.0)).any())


def test_blocks_as_pass_layout():
    act, end = blocks_as_pass(torch.tensor([3, 0, 2]), 4)
    np.testing.assert_array_equal(to_np(act), np.arange(12))
    np.testing.assert_array_equal(to_np(end),
                                  [3] * 4 + [4] * 4 + [10] * 4)


def test_pass_with_ragged_chunks_matches_per_chunk_blocks():
    '''One pass over chunks of very different lengths (2 .. 300 rows,
    past the plain twin's 256-row tile) equals evaluating every chunk
    as its own block with the JAX pair math.'''
    rng = np.random.default_rng(21)
    lens = [2, 300, 7, 1, 40, 129]
    hs = np.concatenate([near_dup_blocks(rng, 1, n, 6)[0][0] for n in lens])
    bounds = np.cumsum(lens)
    end = np.repeat(bounds, lens)
    got = to_np(qcp_kill(torch.as_tensor(hs), torch.arange(len(hs)),
                         torch.as_tensor(end), 0.5))
    L = max(lens)
    idx = np.full((len(lens), L), len(hs), dtype=np.int32)
    for b, (lo, n) in enumerate(zip(bounds - lens, lens)):
        idx[b, :n] = np.arange(lo, lo + n)
    want = np.asarray(_gathered_kill_blocks(
        jnp.asarray(hs), jnp.asarray(idx),
        jnp.asarray(np.array(lens, dtype=np.int32)),
        jnp.asarray(0.5, jnp.float64)))
    np.testing.assert_array_equal(
        got, np.concatenate([want[b, :n] for b, n in enumerate(lens)]))
    assert got.sum() > 0
