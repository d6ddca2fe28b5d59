'''The conformer search's back-off and the clash screen's thread-regime
launch plan, on the CPU.

The back-off: K1's entry `torsion_backoff` on CPU tensors (its plain
twin: every retreat step on the whole batch, the screen by direct
differences), the CPU's own loop (`rotate_batch_with_backoff`, the
undecided rows only) and tscode_tpu/torsions._rotate_batch_with_backoff
on the same seeded candidates, float64: frames within 1e-12 A, flags
identical. The plan: `thread_plan` and `thread_walk`, the shapes the
card's ring kernel is launched with.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_backoff.py -q
'''

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import jax.numpy as jnp  # noqa: E402
from tscode_tpu import torsions as jt
from tscode_tpu.io_xyz import read_xyz
from tscode_tpu_torch import torsions as tt
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.ops.kernels import clash
from tscode_tpu_torch.suite_inputs import chloroalkane
from torch_parity import t64, to_np

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'fixtures')
ATOL = 1e-12


def molecule(name):
    if name == 'chain':
        return chloroalkane(10)
    data = read_xyz(os.path.join(FIX, 'C2F2H4.xyz'))
    return np.array(data.atomcoords[0]), np.array(data.atomnos)


def torsions_of(coords, atomnos):
    graph = graphize(coords, atomnos)
    torsions = tt.get_torsions(graph, [], tt.get_double_bonds_indices(
        coords, atomnos))
    for t in torsions:
        t.sort_torsion(graph, np.array([]))
    return torsions, graph


def masks(graph, torsion):
    move = tt.get_rotation_mask(graph, torsion.torsion)
    other = ~move
    other[list(torsion.torsion[1:3])] = False
    return move, other


def candidates(name, scale, top, B=48, seed=13):
    '''Jittered candidates of a molecule, shrunk by `scale` (so that some
    clash at every step and some retreat), and angles in 5-degree steps
    from 0 to `top`, the first rows 0 and `top`.'''
    rng = np.random.default_rng(seed)
    base, nos = molecule(name)
    coords = (base + rng.normal(size=(B,) + base.shape) * 0.05) * scale
    angles = rng.integers(0, top // 5 + 1, size=B) * 5.0
    angles[:4] = [0.0, 0.0, top, top]
    return coords, nos, angles


@pytest.mark.parametrize('name,scale,top,bucket', [
    ('chain', 1.0, 240, 48), ('chain', 0.75, 355, 72),
    ('rotor', 1.0, 120, 24), ('rotor', 0.6, 240, 96)])
def test_backoff_three_ways(name, scale, top, bucket):
    '''torsion_backoff's plain twin, the CPU's loop and the JAX package
    agree frame for frame within 1e-12 A and flag for flag, torsion
    after torsion; the port's two loops run to the largest angle's own
    step count and to the bucket (steps past a row's angle are invalid
    for it, so both give the same), the JAX package to the bucket. The
    data hold angle-0 rows, rows with no clash-free step and rows that
    retreat.'''
    coords, nos, angles = candidates(name, scale, top)
    torsions, graph = torsions_of(*molecule(name))
    seen = {'angle_0': 0, 'never_clash_free': 0, 'retreated': 0}
    own = int(angles.max() // 5)
    for torsion in torsions:
        move, other = masks(graph, torsion)
        want, want_rot = jt._rotate_batch_with_backoff(
            jnp.asarray(coords), jnp.asarray(np.array(torsion.torsion)),
            jnp.asarray(move), jnp.asarray(angles), jnp.asarray(other),
            jnp.asarray(bucket))
        want, want_rot = np.asarray(want), np.asarray(want_rot)
        full = to_np(clash.torsion_backoff_plain(
            t64(coords), torsion.torsion, move, t64(angles),
            np.zeros_like(other), 0)[0])
        for steps in (own, bucket):
            got = {'plain': clash.torsion_backoff(
                       t64(coords), torsion.torsion, move, t64(angles),
                       other, steps),
                   'cpu': tt.rotate_batch_with_backoff(
                       t64(coords), torsion.torsion, move, t64(angles),
                       other, steps)}
            for what, (frames, rot) in got.items():
                np.testing.assert_array_equal(to_np(rot), want_rot,
                                              err_msg=what)
                np.testing.assert_allclose(to_np(frames), want, rtol=0,
                                           atol=ATOL, err_msg=what)
        seen['angle_0'] += int((angles == 0).sum())
        assert not want_rot[angles == 0].any()
        np.testing.assert_array_equal(want[~want_rot], coords[~want_rot])
        seen['never_clash_free'] += int(((angles > 0) & ~want_rot).sum())
        seen['retreated'] += int((np.abs(want - full).max(axis=(1, 2))
                                  [want_rot] > 1e-6).sum())
    assert seen['angle_0'] > 0
    if scale < 1:
        assert seen['never_clash_free'] > 0 and seen['retreated'] > 0


def test_backoff_entry_refuses_what_the_kernel_does_not_take():
    '''On a CPU tensor the entry is its plain twin (no dtype rule); the
    card's checks raise before any launch: float32 or a mask of the
    wrong length. The plain twin of an empty pair list rotates every
    nonzero angle in full.'''
    import torch
    coords, nos, angles = candidates('rotor', 1.0, 120, B=6)
    torsions, graph = torsions_of(*molecule('rotor'))
    move, other = masks(graph, torsions[0])
    out, rot = clash.torsion_backoff(t64(coords), torsions[0].torsion, move,
                                     t64(angles), np.zeros_like(other), 24)
    np.testing.assert_array_equal(to_np(rot), angles != 0)
    assert out.shape == coords.shape
    meta = torch.zeros(coords.shape, dtype=torch.float32, device='meta')
    with pytest.raises(TypeError):
        clash.torsion_backoff(meta, torsions[0].torsion, move,
                              torch.zeros(6, dtype=torch.float32,
                                          device='meta'), other, 24)
    with pytest.raises(ValueError):
        clash.torsion_backoff(meta.double(), torsions[0].torsion, move[:-1],
                              torch.zeros(6, dtype=torch.float64,
                                          device='meta'), other, 24)


@pytest.mark.parametrize('N,P,itemsize', [
    (11, 30, 4), (11, 30, 8), (12, 36, 4), (12, 36, 8), (15, 56, 4),
    (8, 16, 8), (6, 9, 8), (24, 63, 8), (150, 40, 8)])
def test_thread_plan_fits_and_aligns(N, P, itemsize):
    '''Shared memory within the 232,448-byte opt-in limit; every stage
    on the 16-byte grid; a whole tile of the default size is a multiple
    of 16 bytes (one bulk copy); large poses shrink the ring down to one
    warp's tile, and poses past that are refused.'''
    plan = clash.thread_plan(415872, N, P, itemsize)
    assert plan['smem'] <= clash.SMEM_OPTIN_BYTES
    assert plan['stage_bytes'] % 16 == 0
    assert 2 <= plan['stages'] <= clash.RING_MAX_STAGES
    assert plan['smem'] == clash.RING_BAR_BYTES + -(-4 * P // 16) * 16 \
        + plan['stages'] * plan['stage_bytes']
    assert plan['stage_bytes'] >= plan['tile'] * N * 3 * itemsize
    assert plan['tile'] >= clash.THREAD_MIN_TILE
    if plan['tile'] == clash.THREAD_TILE:
        assert plan['tile'] * N * 3 * itemsize % 16 == 0
    per_sm = plan['blocks_per_sm']
    assert per_sm >= 1 and per_sm * (plan['smem'] + 1024) <= \
        clash.SM_SMEM_BYTES
    assert clash.thread_plan(415872, 150, 40, 8)['tile'] == \
        clash.THREAD_MIN_TILE
    for n in (152, 800, 6000):
        with pytest.raises(ValueError):
            clash.thread_plan(10, n, 30, 8)


@pytest.mark.parametrize('B', [1, 17, 4099, 415872])
@pytest.mark.parametrize('N,itemsize', [(11, 4), (12, 8)])
def test_thread_walk_covers_every_pose_once(B, N, itemsize):
    '''The persistent blocks' tile walk (block b: tiles b, b + blocks,
    ...) covers every pose of the batch exactly once, no block is
    idle, and only the last tile is ragged.'''
    plan = clash.thread_plan(B, N, 30, itemsize)
    assert plan['blocks'] == min(plan['tiles'],
                                 clash.SM_COUNT * plan['blocks_per_sm'])
    hits = np.zeros(B, dtype=np.int64)
    ragged = 0
    for b in range(plan['blocks']):
        walk = clash.thread_walk(plan, B, b)
        assert walk
        for p0, n in walk:
            hits[p0:p0 + n] += 1
            ragged += n != plan['tile']
    assert (hits == 1).all()
    assert ragged == int(B % plan['tile'] != 0)


def test_regime_crossover_in_both_dtypes():
    '''The warp regime starts at CLASH_WARP_MIN_PAIRS pairs in float32
    and in float64 (phase 3's sweep crosses between 56 and 64 in both).'''
    n = clash.CLASH_WARP_MIN_PAIRS
    for itemsize in (4, 8):
        assert clash.clash_regime(n - 1, 12, itemsize) == 'thread'
        assert clash.clash_regime(n, 12, itemsize) == 'warp'


@pytest.mark.parametrize('P,N,itemsize,regime,ring', [
    (30, 151, 8, 'thread', True), (30, 152, 8, 'thread', False),
    (30, 302, 4, 'thread', True), (30, 303, 4, 'thread', False),
    (30, 5000, 8, 'thread', False), (30, 5000, 4, 'thread', False),
    (100, 4800, 8, 'warp', False), (100, 5000, 8, 'thread', False),
    (64, 10000, 4, 'thread', False)])
def test_large_poses_take_pr1_kernel(P, N, itemsize, regime, ring):
    '''Poses too large for a ring of two one-warp stages (and for two
    warp-regime slots when P is large) stay in the thread regime, where
    thread_plan refuses them and the launch takes the v1 kernel, which
    takes any N and P: no shape the screen took before is refused.'''
    assert clash.clash_regime(P, N, itemsize) == regime
    try:
        clash.thread_plan(4099, N, P, itemsize)
        fits = True
    except ValueError:
        fits = False
    assert fits == ring
