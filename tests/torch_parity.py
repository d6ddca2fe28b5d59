'''Shared helpers of the port's tests (tests/test_torch_*.py). Inputs are
made with numpy from a seed and handed to both the JAX package and the
port (tscode_tpu_torch), so the two are compared on the same numbers.'''

import numpy as np
import pytest
import torch

# the suite runs in several worker processes beside JAX's own thread
# pools; torch's intra-op threads spin between ops and, oversubscribed,
# slowed these files ~30x
torch.set_num_threads(1)


def t64(a):
    '''numpy (or jax) array -> CPU float64 tensor.'''
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def to_np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture
def cuda_device():
    '''The card, or a skip: these tests launch the CUDA kernels, which
    build and run only on an NVIDIA GPU.'''
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; on the card run '
                    'python -m pytest tests/test_torch_cuda.py -m cuda '
                    '--noconftest')
    return torch.device('cuda')


def near_dup_blocks(rng, B, L, N, scale=1.5):
    '''(B, L, N, 3) blocks of noisy copies of four base structures per
    block, noise levels chosen so pair rmsds fall on both sides of 0.5 A
    (and for N > 4 inside the band where the maxdev gate decides), and
    m_real (B,) live rows per block.'''
    base = rng.normal(size=(B, 4, N, 3)) * scale
    which = rng.integers(0, 4, size=(B, L))
    sigma = rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=(B, L))
    P = base[np.arange(B)[:, None], which] + \
        rng.normal(size=(B, L, N, 3)) * sigma[..., None, None]
    return P, rng.integers(1, L + 1, size=B).astype(np.int32)


def near_dup_pool(rng, n, N, n_base, scale=1.5):
    '''(n, N, 3) pool of noisy copies of n_base structures in random
    order, with the noise levels of near_dup_blocks.'''
    base = rng.normal(size=(n_base, N, 3)) * scale
    sigma = rng.choice([0.02, 0.1, 0.15, 0.2, 0.25], size=n)
    return base[rng.integers(0, n_base, size=n)] + \
        rng.normal(size=(n, N, 3)) * sigma[:, None, None]
