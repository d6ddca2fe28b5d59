'''
Device and dtype policy of the port (counterpart of tscode_tpu/backend.py).

The device is always explicit: asking for CUDA where there is none
raises, and nothing switches silently to the CPU. The dtype follows the
JAX package's policy: float64 on the CPU (the parity lane, 1e-6 A
geometry agreement), float32 on CUDA (screening throughput; pruning
decisions agree with f64 up to ties at the 0.5 A RMSD and 1.5 A clash
thresholds).
'''

import torch


def get_device(device):
    '''torch.device for `device` ('cuda', 'cuda:0', 'cpu' or a
    torch.device). Raises RuntimeError when CUDA is asked for and is
    not available. On CUDA, float32 matmuls and convolutions are pinned
    to full float32 (no TF32), so the plain PyTorch twins of the kernels
    compute in the working type.'''
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device {device!r} requested but torch.cuda.is_available() '
                f'is False (torch {torch.__version__})')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {device!r}: use cuda or cpu')
    return dev


def default_dtype(device):
    '''float32 on CUDA, float64 on the CPU.'''
    return torch.float32 if get_device(device).type == 'cuda' \
        else torch.float64


def synchronize(device):
    '''Wait for queued work on `device` (no-op on the CPU).'''
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
