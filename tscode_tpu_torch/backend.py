'''
Device and dtype policy of the port (counterpart of tscode_tpu/backend.py).

The device is always explicit: asking for CUDA where there is none
raises, and nothing switches silently to the CPU. The dtype follows the
JAX package's policy: float64 on the CPU (the parity lane, 1e-6 A
geometry agreement), float32 on CUDA (screening throughput; pruning
decisions agree with f64 up to ties at the 0.5 A RMSD and 1.5 A clash
thresholds).

It also holds the switch of the CLI's `--trace` (DeviceTrace) and the
named spans (`span`, `traced`) that the launch, stage and graph layers
mark in that trace; they are inert unless a trace runs.
'''

import contextlib
import functools
import os
import time

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


# True while the CLI's --trace profile runs (DeviceTrace): with no
# profiler running a record_function still costs ~9 us a call, the
# shared nullcontext ~0.6 us (a CPU, timeit, 20,000 calls), and a
# route's kernel launches mark thousands of spans
_TRACING = False
_INERT = contextlib.nullcontext()


def span(name):
    '''A named span of the --trace profile: torch.profiler.record_function
    (name) while DeviceTrace runs, a (shared) contextlib.nullcontext
    otherwise.'''
    if _TRACING:
        return torch.profiler.record_function(name)
    return _INERT


def traced(fn):
    '''fn, run inside span(fn.__name__).'''
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(fn.__name__):
            return fn(*args, **kwargs)
    return wrapper


# seconds DeviceTrace waits after it starts the profiler on a card: a
# kernel launched at once was lost, with every other device event of
# its window, in about one trace in a hundred on an H100; after this
# wait in none of a thousand (tools/trace_loss.py)
TRACE_START_S = 0.05


class DeviceTrace:
    '''The CLI's --trace DIR (counterpart of jax.profiler.trace): what
    runs inside is profiled on the host and, for a CUDA device, on the
    card (torch.profiler, CUPTI), with the spans on; on a card it first
    waits TRACE_START_S for the profiler to take the card's events; on
    exit the device is synchronised, so its last kernels land in the
    window, and
    torch.profiler.tensorboard_trace_handler writes
    DIR/<host>_<pid>.<ns>.pt.trace.json (Chrome trace JSON: TensorBoard,
    Perfetto, chrome://tracing), whose path is then `path`. A CUDA run
    whose profile holds no device activity (CUPTI unavailable) raises
    rather than leave a host-only trace.'''

    def __init__(self, trace_dir, device):
        self.dir = os.path.abspath(trace_dir)
        self.device = get_device(device)
        self.path = None

    def _write(self, prof):
        before = set(os.listdir(self.dir)) if os.path.isdir(self.dir) \
            else set()
        torch.profiler.tensorboard_trace_handler(self.dir)(prof)
        self.path = os.path.join(
            self.dir, max(set(os.listdir(self.dir)) - before))

    def __enter__(self):
        global _TRACING
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities,
                                            on_trace_ready=self._write)
        self._prof.__enter__()
        if self.device.type == 'cuda':
            time.sleep(TRACE_START_S)
        _TRACING = True
        return self

    def __exit__(self, exc_type, exc, tb):
        global _TRACING
        try:
            if exc_type is None:
                synchronize(self.device)
        finally:
            _TRACING = False
            self._prof.__exit__(exc_type, exc, tb)
        if exc_type is None and self.device.type == 'cuda' and not any(
                e.device_type() == torch.autograd.DeviceType.CUDA
                for e in self._prof.profiler.kineto_results.events()):
            raise RuntimeError(
                f'--trace: the profiler recorded no activity on '
                f'{self.device} (CUPTI unavailable?); {self.path} holds '
                f'the host only')
        return False
