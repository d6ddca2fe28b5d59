'''
Build and load the hand-written CUDA kernels of `tscode_tpu_torch/csrc`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for Hopper (`sm_90a`) into `build/tscode_tpu_torch/lib<name>.so` beside
the package, at first use, and again whenever the source is newer than
the library. The library is loaded with ctypes: pointers and the stream
pass as `c_void_p`, and every entry returns the `cudaError_t` of its
launch. A failed build or a nonzero launch error raises.

Nothing here runs at import time: the CPU lane imports every module and
has neither nvcc nor a card.
'''

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time

from tscode_tpu_torch.backend import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'tscode_tpu_torch')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path():
    '''nvcc from CUDA_HOME, the PATH, or the toolkit's default prefix.'''
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home \
        else []
    candidates += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       '(the CUDA kernels build only on a CUDA machine)')


class CudaKernel:
    '''One kernel library of csrc/: built at first use, its launches
    counted, in all and per entry. `symbols` maps each exported C
    function to its ctypes argtypes; every function returns an int
    cudaError_t.'''

    def __init__(self, name, symbols):
        self.name = name
        self.source = os.path.join(CSRC_DIR, name + '.cu')
        self.library = os.path.join(BUILD_DIR, f'lib{name}.so')
        self.symbols = symbols
        self.launches = 0          # kernel launches since the last reset
        self.entry_launches = dict.fromkeys(symbols, 0)   # the same, per entry
        self.wrapper_launches = {}  # the same, per Python wrapper named
        self.build_seconds = None  # nvcc time in this process, 0.0 if fresh
        self._lib = None
        # one build at a time per library; libraries build in parallel
        self._lock = threading.Lock()

    def reset_counts(self):
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.symbols, 0)
        self.wrapper_launches = {}

    def build(self):
        '''Compile when the library is missing or older than its source;
        returns the loaded ctypes library.'''
        with self._lock:
            if self._lib is not None:
                return self._lib
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            if (not os.path.exists(self.library) or
                    os.path.getmtime(self.library)
                    < os.path.getmtime(self.source)):
                tmp = f'{self.library}.{os.getpid()}.tmp'
                cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp, self.source]
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=600)
                with open(os.path.join(BUILD_DIR, self.name + '.log'),
                          'w') as f:
                    f.write(' '.join(cmd) + '\n' + r.stdout + r.stderr)
                if r.returncode != 0:
                    raise RuntimeError(
                        f'nvcc failed for {self.source} (rc {r.returncode}):'
                        f'\n{(r.stderr or r.stdout)[-4000:]}')
                os.replace(tmp, self.library)
            self.build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(self.library)
            for sym, argtypes in self.symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.tt_error_string.argtypes = [ctypes.c_int]
            lib.tt_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib

    def build_log(self):
        '''nvcc's command line and ptxas report of the last build.'''
        path = os.path.join(BUILD_DIR, self.name + '.log')
        if not os.path.exists(path):
            return ''
        with open(path) as f:
            return f.read()

    def launch(self, symbol, *args, device, wrapper=None):
        '''Call one exported entry (which launches the kernel on the
        given stream) with `device`, the card of the tensors it is
        given, as the current device, so the launch and the device
        attributes the entry reads are that card's; count the launch,
        also under the name of the Python wrapper that asked for it, if
        given; raise on a launch error. Under the CLI's --trace the call
        is the span `<library>.<entry>` (the only host-side mark of a
        ctypes launch), inside a span named for the wrapper, if given.'''
        lib = self.build()
        with span(wrapper) if wrapper is not None \
                else contextlib.nullcontext(), \
                span(f'{self.name}.{symbol}'), device_guard(device):
            code = getattr(lib, symbol)(*args)
        if code != 0:
            raise RuntimeError(
                f'{self.name}.{symbol} launch failed: cudaError {code} '
                f'({lib.tt_error_string(code).decode()})')
        self.launches += 1
        self.entry_launches[symbol] += 1
        if wrapper is not None:
            self.wrapper_launches[wrapper] = \
                self.wrapper_launches.get(wrapper, 0) + 1


def device_guard(device):
    '''torch.cuda.device(device), or no switch at all when `device` is
    the current card already: the one-card case, where each launch would
    otherwise set and reset the current device.'''
    import torch
    device = torch.device(device)
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_of(tensor):
    '''The current CUDA stream of `tensor`'s device, as a c_void_p.'''
    import torch
    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())
