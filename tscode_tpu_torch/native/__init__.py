'''
Native (C++) host-runtime components, loaded via ctypes (the port's copy
of the JAX package's native loader, sources unchanged).

Each shared library is built from its source here with the system g++
on first import, into build/tscode_tpu_torch/native/ beside the package
(never into a package directory), and rebuilt when the source is newer.
Any failure (no compiler, load error) degrades silently to the
pure-Python implementations: callers must treat `xyz_native` as
Optional.
'''

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), 'build',
                         'tscode_tpu_torch', 'native')
_SRC = os.path.join(_DIR, 'xyz_io.cpp')
_LIB = os.path.join(BUILD_DIR, '_xyz_io.so')
_lock = threading.Lock()

_ERRORS = {
    -1: 'expected atom count at line {line}',
    -2: 'truncated frame at line {line}',
    -3: 'bad atom line {line}',
    -4: 'unknown element symbol at line {line}',
    -5: 'inconsistent atoms across frames',
    -6: 'no frames found',
}


class XYZNativeError(ValueError):
    def __init__(self, code, line):
        self.code, self.line = code, line
        msg = _ERRORS.get(code, f'native xyz error {code}')
        super().__init__(msg.format(line=line))


def _compile_and_load(src, lib_path):
    '''Build (when stale) + dlopen one shared library.'''
    with _lock:
        if (not os.path.exists(lib_path)
                or os.path.getmtime(lib_path) < os.path.getmtime(src)):
            os.makedirs(os.path.dirname(lib_path), exist_ok=True)
            tmp = f'{lib_path}.{os.getpid()}.tmp'    # processes build apart
            subprocess.run(
                ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
                 src, '-o', tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
        return ctypes.CDLL(lib_path)


def _build_and_load():
    lib = _compile_and_load(_SRC, _LIB)

    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(i64)
    lib.xyz_scan.restype = i64
    lib.xyz_scan.argtypes = [ctypes.c_char_p, i64, p_i64, p_i64, p_i64]
    lib.xyz_parse.restype = i64
    lib.xyz_parse.argtypes = [
        ctypes.c_char_p, i64,
        np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
        np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS'),
        np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS'), p_i64]
    lib.xyz_format.restype = i64
    lib.xyz_format.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
        np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS'),
        i64, i64, ctypes.c_char_p, ctypes.c_char_p, i64]
    return lib


try:
    _lib = _build_and_load()
except Exception:                       # no g++ / load failure: fall back
    _lib = None


def available():
    return _lib is not None


def parse_ensemble(data):
    '''
    Parse a multi-frame .xyz byte buffer.
    Returns (coords (F, N, 3) f64, atomnos (N,) i64, comments list[str]).
    Raises XYZNativeError with the io_xyz error vocabulary on bad input.
    '''
    n_frames = ctypes.c_int64()
    n_atoms = ctypes.c_int64()
    err_line = ctypes.c_int64()
    rc = _lib.xyz_scan(data, len(data), ctypes.byref(n_frames),
                       ctypes.byref(n_atoms), ctypes.byref(err_line))
    if rc != 0:
        raise XYZNativeError(rc, err_line.value)

    F, N = n_frames.value, n_atoms.value
    coords = np.empty((F, N, 3), dtype=np.float64)
    atomnos = np.empty(N, dtype=np.int64)
    spans = np.empty(2 * F, dtype=np.int64)
    rc = _lib.xyz_parse(data, len(data), coords, atomnos, spans,
                        ctypes.byref(err_line))
    if rc != 0:
        raise XYZNativeError(rc, err_line.value)

    comments = [data[spans[2 * i]:spans[2 * i] + spans[2 * i + 1]]
                .decode(errors='replace') for i in range(F)]
    return coords, atomnos, comments


def format_ensemble(coords, atomnos, titles):
    '''Format an (F, N, 3) ensemble into .xyz text (bytes).'''
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    atomnos = np.ascontiguousarray(atomnos, dtype=np.int64)
    F, N = coords.shape[0], coords.shape[1]
    assert atomnos.shape[0] == N and len(titles) == F
    blob = b'\x00'.join(t.encode() for t in titles) + b'\x00'
    cap = F * (N * 80 + 32) + len(blob)
    out = ctypes.create_string_buffer(cap)
    w = _lib.xyz_format(coords, atomnos, F, N, blob, out, cap)
    if w < 0:
        raise XYZNativeError(-7, 0)
    return out.raw[:w]


# ----------------------------------------------------- TFD novelty filter

_TFD_SRC = os.path.join(_DIR, 'tfd_lru.cpp')
_TFD_LIB = os.path.join(BUILD_DIR, '_tfd_lru.so')


def _build_tfd():
    lib = _compile_and_load(_TFD_SRC, _TFD_LIB)
    i64 = ctypes.c_int64
    lib.tfd_lru_filter.restype = i64
    lib.tfd_lru_filter.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS'),
        i64, i64,
        np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')]
    return lib


try:
    _tfd_lib = _build_tfd()
except Exception:                       # no g++ / load failure: fall back
    _tfd_lib = None


def tfd_available():
    return _tfd_lib is not None


def tfd_lru_filter(fingerprints, accept_mask, thresh):
    '''Native sequential TFD novelty filter: fingerprints (B, Q) f32,
    accept_mask (B,) bool -> (B,) bool keep mask. Same semantics as
    ops/tfd.is_new_structure_lru (distance accumulated in f64, so
    borderline sums within f32 rounding of `thresh` may differ from
    the numpy replay by one ulp-level decision).'''
    fps = np.ascontiguousarray(fingerprints, dtype=np.float32)
    accept = np.ascontiguousarray(accept_mask, dtype=np.uint8)
    out = np.zeros(len(fps), dtype=np.uint8)
    _tfd_lib.tfd_lru_filter(fps, fps.shape[0], fps.shape[1], accept,
                            float(thresh), out)
    return out.astype(bool)


def _bind_dedup():
    i64 = ctypes.c_int64
    _tfd_lib.greedy_angular_dedup.restype = None
    _tfd_lib.greedy_angular_dedup.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
        np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
        i64, i64,
        np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')]


if _tfd_lib is not None:
    try:
        _bind_dedup()
    except Exception:
        _tfd_lib = None


def greedy_angular_dedup(clash_ok, similar):
    '''Batched greedy angular dedup (generation order): clash_ok (B, A)
    bool, similar (B, A, A) bool -> keep (B, A) bool. Native form of
    the cyclical embed's per-block host replay.'''
    ok = np.ascontiguousarray(clash_ok, dtype=np.uint8)
    sim = np.ascontiguousarray(similar, dtype=np.uint8)
    out = np.zeros_like(ok)
    _tfd_lib.greedy_angular_dedup(ok, sim, ok.shape[0], ok.shape[1], out)
    return out.astype(bool)
