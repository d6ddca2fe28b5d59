'''tscode_tpu_torch: the PyTorch + CUDA port of tscode_tpu.

The JAX package `tscode_tpu` stays the reference. This package imports
`torch` and never `jax`; its hand-written CUDA kernels live in `csrc/`
and build with nvcc at first use (see `ops/kernels/_build.py`). On CPU
tensors every kernel wrapper runs its plain PyTorch twin instead.

The jax-free host modules of `tscode_tpu` (molecule, orbitals, graphs,
io_xyz, pt, parameters, errors, native) are imported as they are.
'''

__version__ = '0.1.0'
