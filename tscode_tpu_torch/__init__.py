'''tscode_tpu_torch: the PyTorch + CUDA port of tscode_tpu.

The JAX package `tscode_tpu` stays the reference. This package imports
`torch` and never `jax`; its hand-written CUDA kernels live in `csrc/`
and build with nvcc at first use (see `ops/kernels/_build.py`). On CPU
tensors every kernel wrapper runs its plain PyTorch twin instead.

It imports nothing of `tscode_tpu` either: it carries its own copies of
the JAX package's jax-free host modules (molecule, orbitals, graphs,
io_xyz, pt, parameters, errors, native, options, settings, solvents,
utils, quotes, references, modify_settings), whose native C++ helpers
build with g++ into build/tscode_tpu_torch/native/.

The CLI: `python -m tscode_tpu_torch input.txt [--device cuda|cpu]`.
'''

__version__ = '0.1.0'
