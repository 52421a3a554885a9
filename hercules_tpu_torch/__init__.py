"""hercules_tpu_torch -- the PyTorch/CUDA port of hercules_tpu.

The port runs on an NVIDIA H100 through kernels written by hand for
Hopper (CUDA C++ under ``csrc/``, built with nvcc on first use).  It
imports ``torch`` and never ``jax``; the numpy host layers (config,
CVM, meshing, sources, physics constants) are imported from
``hercules_tpu``, whose JAX package stays the reference the port is
tested against.

This slice covers the single-brick elastic solver (a uniform mesh with
Rayleigh, mass or no damping, point or finite sources, stations):
``python -m hercules_tpu_torch.cli [--device=cuda|cpu] <cvmdb>
<physics.in> <numerical.in>``.

Importing the package loads no kernel and runs no compiler.
"""

__version__ = "0.1.0"
