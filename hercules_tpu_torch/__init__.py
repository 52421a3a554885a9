"""hercules_tpu_torch -- the PyTorch/CUDA port of hercules_tpu.

The port runs on an NVIDIA H100 through kernels written by hand for
Hopper (CUDA C++ under ``csrc/``, built with nvcc on first use).  It
imports ``torch`` and nothing of ``jax`` or of the JAX package
``hercules_tpu``: the numpy host layers (config, CVM, etree, meshing,
sources, physics constants, the native meshing helpers) are the port's
own copies of that package's modules, held equal to them by the tests.
The JAX package stays the reference the port is tested against.

The port runs the single-brick solver (a uniform mesh with Rayleigh,
mass, no or BKT damping, point or finite sources, stations) on the CUDA
device by default:
``python -m hercules_tpu_torch.cli [--device=cuda|cpu] <cvmdb>
<physics.in> <numerical.in>``.  ``python -m
hercules_tpu_torch.tools.hbm_ceiling`` measures the card's streaming
ceiling.

Importing the package loads no kernel and runs no compiler.
"""

__version__ = "0.1.0"
