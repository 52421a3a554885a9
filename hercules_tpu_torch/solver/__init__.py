"""Solver layers of the port: numpy table assembly and brick planning
(copies of the JAX package's), and the single-brick solver on the CUDA
kernels.  Imports nothing at package import time."""
