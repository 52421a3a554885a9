"""The port's copy of ``hercules_tpu/physics/__init__.py``."""

from .kmats import (
    build_k_matrices,
    stiffness_matrices_24,
    bkt_matrices_24,
)
from .consts import (
    compute_setab,
    element_coefficients,
    node_masses,
    critical_dt,
    boundary_dashpots,
)
