"""The port's copy of ``hercules_tpu/mesh/__init__.py``."""

from .octree import Octree, domain_ticks
from .extract import MeshArrays, extract_mesh
