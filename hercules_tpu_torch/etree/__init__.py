"""The port's copy of ``hercules_tpu/etree/__init__.py``."""

from .morton import (
    interleave3,
    deinterleave3,
    morton_key,
    zorder_argsort,
    is_ancestor,
)
from .reader import EtreeReader
from .writer import EtreeWriter
