"""The port's copy of ``hercules_tpu/source/__init__.py``."""

from .model import SourceModel, compute_domain_coords_linearinterp
from .filter import butterworth_filter_signal
from .slip import compute_source_function
