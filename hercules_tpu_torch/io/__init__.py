"""The port's copy of ``hercules_tpu/io/__init__.py``."""
