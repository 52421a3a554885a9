"""The port's copy of ``hercules_tpu/tools/__init__.py``."""
