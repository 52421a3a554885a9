"""The CLI's wall-clock timers, fenced on the CUDA device.

The timer table itself is the JAX package's numpy-only
``hercules_tpu.utils.timers`` (its meshing stages already record into
its ``GLOBAL_TIMERS``); this module adds the device fence: ``measure``
waits for the queued device work with ``torch.cuda.synchronize()``
before it stops the clock, so a phase is charged the device time it
caused."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from hercules_tpu.utils.timers import (GLOBAL_TIMERS,  # noqa: F401
                                      print_timing_stat)


@contextmanager
def measure(name, device=None, timers=GLOBAL_TIMERS):
    """Time the block as ``name``; on a CUDA ``device`` the clock stops
    after the device has finished the block's work."""
    timers.start(name)
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        timers.stop(name)
