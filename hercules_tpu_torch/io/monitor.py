"""Progress monitor file (monitor_print, psolve.c:342-365).

The port's copy of ``hercules_tpu/io/monitor.py``, kept equal to it
(tests/test_torch_host.py)."""

from __future__ import annotations

import os
import sys


class Monitor:
    def __init__(self, path=None, echo=True):
        self.fp = None
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.fp = open(path, "w", buffering=1)

    def print(self, msg):
        if self.fp:
            self.fp.write(msg)
        if self.echo:
            sys.stdout.write(msg)
            sys.stdout.flush()
