"""Named cumulative wall-clock timers + hierarchical report.

Mirrors timers.c:29-227 (Timer_Start/Stop/Value/Reduce) and the solver
timing report (print_timing_stat, psolve.c:6041-6274).

The port's copy of ``hercules_tpu/utils/timers.py``, with one change:
the JAX package fences device work inside ``Timers.stop``
(``jax.block_until_ready``); here the fence is the module-level
``measure``, which waits for the queued CUDA work with
``torch.cuda.synchronize()`` before it stops the clock, so a phase is
charged the device time it caused.  The host meshing stages record into
this module's ``GLOBAL_TIMERS``."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Timers:
    def __init__(self):
        self.acc = {}
        self.running = {}
        self.counts = {}

    def start(self, name):
        self.running[name] = time.perf_counter()

    def stop(self, name):
        t0 = self.running.pop(name, None)
        if t0 is None:
            return
        self.acc[name] = self.acc.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextmanager
    def measure(self, name):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def value(self, name):
        return self.acc.get(name, 0.0)

    def report(self, out=None, total=None):
        import sys
        out = out or sys.stdout
        out.write("\n# %-40s %12s %8s\n" % ("timer", "seconds", "calls"))
        out.write("# " + "-" * 64 + "\n")
        items = sorted(self.acc.items(), key=lambda kv: -kv[1])
        tot = total or sum(self.acc.values())
        for name, v in items:
            pct = 100.0 * v / tot if tot else 0.0
            out.write("  %-40s %12.3f %8d  %5.1f%%\n"
                      % (name, v, self.counts.get(name, 0), pct))
        out.write("  %-40s %12.3f\n" % ("TOTAL", tot))


GLOBAL_TIMERS = Timers()


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


MESHING_TIMERS = ("Octor Newtree", "Octor Refinetree",
                  "Octor Balancetree", "Carve Buildings",
                  "Octor Partitiontree", "Octor Extractmesh",
                  "Mesh correct properties", "Mesh Stats Print")


def print_timing_stat(params, mesh, timers=None, out=None,
                      critical_t=None):
    """Hierarchical end-of-run timing report (print_timing_stat,
    psolve.c:6041-6274): raw timers, summary block, meshing/solver
    breakdown."""
    import sys
    out = out or sys.stdout
    t = timers or GLOBAL_TIMERS

    out.write("\n________________________Raw Timers____________________\n")
    t.report(out=out)

    E = mesh.lenum
    steps = params.total_steps
    solver = t.value("Solver")
    out.write("\n_____________Summary_____________\n")
    out.write("Max Frequency             : %.2f\n" % params.freq)
    out.write("Vs                        : %.2f\n" % params.vscut)
    out.write("Total elements            : %d\n" % E)
    out.write("Simulation duration       : %.2f seconds\n"
              % (params.end_time - params.start_time))
    out.write("Total steps               : %d\n" % steps)
    out.write("DeltaT used               : %.6f seconds\n"
              % params.delta_t)
    if critical_t is not None:
        out.write("Critical deltaT           : %.6f seconds\n"
                  % critical_t)
    out.write("\n")
    out.write("Total Wall Clock          : %.2f seconds\n"
              % t.value("Total Wall Clock"))
    if steps:
        out.write("Time/step                 : %.6f seconds\n"
                  % (solver / steps))
        if E:
            out.write("Time/step/elem            : %.6f millisec\n"
                      % (solver * 1000.0 / steps / E))

    out.write("\n____________Breakdown____________\n")
    mesh_tot = sum(t.value(k) for k in MESHING_TIMERS)
    out.write("TOTAL MESHING                       : %.2f seconds\n"
              % mesh_tot)
    for k in MESHING_TIMERS:
        if t.value(k):
            out.write("    %-32s: %.2f seconds\n" % (k, t.value(k)))
    out.write("TOTAL SOLVER                        : %.2f seconds\n"
              % solver)
    for k in sorted(t.acc):
        if k.startswith("Solver "):
            out.write("    %-32s: %.2f seconds\n" % (k[7:], t.value(k)))
