"""Named cumulative wall-clock timers, spans, and the hierarchical
report.

Mirrors timers.c:29-227 (Timer_Start/Stop/Value/Reduce) and the solver
timing report (print_timing_stat, psolve.c:6041-6274).

The port's copy of ``hercules_tpu/utils/timers.py``, grown into spans.
``Timers.span`` times a block as a named timer does (``acc`` and
``counts``, which the report prints), keeps a record of it (its parent,
the time step it covers, its clock readings and counts) in a bounded
log, and opens a ``torch.profiler.record_function`` range of the same
name, so that a traced run holds the span on the profiler's clock beside
the device's operations; a span never waits for the device.  The JAX
package fences device work inside ``Timers.stop``
(``jax.block_until_ready``); here the fence is the module-level
``measure``, a span that waits for the queued CUDA work with
``torch.cuda.synchronize()`` before it ends, so a phase is charged the
device time it caused.  ``ChunkClock`` reads the device's own clock at
the time loop's chunk boundaries, with CUDA events and without a wait.
The host meshing stages record into this module's ``GLOBAL_TIMERS``."""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager

import torch

SPAN_LOG = 4096          # records the span log keeps, the newest
CHUNK = "Solver chunk"   # the time loop's span of one chunk


class Span:
    """One span: ``name``; ``parent``, the span open around it (None at
    the top); ``step``, the first time step it covers (None outside the
    time loop; a span given none takes its parent's); ``t0_ns`` and
    ``t1_ns`` on ``time.perf_counter_ns`` (``t1_ns`` None while open);
    ``counts``, its numbers by name."""

    __slots__ = ("name", "parent", "step", "t0_ns", "t1_ns", "counts")

    def __init__(self, name, parent, step, counts):
        self.name, self.parent, self.step = name, parent, step
        self.counts = counts
        self.t0_ns = self.t1_ns = None


class Timers:
    def __init__(self):
        self.acc = {}
        self.running = {}
        self.counts = {}
        self.log = collections.deque(maxlen=SPAN_LOG)   # closed spans
        self.open = []                                   # innermost last
        self.parent_of = {}   # span name -> the name open around it first

    def start(self, name):
        self.running[name] = time.perf_counter()

    def stop(self, name):
        t0 = self.running.pop(name, None)
        if t0 is None:
            return
        self.acc[name] = self.acc.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextmanager
    def span(self, name, step=None, **counts):
        """Time the block as ``name``: its seconds and one call go to
        ``acc`` and ``counts`` as ``start``/``stop``'s do, and its
        ``Span`` (which the block gets, to add counts to) to the end of
        ``log`` once it ends, also when it raises.  Its parent is the
        span open around it; a ``torch.profiler.record_function`` range
        of the same name spans it.  Never waits for the device."""
        parent = self.open[-1] if self.open else None
        if step is None and parent is not None:
            step = parent.step
        rec = Span(name, parent, step, counts)
        self.parent_of.setdefault(name, parent and parent.name)
        self.open.append(rec)
        with torch.profiler.record_function(name):
            rec.t0_ns = time.perf_counter_ns()
            try:
                yield rec
            finally:
                rec.t1_ns = time.perf_counter_ns()
                self.open.pop()
                self.acc[name] = (self.acc.get(name, 0.0)
                                  + (rec.t1_ns - rec.t0_ns) * 1e-9)
                self.counts[name] = self.counts.get(name, 0) + 1
                self.log.append(rec)

    def value(self, name):
        return self.acc.get(name, 0.0)

    def path(self, name):
        """``name`` after the names of the spans open around it when it
        first opened, outermost first."""
        p = [name]
        while self.parent_of.get(p[-1]) not in (None, *p):
            p.append(self.parent_of[p[-1]])
        return p[::-1]

    def report(self, out=None, total=None):
        """Every timer, longest first, with its share of ``total``: by
        default the sum of the timers that never ran inside a span."""
        import sys
        out = out or sys.stdout
        out.write("\n# %-40s %12s %8s\n" % ("timer", "seconds", "calls"))
        out.write("# " + "-" * 64 + "\n")
        items = sorted(self.acc.items(), key=lambda kv: -kv[1])
        tot = total or sum(v for k, v in self.acc.items()
                           if self.parent_of.get(k) is None)
        for name, v in items:
            pct = 100.0 * v / tot if tot else 0.0
            out.write("  %-40s %12.3f %8d  %5.1f%%\n"
                      % (name, v, self.counts.get(name, 0), pct))
        out.write("  %-40s %12.3f\n" % ("TOTAL", tot))


GLOBAL_TIMERS = Timers()


@contextmanager
def measure(name, device, timers=GLOBAL_TIMERS):
    """A span of the block as ``name`` (``Timers.span``; the block gets
    its ``Span``) fenced on ``device``: on a CUDA device the span ends
    after the device has finished the block's work."""
    with timers.span(name) as rec:
        try:
            yield rec
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)


class ChunkClock:
    """The device's clock at the time loop's chunk boundaries, on a CUDA
    ``device`` (nothing elsewhere): a CUDA event before a chunk's first
    device operation (``start``) and one as soon as its samples' copy to
    the host has returned (``end``).  ``end`` writes into the chunk's ``Span`` the
    device seconds since the previous chunk's end event (``gap_s``), and
    into the previous chunk's its device seconds, start to end
    (``device_s``).  It reads only events that came before the chunk's
    samples copy in the stream, complete once that copy has returned, so
    it never waits: a chunk's own end event is read at the next chunk's
    end, and the last chunk's ``device_s`` stays as it was.  A chunk with
    no samples to copy completes nothing; where its events are not yet
    complete, ``end`` leaves both counts as they were."""

    def __init__(self, device):
        self.device = (torch.device(device) if device is not None
                       and torch.device(device).type == "cuda" else None)
        self.t0 = None
        self.prev = None            # (start, end, Span) of the last chunk

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start(self):
        if self.device is not None:
            self.t0 = self._event()

    def end(self, rec):
        if self.device is None:
            return
        t1 = self._event()
        if self.prev is not None and self.t0.query():
            p0, p1, prec = self.prev
            prec.counts["device_s"] = p0.elapsed_time(p1) * 1e-3
            rec.counts["gap_s"] = p1.elapsed_time(self.t0) * 1e-3
        self.prev = (self.t0, t1, rec)


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
    t.report(out=out, total=t.value("Total Wall Clock") or None)

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
    # a span indented under the solver's spans it ran inside
    for k in sorted((k for k in t.acc if k.startswith("Solver ")),
                    key=t.path):
        d = sum(a.startswith("Solver ") for a in t.path(k)) - 1
        out.write("    %s%-*s: %.2f seconds\n"
                  % ("  " * d, 32 - 2 * d, k[7:], t.value(k)))
