"""The traced window: ``torch.profiler`` over CPU and CUDA, and the
reduction of its trace to the device's busy time, operations by name,
launches and the longest idle gaps by what the host was doing.

The profiler starts at a chunk boundary, and from the next one a user
annotation named ``WINDOW`` spans the traced chunks; everything is
clipped to it.
"""

from __future__ import annotations

import bisect
import json
import os

WINDOW = "port_bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Tracer:
    """Starts the profiler; ``open`` starts the window's annotation, once
    the profiler has warmed up; ``stop`` ends both and returns the
    reduced trace (``reduce``)."""

    def __init__(self, workdir):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.path = os.path.join(workdir, "trace.json")
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.mark = None
        self.torch = torch

    def open(self):
        from torch.profiler import record_function
        self.mark = record_function(WINDOW)
        self.mark.__enter__()

    def stop(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        return reduce(events)


def _union(intervals):
    """Merged [(start, end)] of intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events):
    """{window_s, busy_s, device: [(name, cat, start, dur)] in seconds
    from the window's start, device_ops: [[name, s]] top 10, idle_gaps:
    [[host activity, s]] top 10}."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e["name"], cat, a, b))
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append((e["name"], a, b))
    busy = _union([(a, b) for _, _, a, b in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for name, _, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps: between device activity, and before the first and after
    # the last, each named by the host activity that overlaps it most
    # (the innermost on a tie)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    longest = max((b - a for _, a, b in host), default=0.0)
    named = []
    for a, b in gaps[:10]:
        best, key = "host (no traced operation)", (0.0, 0.0)
        lo = bisect.bisect_left(starts, a - longest)
        for name, ha, hb in host[lo:]:
            if ha >= b:
                break
            ov = min(b, hb) - max(a, ha)
            if ov > 0 and (ov, -(hb - ha)) > key:
                best, key = name, (ov, -(hb - ha))
        named.append([best, (b - a) * 1e-6])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device": [(n, c, (a - w0) * 1e-6, (b - a) * 1e-6)
                   for n, c, a, b in dev],
        "device_ops": [[n, s] for n, s in ops],
        "idle_gaps": named,
    }
