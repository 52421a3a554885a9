"""The traced window: ``torch.profiler`` over CPU and CUDA, and the
reduction of its trace to each card's busy time, operations by name,
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
    reduced trace (``reduce`` over the run's ``cards``)."""

    def __init__(self, workdir, cards=(0,)):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.cards = cards
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
        return reduce(events, self.cards)


def _union(intervals):
    """Merged [(start, end)] of intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def card_of(event):
    """The index of the card a device operation ran on: the trace's
    ``device`` argument, else its process id, which the profiler sets
    to the same (a run on one card counts every operation as its)."""
    return int(event.get("args", {}).get("device", event.get("pid", 0)))


def reduce(events, cards=(0,)):
    """{window_s, busy_s: the mean over ``cards`` (the indices of the
    run's cards) of each card's busy seconds, busy_by_card: [s] in the
    order of ``cards``, device: [(name, cat, start, dur)] in seconds
    from the window's start, every card's, device_ops: [[name, s]] top
    10 over the cards, idle_gaps: [[host activity, s]] top 10, the
    stretches in which no card was busy}."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host, on = [], [], []
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
            on.append(cards[0] if len(cards) == 1 else card_of(e))
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append((e["name"], a, b))
    busy_us = [sum(b - a for a, b in _union(
        [(a, b) for (_, _, a, b), c in zip(dev, on) if c == card]))
        for card in cards]
    busy = _union([(a, b) for _, _, a, b in dev])
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
        "busy_s": sum(b * 1e-6 for b in busy_us) / len(cards),
        "busy_by_card": [b * 1e-6 for b in busy_us],
        "device": [(n, c, (a - w0) * 1e-6, (b - a) * 1e-6)
                   for n, c, a, b in dev],
        "device_ops": [[n, s] for n, s in ops],
        "idle_gaps": named,
    }
