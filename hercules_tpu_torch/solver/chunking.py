"""Chunked time-loop driver (counterpart of
``hercules_tpu/solver/chunking.py:run_chunked``).

JAX compiles a scan per chunk; here a chunk is whatever ``advance``
does for k steps -- one chunk-kernel launch, k single-step launches, or
one replay of a CUDA graph that holds them (``ChunkGraphs``) -- and the
samples come to the host once per chunk.  The ``on_chunk`` and
``on_samples`` hooks keep the contract of the JAX package's loop.

Each chunk is a span (``utils/timers.py``), ``Solver chunk`` at its
first step with its ``steps`` and ``replays`` (the graph replays its
advance made), around ``Solver advance``, ``Solver samples to host``
(the chunk's one copy to the host, and its one wait) and ``Solver
hooks`` (the caller's ``on_samples`` and ``on_chunk``); on a CUDA
device the span also gets the device's clock at the chunk's ends
(``ChunkClock``: ``device_s``, ``gap_s``), the end read as soon as the
copy has returned.  A graph's capture is the span ``Solver graph
capture``, with the chunk's ``k`` and the graph's ``nodes``.
"""

from __future__ import annotations

from contextlib import ExitStack

import numpy as np
import torch

from ..kernels import build
from ..utils.timers import CHUNK, GLOBAL_TIMERS, ChunkClock


def samples_to_host(samples, pinned):
    """A chunk's samples tensor on the host, the host waiting for the
    copy: from a CUDA device into a pinned host buffer of its shape and
    type (kept in the dict ``pinned``, and overwritten by the next
    chunk's), a CPU tensor as it is."""
    if samples.device.type != "cuda":
        return samples
    key = (tuple(samples.shape), samples.dtype)
    buf = pinned.get(key)
    if buf is None:
        buf = pinned[key] = torch.empty(key[0], dtype=key[1],
                                        pin_memory=True)
    return buf.copy_(samples)


def run_chunked(advance, state, total_steps, start_step=0, chunk=1000,
                on_chunk=None, on_samples=None, device=None):
    """Drive ``advance`` over [start_step, total_steps).

    advance(state, s, k) -> (state, samples [k, ...]): steps [s, s+k)
        from state (a tuple of tensors: (S,) elastic, (S, conv) BKT;
        run_chunked does not look inside); the samples a tensor, which
        run_chunked copies to the host (samples_to_host, then a numpy
        array of its own) before the next call
    on_chunk(done, state): fires at every chunk boundary
    on_samples(s0, ys): consumes each chunk's per-step sample rows
        (steps [s0, s0+len)) and returns what to accumulate
    device: the device ``advance`` works on (its chunks' CUDA events)

    Returns (state, samples [T, ...])."""
    clock = ChunkClock(device)
    pinned = {}
    outs = []
    s = start_step
    while s < total_steps:
        k = min(chunk, total_steps - s)
        with GLOBAL_TIMERS.span(CHUNK, step=s, steps=k, replays=0,
                                device_s=None, gap_s=None) as rec:
            clock.start()
            with GLOBAL_TIMERS.span("Solver advance"):
                state, samples = advance(state, s, k)
            with GLOBAL_TIMERS.span("Solver samples to host"):
                host = samples_to_host(samples, pinned)
                clock.end(rec)
                samples = host.numpy().copy()   # the next chunk reuses both
            with GLOBAL_TIMERS.span("Solver hooks"):
                if on_samples is not None:
                    samples = on_samples(s, samples)
                outs.append(samples)
                if on_chunk is not None:
                    on_chunk(s + k, state)
        s += k
    samples = (np.concatenate(outs) if outs
               else np.zeros((0, 0, 3)))
    return state, samples


class ChunkBuffers:
    """A chunk's buffers on ``device``: ``inc`` of shape ``inc_shape``
    [k, ...], the sources' rows of each step as the step takes them
    (uploaded through a pinned host buffer on a CUDA device), and
    ``samples`` of shape ``samples_shape`` [k, ns, 3]; the same tensors
    chunk after chunk, as a replayed graph reads and writes them."""

    def __init__(self, inc_shape, samples_shape, dtype, device):
        device = torch.device(device)
        self.inc = torch.empty(inc_shape, dtype=dtype, device=device)
        self.samples = torch.empty(samples_shape, dtype=dtype,
                                   device=device)
        self.cuda = device.type == "cuda"
        self._host = (torch.empty(inc_shape, dtype=dtype, pin_memory=True)
                      if self.cuda and self.inc.numel() else None)
        self._copied = torch.cuda.Event() if self._host is not None else None

    def upload(self, inc):
        """The rows ``inc`` (numpy, of ``inc``'s shape) into
        ``self.inc``, queued on the device's current stream."""
        if not inc.size:
            return
        if not self.cuda:
            self.inc.copy_(torch.from_numpy(inc))
            return
        self._copied.synchronize()      # the last chunk's copy has read it
        self._host.numpy()[...] = inc
        self.inc.copy_(self._host, non_blocking=True)
        self._copied.record(torch.cuda.current_stream(self.inc.device))


class ChunkGraphs:
    """A route's full chunks replayed from CUDA graphs, one graph per
    chunk size, on one CUDA device or across several (``devices``; the
    first is the one each graph is captured and replayed on).

    ``graphs(state, k, run)`` advances ``state`` by k steps, where
    ``run(state)`` issues the k steps and returns the state: it calls
    ``run`` uncaptured, and where the graphs are ``enabled``, k is the
    loop's ``chunk`` and the state came back in the tensors it was given
    (as after an even k of steps between two buffers in turn, or a ring
    of blocks that ends where it began) it then captures ``run`` once
    more from that state, which brings it back there again, so that the
    uncaptured chunk has checked every call signature of the kernel
    wrappers before the capture.  From the next
    chunk of that k it copies a state given in other tensors into the
    captured buffers (``tensors(state)`` lists a state's tensors) and
    replays.  Replays run after the work already queued on each
    device's current stream and before the work queued there next, and
    each counts a ``replays`` on the open ``Solver chunk``; a capture is
    the span ``Solver graph capture`` with its ``k`` and the graph's
    ``nodes``.  The kernel wrappers' launch counts (``build.launched``)
    leave out the capture's launches, which do not run, and count them
    at each replay, where they do.

    Under capture every device's current stream is a capturing one, so
    each launch and copy of ``run`` -- the port's kernels, torch
    operations that allocate nothing, copies between the devices --
    becomes a node and nothing runs.  ``run`` must allocate nothing on a
    device other than the first (the capture raises where it did: only
    the first device's allocations go to the graph's own pool)."""

    def __init__(self, devices, chunk, enabled, tensors=tuple):
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self.chunk, self.enabled, self.tensors = chunk, enabled, tensors
        # k -> (graph, the captured state, the capture's launches)
        self.held = {}

    def __call__(self, state, k, run):
        got = self.held.get(k)
        if got is not None:
            graph, ring, launches = got
            for x, y in zip(self.tensors(ring), self.tensors(state)):
                if x is not y:
                    x.copy_(y)
            self._replay(graph)
            build.replayed(launches)
            return ring
        new = run(state)
        if self.enabled and k == self.chunk and all(
                x is y for x, y in zip(self.tensors(new),
                                       self.tensors(state))):
            with build.tally() as launches:
                graph = self._capture(lambda: run(new), k)
            self.held[k] = (graph, new, launches)
        return new

    def _capture(self, body, k):
        rest = self.devices[1:]
        made = lambda: [torch.cuda.memory_stats(d).get(
            "allocation.all.allocated", 0) for d in rest]
        with GLOBAL_TIMERS.span("Solver graph capture", k=k,
                                nodes=None) as rec:
            streams = [torch.cuda.Stream(d) for d in self.devices]
            before = made()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=streams[0],
                                  capture_error_mode="thread_local"):
                fork = torch.cuda.Event()
                fork.record(streams[0])
                with ExitStack() as stack:
                    for st in streams[1:]:
                        st.wait_event(fork)
                        stack.enter_context(torch.cuda.stream(st))
                    body()
                    for st in streams[1:]:
                        join = torch.cuda.Event()
                        join.record(st)
                        streams[0].wait_event(join)
                rec.counts["nodes"] = build.capture_nodes(
                    streams[0].cuda_stream)
            if made() != before:
                raise RuntimeError("a captured chunk allocated on a device "
                                   "other than the graph's")
        self._events = [torch.cuda.Event() for _ in self.devices]
        return graph

    def _replay(self, graph):
        main = torch.cuda.current_stream(self.devices[0])
        for d, ev in zip(self.devices[1:], self._events[1:]):
            ev.record(torch.cuda.current_stream(d))
            main.wait_event(ev)
        graph.replay()
        done = self._events[0]
        done.record(main)
        for d in self.devices[1:]:
            torch.cuda.current_stream(d).wait_event(done)
        GLOBAL_TIMERS.add(CHUNK, "replays")
