"""Chunked time-loop driver (counterpart of
``hercules_tpu/solver/chunking.py:run_chunked``).

JAX compiles a scan per chunk; here a chunk is whatever ``advance``
does for k steps -- one chunk-kernel launch, or k single-step launches
-- and the samples come to the host once per chunk.  The ``on_chunk``
and ``on_samples`` hooks keep the JAX driver's contract.

Each chunk is a span (``utils/timers.py``), ``Solver chunk`` at its
first step with its ``steps``, around ``Solver advance``, ``Solver
samples to host`` (the chunk's one copy to the host, and its one wait)
and ``Solver hooks`` (the caller's ``on_samples`` and ``on_chunk``); on
a CUDA device the span also gets the device's clock at the chunk's ends
(``ChunkClock``: ``device_s``, ``gap_s``), the end read as soon as the
copy has returned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timers import CHUNK, GLOBAL_TIMERS, ChunkClock


def run_chunked(advance, state, total_steps, start_step=0, chunk=1000,
                on_chunk=None, on_samples=None, device=None):
    """Drive ``advance`` over [start_step, total_steps).

    advance(state, s, k) -> (state, samples [k, ...]): steps [s, s+k)
        from state (a tuple of tensors: (S,) elastic, (S, conv) BKT;
        run_chunked does not look inside); the samples a tensor, which
        run_chunked copies to the host, or a numpy array
    on_chunk(done, state): fires at every chunk boundary
    on_samples(s0, ys): consumes each chunk's per-step sample rows
        (steps [s0, s0+len)) and returns what to accumulate
    device: the device ``advance`` works on (its chunks' CUDA events)

    Returns (state, samples [T, ...])."""
    clock = ChunkClock(device)
    outs = []
    s = start_step
    while s < total_steps:
        k = min(chunk, total_steps - s)
        with GLOBAL_TIMERS.span(CHUNK, step=s, steps=k, device_s=None,
                                gap_s=None) as rec:
            clock.start()
            with GLOBAL_TIMERS.span("Solver advance"):
                state, samples = advance(state, s, k)
            with GLOBAL_TIMERS.span("Solver samples to host"):
                if isinstance(samples, torch.Tensor):
                    samples = samples.cpu()
                clock.end(rec)
            samples = np.asarray(samples)
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
