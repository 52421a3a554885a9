"""Chunked time-loop driver (counterpart of
``hercules_tpu/solver/chunking.py:run_chunked``).

JAX compiles a scan per chunk; here a chunk is whatever ``advance``
does for k steps -- one chunk-kernel launch, or k single-step launches
-- and the samples come to the host once per chunk.  The ``on_chunk``
and ``on_samples`` hooks keep the JAX driver's contract.
"""

from __future__ import annotations

import numpy as np


def run_chunked(advance, state, total_steps, start_step=0, chunk=1000,
                on_chunk=None, on_samples=None):
    """Drive ``advance`` over [start_step, total_steps).

    advance(state, s, k) -> (state, samples [k, ...] numpy): steps
        [s, s+k) from state (a tuple of tensors: (S,) elastic, (S, conv)
        BKT; run_chunked does not look inside)
    on_chunk(done, state): fires at every chunk boundary
    on_samples(s0, ys): consumes each chunk's per-step sample rows
        (steps [s0, s0+len)) and returns what to accumulate

    Returns (state, samples [T, ...])."""
    outs = []
    s = start_step
    while s < total_steps:
        k = min(chunk, total_steps - s)
        state, samples = advance(state, s, k)
        if on_samples is not None:
            samples = on_samples(s, samples)
        outs.append(samples)
        if on_chunk is not None:
            on_chunk(s + k, state)
        s += k
    samples = (np.concatenate(outs) if outs
               else np.zeros((0, 0, 3)))
    return state, samples
