"""Slip-rate source time functions (compute_source_function,
quakesource.c:309-385), vectorized over time steps.

The port's copy of ``hercules_tpu/source/slip.py``, kept equal to it
(tests/test_torch_host.py)."""

from __future__ import annotations

import numpy as np

SOURCE_FUNCTIONS = ("ramp", "sine", "quadratic", "ricker", "exponential",
                    "discrete")


def compute_source_function(kind, t, T0=None, Ts=None, Tp=None,
                            delay=0.0, dt_discrete=None, discrete=None):
    """Normalized slip decay at times t (array), matching the reference's
    per-type formulas.  decay == 0 for t <= delay (strict '<' in the
    reference condition delayTime < T, quakesource.c:322)."""
    t = np.asarray(t, np.float64)
    T = t - delay
    active = delay < t

    if kind == "ramp":
        decay = np.where(T < T0, T / T0, 1.0)
    elif kind == "sine":
        decay = np.where(T < T0,
                         T / T0 - np.sin(2 * np.pi * T / T0) / np.pi / 2,
                         1.0)
    elif kind == "quadratic":
        decay = np.where(
            T < T0 / 2, 2 * (T / T0) ** 2,
            np.where(T <= T0, -2 * (T / T0) ** 2 + 4 * T / T0 - 1, 1.0))
    elif kind == "ricker":
        t1 = ((T - Ts) * np.pi / Tp) ** 2
        decay = (t1 - 0.5) * np.exp(-t1)
    elif kind == "exponential":
        tao = t / T0  # reference uses undelayed tao (quakesource.c:321)
        decay = 1 - (1 + tao) * np.exp(-tao)
    elif kind == "discrete":
        decay = _interp_linear(T, dt_discrete, np.asarray(discrete))
    else:
        raise ValueError(f"unknown source function {kind!r}")
    return np.where(active, decay, 0.0)


def _interp_linear(time, samplingtime, fn):
    """interpolate_linear (quakesource.c:265-290): clamped at the last
    sample."""
    n = len(fn)
    maxtime = (n - 1) * samplingtime
    idx = np.clip(np.floor(time / samplingtime).astype(np.int64), 0, n - 2)
    m = (fn[idx + 1] - fn[idx]) / samplingtime
    b = fn[idx] - m * idx * samplingtime
    val = m * time + b
    return np.where(time >= maxtime, fn[-1], val)
