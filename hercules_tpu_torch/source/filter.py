"""Butterworth low-pass filtering of force histories.

Matches FilterSignal (quakesource.c:958-1069): differentiate the signal
with 2nd-order one-sided ends, zero-pad to the reference's power-of-two
size, multiply the spectrum by the Butterworth magnitude response,
inverse transform, and re-integrate with the trapezoid rule.  The
reference's hand-rolled radix-2 FFT (dir=1 scales by 1/N) composes to
ifft(fft(x) * H), so NumPy's FFT reproduces it exactly.

The port's copy of ``hercules_tpu/source/filter.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np


def butterworth_filter_signal(signal, samplingfrequency,
                              thresholdfrequency, npoles):
    """Filter along the last axis.  signal [..., T]."""
    signal = np.asarray(signal, np.float64)
    T = signal.shape[-1]
    n = int(np.log(T) / np.log(2)) + 2
    new_size = 1 << n

    fs = samplingfrequency
    d = np.empty_like(signal)
    d[..., 0] = 0.5 * fs * (-3 * signal[..., 0] + 4 * signal[..., 1]
                            - signal[..., 2])
    d[..., -1] = 0.5 * fs * (signal[..., -3] - 4 * signal[..., -2]
                             + 3 * signal[..., -1])
    d[..., 1:-1] = 0.5 * fs * (signal[..., 2:] - signal[..., :-2])

    pad = np.zeros(signal.shape[:-1] + (new_size,))
    pad[..., :T] = d

    freq = fs * np.arange(new_size // 2 + 1) / new_size
    h = np.sqrt(1.0 / (1.0 + (freq / thresholdfrequency) ** (2 * npoles)))
    h[0] = 1.0
    filtered = np.fft.irfft(np.fft.rfft(pad, axis=-1) * h, n=new_size,
                            axis=-1)

    # trapezoid re-integration (quakesource.c:1044-1057)
    y = filtered[..., :T]
    out = np.zeros_like(y)
    incr = 0.5 / fs * (y[..., :-1] + y[..., 1:])
    out[..., 1:] = np.cumsum(incr, axis=-1)
    return out
