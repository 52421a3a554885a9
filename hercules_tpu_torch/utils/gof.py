"""Quantitative waveform goodness-of-fit (GOF) scoring.

Implements the single-valued envelope/phase misfits of Kristekova et
al. (2006, BSSA 96; the standard used to score the SCEC LOH.1
comparisons the reference validates against, doc/validationtests.pdf
Table B2) in their time-domain form: the envelope is the magnitude and
the phase the angle of the analytic signal, misfits are
reference-energy-normalized, and the Anderson (2004)-style score maps
misfit m to GOF = 10*exp(-m) so 10 = identical, >= 8 = excellent,
>= 6 = good.
"""

from __future__ import annotations

import numpy as np


def analytic_signal(x, axis=0):
    """Hilbert analytic signal via FFT (no scipy dependency)."""
    x = np.asarray(x, np.float64)
    n = x.shape[axis]
    X = np.fft.fft(x, axis=axis)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (n + 1) // 2] = 2.0
    shape = [1] * x.ndim
    shape[axis] = n
    return np.fft.ifft(X * h.reshape(shape), axis=axis)


def envelope_phase_misfit(ref, sim, axis=0):
    """(EM, PM): envelope and phase misfit of sim against ref.

    EM = ||E_sim - E_ref|| / ||E_ref||            (L2 over time)
    PM = ||E_ref * wrap(phi_sim - phi_ref)|| / (pi ||E_ref||)

    The phase difference is envelope-weighted so near-zero-amplitude
    samples (where phase is meaningless) do not dominate.
    """
    ar = analytic_signal(ref, axis=axis)
    as_ = analytic_signal(sim, axis=axis)
    er = np.abs(ar)
    es = np.abs(as_)
    nref = np.sqrt(np.sum(er ** 2, axis=axis))
    nref = np.where(nref > 0, nref, 1.0)
    em = np.sqrt(np.sum((es - er) ** 2, axis=axis)) / nref
    dphi = np.angle(as_ * np.conj(ar))
    pm = np.sqrt(np.sum((er * dphi) ** 2, axis=axis)) / (np.pi * nref)
    return em, pm


def gof_score(ref, sim, axis=0):
    """Anderson-style 0..10 score from the combined misfit: 10 *
    exp(-(EM + PM)).  10 = identical; >= 8 excellent; >= 6 good."""
    em, pm = envelope_phase_misfit(ref, sim, axis=axis)
    return 10.0 * np.exp(-(em + pm))
