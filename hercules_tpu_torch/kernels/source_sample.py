"""A step's source add and station sampling in one launch
(``csrc/source_sample.cu``): what the step route does between two
launches of its step kernel.

``SourceSample(src_pos, st_pos, st_phi)`` holds the sources' positions
[L] and the stations' corner positions and weights [ns, 8] of one state
layout.  Called with (S, inc, samples) it adds the increments inc [3,
L] to S's displacement at the sources, then writes the stations'
samples of S into samples [ns, 3]; inc or samples None leaves that half
out.  S is a state [8, LEN] or a displacement alone, a contiguous [3,
LEN] block (the step route's ring, ``solver/fused_brick.py``): only its
rows 0:3 are read and written.  inc and samples are rows of a chunk's
buffers (``solver/chunking.py:ChunkBuffers``), which the checks do not
tell apart: they are kept by the rows' shapes, strides, type and
device, not by their addresses.
CUDA tensors launch the kernel; CPU tensors run ``source_sample_plain``,
the step route's torch operations (``index_add_``, ``sample_stations``).
It counts its kernel launches in ``SourceSample.launches``
(``build.launched``).

The increments are pre-scaled as K5 takes them (f dt^2 rounded to the
working type, times inv_mass at the source node), so the add is the
torch route's ``index_add_`` of ``srcf.T * inv_mass`` bit for bit;
sources sharing a node add one after another in source order.  The
kernel samples with K5's fused multiply-adds in corner order, within
rounding of the torch route's ``einsum``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .brick_chunk import sample_stations


def increments(forces, dt2, invm):
    """[k, 3, L] increments, as the kernel and K5 take them, of the
    sources' forces [k, L, 3] (unscaled) with inv_mass ``invm`` [L] at
    their nodes, in invm's type: f dt^2 rounded to that type, then times
    inv_mass -- the rounding of the torch route's ``srcf.T * invm``."""
    f = np.asarray(np.asarray(forces) * dt2, invm.dtype)
    return np.ascontiguousarray(f.transpose(0, 2, 1) * invm[None, None, :])


def source_groups(pos):
    """(distinct positions [nu], gptr [nu + 1], sources [L]) of source
    positions ``pos`` [L]: the sources at upos[q] are
    sources[gptr[q]:gptr[q + 1]], in source order."""
    pos = np.asarray(pos).ravel()
    order = np.argsort(pos, kind="stable")
    upos, first = np.unique(pos[order], return_index=True)
    return upos, np.append(first, len(pos)), order


def source_sample_plain(S, inc, src_pos, samples, st_pos, st_phi):
    """The torch operations: index_add_ of inc [3, L] at src_pos, then
    samples [ns, 3] = sample_stations(S) (None: that half left out)."""
    if inc is not None and src_pos is not None:
        S[0:3].index_add_(1, src_pos, inc)
    if samples is not None and st_pos is not None:
        samples.copy_(sample_stations(S, st_pos, st_phi))


def _spec(t):
    """What the checks read of a row: its shape, strides, type and
    device (None: no row)."""
    return None if t is None else (tuple(t.shape), t.stride(), t.dtype,
                                   t.device)


def _prepare(S, inc, samples, io):
    """Raise unless the arguments are what the kernel takes (inc and
    samples as ``_spec``s); returns (C entry, LEN, device index).  It
    reads no tensor's values: the cache keeps it by signature."""
    dev, dt = S.device, S.dtype
    if dev.type != "cuda":
        raise ValueError(f"source_sample: no kernel for device {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"source_sample: dtype {dt} (float32 or float64)")
    if S.dim() != 2 or S.shape[0] not in (3, 8) or not S.is_contiguous():
        raise ValueError(f"source_sample: S must be a contiguous [8, LEN] "
                         f"or [3, LEN] tensor, got {tuple(S.shape)}")
    for arg, spec, shape in (("inc", inc, (3, io.L)),
                             ("samples", samples, (io.ns, 3))):
        if spec is not None and spec != (shape, (shape[1], 1), dt, dev):
            raise ValueError(f"source_sample: {arg} must be a contiguous "
                             f"{list(shape)} {dt} tensor on {dev}, got "
                             f"{spec}")
    if io.device != dev:
        raise ValueError(f"source_sample: the sources and stations are on "
                         f"{io.device}, the state on {dev}")
    sfx = "f32" if dt == torch.float32 else "f64"
    return build.entry(f"ht_source_sample_{sfx}"), S.shape[1], dev.index


_CHECKS = build.CheckCache(_prepare)


class SourceSample:
    """The sources at src_pos [L] (int64) and the stations at st_pos
    [ns, 8] (int64) with weights st_phi [ns, 8] of one state layout,
    any of them None; see the module docstring."""

    launches = 0

    def __init__(self, src_pos=None, st_pos=None, st_phi=None):
        self.src_pos, self.st_pos, self.st_phi = src_pos, st_pos, st_phi
        self.L = 0 if src_pos is None else int(src_pos.shape[0])
        self.ns = 0 if st_pos is None else int(st_pos.shape[0])
        held = src_pos if src_pos is not None else st_pos
        self.device = None if held is None else held.device
        if self.device is None or self.device.type != "cuda":
            return
        # the kernel indexes with 32-bit ints
        as_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                           device=self.device)
        self._src = (None, None, None, 0)
        if self.L:
            upos, gptr, gsrc = source_groups(src_pos.cpu().numpy())
            self._src = (as_dev(upos), as_dev(gptr), as_dev(gsrc), len(upos))
        self._st = (None, None)
        if self.ns:
            self._st = (st_pos.to(torch.int32).contiguous(),
                        st_phi.contiguous())

    def __call__(self, S, inc=None, samples=None):
        if not self.L:
            inc = None
        if not self.ns:
            samples = None
        if inc is None and samples is None:
            return
        if S.device.type == "cpu":
            source_sample_plain(S, inc, self.src_pos, samples, self.st_pos,
                                self.st_phi)
            return
        fn, LEN, dev = _CHECKS(S, _spec(inc), _spec(samples), self)
        ptr = lambda t: None if t is None else t.data_ptr()
        upos, gptr, gsrc, nu = self._src
        st32, phi = self._st
        rc = fn(S.data_ptr(), LEN, ptr(inc), self.L, ptr(upos), ptr(gptr),
                ptr(gsrc), nu, ptr(st32), ptr(phi), self.ns, ptr(samples),
                dev, build.stream(S))
        build.check(rc, "source_sample launch")
        build.launched(SourceSample)
