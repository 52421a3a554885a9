"""K7: the HBM streaming probe, out = a + b on [8, LEN] float32.

``stream_add`` launches the CUDA kernel of ``csrc/stream_add.cu`` on
CUDA tensors and runs ``stream_add_plain`` on CPU tensors.  It counts
its kernel launches in ``stream_add.launches``.  ``out=a`` is the
aliased form of the JAX probe (``input_output_aliases={0: 0}``): the
sum is written over ``a`` by the in-place entry point.

The plain version is ``torch.add``: here the plain version and the one
PyTorch call that computes the same function are the same thing.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def stream_add_plain(a, b, out=None):
    """a + b (``torch.add``), into ``out`` when given."""
    return torch.add(a, b, out=out)


def check_args(a, b, out, device):
    """Raise unless a, b and out are what the kernel takes: contiguous
    [8, LEN] float32 tensors on the current CUDA device ``device`` (the
    kernel launches there), 16-byte aligned, out either a itself (the
    same memory) or clear of both inputs.  Returns (C entry, its
    arguments but the stream, as ctypes values)."""
    name = "stream_add"
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if dev.index != device:
        raise ValueError(f"{name}: a is on {dev}, the current device is "
                         f"cuda:{device}")
    shape = tuple(a.shape)
    if len(shape) != 2 or shape[0] != 8:
        raise ValueError(f"{name}: a must be [8, LEN], got {shape}")
    for arg, t in (("a", a), ("b", b), ("out", out)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                             f"expected torch.float32 on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {shape} "
                             f"tensor, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned (the "
                             f"kernel loads float4)")
    aliased = out.data_ptr() == a.data_ptr()
    if build.overlap(out, b) or (not aliased and build.overlap(out, a)):
        raise ValueError(f"{name}: out must be a itself or share memory "
                         f"with neither input")
    ptrs = (a, b) if aliased else (a, b, out)
    args = (*(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
            ctypes.c_longlong(a.numel() // 4))
    return build.entry("ht_stream_add_inplace_f32" if aliased
                       else "ht_stream_add_f32"), args


_CHECKS = build.CheckCache(check_args)


def stream_add(a, b, out=None):
    """a + b into ``out`` (a new tensor unless given; ``out=a`` writes
    over a).  CUDA tensors run the K7 kernel; CPU tensors run
    stream_add_plain."""
    if a.is_cpu:
        return stream_add_plain(a, b, out=out)
    if out is None:
        out = torch.empty_like(a)
    # (a tensor on another device has no kernel: the checks refuse it)
    dev = build.current_device() if a.is_cuda else None
    # the checks' verdict and the entry's arguments but the stream, kept
    # per signature (pointers included)
    fn, args = _CHECKS(a, b, out, dev)
    rc = fn(*args, build.stream(a))
    if rc:
        build.check(rc, "stream_add launch")
    stream_add.launches += 1
    return out


stream_add.launches = 0
