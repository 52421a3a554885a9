"""K2: one step of a uniform-Q BKT brick (node-basis memory variables).

``bkt_step`` launches the CUDA kernel of ``csrc/bkt_step.cu`` on CUDA
tensors and runs ``bkt_step_plain``, the same step in plain PyTorch, on
CPU tensors.  It counts its launches in ``bkt_step.launches`` (one per
step).

Layout (see ``solver/fused_bkt.py``): S [8, LEN] = (u, u-, 0, 0),
conv [6 | 12, LEN] = (s0, s1[, k0, k1]) x 3 components in the storage
type, K [8, LEN] = (mass_minusaM x 3, inv_mass, element valid, 0...),
``scales`` = (mu_f, kappa_f) the operator's two scales in float64, rec
the 9 | 18 recursion scalars.  The plain version multiplies by fm =
[mu_f Kmu | kappa_f Kkappa] [24, 48] (``bkt_operator``: folded in
float64, then cast, as the JAX package folds it); the kernel takes the
scales rounded to the working type and forms the element force in the
spectral form.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..physics.kmats import bkt_matrices_24
from . import build
from .tiles import brick_strides

# (working type, conv storage type) pairs the kernels take, and the
# suffix of their C entries
CONV_TYPES = {(torch.float32, torch.bfloat16): "f32_bf16",
              (torch.float32, torch.float32): "f32_f32",
              (torch.float64, torch.float64): "f64_f64"}


def _pair(r, u, up, du, s0, s1):
    """One recursion pair and its damping vector, in the op order of
    pallas_brick.py:1477-1496 (each product and sum rounded, no fma)."""
    c1, c2, c3, c4, e0, e1, a0, a1, coef = r
    s0n = c2 * u + c1 * up + e0 * s0
    s1n = c4 * u + c3 * up + e1 * s1
    dv = coef * du + u - a0 * s0n - a1 * s1n
    return s0n, s1n, dv


def bkt_recursion_plain(S, conv, rec):
    """(conv' in the working type, dvs [3, LEN], dvk [3, LEN]): the
    node-wise memory-variable recursion; dvk = u when shear-only."""
    u, up = S[0:3], S[3:6]
    du = u - up
    cv = conv.to(S.dtype)
    s0n, s1n, dvs = _pair(rec[0:9], u, up, du, cv[0:3], cv[3:6])
    if len(rec) == 9:
        return torch.cat([s0n, s1n]), dvs, u
    k0n, k1n, dvk = _pair(rec[9:18], u, up, du, cv[6:9], cv[9:12])
    return torch.cat([s0n, s1n, k0n, k1n]), dvs, dvk


@functools.lru_cache(maxsize=None)
def _unit_operators():
    return bkt_matrices_24()


def bkt_operator(scales, dtype=torch.float64, device="cpu"):
    """fm = [mu_f Kmu | kappa_f Kkappa] [24, 48] of scales = (mu_f,
    kappa_f): folded in float64, then cast to ``dtype``."""
    kmu, kk = _unit_operators()
    fm = np.concatenate([scales[0] * kmu, scales[1] * kk], axis=1)
    return torch.as_tensor(fm, dtype=dtype, device=device)


def bkt_step_plain(S, conv, K, offs, scales, rec):
    """The step as the node recursion, 8 shifted slices, one [24, 48] @
    [48, E] product (bkt_operator of ``scales``) and 24 shifted adds.
    conv' rounds to the storage type once, on return.  Returns (S',
    conv')."""
    fm = bkt_operator(scales, S.dtype, S.device)
    LEN = S.shape[1]
    E = LEN - offs[7]                  # element columns whose corners fit
    u, up = S[0:3], S[3:6]
    cn, dvs, dvk = bkt_recursion_plain(S, conv, rec)
    X = torch.cat([dvs[:, o:o + E] for o in offs]
                  + [dvk[:, o:o + E] for o in offs])    # [48, E]
    F = torch.matmul(fm, X) * K[4:5, :E]                 # [24, E]
    force = torch.zeros_like(u)
    for j, o in enumerate(offs):
        force[:, o:o + E] += F[3 * j:3 * j + 3]
    un = u + (force + K[0:3] * (u - up)) * K[3:4]
    return torch.cat([un, u, S[6:8]]), cn.to(conv.dtype)


def check_layout(name, specs, outputs, offs, LEN, rows):
    """Raise unless each (arg, tensor, shape, dtype) of ``specs`` is a
    contiguous tensor of that shape and type on the first one's device,
    no (output, input) pair of ``outputs`` shares storage, the 8 corner
    offsets fit in LEN columns, and rows x LEN elements index in 32
    bits (the kernels' int indexing)."""
    dev = specs[0][1].device
    for arg, t, shape, tdt in specs:
        if t.device != dev or t.dtype != tdt:
            raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                             f"expected {tdt} on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {shape} "
                             f"tensor, got {tuple(t.shape)}")
    if any(o.data_ptr() == i.data_ptr() for o, i in outputs):
        raise ValueError(f"{name}: outputs must not alias the inputs")
    if len(offs) != 8 or not 0 <= offs[7] < LEN:
        raise ValueError(f"{name}: bad corner offsets {offs}")
    if rows * LEN >= 2 ** 31:
        raise ValueError(f"{name}: {LEN} columns exceed 32-bit indexing")


def check_args(name, S, conv, K, offs, scales, rec, out, conv_out):
    """Raise unless the tensors are what the kernels take; returns the
    C entry suffix."""
    dev, dt = S.device, S.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    sfx = CONV_TYPES.get((dt, conv.dtype))
    if sfx is None:
        raise TypeError(f"{name}: working type {dt} with conv {conv.dtype} "
                        f"(one of {list(CONV_TYPES)})")
    LEN = S.shape[1] if S.dim() == 2 else -1
    R = conv.shape[0] if conv.dim() == 2 else -1
    if R not in (6, 12) or len(rec) != 3 * R // 2:
        raise ValueError(f"{name}: conv has {R} rows and rec {len(rec)} "
                         f"values (6 and 9, or 12 and 18)")
    if len(scales) != 2:
        raise ValueError(f"{name}: scales must be (mu_f, kappa_f), got "
                         f"{scales}")
    check_layout(name, (("S", S, (8, LEN), dt), ("K", K, (8, LEN), dt),
                        ("out", out, (8, LEN), dt),
                        ("conv", conv, (R, LEN), conv.dtype),
                        ("conv_out", conv_out, (R, LEN), conv.dtype)),
                 ((out, S), (conv_out, conv)), offs, LEN, 12)
    brick_strides(offs)
    return sfx


def rec_arg(rec, scales, dtype):
    """The C entries' host array of 20 in the working type: the
    recursion scalars (the kappa ones zero when shear-only), then mu_f
    and kappa_f, each rounded to nearest."""
    ct = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    vals = list(rec) + [0.0] * (18 - len(rec)) + list(scales)
    return (ct * 20)(*vals)


def _prepare(S, conv, K, offs, scales, rec, out, conv_out):
    """check_args, then (C entry, LEN, offsets, kernel scalars, kappa
    flag, device index)."""
    sfx = check_args("bkt_step", S, conv, K, offs, scales, rec, out,
                     conv_out)
    return (build.entry(f"ht_bkt_step_{sfx}"), S.shape[1],
            build.offsets_arg(offs), rec_arg(rec, scales, S.dtype),
            int(conv.shape[0] == 12), S.device.index)


_CHECKS = build.CheckCache(_prepare)


def bkt_step(S, conv, K, offs, scales, rec, out=None, conv_out=None):
    """One step (S, conv) -> (out, conv_out) (new tensors unless given).
    CUDA tensors run the K2 kernel; CPU tensors run bkt_step_plain."""
    if S.device.type == "cpu":
        Sn, cn = bkt_step_plain(S, conv, K, offs, scales, rec)
        if out is not None:
            Sn = out.copy_(Sn)
        if conv_out is not None:
            cn = conv_out.copy_(cn)
        return Sn, cn
    if out is None:
        out = torch.empty_like(S)
    if conv_out is None:
        conv_out = torch.empty_like(conv)
    fn, LEN, offs_arg, rec_c, kappa, dev = _CHECKS(
        S, conv, K, offs, tuple(scales), tuple(rec), out, conv_out)
    rc = fn(S.data_ptr(), conv.data_ptr(), K.data_ptr(), out.data_ptr(),
            conv_out.data_ptr(), LEN, offs_arg, rec_c, kappa, dev,
            build.stream(S))
    build.check(rc, "bkt_step launch")
    bkt_step.launches += 1
    return out, conv_out


bkt_step.launches = 0
