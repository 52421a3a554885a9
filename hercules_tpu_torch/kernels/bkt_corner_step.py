"""K4: one step of a BKT brick with memory variables per element corner.

``bkt_corner_step`` launches the CUDA kernels of ``csrc/bkt_corner.cu``
on CUDA tensors and runs ``bkt_corner_step_plain``, the same step in
plain PyTorch, on CPU tensors.  It counts its launches in
``bkt_corner_step.launches`` (one per step: the element pass and the
node pass go out together).

Layout (see ``solver/fused_bktq.py``): S [8, LEN] = (u, u-, 0, 0),
conv [48 | 96, LEN] with row 24 v + 3 j + c = variable v (s0, s1, k0,
k1) of the element's corner j, component c, in the storage type
(bfloat16 in float32 runs, float64 in float64 runs); K [8, LEN] =
(mass_minusaM x 3, inv_mass, ...); bk [11 | 20, LEN] = the element's
coefficient rows (``fused_bkt.bk_row_names``); fm [24, 48] = [Kmu |
Kkappa].
"""

from __future__ import annotations

import torch

from . import build
from .bkt_step import check_layout

# (working type, conv storage type) pairs the kernels take, and the
# suffix of their C entries
CONV_TYPES = {(torch.float32, torch.bfloat16): "f32_bf16",
              (torch.float64, torch.float64): "f64_f64"}


def bkt_corner_step_plain(S, conv, K, bk, offs, fm):
    """The step as 8 shifted slices of u and u - u-, the recursion on the
    element's 48 | 96 corner rows, one [24, 48] @ [48, E] product and 24
    shifted adds.  conv' rounds to the storage type once, on return, and
    is zero at the element columns whose corners leave the state.
    Returns (S', conv')."""
    LEN = S.shape[1]
    E = LEN - offs[7]
    u, up = S[0:3], S[3:6]
    du = u - up
    u24 = torch.cat([u[:, o:o + E] for o in offs])      # [24, E], 3j+c
    du24 = torch.cat([du[:, o:o + E] for o in offs])
    up24 = u24 - du24               # the TPU kernel's u-, rounded alike
    b = bk[:, :E]
    cv = conv[:, :E].to(S.dtype)

    def pair(k, s0, s1):
        s0n = b[k + 1] * u24 + b[k] * up24 + b[k + 4] * s0
        s1n = b[k + 3] * u24 + b[k + 2] * up24 + b[k + 5] * s1
        dv = b[k + 8] * du24 + u24 - b[k + 6] * s0n - b[k + 7] * s1n
        return s0n, s1n, dv

    s0n, s1n, dvs = pair(0, cv[0:24], cv[24:48])
    new = [s0n, s1n]
    if conv.shape[0] == 48:
        dvk = u24
    else:
        k0n, k1n, dvk = pair(9, cv[48:72], cv[72:96])
        new += [k0n, k1n]
    X = torch.cat([dvs * b[-2], dvk * b[-1]])           # [48, E]
    F = torch.matmul(fm, X)                             # [24, E]
    force = torch.zeros_like(u)
    for j, o in enumerate(offs):
        force[:, o:o + E] += F[3 * j:3 * j + 3]
    un = u + (force + K[0:3] * (u - up)) * K[3:4]
    cn = torch.zeros_like(conv)
    cn[:, :E] = torch.cat(new)
    return torch.cat([un, u, S[6:8]]), cn


def check_args(name, S, conv, K, bk, offs, fm, out, conv_out):
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
    NB = bk.shape[0] if bk.dim() == 2 else -1
    if (R, NB) not in ((48, 11), (96, 20)):
        raise ValueError(f"{name}: conv has {R} rows and bk {NB} (48 and "
                         f"11, or 96 and 20)")
    check_layout(name, (("S", S, (8, LEN), dt), ("K", K, (8, LEN), dt),
                        ("bk", bk, (NB, LEN), dt), ("fm", fm, (24, 48), dt),
                        ("out", out, (8, LEN), dt),
                        ("conv", conv, (R, LEN), conv.dtype),
                        ("conv_out", conv_out, (R, LEN), conv.dtype)),
                 ((out, S), (conv_out, conv)), offs, LEN, 96)
    return sfx


def _prepare(S, conv, K, bk, offs, fm, out, conv_out):
    """check_args, then (C entry, constant bank setter, LEN, offsets,
    kappa flag, device index)."""
    sfx = check_args("bkt_corner_step", S, conv, K, bk, offs, fm, out,
                     conv_out)
    return (build.entry(f"ht_bkt_corner_step_{sfx}"),
            f"ht_bkt_corner_set_fm_{sfx[:3]}", S.shape[1],
            build.offsets_arg(offs), int(conv.shape[0] == 96),
            S.device.index)


_CHECKS = build.CheckCache(_prepare)


def bkt_corner_step(S, conv, K, bk, offs, fm, out=None, conv_out=None):
    """One step (S, conv) -> (out, conv_out) (new tensors unless given).
    CUDA tensors run the K4 kernels; CPU tensors run
    bkt_corner_step_plain."""
    if S.device.type == "cpu":
        Sn, cn = bkt_corner_step_plain(S, conv, K, bk, offs, fm)
        if out is not None:
            Sn = out.copy_(Sn)
        if conv_out is not None:
            cn = conv_out.copy_(cn)
        return Sn, cn
    if out is None:
        out = torch.empty_like(S)
    if conv_out is None:
        conv_out = torch.empty_like(conv)
    fn, setter, LEN, offs_arg, kappa, dev = _CHECKS(S, conv, K, bk, offs,
                                                   fm, out, conv_out)
    F = S.new_empty((24, LEN))
    stream = build.stream(S)
    build.ensure_ops(setter, fm, stream)
    rc = fn(S.data_ptr(), conv.data_ptr(), K.data_ptr(), bk.data_ptr(),
            out.data_ptr(), conv_out.data_ptr(), F.data_ptr(), LEN, offs_arg,
            kappa, dev, stream)
    build.check(rc, "bkt_corner_step launch")
    bkt_corner_step.launches += 1
    return out, conv_out


bkt_corner_step.launches = 0
