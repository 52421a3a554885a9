"""K4: one step of a BKT brick with memory variables per element corner.

``bkt_corner_step`` launches the CUDA kernel of ``csrc/bkt_corner.cu``
on CUDA tensors and runs ``bkt_corner_step_plain``, the same step in
plain PyTorch, on CPU tensors.  It counts its launches in
``bkt_corner_step.launches`` (one per step).

Layout (see ``solver/fused_bktq.py``): S [8, LEN] = (u, u-, 0, 0),
conv [48 | 96, LEN] with row 24 v + 3 j + c = variable v (s0, s1, k0,
k1) of the element's corner j, component c, in the storage type
(bfloat16 in float32 runs, float64 in float64 runs); K [8, LEN] =
(mass_minusaM x 3, inv_mass, and at the element columns mu_f, kappa_f,
the shear set index and the kappa set index); tab = ``corner_tab(fm,
shear_sets, kappa_sets)``: fm [24, 48] = [Kmu | Kkappa], which the plain
version multiplies by (the kernel forms the element force in the
spectral form), then each channel's coefficient sets (c1 c2 c3 c4 e0 e1
a0 a1 coef), which the kernel reads from constant memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .bkt_step import check_layout
from .tiles import brick_strides

# the device type the kernel runs on (the tests set "cpu" to reach the
# other refusals of check_args with CPU tensors)
KERNEL_DEVICE = "cuda"
# coefficient sets per channel the table holds (bkt_corner.cu's kSets);
# a channel's coefficients follow its QTABLE bin, 19 sets at most
CORNER_SETS = 32
FM_SIZE = 24 * 48
TAB_SIZE = FM_SIZE + 2 * CORNER_SETS * 9
# (working type, conv storage type) pairs the kernel takes, and the
# suffix of its C entries
CONV_TYPES = {(torch.float32, torch.bfloat16): "f32_bf16",
              (torch.float64, torch.float64): "f64_f64"}


def corner_tab(fm, shear_sets, kappa_sets=None):
    """fm [24, 48] and the coefficient sets [n, 9] of each channel
    (kappa None when shear-only) as the one tensor the kernel takes:
    fm, then the table [2, CORNER_SETS, 9], zero-padded."""
    tab = fm.new_zeros(TAB_SIZE)
    tab[:FM_SIZE] = fm.reshape(-1)
    table = tab[FM_SIZE:].view(2, CORNER_SETS, 9)
    for ch, sets in enumerate((shear_sets, kappa_sets)):
        if sets is None:
            continue
        if not 0 < sets.shape[0] <= CORNER_SETS or sets.shape[1] != 9:
            raise ValueError(f"{tuple(sets.shape)} coefficient sets (at "
                             f"most {CORNER_SETS} of 9 values)")
        table[ch, :sets.shape[0]] = sets
    return tab


def unpack_corner_tab(tab):
    """(fm [24, 48], the sets table [2, CORNER_SETS, 9]) views of tab."""
    return (tab[:FM_SIZE].view(24, 48),
            tab[FM_SIZE:].view(2, CORNER_SETS, 9))


def corner_rows(K, tab, E, kappa):
    """The element columns' coefficient rows [11 | 20, E] (shear c1 c2
    c3 c4 e0 e1 a0 a1 coef, with kappa the same 9 for kappa, then mu_f
    and kappa_f) from K's set indices and mu_f, kappa_f rows."""
    _, table = unpack_corner_tab(tab)
    rows = [table[0][K[6, :E].long()].T]
    if kappa:
        rows.append(table[1][K[7, :E].long()].T)
    return torch.cat(rows + [K[4:6, :E]])


def bkt_corner_step_plain(S, conv, K, offs, tab):
    """The step as 8 shifted slices of u and u - u-, the recursion on the
    element's 48 | 96 corner rows with its coefficient sets, one [24, 48]
    @ [48, E] product and 24 shifted adds.  conv' rounds to the storage
    type once, on return, and is zero at the element columns whose
    corners leave the state.  Returns (S', conv')."""
    LEN = S.shape[1]
    E = LEN - offs[7]
    u, up = S[0:3], S[3:6]
    du = u - up
    u24 = torch.cat([u[:, o:o + E] for o in offs])      # [24, E], 3j+c
    du24 = torch.cat([du[:, o:o + E] for o in offs])
    up24 = u24 - du24               # the TPU kernel's u-, rounded alike
    b = corner_rows(K, tab, E, conv.shape[0] == 96)
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
    F = torch.matmul(unpack_corner_tab(tab)[0], X)      # [24, E]
    force = torch.zeros_like(u)
    for j, o in enumerate(offs):
        force[:, o:o + E] += F[3 * j:3 * j + 3]
    un = u + (force + K[0:3] * (u - up)) * K[3:4]
    cn = torch.zeros_like(conv)
    cn[:, :E] = torch.cat(new)
    return torch.cat([un, u, S[6:8]]), cn


def check_args(name, S, conv, K, offs, tab, out, conv_out):
    """Raise unless the tensors are what the kernel takes; returns the
    C entry suffix."""
    dev, dt = S.device, S.dtype
    if dev.type != KERNEL_DEVICE:
        raise ValueError(f"{name}: no kernel for device {dev}")
    sfx = CONV_TYPES.get((dt, conv.dtype))
    if sfx is None:
        raise TypeError(f"{name}: working type {dt} with conv {conv.dtype} "
                        f"(one of {list(CONV_TYPES)})")
    LEN = S.shape[1] if S.dim() == 2 else -1
    R = conv.shape[0] if conv.dim() == 2 else -1
    if R not in (48, 96):
        raise ValueError(f"{name}: conv has {R} rows (48 or 96)")
    check_layout(name, (("S", S, (8, LEN), dt), ("K", K, (8, LEN), dt),
                        ("tab", tab, (TAB_SIZE,), dt),
                        ("out", out, (8, LEN), dt),
                        ("conv", conv, (R, LEN), conv.dtype),
                        ("conv_out", conv_out, (R, LEN), conv.dtype)),
                 ((out, S), (conv_out, conv)), offs, LEN, 96)
    brick_strides(offs)
    return sfx


def _prepare(S, conv, K, offs, tab, out, conv_out):
    """check_args, then (C entry, constant bank setter, LEN, offsets,
    kappa flag, device index)."""
    sfx = check_args("bkt_corner_step", S, conv, K, offs, tab, out,
                     conv_out)
    return (build.entry(f"ht_bkt_corner_step_{sfx}"),
            f"ht_bkt_corner_set_tab_{sfx[:3]}", S.shape[1],
            build.offsets_arg(offs), int(conv.shape[0] == 96),
            S.device.index)


_CHECKS = build.CheckCache(_prepare)


def bkt_corner_step(S, conv, K, offs, tab, out=None, conv_out=None):
    """One step (S, conv) -> (out, conv_out) (new tensors unless given).
    CUDA tensors run the K4 kernel; CPU tensors run
    bkt_corner_step_plain."""
    if S.device.type == "cpu":
        Sn, cn = bkt_corner_step_plain(S, conv, K, offs, tab)
        if out is not None:
            Sn = out.copy_(Sn)
        if conv_out is not None:
            cn = conv_out.copy_(cn)
        return Sn, cn
    if out is None:
        out = torch.empty_like(S)
    if conv_out is None:
        conv_out = torch.empty_like(conv)
    fn, setter, LEN, offs_arg, kappa, dev = _CHECKS(S, conv, K, offs, tab,
                                                   out, conv_out)
    stream = build.stream(S)
    build.ensure_ops(setter, tab, stream)
    rc = fn(S.data_ptr(), conv.data_ptr(), K.data_ptr(), out.data_ptr(),
            conv_out.data_ptr(), LEN, offs_arg, kappa, dev, stream)
    build.check(rc, "bkt_corner_step launch")
    bkt_corner_step.launches += 1
    return out, conv_out


def corner_grid_of(offs, LEN, dtype, kappa):
    """(resident blocks, slab depth, work items) of the kernel's launch
    on the brick of ``offs`` and LEN columns, as the library computes
    them for this working type and kappa flag on the current CUDA
    device (loads the library)."""
    sfx = {t: s for (t, _), s in CONV_TYPES.items()}[dtype]
    got = (ctypes.c_int * 3)()
    build.check(build.entry(f"ht_bkt_corner_grid_{sfx}")(
        build.offsets_arg(offs), int(LEN), int(kappa),
        build.current_device(), got), "ht_bkt_corner_grid")
    return tuple(got)


bkt_corner_step.launches = 0
