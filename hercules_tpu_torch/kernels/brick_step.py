"""K1: one explicit central-difference step of a uniform brick.

``brick_step`` launches the CUDA kernel of ``csrc/brick_step.cu`` on a
CUDA tensor and runs ``brick_step_plain``, the same step in plain
PyTorch, on a CPU tensor.  ``brick_step_lean`` is the kernel's lean
form: u and u- from two blocks of 3 rows, u+ alone out (or, with
``canonical``, the layout S), and ``brick_step_lean_plain`` its plain
version.  Both count their kernel launches in ``brick_step.launches``,
and in ``brick_step.configs`` by how each was configured: (ring
stages, blocks per SM, slab depth), as the library chose them
(``step_grid_of``; ``tiles.step_grid`` mirrors the slab); the lean
form's launches that write u+ alone also in
``brick_step.lean_launches``.

Layout (see ``solver/fused_brick.py``): S [8, LEN] = (u, u-, 0, 0),
K [8, LEN] = (c1, c2, beta, mass_minusaM x 3, inv_mass, 0), ops
[48, 24] = -[M1; M2]; element e has its corners at columns
e + offs[j], the 8 corners of a brick's flat node grid.  The plain
version multiplies by ops; the kernel forms each element's force in the
spectral form of M1 and M2 (``csrc/elastic_spectral.cuh``), so it takes
no operator.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .bkt_step import check_layout
from .tiles import brick_strides


def brick_step_lean_plain(u, up, K, offs, ops):
    """u+ [3, LEN] from u and u- [3, LEN]: the step as 8 shifted slices,
    one [24, 48] @ [48, E] product and 24 shifted adds
    (hercules_tpu/solver/brickstep.py:207-228, 331-332, in the c1/c2/beta
    form of the fused kernel)."""
    LEN = u.shape[1]
    E = LEN - offs[7]                  # element columns whose corners fit
    c1, c2, beta = K[0:1, :E], K[1:2, :E], K[2:3, :E]
    W = torch.cat([u[:, o:o + E] + beta * (u[:, o:o + E] - up[:, o:o + E])
                   for o in offs])                       # [24, E]
    mcat = torch.cat([ops[:24], ops[24:]], dim=1)        # [24, 48]
    F = torch.matmul(mcat, torch.cat([c1 * W, c2 * W]))  # [24, E]
    force = torch.zeros_like(u)
    for j, o in enumerate(offs):
        force[:, o:o + E] += F[3 * j:3 * j + 3]
    return u + (force + K[3:6] * (u - up)) * K[6:7]


def brick_step_plain(S, K, offs, ops):
    """The step S -> (u+, u, S rows 6:8) (brick_step_lean_plain)."""
    un = brick_step_lean_plain(S[0:3], S[3:6], K, offs, ops)
    return torch.cat([un, S[0:3], S[6:8]])


def check_args(name, S, K, offs, out):
    """Raise unless the arguments are what the kernels take: offs the
    corners of a brick's node grid (checked first, on any device), S, K
    and out contiguous [8, LEN] tensors of one type (float32 or float64)
    on one CUDA device, out apart from S."""
    brick_strides(offs)
    dev, dt = S.device, S.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dt} (float32 or float64)")
    LEN = S.shape[1] if S.dim() == 2 else -1
    check_layout(name, (("S", S, (8, LEN), dt), ("K", K, (8, LEN), dt),
                        ("out", out, (8, LEN), dt)),
                 ((out, S),), offs, LEN, 8)


def step_grid_of(offs, LEN, dtype, device, lean=False):
    """(ring stages, blocks per SM, resident blocks, slab depth, work
    items) of the kernel's launch (its lean form with ``lean``) on the
    brick of ``offs`` and LEN columns in ``dtype`` on CUDA device index
    ``device``, as the library computes them (loads the library)."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    form = "lean_" if lean else ""
    got = (ctypes.c_int * 5)()
    build.check(build.entry(f"ht_brick_step_{form}grid_{sfx}")(
        build.offsets_arg(offs), int(LEN), int(device), got),
        f"ht_brick_step_{form}grid")
    return tuple(got)


def _prepare(S, K, offs, out):
    """check_args, then (C entry, LEN, offsets, device index, the
    launch's configuration key)."""
    check_args("brick_step", S, K, offs, out)
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    LEN, dev = S.shape[1], S.device.index
    stages, per_sm, _, slab, _ = step_grid_of(offs, LEN, S.dtype, dev)
    return (build.entry(f"ht_brick_step_{sfx}"), LEN,
            build.offsets_arg(offs), dev, (stages, per_sm, slab))


_CHECKS = build.CheckCache(_prepare)


def brick_step(S, K, offs, ops, out=None):
    """One step S -> out (a new tensor unless ``out`` is given).  CUDA
    tensors run the K1 kernel; CPU tensors run brick_step_plain (the one
    user of ``ops``)."""
    if S.device.type == "cpu":
        res = brick_step_plain(S, K, offs, ops)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(S)
    fn, LEN, offs_arg, dev, config = _CHECKS(S, K, tuple(offs), out)
    rc = fn(S.data_ptr(), K.data_ptr(), out.data_ptr(), LEN, offs_arg, dev,
            build.stream(S))
    build.check(rc, "brick_step launch")
    build.launched(brick_step, config)
    return out


def _prepare_lean(U, Um, K, offs, out, canonical):
    """The lean form's checks, as check_args's: U and Um contiguous [3,
    LEN], K [8, LEN], out [3, LEN] ([8, LEN] with ``canonical``) sharing
    no memory with U or Um; then (C entry, LEN, offsets, device index,
    the launch's configuration key)."""
    brick_strides(offs)
    dev, dt = U.device, U.dtype
    if dev.type != "cuda":
        raise ValueError(f"brick_step_lean: no kernel for device {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"brick_step_lean: dtype {dt} (float32 or "
                        f"float64)")
    LEN = U.shape[1] if U.dim() == 2 else -1
    check_layout("brick_step_lean",
                 (("U", U, (3, LEN), dt), ("Um", Um, (3, LEN), dt),
                  ("K", K, (8, LEN), dt),
                  ("out", out, (8 if canonical else 3, LEN), dt)),
                 (), offs, LEN, 8)
    if build.overlap(out, U) or build.overlap(out, Um):
        raise ValueError("brick_step_lean: out must not share memory "
                         "with U or Um")
    sfx = "f32" if dt == torch.float32 else "f64"
    dev = dev.index
    stages, per_sm, _, slab, _ = step_grid_of(offs, LEN, dt, dev, lean=True)
    return (build.entry(f"ht_brick_step_lean_{sfx}"), LEN,
            build.offsets_arg(offs), dev, (stages, per_sm, slab))


_LEAN_CHECKS = build.CheckCache(_prepare_lean)


def brick_step_lean(U, Um, K, offs, ops, out, canonical=False):
    """One step from u = U and u- = Um, each a contiguous [3, LEN] block
    (rows of an [8, LEN] state or of any buffer), into ``out``: u+ alone
    into a [3, LEN] block, or with ``canonical`` the layout S (u+, U, 0,
    0) into an [8, LEN] tensor; out shares no memory with U or Um.  CUDA
    tensors run K1's lean form, u+ bit for bit brick_step's rows 0:3;
    CPU tensors run brick_step_lean_plain (the one user of ``ops``).
    Returns out."""
    if U.device.type == "cpu":
        un = brick_step_lean_plain(U, Um, K, offs, ops)
        if not canonical:
            return out.copy_(un)
        out[0:3], out[3:6] = un, U
        out[6:8] = 0
        return out
    fn, LEN, offs_arg, dev, config = _LEAN_CHECKS(U, Um, K, tuple(offs),
                                                  out, canonical)
    rc = fn(U.data_ptr(), Um.data_ptr(), K.data_ptr(), out.data_ptr(), LEN,
            offs_arg, dev, build.stream(U), int(canonical))
    build.check(rc, "brick_step_lean launch")
    build.launched(brick_step, config, 1,
                   *(() if canonical else ("lean_launches",)))
    return out


brick_step.launches = 0
brick_step.lean_launches = 0
brick_step.configs = {}
