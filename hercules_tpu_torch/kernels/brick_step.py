"""K1: one explicit central-difference step of a uniform brick.

``brick_step_lean`` launches the CUDA kernel of ``csrc/brick_step.cu``
on CUDA tensors: u and u- from two blocks of 3 rows, u+ alone out (the
lean form) or, with ``canonical``, the layout S; on CPU tensors it runs
``brick_step_lean_plain``, the same step in plain PyTorch.
``brick_step`` is the step of the layout S: the canonical form on S's
rows 0:3 and 3:6.  Each launch counts in ``brick_step.launches``, and
in ``brick_step.configs`` by how it was configured: (ring stages,
blocks per SM, slab depth, tile width), as the library chose them
(``step_grid_of``; ``tiles.step_grid`` mirrors the slab and the width);
the launches that write u+ alone also in ``brick_step.lean_launches``.

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
    """The step S -> (u+, u, S rows 6:8) (brick_step_lean_plain): K5's
    plain step."""
    un = brick_step_lean_plain(S[0:3], S[3:6], K, offs, ops)
    return torch.cat([un, S[0:3], S[6:8]])


def check_args(name, S, K, offs, out):
    """Raise unless the arguments are what K5 takes: offs the
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


def step_grid_of(offs, LEN, dtype, device):
    """(ring stages, blocks per SM, resident blocks, slab depth, work
    items, tile width) of the kernel's launch on the brick of ``offs``
    and LEN columns in ``dtype`` on CUDA device index ``device``, as the
    library computes them (loads the library)."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    got = (ctypes.c_int * 6)()
    build.check(build.entry(f"ht_brick_step_grid_{sfx}")(
        build.offsets_arg(offs), int(LEN), int(device), got),
        "ht_brick_step_grid")
    return tuple(got)


def _prepare(U, Um, K, offs, out, canonical):
    """Raise unless the arguments are what the kernel takes: offs the
    corners of a brick's node grid (checked first, on any device), U and
    Um contiguous [3, LEN] and K [8, LEN] tensors of one type (float32 or
    float64) on one CUDA device, out [3, LEN] ([8, LEN] with
    ``canonical``) sharing no memory with U or Um; then (C entry, LEN,
    offsets, device index, the launch's configuration key)."""
    brick_strides(offs)
    dev, dt = U.device, U.dtype
    if dev.type != "cuda":
        raise ValueError(f"brick_step: no kernel for device {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"brick_step: dtype {dt} (float32 or float64)")
    LEN = U.shape[1] if U.dim() == 2 else -1
    check_layout("brick_step",
                 (("U", U, (3, LEN), dt), ("Um", Um, (3, LEN), dt),
                  ("K", K, (8, LEN), dt),
                  ("out", out, (8 if canonical else 3, LEN), dt)),
                 (), offs, LEN, 8)
    if build.overlap(out, U) or build.overlap(out, Um):
        raise ValueError("brick_step: out must not share memory with U or "
                         "Um")
    sfx = "f32" if dt == torch.float32 else "f64"
    dev = dev.index
    stages, per_sm, _, slab, _, width = step_grid_of(offs, LEN, dt, dev)
    return (build.entry(f"ht_brick_step_{sfx}"), LEN,
            build.offsets_arg(offs), dev, (stages, per_sm, slab, width))


_CHECKS = build.CheckCache(_prepare)


def brick_step_lean(U, Um, K, offs, ops, out, canonical=False):
    """One step from u = U and u- = Um, each a contiguous [3, LEN] block
    (rows of an [8, LEN] state or of any buffer), into ``out``: u+ alone
    into a [3, LEN] block, or with ``canonical`` the layout S (u+, U, 0,
    0) into an [8, LEN] tensor; out shares no memory with U or Um.  CUDA
    tensors run K1; CPU tensors run brick_step_lean_plain (the one user
    of ``ops``).  Returns out."""
    if U.device.type == "cpu":
        un = brick_step_lean_plain(U, Um, K, offs, ops)
        if not canonical:
            return out.copy_(un)
        out[0:3], out[3:6] = un, U
        out[6:8] = 0
        return out
    fn, LEN, offs_arg, dev, config = _CHECKS(U, Um, K, tuple(offs), out,
                                             canonical)
    rc = fn(U.data_ptr(), Um.data_ptr(), K.data_ptr(), out.data_ptr(), LEN,
            offs_arg, dev, build.stream(U), int(canonical))
    build.check(rc, "brick_step launch")
    build.launched(brick_step, config, 1,
                   *(() if canonical else ("lean_launches",)))
    return out


def brick_step(S, K, offs, ops, out=None):
    """One step of the layout S: S [8, LEN] = (u, u-, 0, 0) -> out = (u+,
    u, 0, 0) (a new tensor unless ``out`` is given): brick_step_lean's
    canonical form on S's rows 0:3 and 3:6."""
    if out is None:
        out = torch.empty_like(S)
    return brick_step_lean(S[0:3], S[3:6], K, offs, ops, out, canonical=True)


brick_step.launches = 0
brick_step.lean_launches = 0
brick_step.configs = {}
