"""K1: one explicit central-difference step of a uniform brick.

``brick_step`` launches the CUDA kernel of ``csrc/brick_step.cu`` on a
CUDA tensor and runs ``brick_step_plain``, the same step in plain
PyTorch, on a CPU tensor.  It counts its kernel launches in
``brick_step.launches``, and in ``brick_step.configs`` by how each was
configured: (ring stages, blocks per SM, slab depth), as the library
chose them (``step_grid_of``; ``tiles.step_grid`` mirrors the slab).

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


def brick_step_plain(S, K, offs, ops):
    """The step as 8 shifted slices, one [24, 48] @ [48, E] product and
    24 shifted adds (hercules_tpu/solver/brickstep.py:207-228, 331-332,
    in the c1/c2/beta form of the fused kernel)."""
    LEN = S.shape[1]
    E = LEN - offs[7]                  # element columns whose corners fit
    u, up = S[0:3], S[3:6]
    c1, c2, beta = K[0:1, :E], K[1:2, :E], K[2:3, :E]
    W = torch.cat([u[:, o:o + E] + beta * (u[:, o:o + E] - up[:, o:o + E])
                   for o in offs])                       # [24, E]
    mcat = torch.cat([ops[:24], ops[24:]], dim=1)        # [24, 48]
    F = torch.matmul(mcat, torch.cat([c1 * W, c2 * W]))  # [24, E]
    force = torch.zeros_like(u)
    for j, o in enumerate(offs):
        force[:, o:o + E] += F[3 * j:3 * j + 3]
    un = u + (force + K[3:6] * (u - up)) * K[6:7]
    return torch.cat([un, u, S[6:8]])


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


def step_grid_of(offs, LEN, dtype, device):
    """(ring stages, blocks per SM, resident blocks, slab depth, work
    items) of the kernel's launch on the brick of ``offs`` and LEN
    columns in ``dtype`` on CUDA device index ``device``, as the library
    computes them (loads the library)."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    got = (ctypes.c_int * 5)()
    build.check(build.entry(f"ht_brick_step_grid_{sfx}")(
        build.offsets_arg(offs), int(LEN), int(device), got),
        "ht_brick_step_grid")
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
    brick_step.launches += 1
    configs = brick_step.configs
    configs[config] = configs.get(config, 0) + 1
    return out


brick_step.launches = 0
brick_step.configs = {}
