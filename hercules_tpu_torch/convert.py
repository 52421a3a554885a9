"""Carry tables and states between the JAX package and the port.

Both packages number the brick's node columns the same way (the flat
node grid of ``plan.bricks[0]``); they differ only in the zero padding
after the nb node columns (the JAX package pads to whole kernel tiles,
the port to ``pallas_geometry(nb)``).  So the tests can feed the same
tables and states to both.
"""

from __future__ import annotations

import numpy as np
import torch

from .solver.fused_brick import (PallasBrickTables, pallas_geometry,
                                 pallas_u_global)


def tables_from_jax(tables, plan, dtype=torch.float32, device="cuda"):
    """The port's constant table K [8, LEN] (the elastic or the BKT
    layout, by tables.damping) from the JAX package's SolverTables
    (numpy) and a single-brick plan, on ``device`` (the CUDA device
    unless the caller asks for the CPU)."""
    return PallasBrickTables(plan, tables, dtype=dtype, device=device).K


def state_from_jax(S_np, plan):
    """The port's packed state [8, LEN] (numpy) from the JAX package's:
    either its packed [8, LEN_jax] state, or a pair (u, up) of global
    [N, 3] displacement fields."""
    b = plan.bricks[0]
    LEN = pallas_geometry(b.nb)
    if isinstance(S_np, tuple):
        u, up = (np.asarray(x) for x in S_np)
        S = np.zeros((8, LEN), u.dtype)
        S[0:3, :b.nb] = u[plan.gnid_cat].T
        S[3:6, :b.nb] = up[plan.gnid_cat].T
        return S
    S_np = np.asarray(S_np)
    if S_np.ndim != 2 or S_np.shape[0] != 8 or S_np.shape[1] < b.nb:
        raise ValueError(f"expected a packed [8, >={b.nb}] state, got "
                         f"{S_np.shape}")
    S = np.zeros((8, LEN), S_np.dtype)
    S[:, :b.nb] = S_np[:, :b.nb]
    return S


def conv_from_jax(conv, plan):
    """The port's BKT memory variables (float64 numpy) from the JAX
    package's, by the number of rows:

    - node basis [8 | 16, LEN_jax] (uniform or node tier: s0, s1[, k0,
      k1] x 3, then padding rows, on the node tier the set index in row
      6 | 12) -> [6 | 12, LEN]: the rows from 6 | 12 on are dropped;
    - corner basis [48 | 96, LEN_jax] -> [48 | 96, LEN];
    - the node tier's carry (conv_node, conv_mix [6 | 12, 8, M]) -> the
      pair (conv, conv_mix), conv_mix passed through.

    Columns past the brick's nb nodes are dropped or zero-padded."""
    if isinstance(conv, (tuple, list)):
        node, *mix = conv
        return (conv_from_jax(node, plan),) + tuple(
            np.asarray(m).astype(np.float64) for m in mix)
    b = plan.bricks[0]
    cv = np.asarray(conv).astype(np.float64)
    if cv.ndim != 2 or cv.shape[0] not in (6, 8, 12, 16, 48, 96) \
            or cv.shape[1] < b.nb:
        raise ValueError(f"expected a conv [8|16|48|96, >={b.nb}], got "
                         f"{cv.shape}")
    R = {8: 6, 16: 12}.get(cv.shape[0], cv.shape[0])
    out = np.zeros((R, pallas_geometry(b.nb)))
    out[:, :b.nb] = cv[:R, :b.nb]
    return out


def state_to_global(S, plan, N):
    """Global [N, 3] displacement u from a packed state of either
    package (rows 0:3 = u, columns = brick nodes then padding)."""
    return pallas_u_global(plan, np.asarray(torch.as_tensor(S).cpu())[0:3],
                           N)
