"""Carry tables and states between the JAX package and the port.

Both packages number a brick's node columns the same way (the flat
node grid of each ``plan.bricks[b]``, then the loose node section of a
multi-brick plan); they differ only in the zero padding after the nb
node columns (the JAX package pads to whole kernel tiles, the port to
``pallas_geometry(nb)``).  So the tests can feed the same tables and
states to both.  The unstructured solvers' states are global ([N, 3]
fields, [E, 8, 3] memory variables) in both packages.  The plastic state
of nonlinear soil (stresses and plastic strains [Enl, 8, 6], ep [Enl,
8][, bottom reactions [Eb, 4]], rows in nonlinear.NLTables.eidx order)
is laid out alike by both packages and both routes: the last entry of
an unstructured or a mesh state (``nonlinear_state``).
"""

from __future__ import annotations

import numpy as np
import torch

from .solver.fused_brick import (PallasBrickTables, fit_field_cm,
                                 pallas_geometry, pallas_u_global)
from .solver.restart import conv_array


def tables_from_jax(tables, plan, dtype=torch.float32, device="cuda",
                    brick=None):
    """The port's constant table K [8, LEN] (the elastic or the BKT
    layout, by tables.damping and the brick's BKT tier) from the JAX
    package's SolverTables (numpy) and a plan, on ``device`` (the CUDA
    device unless the caller asks for the CPU): the plan's one brick,
    or with ``brick`` given, that brick of a multi-brick plan as the
    mesh route builds it (fused_mesh.MeshPallasTables)."""
    if brick is None:
        return PallasBrickTables(plan, tables, dtype=dtype,
                                 device=device).K
    from .solver.fused_brick import solver_device
    from .solver.fused_mesh import brick_step_module
    return brick_step_module(plan, brick, tables, dtype,
                             solver_device(device))[0].K


def state_from_jax(S_np, plan):
    """The port's packed state [8, LEN] (numpy) from the JAX package's:
    either its packed [8, LEN_jax] state, or a pair (u, up) of global
    [N, 3] displacement fields."""
    b = plan.bricks[0]
    LEN = pallas_geometry(b.nb)
    if isinstance(S_np, tuple):
        u, up = (fit_field_cm(plan, x, LEN) for x in S_np)
        S = np.zeros((8, LEN), u.dtype)
        S[0:3], S[3:6] = u, up
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

    Columns past the brick's nb nodes are dropped or zero-padded
    (restart.conv_array, which reads a checkpoint's arrays too)."""
    if isinstance(conv, (tuple, list)):
        node, *mix = conv
        return (conv_from_jax(node, plan),) + tuple(
            np.asarray(m).astype(np.float64) for m in mix)
    b = plan.bricks[0]
    return conv_array(conv, pallas_geometry(b.nb), b.nb)


def state_to_global(S, plan, N):
    """Global [N, 3] displacement u from a packed state of either
    package (rows 0:3 = u, columns = brick nodes then padding)."""
    return pallas_u_global(plan, np.asarray(torch.as_tensor(S).cpu())[0:3],
                           N)


def mesh_state_from_jax(carry, plan, plastic=None):
    """The port's mesh state (Ss, (), ()) -- S [8, LEN_b] for every brick
    and [8, NL] for the loose section, numpy, memory variables left at
    zero (fused_mesh.fit_mesh_state) -- from the JAX package's mesh
    carry: packed ((S_0, ..., S_loose), ...) with S [8, *], legacy (us,
    ups, conv) with [3, *] entries, or a pair (u, up) of global [N, 3]
    displacement fields.  ``plastic``: the plastic state of a nonlinear
    carry of either JAX route (laid out alike), then the fourth entry
    (Ss, (), (), plastic state)."""
    from .solver.fused_mesh import mesh_spans, mesh_states_of_fields
    if plastic is not None:
        return mesh_state_from_jax(carry, plan)[:3] + (
            tuple(np.asarray(a) for a in plastic),)
    if not isinstance(carry[0], (tuple, list)):          # global pair
        return (mesh_states_of_fields(plan, *carry), (), ())
    if np.shape(carry[0][0])[0] == 8:                    # packed
        pairs = [(np.asarray(S)[0:3], np.asarray(S)[3:6]) for S in carry[0]]
    else:                                                # legacy
        pairs = [(np.asarray(u), np.asarray(up))
                 for u, up in zip(carry[0], carry[1])]
    spans = mesh_spans(plan)
    if len(pairs) != len(spans):
        raise ValueError(f"{len(pairs)} arrays, the plan has "
                         f"{len(spans) - 1} bricks and the loose section")
    Ss = []
    for (o, n, LEN), (u, up) in zip(spans, pairs):
        S = np.zeros((8, LEN), u.dtype)
        S[0:3, :n] = u[:, :n]
        S[3:6, :n] = up[:, :n]
        Ss.append(S)
    return (tuple(Ss), (), ())


def mesh_state_to_global(Ss, plan, N):
    """Global [N, 3] displacement u from the S arrays of a mesh state of
    either package (rows 0:3 = u)."""
    from .solver.fused_mesh import mesh_u_global
    return mesh_u_global(plan, Ss, N)


def _numpy_state(state, host):
    """(u, u-, conv[, plastic state]) with ``host`` applied to each
    array; conv None or a tuple."""
    if len(state) not in (3, 4):
        raise ValueError(f"expected an unstructured state (u, u-, conv[, "
                         f"plastic state]), got {len(state)} entries")
    u, up, conv = state[:3]
    out = (host(u), host(up),
           None if conv is None else tuple(host(c) for c in conv))
    return out + tuple(tuple(host(a) for a in s) for s in state[3:])


def unstructured_state_from_jax(carry):
    """The port's unstructured state (step.run_solver's ``state``), numpy,
    from the JAX package's run_solver carry: global u and u- [N, 3],
    conv None or, with BKT, four [E, 8, 3] memory-variable arrays, and
    with nonlinear soil the plastic state.  Both packages lay it out
    alike, so the arrays pass as they are."""
    return _numpy_state(carry, np.asarray)


def unstructured_state_to_global(state):
    """The global (u [N, 3], u- [N, 3], conv[, plastic state]) numpy
    arrays of the port's unstructured state (tensors on any device)."""
    return _numpy_state(state, lambda x: torch.as_tensor(x).cpu().numpy())


def nonlinear_state(state):
    """The plastic state of a port state with nonlinear soil, on the
    unstructured route (u, u-, conv, plastic state) or the mesh route
    (Ss, convs, lconv, plastic state), as numpy arrays in the layout of
    the JAX package's carries (their last entry, on either route)."""
    if len(state) != 4:
        raise ValueError("the state has no nonlinear part")
    return tuple(torch.as_tensor(a).cpu().numpy() for a in state[3])
