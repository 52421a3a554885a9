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


def mc_state_from_jax(path, carry):
    """The per-rank state of a multi-chip path (parallel/driver.py) from
    the JAX package's rank-stacked carry of the same path and rank
    count, numpy arrays [n_dev, ...] in nests of tuples:

    - "sharded": (u, u-, conv[, plastic state]), as the port lays it
      out per rank;
    - "slab": (u, u-[, (s0, s1, k0, k1)]), [n_dev, 3, tot_local] fields
      and [n_dev, 24, S] memory variables, as the port's;
    - "slab_pallas": (S[, conv]) packed, S [n_dev, 8, LEN_jax] and the
      node-basis memory variables [n_dev, 8 | 16, LEN_jax] of its one
      Q set, or (u, u-, conv) [n_dev, 3, LEN_jax] with corner-basis
      ones [n_dev, 48 | 96, LEN_jax] (several Q sets), fitted to the
      port's fragments (restart.fit_conv);
    - "gslab": the same per brick, (Ss[, convs]) packed or (us, ups,
      convs) with the corner basis, each entry a tuple over the bricks;
    - "gmesh": (Ss, S_l[, convs | plastic state]), S_l [n_dev, 8, NL]
      the loose section, the plastic state (stresses, plastic strains,
      ep) padded to one width over the ranks: each rank keeps its own
      rows."""
    from .solver.restart import fit_conv
    n = path.n_dev
    on = [lambda x, dev=dev: torch.as_tensor(np.asarray(x)).to(
        dev, path.dtype) for dev in path.group.devices]
    if path.name not in ("slab_pallas", "gslab", "gmesh"):
        def rank(tree, r):
            if isinstance(tree, (tuple, list)):
                return tuple(rank(t, r) for t in tree)
            return on[r](np.asarray(tree)[r])
        return [rank(tuple(carry), r) for r in range(n)]

    def packed(S_j, conv_j, r, mod, LEN, tot_local):
        """(S [8, LEN] on rank r's device, its memory variables or ())
        from a JAX fragment's S [8 | 3 + 3, LEN_jax] and conv."""
        S = np.zeros((8, LEN), S_j.dtype)
        w = min(LEN, S_j.shape[-1], tot_local)
        S[:S_j.shape[0], :w] = S_j[:, :w]
        if conv_j is None:
            return on[r](S), ()
        cv = fit_conv(mod, LEN, (conv_j,))
        dev = path.group.devices[r]
        return on[r](S), tuple(torch.as_tensor(c).to(dev, dt) for c, (_, dt)
                               in zip(cv, mod.state_parts(LEN)))

    step = path.step
    if path.name == "slab_pallas":
        S_j = np.asarray(carry[0])
        conv = None
        if S_j.shape[1] == 3:            # the JAX corner tier: (u, u-, conv)
            S_j = np.concatenate([S_j, np.asarray(carry[1])], axis=1)
            conv = np.asarray(carry[2])
        elif len(carry) > 1:
            conv = np.asarray(carry[1])
        out = []
        for r in range(n):
            S, cv = packed(S_j[r], None if conv is None else conv[r], r,
                           step.mods[r][0], step.LEN, path.st.tot_local)
            out.append((S,) + cv)
        return out

    NB = len(path.st.bricks)
    if path.name == "gslab":
        first = carry[0]
        if np.shape(first[0])[1] == 3:   # (us, ups, convs): corner tier
            Ss = [np.concatenate([np.asarray(a), np.asarray(b)], axis=1)
                  for a, b in zip(carry[0], carry[1])]
            convs, rest = carry[2], None
        else:
            Ss = [np.asarray(a) for a in first]
            convs = carry[1] if len(carry) > 1 else None
            rest = None
    else:
        Ss = [np.asarray(a) for a in carry[0]]
        rest = np.asarray(carry[1])
        convs = (carry[2] if len(carry) > 2 and path.st.damping == "bkt"
                 else None)
    out = []
    for r in range(n):
        bricks, cvs = [], []
        for b, fb in enumerate(path.st.bricks):
            S, cv = packed(Ss[b][r], None if convs is None
                           else np.asarray(convs[b])[r], r,
                           step.mods[r][b], fb.LEN, fb.tot_local)
            bricks.append(S)
            cvs.append(cv)
        s = (tuple(bricks),)
        if path.name == "gmesh":
            s += (on[r](rest[r]),)
        if convs is not None:
            s += (tuple(cvs),)
        elif path.name == "gmesh" and path.st.nl is not None:
            k = len(path.st.nl[r]["idx"])
            s += (tuple(on[r](np.asarray(a)[r, :k]) for a in carry[2]),)
        out.append(s)
    assert all(len(x[0]) == NB for x in out)
    return out


def mc_state_to_jax(path, state, like):
    """The JAX package's rank-stacked carry (numpy) of a multi-chip
    path from the port's per-rank state, shaped as ``like`` (a JAX carry
    of the same path and rank count, e.g. its init_state): the
    inverse of mc_state_from_jax, padding columns (and gmesh's padded
    plastic-state rows) zero; a node-basis conv [6 | 12, LEN] fills the
    first rows of the JAX [8 | 16, LEN_jax]."""
    def host(x):
        return np.asarray(torch.as_tensor(x).detach().cpu().to(
            torch.float64 if x.dtype == torch.float64 else torch.float32))

    def fill(ranks, ref):
        ref = np.asarray(ref)
        out = np.zeros(ref.shape, ref.dtype)
        for r, x in enumerate(ranks):
            a = host(x)
            cut = tuple(slice(0, min(p, q)) for p, q in
                        zip(a.shape, ref.shape[1:]))
            out[(r,) + cut] = a[cut]
        return out

    def walk(parts, ref):
        if isinstance(ref, (tuple, list)):
            return tuple(walk([p[i] for p in parts], ref[i])
                         for i in range(len(ref)))
        return fill(parts, ref)

    parts = list(state)
    if path.name == "slab_pallas" and np.shape(like[0])[1] == 3:
        parts = [(s[0][0:3], s[0][3:6]) + tuple(s[1:]) for s in parts]
    if path.name in ("gslab", "gmesh") and path.st.damping == "bkt":
        # one memory-variable array per brick, as the JAX carry holds it
        parts = [s[:-1] + (tuple(c[0] for c in s[-1]),) for s in parts]
    if path.name == "gslab" and np.shape(like[0][0])[1] == 3:
        parts = [(tuple(S[0:3] for S in s[0]), tuple(S[3:6] for S in s[0]))
                 + tuple(s[1:]) for s in parts]
    return walk(parts, like)
