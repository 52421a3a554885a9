"""The check that decides ``correct``: the program's receivers and field
against the plain reference (``reference/fem.py``), which works out the
mesh, masses, stiffness, source forces and receivers again from the
configuration and the seed's source.

Three numbers, each the largest gap over its array as a share of the
reference's largest magnitude there:

- ``first_chunk``: the receivers' samples of the set-up's chunk (steps
  0 to chunk - 1, from rest), against the reference from rest;
- ``window_chunk``: the receivers' samples of the window's chunk drawn
  from the seed, against the reference stepped over the same steps from
  the program's state at that chunk's start;
- ``window_field``: the displacement of every node at that chunk's end,
  against the same reference run.

The reference follows the program from the program's state at the drawn
chunk: it cannot step the whole run in the time of a check.  The start
that this skips (meshing, tables, forces, the loop from rest) is
``first_chunk``'s.  Besides the three, the mesh's elements, nodes and
dangling nodes must equal the reference's (limit 0).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import fem


def gap(prog, ref):
    """max |prog - ref| / max |ref|."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    if not np.isfinite(prog).all():
        return float("inf")
    return float(np.abs(prog - ref).max() / scale) if scale > 0 else \
        float(np.abs(prog).max())


def node_map(prog_mesh, mesh: fem.Mesh):
    """Reference node index of each program node, by coordinates."""
    ts = prog_mesh.ticksize
    keys = np.stack([np.asarray(getattr(prog_mesh, f"node_{a}"), np.float64)
                     * ts / mesh.hmin for a in "xyz"], 1)
    ik = np.rint(keys).astype(np.int64)
    if np.abs(keys - ik).max() > 1e-6:
        raise ValueError("a program node is off the reference's grid")
    dims = np.rint(np.array(mesh.extents) / mesh.hmin).astype(np.int64)
    ref_keys = fem.node_keys(mesh.nodes, dims)
    want = fem.node_keys(ik, dims)
    pos = np.searchsorted(ref_keys, want)
    pos = np.minimum(pos, len(ref_keys) - 1)
    if not (ref_keys[pos] == want).all():
        raise ValueError("a program node is not a reference node")
    return pos


def readings(cfg, chunk, src, recv, job, first_samples, kept, prog_mesh,
             device, run_dtype=None):
    """{name: gap} of the numbers above; ``job``: the steps of the job
    whose forces the source applies, held at their last value after it
    (as ``cell.HeldForces`` gives them to the program); ``kept`` =
    (start step, u, u-, samples [k, R, 3], u at the end), fields [N, 3]
    in the program's node order.  ``run_dtype``: the type the reference computes in where it
    stands in for the program (the control), float64 otherwise."""
    mesh = fem.build_mesh(cfg)
    out = {"mesh_elements": abs(prog_mesh.lenum - mesh.E),
           "mesh_nodes": abs(prog_mesh.nnum - mesh.N),
           "mesh_dangling": abs(len(prog_mesh.dn_ids) - len(mesh.dn_ids))}
    if out["mesh_elements"] or out["mesh_nodes"] or out["mesh_dangling"]:
        return out
    ref = fem.Solver(cfg, mesh, src, recv, job, torch.float64, device)
    alt = (None if run_dtype is None else
           fem.Solver(cfg, mesh, src, recv, job, run_dtype, device))
    pm = node_map(prog_mesh, mesh)

    def field(x, solver):
        u = torch.zeros((mesh.N, 3), dtype=solver.dtype, device=device)
        u[torch.as_tensor(pm, device=device)] = torch.as_tensor(
            np.asarray(x), device=device).to(solver.dtype)
        return u

    with torch.no_grad():
        u, up = ref.zeros()
        _, _, ys = ref.run(u, up, 0, chunk)
        first = first_samples
        if alt is not None:
            first = alt.run(*alt.zeros(), 0, chunk)[2].double().cpu().numpy()
        out["first_chunk"] = gap(first, ys.cpu().numpy())
        s0, u0, up0, samples, u_end = kept
        k = len(samples)
        ue, _, ys = ref.run(field(u0, ref), field(up0, ref), s0, k)
        end = np.asarray(u_end)
        if alt is not None:
            ae, _, samples = alt.run(field(u0, alt), field(up0, alt), s0, k)
            samples = samples.double().cpu().numpy()
            end = ae.double().cpu().numpy()[pm]
        out["window_chunk"] = gap(samples, ys.cpu().numpy())
        out["window_field"] = gap(end, ue.cpu().numpy()[pm])
    return out


def judge(values, limits):
    """(correct, lines): each number beside its limit."""
    ok = True
    lines = []
    for name, limit in limits.items():
        v = values.get(name, float("inf"))
        good = v <= limit
        ok &= good
        lines.append((name, v, limit, good))
    return ok, lines
