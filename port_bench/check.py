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
             devices, run_dtype=None):
    """{name: gap} of the numbers above; ``job``: the steps of the job
    whose forces the source applies, held at their last value after it
    (as ``cell.HeldForces`` gives them to the program); ``kept`` =
    (start step, u, u-, samples [k, R, 3], u at the end), fields [N, 3]
    in the program's node order.  The reference runs on ``devices[0]``;
    where the run has a second device, the window's chunk runs there,
    beside the set-up's chunk on the first.  ``run_dtype``: the type the
    reference computes in where it stands in for the program (the
    control), float64 otherwise."""
    mesh = fem.build_mesh(cfg)
    out = {"mesh_elements": abs(prog_mesh.lenum - mesh.E),
           "mesh_nodes": abs(prog_mesh.nnum - mesh.N),
           "mesh_dangling": abs(len(prog_mesh.dn_ids) - len(mesh.dn_ids))}
    if out["mesh_elements"] or out["mesh_nodes"] or out["mesh_dangling"]:
        return out
    two = [d for d in devices if d != devices[0]][:1]

    def solvers(dtype):
        first = fem.Solver(cfg, mesh, src, recv, job, dtype, devices[0])
        return first, (first.on(two[0]) if two else first)

    ref, ref_w = solvers(torch.float64)
    alt, alt_w = (None, None) if run_dtype is None else solvers(run_dtype)
    pm = node_map(prog_mesh, mesh)

    def field(x, solver):
        u = torch.zeros((mesh.N, 3), dtype=solver.dtype,
                        device=solver.device)
        u[torch.as_tensor(pm, device=solver.device)] = torch.as_tensor(
            np.asarray(x), device=solver.device).to(solver.dtype)
        return u

    s0, u0, up0, samples, u_end = kept
    k = len(samples)
    with torch.no_grad():
        (_, _, ys), (ue, _, ys_w) = fem.run_legs([
            (ref, *ref.zeros(), 0, chunk),
            (ref_w, field(u0, ref_w), field(up0, ref_w), s0, k)])
        first = first_samples
        end = np.asarray(u_end)
        if alt is not None:
            (_, _, first), (ae, _, samples) = fem.run_legs([
                (alt, *alt.zeros(), 0, chunk),
                (alt_w, field(u0, alt_w), field(up0, alt_w), s0, k)])
            first = first.double().cpu().numpy()
            samples = samples.double().cpu().numpy()
            end = ae.double().cpu().numpy()[pm]
        out["first_chunk"] = gap(first, ys.cpu().numpy())
        out["window_chunk"] = gap(samples, ys_w.cpu().numpy())
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
