"""Simulation statistics: stability scan, damping statistics, mesh
stats, K-matrix printer.

Mirrors solver_set_critical_T (psolve.c:2779-3140),
damping_statistics (:2589-2777, 40-interval histograms),
mesh_print_stat (:2243-2360) and print_K_stdoutput (:3184).

The port's copy of ``hercules_tpu/utils/stats.py``, kept equal to it
(tests/test_torch_host.py)."""

from __future__ import annotations

import sys

import numpy as np

from ..physics.consts import compute_setab


def critical_t_stats(mesh, params, out=None):
    """min h/Vp + the damping-related extremes; returns critical dt."""
    out = out or sys.stdout
    props = mesh.props
    vp, vs = props["Vp"], props["Vs"]
    h = mesh.edge_m
    ratio = h / vp
    zeta = np.minimum(10.0 / vs, params.threshold_damping)
    a_base, b_base = compute_setab(params.freq, params.type_of_damping)
    omega = 3.46410161514 / ratio
    a = zeta * a_base
    b = zeta * b_base
    xi = a / (2 * omega) + b * omega / 2
    dt_x = 0.57735026919 * (1 - xi) * ratio
    dt_z = 0.57735026919 * (1 - zeta) * ratio

    crit = float(ratio.min())
    out.write("\n Critical delta t related information:\n\n")
    out.write(f"\t 1. The minimum h/Vp          = {crit:.6f}\n")
    if params.damping_statistics:
        out.write(f"\t 2. The minimum dt X          = {dt_x.min():.6f}\n")
        out.write(f"\t 3. The minimum dt Z          = {dt_z.min():.6f}\n")
        out.write(f"\t 4. The minimum zeta          = {zeta.min():.6f}\n")
        out.write(f"\t 5. The maximum zeta          = {zeta.max():.6f}\n")
        out.write(f"\t 6. The minimum xi            = {xi.min():.6f}\n")
        out.write(f"\t 7. The maximum xi            = {xi.max():.6f}\n")
        vsvp = vs / vp
        out.write(f"\t 8. The minimum Vs/Vp         = {vsvp.min():.6f}\n")
        out.write(f"\t 9. The maximum Vs/Vp         = {vsvp.max():.6f}\n")
        vpvsz = zeta * vp / vs
        out.write(f"\t10. The minimum (Vp/Vs)*zeta  = {vpvsz.min():.6f}\n")
        out.write(f"\t11. The maximum (Vp/Vs)*zeta  = {vpvsz.max():.6f}\n")
        out.write(f"\t12. The minimum Vs            = {vs.min():.6f}\n")
        out.write(f"\t13. The maximum Vs            = {vs.max():.6f}\n")
    if params.delta_t > crit:
        out.write(f"\nWARNING: delta_t {params.delta_t} exceeds the "
                  f"critical value {crit:.6f} - unstable!\n")
    return crit


def damping_histograms(mesh, params, intervals=40, out=None):
    """40-interval histograms of xi and zeta (damping_statistics)."""
    out = out or sys.stdout
    props = mesh.props
    zeta = np.minimum(10.0 / props["Vs"], params.threshold_damping)
    a_base, b_base = compute_setab(params.freq, params.type_of_damping)
    ratio = mesh.edge_m / props["Vp"]
    omega = 3.46410161514 / ratio
    xi = zeta * a_base / (2 * omega) + zeta * b_base * omega / 2
    for name, v in (("zeta", zeta), ("xi", xi)):
        hist, edges = np.histogram(v, bins=intervals)
        out.write(f"\n# {name} histogram ({intervals} intervals)\n")
        for i in range(intervals):
            if hist[i]:
                out.write(f"  [{edges[i]:.6f}, {edges[i+1]:.6f})  "
                          f"{hist[i]}\n")
    return True


def mesh_stats(mesh, out=None):
    """mesh_print_stat: element/node/dangling counts + level range."""
    out = out or sys.stdout
    lv = mesh.elem_level
    out.write("\n# Mesh statistics\n")
    out.write(f"Total elements:       {mesh.lenum}\n")
    out.write(f"Total nodes:          {mesh.nnum}\n")
    out.write(f"Total dangling nodes: {len(mesh.dn_ids)}\n")
    out.write(f"Maximum leaf level:   {int(lv.max())}\n")
    out.write(f"Minimum leaf level:   {int(lv.min())}\n")
    hist = np.bincount(lv.astype(np.int64))
    for l, c in enumerate(hist):
        if c:
            out.write(f"  level {l:2d}: {c} elements "
                      f"({mesh.edge_m[lv == l][0]:.3f} m)\n")
    return True


def print_k_matrices(out=None):
    """print_K_stdoutput equivalent: dump K1 (merged), K2, K3."""
    out = out or sys.stdout
    from ..physics.kmats import build_k_matrices
    K1, K2, K3 = build_k_matrices()
    for name, K in (("K1", K1), ("K2", K2), ("K3", K3)):
        out.write(f"\n# {name} [8][8][3][3]\n")
        for i in range(8):
            for k in range(3):
                row = []
                for j in range(8):
                    for m in range(3):
                        row.append(f"{K[i, j, k, m]: 8.5f}")
                out.write(" ".join(row) + "\n")
    return True


def schedule_stats(mesh, plan=None, out=None, error_check=False):
    """Exchange-plan report: the TPU analogue of the reference's
    schedule printers (schedule_print/solver_printstat,
    psolve.c:5091-5319).  The dn/an message schedules become the brick
    plan's interface-reconciliation tables; this prints their sizes
    and, with error_check, re-validates the invariants the reference's
    gnid-in-message cross-checks guard (schedule_print_error_check,
    psolve.c:790)."""
    out = out or sys.stdout
    out.write("\n# Exchange-plan statistics\n")
    D = len(mesh.dn_ids)
    ndeps = int((mesh.dn_weights > 0).sum()) if D else 0
    out.write(f"dangling nodes (dn plan):   {D}\n")
    out.write(f"dangling anchor deps:       {ndeps}\n")
    if plan is None:
        return True
    G = len(plan.grp_node)
    K = len(plan.ex_pos)
    out.write(f"bricks:                     {len(plan.bricks)}\n")
    out.write(f"loose elements:             {len(plan.loose_eidx)}\n")
    out.write(f"reconcile groups (an plan): {G}\n")
    out.write(f"interface node copies:      {K}\n")
    if G:
        copies = np.bincount(plan.ex_seg, minlength=G)
        out.write(f"copies per group:           min {copies.min()} "
                  f"max {copies.max()} mean {copies.mean():.2f}\n")
    if error_check:
        # every interface copy maps to a live group, groups are
        # contiguous in the copy list (segment-sum precondition), and
        # each dangling node resolves to a group with valid anchors
        assert (plan.ex_seg[:-1] <= plan.ex_seg[1:]).all(), \
            "interface copies not group-sorted"
        if G:
            assert plan.ex_seg.min() >= 0 and plan.ex_seg.max() < G
            assert (np.bincount(plan.ex_seg, minlength=G) > 0).all(), \
                "empty reconcile group"
            gn = plan.mesh.nnum
            assert plan.grp_node.min() >= 0 and plan.grp_node.max() < gn
        if D:
            assert plan.dn_grp.min() >= 0 and plan.dn_grp.max() < G
            assert (plan.dn_anc_grp >= 0).all() \
                and (plan.dn_anc_grp < G).all()
        out.write("error check: OK\n")
    return True
