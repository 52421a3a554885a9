"""The multi-brick solver on the port's kernels: the graded-mesh route.

Counterpart of ``hercules_tpu/solver/pallas_mesh.py``; the JAX names
are kept (``mesh_plan_applies``, ``_Gather``, ``MeshPallasTables``,
``interface_epilogue_consts``, ``locate_concat``, ``first_concat_copy``,
``init_mesh_state``, ``mesh_u_global``, ``run_mesh_solver``).

Every dense brick of the plan (``solver/bricks.py``) runs the step
kernel of its damping and tier once per step, as the single-brick
routes do (``fused_brick.py``): K1 for Rayleigh, mass or no damping;
for BKT the first tier that holds the brick, by the single-brick rule
(``fused_bktq.bkt_step_module``: uniform K2, node K3 unless the node
tables decline, corner K4), chosen per brick.  Torch code between the
launches does the rest:

- the loose elements (graded-transition slivers too small to brick)
  gather their corners from the loose node section, form their force
  (``brickstep.loose_elastic_force`` / ``loose_bkt_force``) and add it
  by a fixed-order segment sum, then update that section;
- the interface reconciliation.  The kernels never write their element
  forces, but each ends in the same central-difference update, so the
  local force of any node copy is recovered by linearity from its
  kernel's output,

      F = (u+ - u) * mass - mass_minusaM * (u - u-),

  and the copies of a shared or hanging node are reconciled from
  (u, u-, u+) alone: by ``planerec.PlaneReconciler`` (dense planes,
  when every interface is a full z-plane of both bricks) or by the
  index epilogue (gathers, fixed-order segment sums, the dangling
  distribute/assign algebra of compute_adjust, psolve.c:5936-6039,
  and scatters);
- the sources: a source on a shared node is added once, in the
  reconciliation; one on a single-copy node is added after it
  (``src_direct``);
- the stations, sampled from the first copy of each node before the
  step;
- nonlinear soil and DRM part 2 (``attach_nonlinear_mesh``,
  ``attach_drm_mesh``, as the JAX package's packed mesh step places
  them): K1 runs every brick with the nonlinear elements' c1, c2 and
  beta zeroed in its K table, and a subset pass in torch ops, after the
  launches and the loose section and before the reconciliation, updates
  the plastic state and adds the nonlinear elements' stress-integral
  and damping forces, the geostatic gravity rows and bottom reactions
  and the lerped DRM effective forces into the next-step arrays as F *
  inv_mass; the reconciler recovers them by linearity like any kernel
  force.  After the direct sources, the geostatic bottom pin.  The
  cases the route does not take go to the unstructured solver by the
  JAX package's rules (``nl_mesh_refusal``, ``drm_mesh_refusal``: each
  returns its reason).

State layout (one layout, where the JAX package keeps two): every brick
and the loose node section hold S [8, LEN] = (u, u-, 0, 0), the columns
the brick's flat node grid (``Brick.axes`` order) then zero padding to
``fused_brick.pallas_geometry(nb)``; BKT bricks add their tier's memory
variables (node tier: conv and the mixed elements' conv_mix, K3 forms
their force inside, so the JAX mesh step's ``bkt_mix_epilogue`` has no
counterpart), and the loose elements theirs, (s0, s1, k0, k1) [El, 8,
3].  The mesh state is (Ss, convs, lconv): Ss the NB + 1 S tensors
(bricks, then the loose section), convs the NB tuples of memory
variables (empty for elastic bricks), lconv the loose elements' tuple
(empty without BKT or loose elements); with nonlinear soil a fourth
entry, the plastic state (stresses [Enl, 8, 6], plastic strains [Enl,
8, 6], ep [Enl, 8][, bottom reactions [Eb, 4] with geostatic loading]),
the JAX mesh carry's tail.

Not ported: the TPU's layout switches (``HT_MESH_PACKED``,
``HT_MESH_ABLATE``, ``HT_BKT_UNIFORM``, ``HT_PALLAS_TILE``, the elastic
``_tier_kco`` tiers).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..nonlinear import (nl_device_tables, nl_force, nl_state_shapes,
                         nl_state_update, smooth_rise_factor)
from ..utils.timers import GLOBAL_TIMERS, measure
from .brickstep import SegmentSum, loose_bkt_force, loose_elastic_force
from .chunking import run_chunked
from .fused_brick import (BrickStep, pack_constants, pallas_geometry,
                          solver_device)
from .fused_bktq import bkt_step_module
from .planerec import PlaneReconciler
from .step import drm_lerp
from .restart import Checkpoint, fit_conv

RECONCILERS = ("plane", "index")


def mesh_plan_applies(plan, damping) -> bool:
    """True if the multi-brick route covers this plan: any number of
    bricks.  (The JAX package also caps the bricks,
    ``HT_PALLAS_MAX_BRICKS``, and requires every brick's stencil reach
    to fit its on-chip tile, ``pallas_fits``: limits of the TPU's
    kernels that the CUDA kernels do not share.)"""
    return damping in ("rayleigh", "mass", "none", "bkt")


@dataclass
class BrickColumns:
    """A brick's slice [b.off, b.off + b.nb) of the plan's per-column
    arrays (numpy views): what the single-brick table functions
    (``fused_brick.pack_constants``, ``fused_bktq.bkt_step_module``)
    read of a plan."""
    gnid_cat: np.ndarray
    evalid_cat: np.ndarray
    eidx_cat: np.ndarray


def brick_columns(plan, b) -> BrickColumns:
    cut = slice(b.off, b.off + b.nb)
    return BrickColumns(plan.gnid_cat[cut], plan.evalid_cat[cut],
                        plan.eidx_cat[cut])


def brick_step_module(plan, b, tables, dtype, device, tier=None,
                      masked=None):
    """(step module, LEN) of brick ``b`` of the plan: BrickStep for
    Rayleigh, mass or no damping (``masked``: its columns whose element
    K1 leaves out, fused_brick.pack_constants); for BKT the module of
    the first tier that holds the brick (fused_bktq.bkt_step_module), or
    of ``tier`` where given."""
    brick = plan.bricks[b]
    cols = brick_columns(plan, brick)
    offs = tuple(brick.corner_offsets())
    LEN = pallas_geometry(brick.nb)
    if tables.damping == "bkt":
        if masked is not None:
            raise ValueError("a column mask on a BKT brick")
        return bkt_step_module(cols, tables, LEN, offs, dtype, device,
                               tier=tier)[0], LEN
    if tier is not None:
        raise ValueError(f"tier={tier!r} on a {tables.damping} brick")
    K = torch.as_tensor(pack_constants(cols, tables, LEN, masked=masked),
                        dtype=dtype, device=device)
    return BrickStep(K, offs), LEN


class _Gather:
    """Precomputed extraction of K entries spread over the per-brick
    (+ loose) arrays: entry k reads column locals[k] of array arrs[k].

    When the entries are ordered by (array, local) -- the interface
    ordering of ``interface_epilogue_consts`` -- each array's locals are
    sorted, and on depth-graded meshes (brick interfaces = z-planes of
    the brick grids) they collapse into a handful of contiguous runs,
    read and written as slices; otherwise index gathers."""

    MAX_RUNS = 64

    def __init__(self, arrs, locals_, n_arrays, K, device):
        self.K = K
        self.plan = []      # index mode: (arr, src, dst)
        self.runs = None    # slice mode: list of (arr, lo, size, dst0)
        order_ok = True
        runs = []
        pos = 0
        for a in range(n_arrays):
            m = arrs == a
            if not m.any():
                continue
            idx = np.flatnonzero(m)
            loc = locals_[idx]
            if not ((idx == np.arange(pos, pos + len(idx))).all()
                    and (np.diff(loc) > 0).all()):
                order_ok = False
            brk = np.flatnonzero(np.diff(loc) != 1)
            starts = np.concatenate([[0], brk + 1])
            ends = np.concatenate([brk + 1, [len(loc)]])
            for s, e in zip(starts, ends):
                runs.append((a, int(loc[s]), int(e - s), int(pos + s)))
            pos += len(idx)
            self.plan.append((a, torch.as_tensor(loc, device=device),
                              torch.as_tensor(idx, device=device)))
        if order_ok and len(runs) <= self.MAX_RUNS:
            self.runs = runs

    def __call__(self, arrays, row=0):
        """[K, 3]: rows row:row+3 of the arrays at the entries."""
        if self.runs is not None:
            return torch.cat([arrays[a][row:row + 3, lo:lo + n].T
                              for a, lo, n, _ in self.runs])
        out = arrays[0].new_empty((self.K, 3))
        for a, src, dst in self.plan:
            out[dst] = arrays[a][row:row + 3, src].T
        return out

    def scatter_set(self, arrays, vals):
        """Write vals [K, 3] into rows 0:3 of the arrays in place."""
        if self.runs is not None:
            for a, lo, n, d0 in self.runs:
                arrays[a][0:3, lo:lo + n] = vals[d0:d0 + n].T
            return arrays
        for a, src, dst in self.plan:
            arrays[a][0:3, src] = vals[dst].T
        return arrays


def locate_concat(plan, pos):
    """concat position -> (array index, local column): bricks are
    0..NB-1, the loose node section is NB.  The concat-layout
    convention -- sources and stations resolve through here."""
    NB = len(plan.bricks)
    off_loose = (plan.bricks[-1].off + plan.bricks[-1].nb
                 if NB else 0)
    pos = np.asarray(pos, np.int64)
    arr = np.full(len(pos), NB, np.int64)
    loc = pos - off_loose
    for a, b in enumerate(plan.bricks):
        m = (pos >= b.off) & (pos < b.off + b.nb)
        arr[m] = a
        loc[m] = pos[m] - b.off
    return arr, loc


def first_concat_copy(plan, node_ids, what="node"):
    """Concat position of the FIRST copy of each global node id
    (interface nodes have several copies; per-node force injections
    count once when added to exactly one)."""
    g = plan.gnid_cat
    uniq, first = np.unique(g, return_index=True)
    ids = np.asarray(node_ids).ravel()
    pos = first[np.searchsorted(uniq, np.clip(ids, uniq[0],
                                              uniq[-1]))]
    if not (g[pos] == ids).all():
        raise RuntimeError(f"{what} missing from plan")
    return pos


def plane_refusal(plan):
    """Why the nonlinear and DRM subset passes cannot ride this plan's
    reconciliation, or None: they need the plane reconciler wherever
    the plan has shared copies (the JAX package's packed mode,
    pallas_mesh.py:180-181, 252-255)."""
    if len(plan.ex_pos) and PlaneReconciler.analyse(plan) is None:
        return ("the plan's shared copies are not full z-plane interfaces "
                "(the plane reconciler does not hold them)")
    return None


def _nl_columns(plan, tables, nl_tables):
    """Concat element column of each nonlinear element (-1 where the
    plan has none)."""
    valid = np.flatnonzero(plan.evalid_cat)
    col_of = -np.ones(tables.E, np.int64)
    col_of[plan.eidx_cat[valid]] = valid
    return col_of, col_of[nl_tables.eidx]


def nl_mesh_refusal(plan, tables, nl_tables):
    """Why the mesh route does not take nonlinear soil on this plan (the
    JAX package's rules, attach_nonlinear_mesh and MeshPallasTables), or
    None: the unstructured solver then runs the case."""
    if tables.damping == "bkt":
        return "nonlinear soil with BKT damping"
    if nl_tables.cfg.geostatic_loading_t > 0 and len(plan.loose_eidx):
        return "geostatic loading with loose elements"
    if np.isin(nl_tables.eidx, plan.loose_eidx).any():
        return "a nonlinear element in the loose section"
    if (_nl_columns(plan, tables, nl_tables)[1] < 0).any():
        return "a nonlinear element missing from the plan"
    return plane_refusal(plan)


def drm_mesh_refusal(plan, drm):
    """Why the mesh route does not take DRM part 2 (the bundle of
    drm.attach_drm) on this plan, or None."""
    if not np.isin(np.asarray(drm["ids"]), plan.gnid_cat).all():
        return "a DRM node missing from the plan"
    return plane_refusal(plan)


def nl_subset_plans(pos, brick_of, gnids, inv_mass, dtype, device,
                    corner0=0):
    """(gather, scatter) per-array plans of a subset pass over the flat
    (element, corner) entries of elements whose corners sit at columns
    pos [n, 8] of arrays brick_of [n] (array a's columns hold the global
    nodes gnids[a]): gather (array, columns, entries); scatter (array,
    entries or None for all of them in order, their fixed-order sum by
    column, inv_mass [columns, 1]) over corners [corner0:8]."""
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    nc = 8 - corner0
    flat_pos = pos[:, corner0:].ravel()
    flat_brick = np.repeat(brick_of, nc)
    gth, sct = [], []
    for bi, gn in enumerate(gnids):
        m = flat_brick == bi
        if not m.any():
            continue
        loc = flat_pos[m]
        dst = np.flatnonzero(m)
        every = m.all()
        gth.append((bi, i64(loc), None if every else i64(dst)))
        invm = inv_mass[gn[np.unique(loc)]]
        sct.append((bi, None if every else i64(dst),
                    SegmentSum(loc, device), f(invm)[:, None]))
    return gth, sct


def attach_nonlinear_mesh(mesh, params, tables, nl_tables, plan,
                          dtype=torch.float32, device="cuda"):
    """Nonlinear bundle for the mesh route (pallas_mesh.py:518-662), on
    ``device`` (the CUDA device unless the caller asks for the CPU).

    K1 leaves the nonlinear elements out (their c1, c2 and beta zeroed
    in MeshPallasTables: stiffness.c:46-105's linear-element map
    excludes them); a subset pass per step updates their plastic state
    (compute_nonlinear_state, nonlinear.c:1671) from their corners'
    (u, u-), gathered brick by brick, and adds their stress-integral
    force (compute_addforce_nl, nonlinear.c:1544) plus their Rayleigh
    damping force into the next-step arrays before the reconciliation,
    as F * inv_mass (inv_mass folded per target column).  Geostatic
    loading: a constant gravity row per brick (rise-scaled each step),
    the bottom elements' reaction capture and replay, and the bottom
    pin at every copy of the bottom nodes.  Raises ValueError where
    nl_mesh_refusal gives a reason."""
    reason = nl_mesh_refusal(plan, tables, nl_tables)
    if reason is not None:
        raise ValueError(f"the mesh route does not take this case: "
                         f"{reason}")
    device = solver_device(device)
    t = nl_tables
    geostatic = t.cfg.geostatic_loading_t > 0
    g = plan.gnid_cat
    col_of, cols = _nl_columns(plan, tables, t)
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)

    def corner_positions(eidx, ecols):
        """Within-brick node positions of each element's 8 corners (in
        elem_lnid's corner order, verified) and its brick."""
        pos = np.zeros((len(eidx), 8), np.int64)
        brick_of = np.zeros(len(eidx), np.int64)
        for bi, b in enumerate(plan.bricks):
            m = (ecols >= b.off) & (ecols < b.off + b.nb)
            if not m.any():
                continue
            brick_of[m] = bi
            offs = np.asarray(b.corner_offsets())
            pos[m] = (ecols[m] - b.off)[:, None] + offs[None, :]
            if not (g[b.off + pos[m]] == mesh.elem_lnid[eidx[m]]).all():
                raise RuntimeError(f"brick {bi}: corner order does not "
                                   f"match elem_lnid")
        return pos, brick_of

    gnids = [g[b.off:b.off + b.nb] for b in plan.bricks]

    def subset_plans(pos, brick_of, corner0=0):
        return nl_subset_plans(pos, brick_of, gnids, tables.inv_mass,
                               dtype, device, corner0)

    pos, brick_of = corner_positions(t.eidx, cols)
    gth, sct = subset_plans(pos, brick_of)
    bundle = {
        "d": nl_device_tables(t, dtype, device), "n": t.n,
        "dt": params.delta_t, "dt2": params.delta_t ** 2,
        "cols": cols,
        "c3": f(tables.c3[t.eidx]), "c4": f(tables.c4[t.eidx]),
        "mcat": f(tables.m48.T),
        "gather": gth, "scatter": sct,
        "geostatic": geostatic, "parts": nl_state_shapes(t),
    }
    if geostatic:
        dt2 = params.delta_t ** 2
        final = t.cfg.geostatic_final_step(params.delta_t)
        ngeo = int(t.cfg.geostatic_loading_t / params.delta_t)
        bundle["final_step"] = final
        bundle["rise"] = f(smooth_rise_factor(np.arange(final + 2), ngeo))
        # gravity: a constant per-node z-force row per brick, inv_mass
        # folded, zero on the padding (the reference re-scatters E * 8
        # corner weights every step, compute_addforce_gravity
        # nonlinear.c:1365)
        all_cols = col_of[np.arange(tables.E)]
        apos, abrick = corner_positions(np.arange(tables.E), all_cols)
        gw = np.repeat(t.grav_W * dt2, 8)
        rows = []
        for bi, b in enumerate(plan.bricks):
            row = np.zeros(pallas_geometry(b.nb))
            m = abrick == bi
            np.add.at(row, apos[m].ravel(), gw[np.repeat(m, 8)])
            row[:b.nb] *= tables.inv_mass[g[b.off:b.off + b.nb]]
            rows.append(f(row))
        bundle["grav_nb"] = rows
        # bottom elements: reaction capture at the geostatic final step
        # and replay after it (nonlinear.c:1436-1504)
        be = t.bot_eidx
        bundle["bot"] = None
        if len(be):
            bpos, bbrick = corner_positions(be, col_of[be])
            bundle["bot"] = {
                "n": len(be),
                "gather": subset_plans(bpos, bbrick)[0],
                "scatter": subset_plans(bpos, bbrick, corner0=4)[1],
                "bc1": f(tables.c1[be]), "bc2": f(tables.c2[be]),
                "botW": f(t.grav_W[be] * dt2),
            }
        # bottom-node displacement pin during loading, at every concat
        # copy of the bottom nodes (geostatic_displacements_fix)
        botn = (np.unique(mesh.elem_lnid[be][:, 4:]) if len(be)
                else np.zeros(0, np.int64))
        arr, loc = locate_concat(plan, np.flatnonzero(np.isin(g, botn)))
        bundle["pin"] = [(int(a), i64(loc[arr == a]))
                         for a in np.unique(arr)]
    return bundle


def attach_drm_mesh(drm, plan, tables, dtype=torch.float32, device="cuda"):
    """Mesh-route DRM part-2 bundle (pallas_mesh.py:665-692; the
    effective forces of solver_compute_effective_drm_force,
    drm.c:2316-2437), on ``device`` (the CUDA device unless the caller
    asks for the CPU): each DRM node's first concat copy, where the
    lerped force is added as F * inv_mass before the reconciliation
    (interface copies reconcile after, so each node's force counts
    once).  Raises ValueError where drm_mesh_refusal gives a reason."""
    reason = drm_mesh_refusal(plan, drm)
    if reason is not None:
        raise ValueError(f"the mesh route does not take this case: "
                         f"{reason}")
    device = solver_device(device)
    ids = np.asarray(drm["ids"])
    arr, loc = locate_concat(plan, first_concat_copy(plan, ids,
                                                     what="DRM node"))
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    out = {"Fdev": torch.as_tensor(drm["F"], dtype=dtype, device=device),
           "aux": int(drm["aux"]), "adds": []}
    rows = np.arange(len(ids))
    for a in range(len(plan.bricks) + 1):
        m = arr == a
        if m.any():
            out["adds"].append((a, i64(loc[m]), i64(rows[m]),
                                f(tables.inv_mass[ids[m]])[:, None]))
    return out


def interface_epilogue_consts(plan, tables, src_ids, dtype, device):
    """Device constants of the index-based interface reconciliation
    (compute_adjust semantics, psolve.c:5936-6039): per-copy gather
    coordinates, group segments and their fixed-order sums (grp_sum,
    anc_sum: brickstep.SegmentSum), per-entry node masses, the dangling
    distribute/assign tables, and the group/direct source split."""
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                  device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64),
                                    device=device)
    g = plan.gnid_cat
    NB = len(plan.bricks)
    out = {"K": len(plan.ex_pos), "G": len(plan.grp_node),
           "D": len(plan.dn_grp), "src_grp_idx": None,
           "src_grp_rows": None, "src_direct": []}
    K, G, D = out["K"], out["G"], out["D"]
    ex_seg = None
    if K:
        # order interface entries by concat position = (array, local):
        # per-array locals become sorted and (on depth-graded meshes)
        # contiguous, so _Gather runs in slice mode; ex_seg is then
        # not sorted (the segment sum permutes)
        order = np.argsort(plan.ex_pos, kind="stable")
        ex_pos = plan.ex_pos[order]
        ex_seg = plan.ex_seg[order]
        ex_arr, ex_loc = locate_concat(plan, ex_pos.astype(np.int64))
        out["ex_arr"], out["ex_loc"] = ex_arr, ex_loc
        out["ex_pos"] = ex_pos
        out["ex_seg"] = i64(ex_seg)
        out["grp_sum"] = SegmentSum(ex_seg, device)
        first = np.full(G, K, np.int64)
        np.minimum.at(first, ex_seg, np.arange(K))
        out["grp_first"] = i64(first)
        gn = g[ex_pos]
        out["mass_ex"] = f(1.0 / tables.inv_mass[gn])[:, None]
        out["invm_ex"] = f(tables.inv_mass[gn])[:, None]
        out["mm_ex"] = f(tables.mass_minusaM[gn])
    if D:
        out["dn_grp"] = i64(plan.dn_grp)
        out["dn_anc_grp"] = i64(plan.dn_anc_grp)
        out["anc_sum"] = SegmentSum(plan.dn_anc_grp, device)
        out["dn_wgt"] = f(plan.dn_wgt)
        isdn = np.zeros(G, bool)
        isdn[plan.dn_grp] = True
        grp2dn = np.zeros(G, np.int64)
        grp2dn[plan.dn_grp] = np.arange(D)
        m = isdn[ex_seg]
        out["dnc_k"] = i64(np.flatnonzero(m))
        out["dnc_src"] = i64(grp2dn[ex_seg[m]])
    if src_ids is not None and len(src_ids):
        pos = first_concat_copy(plan, src_ids, what="source node")
        node2grp = -np.ones(plan.mesh.nnum, np.int64)
        node2grp[plan.grp_node] = np.arange(G)
        gi = node2grp[src_ids]
        ing = gi >= 0
        if ing.any():
            out["src_grp_idx"] = i64(gi[ing])
            out["src_grp_rows"] = i64(np.flatnonzero(ing))
        dm = ~ing
        if dm.any():
            arr, loc = locate_concat(plan, pos[dm])
            rows = np.flatnonzero(dm)
            for a in range(NB + 1):
                sel = arr == a
                if sel.any():
                    iv = tables.inv_mass[g[pos[dm][sel]]]
                    out["src_direct"].append(
                        (a, i64(loc[sel]), i64(rows[sel]),
                         f(iv)[:, None]))
    return out


def interface_algebra(ep, u_ex, up_ex, un_ex, srcf):
    """The index epilogue's algebra (compute_adjust, psolve.c:5936-6039)
    on the interface entries' (u, u-, u+) [K, 3], ``ep`` the tables of
    interface_epilogue_consts: each copy's local force recovered by
    linearity, the group sums and the group-level sources, the dangling
    nodes' forces distributed to their anchors, the update, and the
    dangling nodes assigned from their anchors.  Returns u+ [K, 3] of
    every entry."""
    du_ex = u_ex - up_ex
    F_ex = (un_ex - u_ex) * ep["mass_ex"] - ep["mm_ex"] * du_ex
    tot = ep["grp_sum"](F_ex)                              # [G, 3]
    if ep["src_grp_idx"] is not None:
        tot.index_add_(0, ep["src_grp_idx"], srcf[ep["src_grp_rows"]])
    if ep["D"]:
        contrib = (tot[ep["dn_grp"]][:, None, :]
                   * ep["dn_wgt"][:, :, None])             # [D, 4, 3]
        tot = tot.index_add(0, ep["anc_sum"].ids,
                            ep["anc_sum"](contrib.reshape(-1, 3)))
    un_ex = u_ex + (tot[ep["ex_seg"]] + ep["mm_ex"] * du_ex) * ep["invm_ex"]
    if ep["D"]:
        u_rep = un_ex[ep["grp_first"]]
        dnv = (u_rep[ep["dn_anc_grp"]] * ep["dn_wgt"][:, :, None]).sum(dim=1)
        un_ex[ep["dnc_k"]] = dnv[ep["dnc_src"]]
    return un_ex


class MeshPallasTables:
    """Tables, per-brick step modules, the loose section, the
    reconciler, sources and stations of a multi-brick plan, on
    ``device`` (the CUDA device unless the caller asks for the CPU) in
    ``dtype``.

    ``steps[b]`` is brick b's step module (fused_brick.BrickStep, or
    for BKT the module of its tier) and ``tiers[b]`` its tier
    ("elastic", "uniform", "node" or "corner").  ``reconciler``:
    "plane" (PlaneReconciler; raises if it does not hold the plan),
    "index" (the index epilogue), or None for the plane reconciler
    whenever it holds the plan, else the index epilogue.
    ``self.reconciler`` names the one taken (None when the plan has no
    shared copies).  ``nl``, ``drm``: the attach_nonlinear_mesh and
    attach_drm_mesh bundles, on the same device; they need the plane
    reconciler where the plan has shared copies (plane_refusal), and
    reconciler="index" with either raises."""

    def __init__(self, plan, tables, src_ids=None, st_nodes=None,
                 st_phi=None, dtype=torch.float32, device="cuda",
                 reconciler=None, nl=None, drm=None):
        if not mesh_plan_applies(plan, tables.damping):
            raise ValueError(f"damping={tables.damping}: no mesh route")
        if reconciler not in (None, *RECONCILERS):
            raise ValueError(f"reconciler must be one of {RECONCILERS} or "
                             f"None, got {reconciler!r}")
        if (nl is not None or drm is not None) and reconciler == "index":
            raise ValueError("the nonlinear and DRM subset passes ride the "
                             "plane reconciler; reconciler='index' does "
                             "not take them")
        self.dtype, self.device = dtype, solver_device(device)
        dev = self.device
        self.plan = plan
        self.damping = tables.damping
        self.nl, self.drm = nl, drm
        bkt = self.damping == "bkt"
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                      device=dev)
        NB = self.NB = len(plan.bricks)
        TOT = plan.total_nb
        self.off_loose = (plan.bricks[-1].off + plan.bricks[-1].nb
                          if NB else 0)
        self.NL = TOT - self.off_loose
        g = plan.gnid_cat

        # ---- per-brick step modules ------------------------------------
        self.steps, self.LENs = [], []
        for b in range(NB):
            masked = None
            if nl is not None:
                # the linear-element map: K1 leaves the nonlinear
                # elements out, the subset pass adds their force
                brick = plan.bricks[b]
                masked = np.zeros(brick.nb, bool)
                c = nl["cols"]
                masked[c[(c >= brick.off) & (c < brick.off + brick.nb)]
                       - brick.off] = True
            mod, LEN = brick_step_module(plan, b, tables, dtype, dev,
                                         masked=masked)
            self.steps.append(mod)
            self.LENs.append(LEN)
        self.tiers = [getattr(m, "tier", "elastic") for m in self.steps]

        # ---- loose section ---------------------------------------------
        lsl = slice(self.off_loose, TOT)
        self.mm_l = f(tables.mass_minusaM[g[lsl]].T)        # [3, NL]
        self.invm_l = f(tables.inv_mass[g[lsl]])[None, :]   # [1, NL]
        le = plan.loose_eidx
        self.El = El = len(le)
        if El:
            rows = plan.loose_rows - self.off_loose
            self.l_rows = torch.as_tensor(rows.astype(np.int64), device=dev)
            lseg = rows.ravel()
            lperm = np.argsort(lseg, kind="stable")
            self.l_perm = torch.as_tensor(lperm, device=dev)
            self.l_sum = SegmentSum(lseg[lperm], dev)
            if bkt:
                self.l_bkt = {k: f(v[le]) for k, v in tables.bkt.items()}
                self.kmu_cat = f(tables.kmu.T)
                self.kkappa_cat = f(tables.kkappa.T)
            else:
                self.l_c = [f(getattr(tables, f"c{k}")[le])
                            for k in range(1, 5)]
                self.mcat = f(tables.m48.T)

        # ---- reconciliation ------------------------------------------
        ep = interface_epilogue_consts(plan, tables, src_ids, dtype, dev)
        self.K, self.G, self.D = ep["K"], ep["G"], ep["D"]
        self.plane_rec = None
        self.reconciler = None
        if self.K:
            if reconciler != "index":
                self.plane_rec = PlaneReconciler.build(
                    plan, tables, src_ids=src_ids, dtype=dtype, device=dev)
                if self.plane_rec is None and reconciler == "plane":
                    raise ValueError("reconciler='plane': the plan's "
                                     "interfaces are not full z-planes")
            self.reconciler = "index" if self.plane_rec is None else "plane"
            if (nl is not None or drm is not None) \
                    and self.reconciler != "plane":
                raise ValueError("the nonlinear and DRM subset passes need "
                                 "the plane reconciler: " + str(
                                     plane_refusal(plan)))
        if self.reconciler == "index":
            self.ex_gather = _Gather(ep["ex_arr"], ep["ex_loc"], NB + 1,
                                     self.K, dev)
            self.ep = ep
        # a shared node's source is added once, by the reconciler
        self.src_direct = ep["src_direct"]
        self.has_src = src_ids is not None and len(src_ids) > 0

        # ---- stations --------------------------------------------------
        self.st = None
        if st_nodes is not None and len(np.asarray(st_nodes)):
            st_nodes = np.asarray(st_nodes)
            pos = first_concat_copy(plan, st_nodes, what="station node")
            arr, loc = locate_concat(plan, pos)
            self.st = (_Gather(arr, loc, NB + 1, st_nodes.size, dev),
                       st_nodes.shape, f(st_phi))

    def state_parts(self, b):
        """(shape, dtype) of brick b's memory variables after S."""
        step = self.steps[b]
        return [] if self.tiers[b] == "elastic" else \
            step.state_parts(self.LENs[b])

    def launches_per_step(self):
        """{kernel wrapper name: bricks on it}: the launches one step
        makes."""
        name = {"elastic": "brick_step", "uniform": "bkt_step",
                "node": "bkt_node_step", "corner": "bkt_corner_step"}
        out = {}
        for t in self.tiers:
            out[name[t]] = out.get(name[t], 0) + 1
        return out


def init_mesh_state(mt: MeshPallasTables):
    """Zero mesh state (Ss, convs, lconv[, nl_state])."""
    z = lambda shape, dt=mt.dtype: torch.zeros(shape, dtype=dt,
                                               device=mt.device)
    Ss = tuple(z((8, L)) for L in mt.LENs) + (z((8, mt.NL)),)
    convs = tuple(tuple(z(shape, dt) for shape, dt in mt.state_parts(b))
                  for b in range(mt.NB))
    lconv = (tuple(z((mt.El, 8, 3)) for _ in range(4))
             if mt.damping == "bkt" and mt.El else ())
    if mt.nl is None:
        return (Ss, convs, lconv)
    return (Ss, convs, lconv, tuple(z(s) for s in mt.nl["parts"]))


def fit_mesh_state(mt: MeshPallasTables, state):
    """A copy of ``state`` = (Ss, convs, lconv[, nl_state]) in the
    solver's layout, type and device; empty convs, lconv or nl_state
    (or a state without the last) start at zero (as
    ``mesh_state_from_jax`` gives them)."""
    want = init_mesh_state(mt)
    state = tuple(state) + ((),) * (len(want) - len(state))

    def fit(got, zero):
        if isinstance(zero, tuple):
            if not len(got):
                return zero
            if len(got) != len(zero):
                raise ValueError(f"state has {len(got)} parts where the "
                                 f"solver has {len(zero)}")
            return tuple(fit(g_, z_) for g_, z_ in zip(got, zero))
        t = torch.as_tensor(got).to(dtype=zero.dtype, device=zero.device)
        if t.shape != zero.shape:
            raise ValueError(f"state part must be {list(zero.shape)}, got "
                             f"{list(t.shape)}")
        return t.clone()

    if len(state[0]) != len(want[0]):
        raise ValueError(f"{len(state[0])} S arrays, the plan has "
                         f"{len(want[0])} (bricks + the loose section)")
    return fit(tuple(state), want)


def mesh_conv_flat(state):
    """The memory variables of a mesh state (Ss, convs, lconv[,
    nl_state]) in the order of the JAX package's mesh checkpoints: each
    BKT brick's conv in brick order, the loose elements' four arrays,
    then the conv_mix of each node-tier brick with mixed elements, in
    brick order; then the plastic state's arrays (the JAX mesh carry's
    tail, pallas_mesh.py:1117-1125)."""
    _, convs, lconv = state[:3]
    nl = tuple(state[3]) if len(state) > 3 else ()
    return (tuple(c[0] for c in convs if c) + tuple(lconv)
            + tuple(c[1] for c in convs if len(c) > 1) + nl)


def _fit_mesh_conv(mt: MeshPallasTables, conv_flat):
    """(convs, lconv[, nl_state]), float64 numpy, of a checkpoint's flat
    memory variables (mesh_conv_flat's order).  Each brick's array, in
    the node or the corner basis, is fitted to its own tier
    (restart.fit_conv: the other basis converted); the conv_mix arrays
    are optional, as in the JAX package's mesh checkpoints of the corner
    basis.  With nonlinear soil the arrays are the plastic state, in
    the shapes of nonlinear.nl_state_shapes (pallas_mesh.py:1198-1215)."""
    arrays = list(conv_flat)
    if mt.nl is not None:
        want = mt.nl["parts"]
        got = [tuple(np.shape(a)) for a in arrays]
        if got != want:
            raise RuntimeError(f"checkpoint nonlinear state {got} does not "
                               f"match this mesh's layout {want}")
        return (), (), tuple(np.asarray(a, np.float64) for a in arrays)
    NB = mt.NB
    n_loose = 4 if mt.El and mt.damping == "bkt" else 0
    mix_bricks = [b for b in range(NB)
                  if mt.tiers[b] == "node" and mt.steps[b].mix_M]
    base = (NB if mt.damping == "bkt" else 0) + n_loose
    if len(arrays) == base:
        mixes = {}
    elif len(arrays) == base + len(mix_bricks):
        mixes = dict(zip(mix_bricks, arrays[base:]))
    else:
        raise RuntimeError(
            f"checkpoint BKT state has {len(arrays)} arrays; the "
            f"multi-brick layout wants {NB if base else 0} brick + "
            f"{n_loose} loose (+ {len(mix_bricks)} mixed-element "
            f"carries); restart with the solver path that wrote it")
    if mt.damping != "bkt":
        return (), ()
    convs = tuple(
        fit_conv(mt.steps[b], mt.LENs[b],
                 (arrays[b],) + ((mixes[b],) if b in mixes else ()))
        for b in range(NB))
    lconv = ()
    if n_loose:
        want = (mt.El, 8, 3)
        lconv = tuple(np.asarray(a, np.float64)
                      for a in arrays[NB:NB + 4])
        if any(a.shape != want for a in lconv):
            raise RuntimeError(f"checkpoint loose-element BKT state "
                               f"{[a.shape for a in lconv]} does not "
                               f"match {want}")
    return convs, lconv


def mesh_spans(plan):
    """(first position in plan.gnid_cat, nodes, LEN) of every brick's
    array, then of the loose section's."""
    spans = [(b.off, b.nb, pallas_geometry(b.nb)) for b in plan.bricks]
    off_loose = (plan.bricks[-1].off + plan.bricks[-1].nb
                 if plan.bricks else 0)
    NL = plan.total_nb - off_loose
    return spans + [(off_loose, NL, NL)]


def mesh_states_of_fields(plan, u, up):
    """S [8, LEN] (numpy, in the fields' type) of every brick and of the
    loose section from two canonical global [N, 3] fields u and u-;
    RuntimeError for fields of another layout."""
    u, up = np.asarray(u), np.asarray(up)
    if any(x.ndim != 2 or x.shape[1] != 3 for x in (u, up)):
        raise RuntimeError("checkpoint layout does not match the "
                           "multi-brick solver")
    Ss = []
    for off, n, L in mesh_spans(plan):
        S = np.zeros((8, L), u.dtype)
        for r, x in zip((0, 3), (u, up)):
            S[r:r + 3, :n] = x[plan.gnid_cat[off:off + n]].T
        Ss.append(S)
    return tuple(Ss)


def restore_mesh_state(mt: MeshPallasTables, ck: Checkpoint):
    """The mesh state (Ss, convs, lconv[, nl_state]) of a checkpoint
    (restart.Checkpoint): canonical global [N, 3] fields split into
    every brick's and the loose section's S (mesh_states_of_fields),
    the memory variables or the plastic state by _fit_mesh_conv, in the
    solver's types and device."""
    Ss = mesh_states_of_fields(mt.plan, ck.u_now, ck.u_prev)
    return fit_mesh_state(mt, (Ss, *_fit_mesh_conv(mt, ck.conv)))


def _gather_corners(Ss, plan, n, row):
    """[n * 8, 3]: rows row:row+3 of the arrays at the subset's
    (element, corner) entries, by its per-brick gather plan."""
    if len(plan) == 1 and plan[0][2] is None:
        bi, loc, _ = plan[0]
        return Ss[bi][row:row + 3, loc].T
    out = Ss[0].new_empty((n * 8, 3))
    for bi, loc, dst in plan:
        out[dst] = Ss[bi][row:row + 3, loc].T
    return out


def _scatter_corners(Sns, plan, F, rows):
    """Add the subset's (element, corner) forces F [entries, len(rows)]
    into rows ``rows`` of the next-step arrays, summed per column in a
    fixed order and times inv_mass (the per-brick scatter plan)."""
    for bi, dst, s, invm in plan:
        sums = s(F if dst is None else F[dst]) * invm
        Sns[bi][rows].index_add_(1, s.ids, sums.T)


def _nl_subset_pass(mt, Ss, Sns, ue, nlstate, step_idx):
    """The nonlinear subset forces, added into the next-step arrays
    before the reconciliation (pallas_mesh.py:786-836); returns the
    new plastic state.  ue [Enl, 24]: the corners' u before the step,
    nlstate: the plastic state after this step's update; u- is read
    from Ss."""
    nl = mt.nl
    n = nl["n"]
    upe = _gather_corners(Ss, nl["gather"], n, 3).reshape(n, 24)
    fnl = nl_force(nl["d"], nlstate[:3], nl["dt2"])     # [Enl, 24]
    # their Rayleigh damping force -[c3 du, c4 du] @ [M1; M2], the
    # operand written in place of a concatenation
    du = ue - upe
    ab = du.new_empty((n, 48))
    torch.mul(nl["c3"][:, None], du, out=ab[:, :24])
    torch.mul(nl["c4"][:, None], du, out=ab[:, 24:])
    f_lin = -(ab @ nl["mcat"].T)
    _scatter_corners(Sns, nl["scatter"], (fnl + f_lin).reshape(-1, 3),
                     slice(0, 3))
    if not nl["geostatic"]:
        return nlstate
    # gravity as one rise-scaled constant row per brick
    # (compute_addforce_gravity, nonlinear.c:1365)
    rise = nl["rise"][min(step_idx, nl["rise"].shape[0] - 1)]
    for b in range(mt.NB):
        Sns[b][2].add_(rise * nl["grav_nb"][b])
    bt = nl["bot"]
    if bt is None:
        return nlstate
    # bottom reactions captured at the final geostatic step, replayed
    # after it (nonlinear.c:1436); the JAX package's jnp.where on the
    # step index, a branch on the host here
    reactions = nlstate[3]
    if step_idx == nl["final_step"]:
        Eb = bt["n"]
        ub = _gather_corners(Ss, bt["gather"], Eb, 0).reshape(Eb, 24)
        kf = (torch.cat([bt["bc1"][:, None] * ub, bt["bc2"][:, None] * ub],
                        1) @ nl["mcat"].T).reshape(Eb, 8, 3)
        reactions = kf[:, 4:, 2] - bt["botW"][:, None]
    if step_idx > nl["final_step"]:
        _scatter_corners(Sns, bt["scatter"], reactions.reshape(-1, 1),
                         slice(2, 3))
    return nlstate[:3] + (reactions,)


def make_mesh_step(mt: MeshPallasTables):
    """step(state, spare, srcf, step_idx=0) -> (new state, sample [ns,
    3]): one step from ``state`` into the buffers of ``spare`` (same
    structure; the caller swaps them), with the step's source forces
    srcf [L, 3] (already times dt^2, or None without sources); the step
    index (a Python int) times the geostatic loading and the DRM
    records."""
    NB = mt.NB
    bkt = mt.damping == "bkt"
    names = ("out", "conv_out", "conv_mix_out")
    nl, drm = mt.nl, mt.drm

    def sample_of(Ss):
        if mt.st is None:
            return Ss[0].new_zeros((0, 3))
        gat, shape, phi = mt.st
        u_st = gat(Ss).reshape(shape + (3,))
        return torch.einsum("sn,snc->sc", phi, u_st)

    def step(state, spare, srcf, step_idx=0):
        Ss, convs, lconv = state[:3]
        nSs, nconvs = spare[:2]
        sample = sample_of(Ss)

        # ---- nonlinear state update (solver_nonlinear_state) ------------
        if nl is not None:
            ue = _gather_corners(Ss, nl["gather"], nl["n"], 0
                                 ).reshape(nl["n"], 24)
            nlstate = nl_state_update(nl["d"], ue, state[3][:3],
                                      nl["dt"]) + tuple(state[3][3:])

        # ---- per-brick kernels ------------------------------------------
        Sns, new_convs = [], []
        for b in range(NB):
            if mt.tiers[b] == "elastic":
                Sns.append(mt.steps[b](Ss[b], out=nSs[b]))
                new_convs.append(())
                continue
            outs = dict(zip(names, (nSs[b],) + nconvs[b]))
            Sn, *cv = mt.steps[b](Ss[b], *convs[b], **outs)
            Sns.append(Sn)
            new_convs.append(tuple(cv))

        # ---- nonlinear subset forces (before the reconciliation) --------
        if nl is not None:
            nlstate = _nl_subset_pass(mt, Ss, Sns, ue, nlstate, step_idx)

        # ---- loose elements (gather/scatter) ----------------------------
        S_l, Sn_l = Ss[NB], nSs[NB]
        new_lconv = lconv
        if mt.NL:
            u_l, up_l = S_l[0:3], S_l[3:6]
            F_l = torch.zeros_like(u_l)
            if mt.El:
                ue = u_l.T[mt.l_rows].reshape(mt.El, 24)
                upe = up_l.T[mt.l_rows].reshape(mt.El, 24)
                if bkt:
                    lf, new_lconv = loose_bkt_force(
                        ue, upe, lconv, mt.l_bkt, mt.kmu_cat,
                        mt.kkappa_cat)
                else:
                    lf = loose_elastic_force(ue, upe, mt.l_c, mt.mcat)
                flat = lf.reshape(-1, 3)[mt.l_perm]
                F_l.index_add_(1, mt.l_sum.ids, mt.l_sum(flat).T)
            torch.add(u_l, (F_l + mt.mm_l * (u_l - up_l)) * mt.invm_l,
                      out=Sn_l[0:3])
            Sn_l[3:6] = u_l
            Sn_l[6:8] = 0
        Sns.append(Sn_l)

        # ---- DRM part-2 effective forces (before the reconciliation) ----
        if drm is not None:
            fd = drm_lerp(drm["Fdev"], drm["aux"], step_idx)
            for a, cols, rows, invm in drm["adds"]:
                Sns[a][0:3].index_add_(1, cols, (fd[rows] * invm).T)

        # ---- interface reconciliation -----------------------------------
        if mt.reconciler == "plane":
            mt.plane_rec.apply([S[0:3] for S in Ss], [S[3:6] for S in Ss],
                               Sns, srcf)
        elif mt.reconciler == "index":
            un_ex = interface_algebra(mt.ep, mt.ex_gather(Ss, 0),
                                      mt.ex_gather(Ss, 3),
                                      mt.ex_gather(Sns, 0), srcf)
            mt.ex_gather.scatter_set(Sns, un_ex)

        # ---- direct (single-copy) source injection ----------------------
        for a, pp, rows, iv in mt.src_direct:
            Sns[a][0:3].index_add_(1, pp, (srcf[rows] * iv).T)

        new = (tuple(Sns), tuple(new_convs), new_lconv)
        if nl is None:
            return new, sample
        if nl["geostatic"] and step_idx <= nl["final_step"]:
            # geostatic_displacements_fix: bottom z pinned during
            # loading, at every copy
            for a, cols_p in nl["pin"]:
                Sns[a][2].index_fill_(0, cols_p, 0.0)
        return new + (nlstate,), sample

    return step


def route_name(mt: MeshPallasTables) -> str:
    """The route's name in monitor.txt: cuda_mesh, or torch_plain (the
    plain versions, on the CPU)."""
    return "torch_plain" if mt.device.type == "cpu" else "cuda_mesh"


def run_mesh_solver(plan, tables, src_ids, src_forces, total_steps, dt,
                    st_nodes=None, st_phi=None, dtype=torch.float32,
                    device="cuda", chunk=None, state=None, on_chunk=None,
                    start_step=0, on_samples=None, reconciler=None,
                    on_route=None, nl=None, drm=None):
    """Chunked time loop on a multi-brick plan; the contract of the JAX
    package's run_mesh_solver.  ``state``: an initial mesh state (see
    fit_mesh_state), zero when None; a restart.Checkpoint resumes it
    (restore_mesh_state) at ``start_step``.  ``reconciler``: see
    MeshPallasTables.  ``on_route``, if given, is called with the
    route's name before the loop.  ``nl``, ``drm``: the
    attach_nonlinear_mesh and attach_drm_mesh bundles.  Returns ((Ss,
    convs, lconv[, nl_state]), samples [T, ns, 3] numpy).  Runs on the
    CUDA device unless ``device`` is the CPU."""
    device = solver_device(device)
    with measure("Solver tables", device):
        mt = MeshPallasTables(plan, tables, src_ids=src_ids,
                              st_nodes=st_nodes, st_phi=st_phi,
                              dtype=dtype, device=device,
                              reconciler=reconciler, nl=nl, drm=drm)
    return run_mesh(mt, src_forces, total_steps, dt, chunk=chunk,
                    state=state, on_chunk=on_chunk, start_step=start_step,
                    on_samples=on_samples, on_route=on_route)


def run_mesh(mt: MeshPallasTables, src_forces, total_steps, dt, chunk=None,
             state=None, on_chunk=None, start_step=0, on_samples=None,
             on_route=None):
    """run_mesh_solver's time loop on tables already built."""
    if state is None:
        state = init_mesh_state(mt)
    elif isinstance(state, Checkpoint):
        state = restore_mesh_state(mt, state)
    else:
        state = fit_mesh_state(mt, state)
    if chunk is None:
        chunk = min(total_steps, 1000)
    if on_route is not None:
        on_route(route_name(mt))
    step = make_mesh_step(mt)
    dt2 = dt * dt
    spare = [init_mesh_state(mt)]

    def advance(state, s, k):
        with GLOBAL_TIMERS.span("Solver forces upload"):
            srcf = (torch.as_tensor(src_forces[s:s + k] * dt2,
                                    dtype=mt.dtype, device=mt.device)
                    if mt.has_src else None)
        samples = []
        with GLOBAL_TIMERS.span("Solver issue"):
            for i in range(k):
                new, sample = step(state, spare[0],
                                   None if srcf is None else srcf[i], s + i)
                samples.append(sample)
                spare[0], state = state, new
        return state, torch.stack(samples)

    with measure("Solver time loop", mt.device):
        return run_chunked(advance, state, total_steps,
                           start_step=start_step, chunk=chunk,
                           on_chunk=on_chunk, on_samples=on_samples,
                           device=mt.device)


def mesh_u_global(plan, Ss, N, gnid=None):
    """Global [N, 3] displacement (numpy, in the states' type) from the
    per-array states (rows 0:3 are u; brick columns past nb are
    padding): scattered array by array where the states lie (a node
    shared by several arrays takes the last one's copy), then one copy
    to the host.  ``gnid``: plan.gnid_cat already on the states'
    device (copied there when None)."""
    ts = [torch.as_tensor(S) for S in Ss]
    u = ts[-1].new_zeros((N, 3))
    if gnid is None:
        gnid = torch.as_tensor(plan.gnid_cat, device=u.device)

    def put(lo, hi, vals):
        u[gnid[lo:hi]] = vals

    for b, t in zip(plan.bricks, ts):
        put(b.off, b.off + b.nb, t[:3, :b.nb].T)
    off_loose = (plan.bricks[-1].off + plan.bricks[-1].nb
                 if plan.bricks else 0)
    put(off_loose, len(plan.gnid_cat), ts[-1][:3].T)
    return u.cpu().numpy()
