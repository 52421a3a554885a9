"""The multi-brick solver in plain PyTorch ops: the oracle of the CUDA
mesh route (``fused_mesh.py``), on the CPU and on the card, and the
"bricks" route of ``Simulation.run`` (a plan the kernel routes do not
take, as the JAX package routes it).

Counterpart of ``hercules_tpu/solver/brickstep.py``; the JAX names are
kept (``BrickMeta``, ``assemble_brick_tables``, ``make_brick_step``,
``init_brick_state``, ``run_brick_solver``, ``brick_u_global``).
``assemble_brick_tables`` is numpy and copied as it is.

All state lives component-major, [3, TOT] over the plan's concatenated
node columns (the bricks, then the loose section).  Per brick the step
materialises the [24, S] element field of 8 shifted slices (S element
columns whose corners fit the brick), multiplies it by the constant
stiffness operators and adds the [24, S] force back with 24 shifted
slice-adds.  The loose elements (graded-transition slivers too small
to brick) gather and scatter their corners.  The shared and hanging
nodes of the plan's groups are reconciled last: the copies' forces
summed per group, the dangling nodes' share distributed to their
anchors, and after the update each dangling copy set to the weighted
mean of its anchors (compute_adjust, psolve.c:5936-6039).

Every sum over a scattered set runs in a fixed order (``SegmentSum``):
on CUDA ``index_add_`` adds by atomics in no fixed order, so a run
would not repeat its bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.timers import measure
from .chunking import run_chunked

# BKT recursion row names of one channel (pallas_brick.py:52-56)
_BKT_PAIR = ("c1", "c2", "c3", "c4", "e0", "e1")


@dataclass
class BrickMeta:
    off: int
    nb: int
    S: int
    offs: tuple      # 8 corner flat offsets


class SegmentSum:
    """Row sums by segment id in a fixed order: ``self(rows)`` [K, C]
    -> [len(ids), C], row i the sum of the rows whose id is ids[i],
    added one after another in their order in ``seg``
    (``torch.segment_reduce`` over a stable sort by id).  ``ids`` are
    the distinct ids in ascending order, so adding the result at them
    (``index_add_``) meets each target once."""

    def __init__(self, seg, device):
        seg = np.asarray(seg, np.int64).ravel()
        order = np.argsort(seg, kind="stable")
        ids, counts = np.unique(seg[order], return_counts=True)
        self.perm = (None if np.array_equal(order, np.arange(len(seg)))
                     else torch.as_tensor(order, device=device))
        self.ids = torch.as_tensor(ids, device=device)
        self.lengths = torch.as_tensor(counts, device=device)

    def __call__(self, rows):
        if self.perm is not None:
            rows = rows[self.perm]
        return torch.segment_reduce(rows, "sum", lengths=self.lengths,
                                    axis=0, unsafe=True)


def assemble_brick_tables(plan, tables, src_ids=None, st_nodes=None,
                          st_phi=None):
    """Build host arrays for the brick step from global SolverTables."""
    TOT = plan.total_nb
    g = plan.gnid_cat
    ev = plan.evalid_cat
    ei = plan.eidx_cat

    t = {
        "mcat": tables.m48.T.copy(),               # [24, 48]
        "inv_mass": tables.inv_mass[g],            # [TOT]
        "mass_minusaM": tables.mass_minusaM[g].T.copy(),   # [3, TOT]
    }
    for k in ("c1", "c2", "c3", "c4"):
        t[k] = np.where(ev, getattr(tables, k)[ei], 0.0)

    if tables.damping == "bkt":
        t["kmu_cat"] = tables.kmu.T.copy()         # [24, 24]
        t["kkappa_cat"] = tables.kkappa.T.copy()
        t["bkt"] = {k: np.where(ev, v[ei], 0.0)
                    for k, v in tables.bkt.items()}

    # reconciliation plan
    t["ex_pos"] = plan.ex_pos
    t["ex_seg"] = plan.ex_seg
    t["grp_rep"] = plan.grp_rep
    t["n_groups"] = len(plan.grp_node)
    t["dn_grp"] = plan.dn_grp
    t["dn_anc_grp"] = plan.dn_anc_grp
    t["dn_wgt"] = plan.dn_wgt
    # positions of dangling copies for the assignment write-back
    if len(plan.dn_grp):
        isdn = np.zeros(t["n_groups"], bool)
        isdn[plan.dn_grp] = True
        grp2dn = np.zeros(t["n_groups"], np.int64)
        grp2dn[plan.dn_grp] = np.arange(len(plan.dn_grp))
        m = isdn[plan.ex_seg]
        t["dnc_pos"] = plan.ex_pos[m]
        t["dnc_src"] = grp2dn[plan.ex_seg[m]].astype(np.int32)
    else:
        t["dnc_pos"] = np.zeros(0, np.int32)
        t["dnc_src"] = np.zeros(0, np.int32)

    # source plan: first concat copy of each source node
    if src_ids is not None and len(src_ids):
        uniq, first = np.unique(plan.gnid_cat, return_index=True)
        pos = first[np.searchsorted(uniq, src_ids)]
        assert (plan.gnid_cat[pos] == src_ids).all()
        t["src_pos"] = pos.astype(np.int32)
    # stations: first copy of each interpolation node
    if st_nodes is not None:
        uniq, first = np.unique(plan.gnid_cat, return_index=True)
        pos = first[np.searchsorted(uniq, st_nodes.ravel())]
        t["st_pos"] = pos.reshape(st_nodes.shape).astype(np.int32)
        t["st_phi"] = st_phi

    # loose elements (graded-shell slivers): gather/scatter tables
    le = plan.loose_eidx
    t["l_rows"] = plan.loose_rows                    # [El, 8]
    for k in ("c1", "c2", "c3", "c4"):
        t[f"l_{k}"] = getattr(tables, k)[le]
    lseg = plan.loose_rows.ravel()
    lperm = np.argsort(lseg, kind="stable").astype(np.int32)
    t["l_perm"] = lperm
    t["l_seg"] = lseg[lperm].astype(np.int32)
    if tables.damping == "bkt":
        t["l_bkt"] = {k: v[le] for k, v in tables.bkt.items()}

    return t, brick_meta(plan), TOT


def brick_meta(plan):
    """A BrickMeta per brick of the plan."""
    meta = []
    for b in plan.bricks:
        offs = tuple(b.corner_offsets())
        meta.append(BrickMeta(off=b.off, nb=b.nb, S=b.nb - offs[7],
                              offs=offs))
    return meta


def loose_elastic_force(ue, upe, c, mcat):
    """[El, 24] force of the loose elements (Rayleigh, mass or no
    damping) from their corner fields ue, upe [El, 24]; c = (c1, c2, c3,
    c4) [El] each, mcat [24, 48]."""
    c1, c2, c3, c4 = (x[:, None] for x in c)
    du = ue - upe
    a = c1 * ue + c3 * du
    b = c2 * ue + c4 * du
    return -(torch.cat([a, b], 1) @ mcat.T)


def loose_bkt_force(ue, upe, lconv, lbk, kmu_cat, kkappa_cat):
    """BKT force [El, 24] and memory variables of the loose elements
    (pallas_mesh.py:_loose_bkt_force): lconv = (s0, s1, k0, k1) [El, 8,
    3] each, lbk the elements' BKT rows [El] by name."""
    El = ue.shape[0]
    ue3 = ue.reshape(El, 8, 3)
    upe3 = upe.reshape(El, 8, 3)
    ls0, ls1, lk0, lk1 = lconv

    def col(name):
        return lbk[name][:, None, None]

    def lupd(f0, f1, p):
        c1, c2, c3, c4, e0, e1 = (col(f"{p}_{k}") for k in _BKT_PAIR)
        f0n = c2 * ue3 + c1 * upe3 + e0 * f0
        f1n = c4 * ue3 + c3 * upe3 + e1 * f1
        return f0n, f1n

    ls0, ls1 = lupd(ls0, ls1, "shear")
    lk0, lk1 = lupd(lk0, lk1, "kappa")
    du3 = ue3 - upe3
    dvs = (col("shear_coef") * du3
           - (col("a0_shear") * ls0 + col("a1_shear") * ls1) + ue3)
    dvk = (col("kappa_coef") * du3
           - (col("a0_kappa") * lk0 + col("a1_kappa") * lk1) + ue3)
    lf = (lbk["mu_f"][:, None] * (dvs.reshape(El, 24) @ kmu_cat.T)
          + lbk["kappa_f"][:, None] * (dvk.reshape(El, 24) @ kkappa_cat.T))
    return lf, (ls0, ls1, lk0, lk1)


def _to_device(t, dtype, device):
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    d = {}
    for k, v in t.items():
        if k == "n_groups":
            d[k] = v
        elif k in ("bkt", "l_bkt"):
            d[k] = {kk: f(vv) for kk, vv in v.items()}
        elif k in ("ex_pos", "ex_seg", "grp_rep", "dn_grp", "dn_anc_grp",
                   "dnc_pos", "dnc_src", "src_pos", "st_pos", "l_rows",
                   "l_perm", "l_seg"):
            d[k] = i(v)
        else:
            d[k] = f(v)
    return d


def _elem_field(u, meta: BrickMeta):
    """[24, S] element-corner view of the brick node field [3, nb]:
    row 3j+c = component c at corner j."""
    return torch.cat([u[:, o:o + meta.S] for o in meta.offs])


def _scatter_back(force_b, f, meta: BrickMeta):
    """Add f [24, S] back onto the brick node field [3, nb]."""
    for j, o in enumerate(meta.offs):
        force_b[:, o:o + meta.S] += f[3 * j:3 * j + 3]
    return force_b


def brick_force(d, cut, ue, upe, conv=None):
    """(f, conv'): the [24, S] element force of one brick from its
    element fields ue, upe [24, S] (``_elem_field``), and with BKT
    damping (``conv`` the brick's (s0, s1, k0, k1), [24, S] each) its
    new memory variables (None otherwise).  ``cut(v)`` gives the
    brick's [1, S] rows of a per-column table of ``d`` (c1..c4, or the
    "bkt" rows); d also holds "mcat", "kmu_cat" and "kkappa_cat"."""
    if conv is None:
        du = ue - upe
        a = cut(d["c1"]) * ue + cut(d["c3"]) * du
        b = cut(d["c2"]) * ue + cut(d["c4"]) * du
        return -(d["mcat"] @ torch.cat([a, b])), None
    # BKT: memory variables carried per element corner
    bk = {k: cut(v) for k, v in d["bkt"].items()}
    s0, s1, k0, k1 = conv

    def upd(f0, f1, p):
        c1, c2, c3, c4, e0, e1 = (bk[f"{p}_{k}"] for k in _BKT_PAIR)
        return (c2 * ue + c1 * upe + e0 * f0,
                c4 * ue + c3 * upe + e1 * f1)

    s0, s1 = upd(s0, s1, "shear")
    k0, k1 = upd(k0, k1, "kappa")
    du = ue - upe
    dvs = (bk["shear_coef"] * du
           - (bk["a0_shear"] * s0 + bk["a1_shear"] * s1) + ue)
    dvk = (bk["kappa_coef"] * du
           - (bk["a0_kappa"] * k0 + bk["a1_kappa"] * k1) + ue)
    f = (bk["mu_f"] * (d["kmu_cat"] @ dvs)
         + bk["kappa_f"] * (d["kkappa_cat"] @ dvk))
    return f, (s0, s1, k0, k1)


def make_brick_step(t_host, meta, TOT, damping, dtype=torch.float32,
                    device="cuda"):
    """Returns (step, d): step(carry, srcf) -> (carry, sample [ns, 3])
    advances carry = (u, up, conv) by one step with the source forces
    srcf [L, 3] (already times dt^2); d holds the device tables."""
    d = _to_device(t_host, dtype, device)
    G = t_host["n_groups"]
    has_src = "src_pos" in d
    has_st = "st_pos" in d
    has_dn = len(t_host["dn_grp"]) > 0
    El = len(t_host["l_rows"])
    bkt = damping == "bkt"
    loose_sum = SegmentSum(t_host["l_seg"], device) if El else None
    grp_sum = SegmentSum(t_host["ex_seg"], device) if G else None
    anc_sum = (SegmentSum(t_host["dn_anc_grp"], device) if has_dn
               else None)

    def step(carry, srcf):
        mcat = d["mcat"]
        u, up, conv = carry

        if has_st:
            sample = torch.einsum("sn,csn->sc", d["st_phi"],
                                  u[:, d["st_pos"]])
        else:
            sample = u.new_zeros((0, 3))

        force = torch.zeros((3, TOT), dtype=dtype, device=u.device)
        if has_src:
            force.index_add_(1, d["src_pos"], srcf.T)

        new_conv = []
        for bi, m in enumerate(meta):
            ue = _elem_field(u[:, m.off:m.off + m.nb], m)       # [24, S]
            upe = _elem_field(up[:, m.off:m.off + m.nb], m)

            def cut(v):
                return v[m.off:m.off + m.S][None]

            f, cv = brick_force(d, cut, ue, upe, conv[bi] if bkt else None)
            if bkt:
                new_conv.append(cv)
            _scatter_back(force[:, m.off:m.off + m.nb], f, m)

        # ---- loose elements: gather/scatter path --------------------
        if El:
            ue = u.T[d["l_rows"]].reshape(El, 24)
            upe = up.T[d["l_rows"]].reshape(El, 24)
            if not bkt:
                lf = loose_elastic_force(
                    ue, upe, [d[f"l_c{k}"] for k in range(1, 5)], mcat)
            else:
                lf, lconv = loose_bkt_force(ue, upe, conv[-1], d["l_bkt"],
                                            d["kmu_cat"], d["kkappa_cat"])
                new_conv.append(lconv)
            flat = lf.reshape(-1, 3)[d["l_perm"]]
            force.index_add_(1, loose_sum.ids, loose_sum(flat).T)

        # ---- irregular reconciliation over shared/hanging nodes ----
        if G:
            tot = grp_sum(force[:, d["ex_pos"]].T)         # [G, 3]
            if has_dn:
                contrib = (tot[d["dn_grp"]][:, None, :]
                           * d["dn_wgt"][:, :, None])      # [D, 4, 3]
                tot = tot.index_add(0, anc_sum.ids,
                                    anc_sum(contrib.reshape(-1, 3)))
            force[:, d["ex_pos"]] = tot[d["ex_seg"]].T

        # increment form (see solver/step.py): better f32 conditioning
        u_next = u + (force + d["mass_minusaM"] * (u - up)) \
            * d["inv_mass"][None, :]

        if has_dn:
            u_rep = u_next[:, d["grp_rep"]].T              # [G, 3]
            dnv = (u_rep[d["dn_anc_grp"]]
                   * d["dn_wgt"][:, :, None]).sum(dim=1)   # [D, 3]
            u_next[:, d["dnc_pos"]] = dnv[d["dnc_src"]].T

        return (u_next, u, tuple(new_conv) if bkt else conv), sample

    return step, d


def init_brick_state(meta, TOT, damping, dtype=torch.float32,
                     device="cuda", n_loose=0):
    u = torch.zeros((3, TOT), dtype=dtype, device=device)
    conv = ()
    if damping == "bkt":
        zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
        conv = tuple(tuple(zeros((24, m.S)) for _ in range(4))
                     for m in meta)
        if n_loose:
            conv = conv + (tuple(zeros((n_loose, 8, 3)) for _ in range(4)),)
    return (u, u, conv)


def run_brick_solver(plan, tables, src_ids, src_forces, total_steps, dt,
                     st_nodes=None, st_phi=None, dtype=torch.float32,
                     device="cuda", chunk=None, state=None, on_chunk=None,
                     start_step=0, on_samples=None):
    """Chunked brick time loop; the contract of the JAX package's
    run_brick_solver.  Returns ((u, up, conv), samples [T, ns, 3]
    numpy).  Runs on the CUDA device unless ``device`` is the CPU."""
    from .fused_brick import solver_device

    device = solver_device(device)
    with measure("Solver tables", device):
        t_host, meta, TOT = assemble_brick_tables(
            plan, tables, src_ids=src_ids, st_nodes=st_nodes,
            st_phi=st_phi)
        step, _ = make_brick_step(t_host, meta, TOT, tables.damping, dtype,
                                  device)
    if state is None:
        state = init_brick_state(meta, TOT, tables.damping, dtype, device,
                                 n_loose=len(plan.loose_eidx))
    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt
    has_src = src_ids is not None and len(src_ids) > 0

    def advance(state, s, k):
        srcf = (torch.as_tensor(src_forces[s:s + k] * dt2, dtype=dtype,
                                device=device) if has_src else None)
        samples = []
        for i in range(k):
            state, sample = step(state, None if srcf is None else srcf[i])
            samples.append(sample)
        return state, torch.stack(samples)

    with measure("Solver time loop", device):
        return run_chunked(advance, state, total_steps,
                           start_step=start_step, chunk=chunk,
                           on_chunk=on_chunk, on_samples=on_samples,
                           device=device)


def brick_u_global(plan, u_cat, N):
    """Global [N, 3] displacement from the concatenated brick field."""
    arr = np.asarray(torch.as_tensor(u_cat).cpu()).T  # [TOT, 3]
    u = np.zeros((N, 3), arr.dtype)
    u[plan.gnid_cat] = arr
    return u
