"""Spatial domain decomposition for multi-chip runs.

The reference partitions octree leaves into contiguous Z-order blocks
per MPI rank and exchanges shared-node partial sums with index-mapped
messages every step (octor_partitiontree octor.c:4904-5258;
schedule_senddata psolve.c:4946-5079).  The TPU design keeps the same
contiguous Z-order blocks but collapses the reference's FOUR per-step
exchanges (dangling/anchored x force/displacement) into ONE psum over a
shared-node boundary buffer:

- each device applies the (linear) dangling distribution to its own
  partial forces, so one psum yields exact anchor totals;
- after the psum every replica of a shared node computes bit-identical
  displacement updates, so no displacement share-back is needed.

Elements and nodes are padded to uniform per-device sizes with a trash
node slot so the step is a single static-shape SPMD program.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ShardedTables:
    n_dev: int
    E_pad: int
    N_pad: int          # includes the trash slot at index N_pad-1
    B_pad: int
    dt: float
    damping: str
    m48: np.ndarray     # [48, 24] shared constants
    kmu: np.ndarray = None
    kkappa: np.ndarray = None

    # stacked per-device arrays, leading axis n_dev
    lnid: np.ndarray = None          # [d, E_pad, 8] local node ids
    c: dict = field(default_factory=dict)   # c1..c4 [d, E_pad]
    bkt: dict = field(default_factory=dict)
    inv_mass: np.ndarray = None      # [d, N_pad]
    mass_minusaM: np.ndarray = None  # [d, N_pad, 3]
    scat_perm: np.ndarray = None     # [d, E_pad*8]
    scat_seg: np.ndarray = None
    dn_ids: np.ndarray = None        # [d, D_pad]
    dn_anchors: np.ndarray = None    # [d, D_pad, 4]
    dn_weights: np.ndarray = None    # [d, D_pad, 4]
    dn_scat_perm: np.ndarray = None
    dn_scat_seg: np.ndarray = None
    # boundary exchange plan
    b_lidx: np.ndarray = None        # [d, B_pad] local idx of shared node
    b_mask: np.ndarray = None        # [d, B_pad] bool
    # source scatter (owner-device only)
    src_lidx: np.ndarray = None      # [d, L] local idx or trash
    src_mask: np.ndarray = None      # [d, L]
    # host-side bookkeeping for gathering results
    owned_global: list = None        # per device: global node ids owned
    owned_local: list = None         # per device: local indices of owned
    local_globals: list = None       # per device: global ids of local nodes


def _block_bounds(n, parts):
    lo = (np.arange(parts) * n) // parts
    hi = (np.arange(1, parts + 1) * n) // parts
    return lo, hi


def shard_tables(tables, mesh, n_dev, src_ids=None) -> ShardedTables:
    """Split global SolverTables into n_dev contiguous Z-order element
    blocks with halo node replication."""
    E, N = tables.E, tables.N
    lo, hi = _block_bounds(E, n_dev)

    # global dangling lookup
    D = len(tables.dn_ids)
    dn_of = {int(n_): i for i, n_ in enumerate(tables.dn_ids)}

    dev_nodes = []       # sorted global node ids per device
    dev_elems = []
    for d in range(n_dev):
        el = np.arange(lo[d], hi[d])
        dev_elems.append(el)
        nodes = np.unique(tables.lnid[el])
        # add anchors of local dangling nodes
        if D:
            mask = np.isin(tables.dn_ids, nodes)
            extra = np.unique(tables.dn_anchors[mask])
            nodes = np.unique(np.concatenate([nodes, extra]))
        dev_nodes.append(nodes)

    # shared nodes = in >1 device
    counts = np.zeros(N, np.int32)
    for nodes in dev_nodes:
        counts[nodes] += 1
    shared = np.flatnonzero(counts > 1)
    B = len(shared)
    shared_pos = -np.ones(N, np.int64)
    shared_pos[shared] = np.arange(B)

    # owner of each node = lowest device holding it
    owner = np.full(N, -1, np.int32)
    for d in range(n_dev - 1, -1, -1):
        owner[dev_nodes[d]] = d

    E_pad = int(max(len(e) for e in dev_elems))
    N_pad = int(max(len(n_) for n_ in dev_nodes)) + 1  # + trash slot
    D_pad = 0
    dev_dn = []
    for d in range(n_dev):
        if D:
            m = np.isin(tables.dn_ids, dev_nodes[d])
            dev_dn.append(np.flatnonzero(m))
            D_pad = max(D_pad, int(m.sum()))
        else:
            dev_dn.append(np.zeros(0, np.int64))
    D_pad = max(D_pad, 1)
    B_pad = max(B, 1)
    L = len(src_ids) if src_ids is not None else 0

    st = ShardedTables(
        n_dev=n_dev, E_pad=E_pad, N_pad=N_pad, B_pad=B_pad,
        dt=tables.dt, damping=tables.damping, m48=tables.m48,
        kmu=tables.kmu, kkappa=tables.kkappa)

    lnid_s, perm_s, seg_s = [], [], []
    cs = {k: [] for k in ("c1", "c2", "c3", "c4")}
    bkt_s = {k: [] for k in tables.bkt} if tables.bkt else {}
    invm_s, m1_s = [], []
    dnid_s, danc_s, dwgt_s, dperm_s, dseg_s = [], [], [], [], []
    blidx_s, bmask_s = [], []
    srcl_s, srcm_s = [], []
    owned_g, owned_l, loc_g = [], [], []

    trash_local = N_pad - 1
    for d in range(n_dev):
        nodes = dev_nodes[d]
        nl = len(nodes)
        g2l = -np.ones(N, np.int64)
        g2l[nodes] = np.arange(nl)
        el = dev_elems[d]
        ne = len(el)

        ln = np.full((E_pad, 8), trash_local, np.int32)
        ln[:ne] = g2l[tables.lnid[el]]
        lnid_s.append(ln)
        for k in cs:
            v = np.zeros(E_pad)
            v[:ne] = getattr(tables, k)[el]
            cs[k].append(v)
        for k in bkt_s:
            v = np.zeros(E_pad)
            v[:ne] = tables.bkt[k][el]
            bkt_s[k].append(v)

        seg = ln.ravel()
        perm = np.argsort(seg, kind="stable").astype(np.int32)
        perm_s.append(perm)
        seg_s.append(seg[perm].astype(np.int32))

        im = np.ones(N_pad)
        im[:nl] = tables.inv_mass[nodes]
        invm_s.append(im)
        mm = np.zeros((N_pad, 3))
        mm[:nl] = tables.mass_minusaM[nodes]
        m1_s.append(mm)

        dn_rows = dev_dn[d]
        nd = len(dn_rows)
        di = np.full(D_pad, trash_local, np.int32)
        da = np.full((D_pad, 4), trash_local, np.int32)
        dw = np.zeros((D_pad, 4))
        if nd:
            di[:nd] = g2l[tables.dn_ids[dn_rows]]
            da[:nd] = g2l[tables.dn_anchors[dn_rows]]
            dw[:nd] = tables.dn_weights[dn_rows]
            if (da[:nd] < 0).any():
                raise RuntimeError(
                    "dangling anchor missing from device node set")
        dnid_s.append(di)
        danc_s.append(da)
        dwgt_s.append(dw)
        dseg = da.ravel()
        dperm = np.argsort(dseg, kind="stable").astype(np.int32)
        dperm_s.append(dperm)
        dseg_s.append(dseg[dperm].astype(np.int32))

        # boundary plan
        bl = np.full(B_pad, trash_local, np.int32)
        bm = np.zeros(B_pad, bool)
        here = nodes[counts[nodes] > 1]
        bl[shared_pos[here]] = g2l[here]
        bm[shared_pos[here]] = True
        blidx_s.append(bl)
        bmask_s.append(bm)

        # source plan (owner only)
        if L:
            sl = np.full(L, trash_local, np.int32)
            sm = np.zeros(L, bool)
            mine = owner[src_ids] == d
            sl[mine] = g2l[src_ids[mine]]
            sm[mine] = True
            srcl_s.append(sl)
            srcm_s.append(sm)

        og = nodes[owner[nodes] == d]
        owned_g.append(og)
        owned_l.append(g2l[og])
        loc_g.append(nodes)

    st.lnid = np.stack(lnid_s)
    st.c = {k: np.stack(v) for k, v in cs.items()}
    st.bkt = {k: np.stack(v) for k, v in bkt_s.items()}
    st.inv_mass = np.stack(invm_s)
    st.mass_minusaM = np.stack(m1_s)
    st.scat_perm = np.stack(perm_s)
    st.scat_seg = np.stack(seg_s)
    st.dn_ids = np.stack(dnid_s)
    st.dn_anchors = np.stack(danc_s)
    st.dn_weights = np.stack(dwgt_s)
    st.dn_scat_perm = np.stack(dperm_s)
    st.dn_scat_seg = np.stack(dseg_s)
    st.b_lidx = np.stack(blidx_s)
    st.b_mask = np.stack(bmask_s)
    if L:
        st.src_lidx = np.stack(srcl_s)
        st.src_mask = np.stack(srcm_s)
    st.owned_global = owned_g
    st.owned_local = owned_l
    st.local_globals = loc_g
    return st


def shard_nonlinear(st: ShardedTables, tables, mesh, params,
                    nl_tables, n_dev):
    """Per-device nonlinear bundle for the sharded path
    (nonlinear.c:1671-1823 runs on every MPI rank in the reference;
    the plastic state is per-element, so it shards with the element
    partition).  Returns a host dict of stacked arrays; padding rows
    use neutral material constants (k=1, h=1, the rest 0) whose
    plastic update is exactly zero, and scatter to the trash node."""
    from ..nonlinear import smooth_rise_factor

    t = nl_tables
    E = tables.E
    N = mesh.nnum
    lo, hi = _block_bounds(E, n_dev)
    trash = st.N_pad - 1
    dt = params.delta_t
    dt2 = dt * dt

    # rows of t.eidx per device
    dev_rows = [np.flatnonzero((t.eidx >= lo[d]) & (t.eidx < hi[d]))
                for d in range(n_dev)]
    NLpad = max(1, max(len(r) for r in dev_rows))

    geostatic = t.cfg.geostatic_loading_t > 0
    consts = ("mu", "lam", "alpha", "k", "hard", "strainrate",
              "sensitivity", "h")
    neutral = {"k": 1.0, "h": 1.0, "sensitivity": 1.0}

    out = {
        "n_dev": n_dev, "NLpad": NLpad, "dt": dt, "dt2": dt2,
        "model": t.cfg.material_model,
        "rate_dep": t.cfg.plasticity_type.startswith("rate_dep"),
        "geostatic": geostatic,
        "n_rows": [len(r) for r in dev_rows],
    }
    cs = {k: [] for k in consts}
    lnid_s, perm_s, seg_s = [], [], []
    if geostatic:
        final = t.cfg.geostatic_final_step(dt)
        out["final_step"] = final
        ngeo = int(t.cfg.geostatic_loading_t / dt)
        out["rise"] = smooth_rise_factor(np.arange(final + 2), ngeo)
        bot_global = np.unique(mesh.elem_lnid[t.bot_eidx][:, 4:])
        dev_bot = [np.intersect1d(t.bot_eidx,
                                  np.arange(lo[d], hi[d]))
                   for d in range(n_dev)]
        EBpad = max(1, max(len(b) for b in dev_bot))
        out["EBpad"] = EBpad
        gw_s, gperm_s, gseg_s = [], [], []
        bl_s, bc1_s, bc2_s, bw_s, bperm_s, bseg_s = \
            [], [], [], [], [], []
        bn_s, bnm_s = [], []

    for d in range(n_dev):
        nodes = st.local_globals[d]
        g2l = np.full(N, trash, np.int64)
        g2l[nodes] = np.arange(len(nodes))
        rows = dev_rows[d]
        nr = len(rows)

        for k in cs:
            v = np.full(NLpad, neutral.get(k, 0.0))
            v[:nr] = getattr(t, k)[rows]
            cs[k].append(v)
        ln = np.full((NLpad, 8), trash, np.int32)
        ln[:nr] = g2l[mesh.elem_lnid[t.eidx[rows]]]
        lnid_s.append(ln)
        seg = ln.ravel()
        perm = np.argsort(seg, kind="stable").astype(np.int32)
        perm_s.append(perm)
        seg_s.append(seg[perm].astype(np.int32))

        if geostatic:
            el = np.arange(lo[d], hi[d])
            gw = np.zeros(st.E_pad * 8)
            gw[: len(el) * 8] = np.repeat(t.grav_W[el] * dt2, 8)
            gseg = np.full((st.E_pad, 8), trash, np.int32)
            gseg[: len(el)] = g2l[mesh.elem_lnid[el]]
            gseg = gseg.ravel()
            gperm = np.argsort(gseg, kind="stable").astype(np.int32)
            gw_s.append(gw)
            gperm_s.append(gperm)
            gseg_s.append(gseg[gperm].astype(np.int32))

            be = dev_bot[d]
            nb_ = len(be)
            bl = np.full((EBpad, 8), trash, np.int32)
            bc1 = np.zeros(EBpad)
            bc2 = np.zeros(EBpad)
            bw = np.zeros(EBpad)
            if nb_:
                bl[:nb_] = g2l[mesh.elem_lnid[be]]
                bc1[:nb_] = tables.c1[be]
                bc2[:nb_] = tables.c2[be]
                bw[:nb_] = (mesh.props["rho"][be]
                            * mesh.edge_m[be] ** 3 * 9.8 * 0.125 * dt2)
            bl_s.append(bl)
            bc1_s.append(bc1)
            bc2_s.append(bc2)
            bw_s.append(bw)
            bseg = bl[:, 4:].ravel()
            bperm = np.argsort(bseg, kind="stable").astype(np.int32)
            bperm_s.append(bperm)
            bseg_s.append(bseg[bperm].astype(np.int32))
            # z-fix applies to EVERY local replica of a bottom node
            present = bot_global[np.isin(bot_global, nodes)]
            bn = np.full(len(bot_global), trash, np.int32)
            bn[: len(present)] = g2l[present]
            bn_s.append(bn)
            bnm_s.append(np.arange(len(bot_global)) < len(present))

        # zero the linear stiffness coefficients of nonlinear elements
        # in the already-stacked sharded tables (stiffness.c:46-105)
        if nr:
            st.c["c1"][d][t.eidx[rows] - lo[d]] = 0.0
            st.c["c2"][d][t.eidx[rows] - lo[d]] = 0.0

    out["consts"] = {k: np.stack(v) for k, v in cs.items()}
    out["lnid"] = np.stack(lnid_s)
    out["scat_perm"] = np.stack(perm_s)
    out["scat_seg"] = np.stack(seg_s)
    if geostatic:
        out["grav_W"] = np.stack(gw_s)
        out["gscat_perm"] = np.stack(gperm_s)
        out["gscat_seg"] = np.stack(gseg_s)
        out["bot_lnid"] = np.stack(bl_s)
        out["bc1"] = np.stack(bc1_s)
        out["bc2"] = np.stack(bc2_s)
        out["bot_W"] = np.stack(bw_s)
        out["bscat_perm"] = np.stack(bperm_s)
        out["bscat_seg"] = np.stack(bseg_s)
        out["bot_nodes"] = np.stack(bn_s)
        out["bot_nodes_mask"] = np.stack(bnm_s)
    return out


def shard_fixedbase(st: ShardedTables, fb_ids, n_dev):
    """Per-device fixed-base building plan (buildings.c:975-1146):
    prescribed base DISPLACEMENTS are a set, not an add, so every
    device writes ALL of its local copies (owned + halo replicas) of
    each base node — replicas stay consistent with no extra exchange,
    exactly as the reference applies them on every rank harboring the
    node."""
    ids = np.asarray(fb_ids)
    trash = st.N_pad - 1
    lidx = np.full((n_dev, len(ids)), trash, np.int32)
    mask = np.zeros((n_dev, len(ids)), bool)
    covered = np.zeros(len(ids), bool)
    for d in range(n_dev):
        nodes = st.local_globals[d]
        srt = np.sort(nodes)
        order = np.argsort(nodes, kind="stable")
        pos = np.clip(np.searchsorted(srt, ids), 0, len(srt) - 1)
        ok = srt[pos] == ids
        lidx[d][ok] = order[pos[ok]]
        mask[d][ok] = True
        covered |= ok
    if not covered.all():
        raise RuntimeError("fixed-base node not local to any device")
    return {"lidx": lidx, "mask": mask}


def shard_drm(st: ShardedTables, drm, n_dev):
    """Per-device DRM PART2 bundle: the precomputed effective-force
    records are replicated; each record row is applied once, by the
    device owning the node (drm.c:2316-2437)."""
    ids = np.asarray(drm["ids"])
    trash = st.N_pad - 1
    lidx = np.full((n_dev, len(ids)), trash, np.int32)
    mask = np.zeros((n_dev, len(ids)), bool)
    assigned = np.zeros(len(ids), bool)
    for d in range(n_dev):
        nodes = st.local_globals[d]
        srt = np.sort(nodes)
        order = np.argsort(nodes, kind="stable")
        pos = np.clip(np.searchsorted(srt, ids), 0, len(srt) - 1)
        ok = (srt[pos] == ids) & ~assigned
        lidx[d][ok] = order[pos[ok]]
        mask[d][ok] = True
        assigned |= ok
    if not assigned.all():
        raise RuntimeError("DRM boundary node not local to any device")
    return {"lidx": lidx, "mask": mask, "F": np.asarray(drm["F"]),
            "aux": drm["aux"]}
