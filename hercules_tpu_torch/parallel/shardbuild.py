"""Shard-local solver-table construction: SlabTables directly from a
MeshShard, with NO process ever materializing the global mesh or
global-length solver tables.

This is the missing piece of the reference's scalability story
(octor.c:5267-6651 keeps a per-rank mesh_t; psolve.c:4705-4863 builds
the halo schedules from the local table only): the sharded mesher
(mesh/distributed.py) already produces exact global numbering per
rank, but the previous pipeline re-materialized the global MeshArrays
(`gather_mesh`) before `assemble` + `build_slab_tables`.  Here every
rank computes its own elements' coefficients and mass contributions
and routes them straight to the process feeding the owning DEVICE
z-slab, in bounded-size exchange rounds — per-process memory stays
O(shard + slab), and the arithmetic reproduces the global build
BITWISE (contributions are re-summed in global element order).

Scope: the slab decomposition (single uniform brick — the production
large-mesh case).  Graded meshes keep the gather_mesh path for now
(the gslab and gmesh tables are built from global inputs).

The port's copy of ``hercules_tpu/parallel/shardbuild.py``, pointed at
the port's own modules; the port's SlabTables has no ``ez_per`` (its
``ez_of`` holds the per-rank counts) and also records ``shear_only``,
agreed over the ranks, which its kernel step reads.
"""

from __future__ import annotations

import numpy as np

from ..mesh.octree import PIXELLEVEL
from ..physics.consts import compute_setab, element_coefficients
from ..physics.kmats import bkt_matrices_24, stiffness_matrices_24
from ..solver.assemble import bkt_element_tables
from ..solver.brickstep import BrickMeta
from ..solver.fused_bkt import (bk_row_names, bkt_kappa_zero,
                                detect_bkt_uniform)
from .slab import SlabTables

# bound on the per-round allgather payload (rows); peak transient
# memory of an exchange is nproc * EXCHANGE_CHUNK rows regardless of
# total volume
EXCHANGE_CHUNK = 1 << 20


def _exchange(rows, dest, comm, d0, d1, chunk=EXCHANGE_CHUNK):
    """Route f64 rows to the processes owning devices [d0, d1):
    bounded allgather rounds, each rank keeps only rows whose dest
    device falls in its range and discards the rest immediately.

    rows: [n, c] float64; dest: [n] int device ids (duplicate rows
    for multi-owner targets before calling).  Returns the kept rows
    (concatenated, arbitrary inter-round order) and their dests."""
    rows = np.ascontiguousarray(rows, np.float64)
    dest = np.asarray(dest, np.int64)
    tagged = np.concatenate([dest[:, None].astype(np.float64), rows],
                            axis=1)
    nrounds = int(comm.allreduce_max(-(-len(tagged) // chunk) if
                                     len(tagged) else 0))
    kept = []
    for k in range(max(nrounds, 1) if nrounds else 0):
        part = tagged[k * chunk:(k + 1) * chunk]
        for got in comm.allgather_rows(
                part if len(part) else np.zeros((0, tagged.shape[1]))):
            if not len(got):
                continue
            dd = got[:, 0].astype(np.int64)
            sel = (dd >= d0) & (dd < d1)
            if sel.any():
                kept.append(got[sel])
    if kept:
        out = np.concatenate(kept, axis=0)
        return out[:, 1:], out[:, 0].astype(np.int64)
    return np.zeros((0, rows.shape[1])), np.zeros(0, np.int64)


def _ordered_sums(npos, eidx, vals, size):
    """Per-target ordered accumulation: sum vals[:, c] per npos in
    ascending eidx order — the exact float sequence of the global
    np.bincount over the element-order scatter (strictly sequential
    per bin; np.add.reduceat is sequential below the pairwise
    blocksize of 128, and fan-in here is <= 8 per node)."""
    out = np.zeros((vals.shape[1], size))
    if not len(npos):
        return out
    order = np.lexsort((eidx, npos))
    npos_s = npos[order]
    starts = np.flatnonzero(np.concatenate(
        [[True], npos_s[1:] != npos_s[:-1]]))
    tgt = npos_s[starts]
    for c in range(vals.shape[1]):
        out[c, tgt] = np.add.reduceat(vals[order, c], starts)
    return out


def build_slab_tables_shard(shard, params, comm, n_dev,
                            src_gnids=None, dev_slice=None,
                            boundary=True, halfspace=True
                            ) -> SlabTables:
    """SlabTables for devices [d0, d1) from this rank's MeshShard.

    Bitwise-identical to build_slab_tables(gather_mesh(shard), ...,
    dev_slice=...) on uniform meshes; raises RuntimeError when the
    global mesh is not a single uniform brick (callers fall back to
    the gather_mesh pipeline)."""
    d0, d1 = dev_slice if dev_slice is not None else (0, n_dev)
    E = shard.lenum
    lv = shard.elem_level.astype(np.int64)
    lmax = comm.allreduce_max(int(lv.max()) if E else 0)
    lmin = -comm.allreduce_max(int(-lv.min()) if E else -lmax)
    if lmax != lmin:
        raise RuntimeError("slab decomposition requires a single "
                           "uniform brick covering the whole mesh")
    ndang = comm.allreduce_max(len(shard.dn_ids))
    if ndang:
        raise RuntimeError("uniform slab mesh cannot have dangling "
                           "nodes; mesh inconsistent")
    L = lmax
    shift = PIXELLEVEL - L
    far = shard.farendp
    nx = int(far[0]) >> shift
    ny = int(far[1]) >> shift
    nz = int(far[2]) >> shift
    if shard.e_global != nx * ny * nz:
        raise RuntimeError("slab decomposition requires a single "
                           "uniform brick covering the whole mesh")
    nxp, nyp, nzp = nx + 1, ny + 1, nz + 1
    plane = nyp * nxp
    if nz < n_dev:
        raise RuntimeError(f"{nz} element layers cannot feed "
                           f"{n_dev} devices (each needs >= 1)")
    ez_lo, r = divmod(nz, n_dev)
    ez_hi = ez_lo + (1 if r else 0)
    ez_of = np.array([ez_lo + (1 if d < r else 0)
                      for d in range(n_dev)], np.int32)
    zlo = np.array([d * ez_lo + min(d, r) for d in range(n_dev)],
                   np.int64)                    # first owned layer
    tot_local = (ez_hi + 1) * plane
    offs = tuple((w & 1) + ((w >> 1) & 1) * nxp
                 + ((w >> 2) & 1) * plane for w in range(8))
    meta = BrickMeta(off=0, nb=tot_local, S=tot_local - offs[7],
                     offs=offs)

    def dev_of_layer(iz):
        """Owning device of element layer iz (exactly one)."""
        d = np.minimum(iz // max(ez_lo, 1), n_dev - 1)
        if r:
            # layers < r*(ez_lo+1) belong to the widened devices
            wide = iz < r * (ez_lo + 1)
            d = np.where(wide, iz // (ez_lo + 1),
                         r + (iz - r * (ez_lo + 1)) // max(ez_lo, 1))
        return np.minimum(d, n_dev - 1).astype(np.int64)

    # ---- per-element coefficients (local, exact) --------------------
    a_base, b_base = compute_setab(params.freq, params.type_of_damping)
    props = shard.props
    if not E:
        # empty shard (possible under skewed interval tables): all
        # local passes run on zero-length columns
        props = {k: np.zeros(0) for k in
                 (list(props) or ["Vp", "Vs", "rho"])}
        if params.type_of_damping == "bkt":
            for name in ("shear", "kappa"):
                for c in ("a0", "a1", "g0", "g1", "b"):
                    props.setdefault(f"{c}_{name}", np.zeros(0))
    coeffs = element_coefficients(props, shard.edge_m, params,
                                  a_base, b_base)
    bkt_local = (bkt_element_tables(props, coeffs["c1"], coeffs["c2"],
                                    params)
                 if params.type_of_damping == "bkt" else None)

    ex = shard.elem_x.astype(np.int64) >> shift
    ey = shard.elem_y.astype(np.int64) >> shift
    ez = shard.elem_z.astype(np.int64) >> shift
    epos = ez * plane + ey * nxp + ex            # global grid pos
    edev = dev_of_layer(ez)

    ckeys = ["c1", "c2", "c3", "c4"]
    # static key order (ranks with empty shards must send rows of the
    # same width)
    bkeys = (sorted(
        [f"{n}_{s}" for n in ("shear", "kappa")
         for s in ("c1", "c2", "c3", "c4", "e0", "e1", "coef")]
        + [f"a{i}_{n}" for i in (0, 1) for n in ("shear", "kappa")]
        + ["mu_f", "kappa_f"])
        if bkt_local is not None else [])
    cval = (np.stack([coeffs[k] for k in ckeys]
                     + [np.broadcast_to(np.asarray(bkt_local[k]),
                                        (E,)) for k in bkeys],
                     axis=1) if E else np.zeros((0, 4 + len(bkeys))))
    crows, cdev = _exchange(
        np.concatenate([epos[:, None].astype(np.float64), cval],
                       axis=1) if E else np.zeros((0, 5 + len(bkeys))),
        edev, comm, d0, d1)

    # ---- node-mass contributions ------------------------------------
    # corner grid positions [E, 8] and their (M, base) values
    dt = params.delta_t
    M = props["rho"] * shard.edge_m ** 3 / 8.0 if E else np.zeros(0)
    aM = dt * coeffs["a"] * M if E else np.zeros(0)
    base = M - aM
    w = np.arange(8)
    cx = ex[:, None] + (w & 1)[None, :]
    cy = ey[:, None] + ((w >> 1) & 1)[None, :]
    cz = ez[:, None] + ((w >> 2) & 1)[None, :]
    # per-node accumulation order: the global bincount adds in flat
    # (8*eidx + j) order; each element touches a node at most once,
    # so per-node the order reduces to ascending global eidx
    cpos = (cz * plane + cy * nxp + cx).ravel()   # [8E]
    geidx = shard.e0 + np.arange(E, dtype=np.int64)
    ge8 = np.repeat(geidx, 8)
    M8 = np.repeat(M, 8)
    base8 = np.repeat(base, 8)

    # fully-local nodes: all analytic contributors are in this shard
    exp_cnt = np.ones(0, np.int64)
    if E:
        loc_cnt = np.bincount(cpos, minlength=nzp * plane)
        ucpos = np.unique(cpos)
        uz, rem = np.divmod(ucpos, plane)
        uy, ux = np.divmod(rem, nxp)

        def axis_cnt(i, n):
            return ((i - 1 >= 0).astype(np.int64)
                    + (i <= n - 1).astype(np.int64))
        exp_cnt = (axis_cnt(ux, nx) * axis_cnt(uy, ny)
                   * axis_cnt(uz, nz))
        full = loc_cnt[ucpos] == exp_cnt
        full_nodes = ucpos[full]
        part_nodes = ucpos[~full]
        is_part = np.zeros(nzp * plane, bool)
        is_part[part_nodes] = True
        pm = is_part[cpos]
        # aggregated rows: ordered local sums (local element order ==
        # global element order restricted to the shard's contiguous
        # block, so the per-bin accumulation order matches bincount)
        aggM = np.bincount(cpos, weights=M8, minlength=nzp * plane)
        aggB = np.bincount(cpos, weights=base8, minlength=nzp * plane)
        agg_rows = np.stack([full_nodes.astype(np.float64),
                             aggM[full_nodes], aggB[full_nodes]],
                            axis=1)
        ind_rows = np.stack([cpos[pm].astype(np.float64),
                             ge8[pm].astype(np.float64),
                             M8[pm], base8[pm]], axis=1)
    else:
        agg_rows = np.zeros((0, 3))
        ind_rows = np.zeros((0, 4))

    def node_dests(npos_col):
        """[n] grid node rows -> duplicated (rows_idx, dev) for every
        owning device (z planes shared between neighbors go to
        both)."""
        iz = npos_col.astype(np.int64) // plane
        dl = dev_of_layer(np.minimum(iz, nz - 1))      # element below
        d_hi = np.minimum(dl, n_dev - 1)
        # plane iz is owned by device owning layer iz (top plane of
        # its slab is iz==zlo+ez -> also next device's bottom plane)
        own1 = dev_of_layer(np.clip(iz - 1, 0, nz - 1))
        own2 = dev_of_layer(np.minimum(iz, nz - 1))
        idx = np.concatenate([np.arange(len(iz)), np.arange(len(iz))])
        dev = np.concatenate([own1, own2])
        keep = np.ones(len(dev), bool)
        keep[len(iz):] = own2 != own1
        return idx[keep], dev[keep]

    ai, ad = node_dests(agg_rows[:, 0])
    arows, adev = _exchange(agg_rows[ai], ad, comm, d0, d1)
    ii, idd = node_dests(ind_rows[:, 0])
    irows, idev = _exchange(ind_rows[ii], idd, comm, d0, d1)

    # ---- dashpot contributions (boundary elements only) -------------
    if boundary and E:
        e_t = shard.edge_m / shard.ticksize    # edge in ticks (float)
        et = (np.int64(1) << shift)
        fx = (np.where(shard.elem_x == 0, -1, 0)
              + np.where(shard.elem_x.astype(np.int64) + et == far[0],
                         1, 0))
        fy = (np.where(shard.elem_y == 0, -1, 0)
              + np.where(shard.elem_y.astype(np.int64) + et == far[1],
                         1, 0))
        fz = (np.where(shard.elem_z == 0, -1, 0)
              + np.where(shard.elem_z.astype(np.int64) + et == far[2],
                         1, 0))
        if halfspace:
            fz = np.where(fz == -1, 0, fz)
        eb = np.flatnonzero((fx != 0) | (fy != 0) | (fz != 0))
        if len(eb):
            vp = props["Vp"][eb]
            vs = props["Vs"][eb]
            rho = props["rho"][eb]
            h = shard.edge_m[eb]
            scale = rho * (h / 2) ** 2
            node_bit = np.stack([(w & 1), (w >> 1) & 1, (w >> 2) & 1])
            flags = np.stack([fx[eb], fy[eb], fz[eb]])
            on = np.zeros((3, len(eb), 8), bool)
            for axis in range(3):
                f = flags[axis][:, None]
                nb_ = node_bit[axis][None, :]
                on[axis] = (((f == -1) & (nb_ == 0))
                            | ((f == 1) & (nb_ == 1)))
            faces_on = on.sum(axis=0).astype(np.float64)
            dash_b = np.empty((len(eb), 8, 3))
            for comp in range(3):
                oc = on[comp].astype(np.float64)
                dash_b[:, :, comp] = (vs[:, None] * (faces_on - oc)
                                      + vp[:, None] * oc)
            dash_b *= scale[:, None, None]
            dpos = (cz[eb] * plane + cy[eb] * nxp + cx[eb]).ravel()
            drows = np.concatenate(
                [dpos[:, None].astype(np.float64),
                 np.repeat(geidx[eb], 8)[:, None].astype(np.float64),
                 dash_b.reshape(-1, 3)], axis=1)
        else:
            drows = np.zeros((0, 5))
    else:
        drows = np.zeros((0, 5))
    di, dd = node_dests(drows[:, 0])
    drows, ddev = _exchange(drows[di], dd, comm, d0, d1)

    # ---- gnid rows (owned nodes -> plane owners) --------------------
    gx = shard.node_x >> shift
    gy = shard.node_y >> shift
    gz = shard.node_z >> shift
    gpos = gz * plane + gy * nxp + gx
    gn = shard.gnid0 + np.arange(len(gpos), dtype=np.int64)
    grows0 = np.stack([gpos.astype(np.float64),
                       gn.astype(np.float64)], axis=1)
    gi, gd = node_dests(grows0[:, 0])
    grows, gdev = _exchange(grows0[gi], gd, comm, d0, d1)

    # ---- per-device assembly ----------------------------------------
    st = SlabTables(
        n_dev=n_dev, nzp=nzp, nyp=nyp, nxp=nxp,
        tot_local=tot_local, meta=meta, dt=params.delta_t,
        damping=params.type_of_damping,
        m48=np.concatenate([m.T for m in stiffness_matrices_24()],
                           axis=0),
        ez_of=ez_of)
    st.dev0 = d0

    nloc = d1 - d0
    cs = {k: np.zeros((nloc, tot_local)) for k in ckeys}
    bks = ({k: np.zeros((nloc, tot_local)) for k in bkeys}
           if bkt_local is not None else None)
    vals_v = (np.zeros((nloc, tot_local)) if bkt_local is not None
              else None)
    invm = np.zeros((nloc, tot_local))
    m1 = np.zeros((nloc, 3, tot_local))
    gnids = [None] * n_dev

    for dl, d in enumerate(range(d0, d1)):
        z0 = int(zlo[d])
        ez_d = int(ez_of[d])
        n0 = z0 * plane
        real = (ez_d + 1) * plane

        def localize(nposg):
            return nposg.astype(np.int64) - n0

        # element coefficients (exactly the owned layers)
        sel = cdev == d
        lp = localize(crows[sel, 0])
        for ci, k in enumerate(ckeys):
            cs[k][dl, lp] = crows[sel, 1 + ci]
        if bks is not None:
            for bi, k in enumerate(bkeys):
                bks[k][dl, lp] = crows[sel, 1 + len(ckeys) + bi]
            vals_v[dl, lp] = 1.0

        # masses: aggregated + ordered individual sums
        msA = np.zeros(real)        # mass_simple
        bsA = np.zeros(real)        # base accumulation
        sel = adev == d
        ap = localize(arows[sel, 0])
        msA[ap] = arows[sel, 1]
        bsA[ap] = arows[sel, 2]
        sel = idev == d
        if sel.any():
            ip = localize(irows[sel, 0])
            acc = _ordered_sums(ip, irows[sel, 1].astype(np.int64),
                                irows[sel, 2:4], real)
            msA += acc[0]
            bsA += acc[1]
        mm = np.repeat(bsA[None, :], 3, axis=0)
        sel = ddev == d
        if sel.any():
            dp = localize(drows[sel, 0])
            dacc = _ordered_sums(dp, drows[sel, 1].astype(np.int64),
                                 drows[sel, 2:5], real)
            mm -= dt * dacc
        with np.errstate(divide="ignore"):
            inv = np.where(msA > 0, 1.0 / msA, 0.0)
        invm[dl, :real] = inv
        m1[dl, :, :real] = mm

        # gnid map
        sel = gdev == d
        g = np.full(real, -1, np.int64)
        g[localize(grows[sel, 0])] = grows[sel, 1].astype(np.int64)
        if (g < 0).any():
            raise RuntimeError("slab grid node missing a gnid row; "
                               "shard numbering inconsistent")
        gnids[d] = g

    st.c = cs
    st.inv_mass = invm
    st.mass_minusaM = m1
    st.gnid_local = gnids
    if src_gnids is not None and len(src_gnids):
        attach_sources_shard(st, shard, src_gnids, comm)
    if bks is not None:
        st.bkt = bks
        kmu, kkappa = bkt_matrices_24()
        st.kmu = kmu
        st.kkappa = kkappa
        st.bkt_valid = vals_v
        st.shear_only = comm.allreduce_max(
            0 if E == 0 or bkt_kappa_zero(bkt_local) else 1) == 0
        import os
        if os.environ.get("HT_BKT_UNIFORM", "1") != "0":
            st.bk_scal = _detect_bkt_uniform_shard(bkt_local, E, comm)
    return st


def attach_sources_shard(st: SlabTables, shard, src_gnids, comm):
    """Fill st.src_lidx / st.src_mask from global source gnids: the
    rank owning each gnid reports its grid position (tiny allgather),
    then each local device derives its local index + ownership mask
    (build_slab_tables' source plan, slab.py)."""
    nxp, nyp = st.nxp, st.nyp
    nx = nxp - 1
    plane = nyp * nxp
    shift = (int(shard.farendp[0]) // nx).bit_length() - 1
    gx = shard.node_x >> shift
    gy = shard.node_y >> shift
    gz = shard.node_z >> shift
    gpos = gz * plane + gy * nxp + gx
    sg = np.asarray(src_gnids, np.int64)
    nsrc = len(sg)
    mine = (sg >= shard.gnid0) & (sg < shard.gnid0 + len(gpos))
    src_rows = np.stack(
        [np.flatnonzero(mine).astype(np.float64),
         gpos[sg[mine] - shard.gnid0].astype(np.float64)], axis=1)
    src_tbl = np.full(nsrc, -1, np.int64)
    for got in comm.allgather_rows(src_rows):
        if len(got):
            src_tbl[got[:, 0].astype(np.int64)] = \
                got[:, 1].astype(np.int64)
    if (src_tbl < 0).any():
        raise RuntimeError("source node gnid not found in any shard")

    n_dev = st.n_dev
    ez_lo, r = divmod(st.nzp - 1, n_dev)
    srcl, srcm = [], []
    d1 = st.dev0 + len(st.inv_mass)
    for d in range(st.dev0, d1):
        z0 = d * ez_lo + min(d, r)
        ez_d = int(st.ez_of[d])
        n0 = z0 * plane
        real = (ez_d + 1) * plane
        mine = (src_tbl >= n0) & (src_tbl < n0 + real)
        if d > 0:
            mine &= src_tbl >= n0 + plane
        sl = np.where(mine, src_tbl - n0, st.tot_local - 1)
        srcl.append(sl.astype(np.int32))
        srcm.append(mine)
    st.src_lidx = np.stack(srcl)
    st.src_mask = np.stack(srcm)
    return st


def _detect_bkt_uniform_shard(bkt_local, E, comm):
    """Global uniform-Q detection without global arrays: per-rank
    uniformity + cross-rank set equality (detect_bkt_uniform
    semantics)."""
    kz_local = 1 if (E == 0 or bkt_kappa_zero(bkt_local)) else 0
    kz = comm.allreduce_max(1 - kz_local) == 0
    scal = None
    if E:
        scal = detect_bkt_uniform(
            {k: np.broadcast_to(np.asarray(v), (E,))
             for k, v in bkt_local.items()},
            np.arange(E), np.ones(E, bool), kz)
    names = bk_row_names(kz)
    row = (np.array([[1.0] + [scal[k] for k in names]])
           if scal is not None else
           np.array([[0.0] + [0.0] * len(names)]))
    if E == 0:
        row = np.zeros((0, 1 + len(names)))
    rows = [g for g in comm.allgather_rows(row) if len(g)]
    tbl = np.concatenate(rows, axis=0)
    if (tbl[:, 0] == 1.0).all() and \
            (tbl[1:] == tbl[:1]).all():
        return dict(zip(names, tbl[0, 1:]))
    return None
