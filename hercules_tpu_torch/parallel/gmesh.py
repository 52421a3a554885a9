"""General graded-mesh multi-chip solver: the kernels for any brick
decomposition.

Counterpart of ``hercules_tpu/parallel/gmesh.py``; the JAX names are
kept (``GMeshTables``, ``build_gmesh_tables``, ``gmesh_u_global``,
``init_nl_gmesh_state``).  ``gslab.py`` needs every brick interface to
be a full z-plane (depth-graded meshes); laterally graded meshes -- a
fine region bounded in x or y, the basin-edge shape -- have vertical
interfaces.  Here every dense brick of the default plan (``build_plan``'s
storage axes, not ``legacy_axes``) is split over the ranks along its
outermost storage axis, as gslab splits z (``slab.split_bricks``).
Per step (``GMeshStep``):

- per brick and rank, one launch of the brick's kernel on the fragment:
  K1 (Rayleigh, mass or no damping), or K2 (BKT, one coefficient set
  per brick); the direct sources each rank owns (single-copy nodes; a
  node on a fragment-shared plane belongs to the rank below) added to
  its output;
- nonlinear soil: each rank's plastic subset pass on its own nonlinear
  elements (``fused_mesh._nl_subset_pass``, with
  ``nonlinear.nl_state_update`` and ``nl_force``), K1's tables having
  their columns masked (``fused_brick.pack_constants(masked=)``);
- per brick, the slab halo (``slab.halo_exchange``);
- the loose section (graded transition slivers), replicated: every
  rank runs the same small torch pass on it (``gmesh.py:695-712``);
- the interface reconciliation on one ``allsum`` of a [K, 9] entry
  buffer (``gmesh.py:714-770``): each rank fills the (u, u-, u+) rows of
  the interface entries it owns -- rank 0 alone the loose section's --
  and leaves every other row exactly zero, so that the rank-order sum
  is the owner's row; then the group algebra of
  ``fused_mesh.interface_algebra`` on every rank (segment sums, the
  group-level sources, the dangling nodes distributed and assigned),
  and each rank writes back every local copy, the lower replica of a
  fragment-shared plane included, so that replicas stay bit-identical.

State per rank: (Ss, S_l) elastic, (Ss, S_l, convs) with BKT, (Ss, S_l,
nl_state) with nonlinear soil; Ss the bricks' packed S [8, LEN_b],
S_l [8, NL] the loose section (the same on every rank), convs the
bricks' node-basis memory variables, nl_state the rank's plastic state
(stresses and plastic strains [Enl_r, 8, 6], ep [Enl_r, 8]: its own
nonlinear elements in NLTables.eidx order; the JAX package pads every
rank's to the largest count, which ``driver.GMeshPath.tail`` and
``state_from_global`` map).  On the CPU the kernels' plain versions
run.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..nonlinear import nl_device_tables, nl_state_update
from ..solver.bricks import build_plan
from ..solver.brickstep import SegmentSum, loose_elastic_force
from ..solver.fused_bkt import bkt_kappa_zero, detect_bkt_uniform
from ..solver.fused_mesh import (_gather_corners, _nl_subset_pass,
                                 interface_algebra,
                                 interface_epilogue_consts,
                                 mesh_plan_applies, nl_subset_plans)
from .slab import FragmentSteps, split_bricks

NL_KEYS = ("mu", "lam", "alpha", "k", "hard", "strainrate", "sensitivity",
           "h")


@dataclass
class GMeshTables:
    n_dev: int
    damping: str
    plan: object
    tables: object
    src_ids: object
    bricks: list
    N: int = 0
    K: int = 0                  # interface entries
    tier: str = "elastic"       # "elastic" (K1) or "uniform" (K2)
    # per rank, per brick: (entries, fragment columns) it gathers (the
    # owner's copy) and it writes back (the owner's and the lower
    # replica of a fragment-shared plane)
    gather: list = None
    scatter: list = None
    # the loose section: its node count, elements, global node ids and
    # (entries, columns) of its interface copies (rank 0 gathers, every
    # rank writes back)
    NL: int = 0
    El: int = 0
    gnid_loose: np.ndarray = None
    loose_ent: tuple = None
    # direct (single-copy) sources: per rank (brick, columns, rows); the
    # loose section's (columns, rows), on every rank
    src_brick: list = None
    src_loose: tuple = None
    # nonlinear soil: per rank the host plan of its subset pass, None
    # without; the NLTables and the time step
    nl: list = None
    nl_cfg: object = None


def _owner(z0s, z):
    """Rank owning node plane (or element layer) z: the highest rank
    whose first layer is <= z."""
    return np.clip(np.searchsorted(z0s, z, side="right") - 1, 0,
                   len(z0s) - 1)


def build_gmesh_tables(mesh, tables, n_dev, src_ids=None,
                       min_brick_elems=2048, nl_tables=None,
                       params=None, plan=None) -> GMeshTables:
    """Split every brick of the default plan (``plan``, where the caller
    has it) over n_dev ranks and lay out the interface entries, the
    loose section, the sources and, with ``nl_tables`` (and
    ``params``), the nonlinear subset.  Raises RuntimeError on each
    case the JAX package's build_gmesh_tables refuses (gmesh.py:118-158,
    392-395): damping other than rayleigh, mass, none or bkt; nonlinear
    soil with BKT; BKT with loose elements; a brick with several BKT
    coefficient sets; a nonlinear element missing from the plan or in
    the loose section; geostatic loading; a brick with fewer element
    layers than ranks."""
    bkt = tables.damping == "bkt"
    if not mesh_plan_applies(None, tables.damping):
        raise RuntimeError(f"gmesh: unsupported damping {tables.damping}")
    if bkt and nl_tables is not None:
        raise RuntimeError("nonlinear+BKT: unstructured path only")
    if plan is None:
        plan = build_plan(mesh, min_brick_elems=min_brick_elems)
    if not plan.bricks:
        raise RuntimeError("no dense bricks")
    if bkt and len(plan.loose_eidx):
        raise RuntimeError("gmesh BKT with loose elements: use gslab or "
                           "the unstructured path")
    NB = len(plan.bricks)
    off_loose = plan.bricks[-1].off + plan.bricks[-1].nb
    nl_cols = None
    if nl_tables is not None:
        if nl_tables.cfg.geostatic_loading_t > 0:
            raise RuntimeError("geostatic loading on multi-chip: "
                               "unstructured path only (for now)")
        valid = np.flatnonzero(plan.evalid_cat)
        col_of = -np.ones(tables.E, np.int64)
        col_of[plan.eidx_cat[valid]] = valid
        nl_cols = col_of[nl_tables.eidx]
        if not (nl_cols >= 0).all():
            raise RuntimeError("nonlinear element missing from plan; "
                               "unstructured path only")
        if (nl_cols >= off_loose).any():
            raise RuntimeError("nonlinear elements in the loose section; "
                               "unstructured path only")
    tier = "elastic"
    if bkt:
        shear_only = bkt_kappa_zero(tables.bkt)
        if not all(detect_bkt_uniform(
                tables.bkt, plan.eidx_cat[b.off:b.off + b.nb],
                plan.evalid_cat[b.off:b.off + b.nb], shear_only) is not None
                for b in plan.bricks):
            raise RuntimeError("gmesh BKT needs one Q set per brick (the "
                               "heterogeneous-Q node tier is single-chip "
                               "only); use gslab or the unstructured path")
        tier = "uniform"
    bricks = split_bricks(plan, n_dev)
    st = GMeshTables(n_dev=n_dev, damping=tables.damping, plan=plan,
                     tables=tables, src_ids=src_ids, bricks=bricks,
                     N=mesh.nnum, tier=tier)

    # ---- interface entries (host side of the epilogue's tables) -------
    ep = interface_epilogue_consts(plan, tables, src_ids, torch.float64,
                                   "cpu")
    st.K = ep["K"]
    st.gather = [[None] * NB for _ in range(n_dev)]
    st.scatter = [[None] * NB for _ in range(n_dev)]
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    ex_arr = ep.get("ex_arr", np.zeros(0, np.int64))
    ex_loc = ep.get("ex_loc", np.zeros(0, np.int64)).astype(np.int64)
    for bi, fb in enumerate(bricks):
        kk = np.flatnonzero(ex_arr == bi)
        z, rr = np.divmod(ex_loc[kk], fb.plane)
        own = _owner(fb.z0s, z)
        for d in range(n_dev):
            col = (z - fb.z0s[d]) * fb.plane + rr
            g = own == d
            s = g | ((own == d + 1) & (z == fb.z0s[own]))
            st.gather[d][bi] = (kk[g], col[g]) if g.any() else empty
            st.scatter[d][bi] = (kk[s], col[s]) if s.any() else empty
    st.NL = plan.total_nb - off_loose
    st.El = len(plan.loose_eidx)
    st.gnid_loose = plan.gnid_cat[off_loose:]
    kk = np.flatnonzero(ex_arr == NB)
    st.loose_ent = (kk, ex_loc[kk])

    # ---- direct sources: a brick's on the rank below a shared plane ---
    st.src_brick = [[] for _ in range(n_dev)]
    st.src_loose = empty
    for a, pp, rows, _ in ep["src_direct"]:
        pp, rows = pp.numpy(), rows.numpy()
        if a == NB:
            st.src_loose = (pp, rows)
            continue
        fb = bricks[a]
        z, rr = np.divmod(pp, fb.plane)
        own = np.clip(np.searchsorted(fb.z0s, z, side="left") - 1, 0,
                      n_dev - 1)
        for d in range(n_dev):
            m = own == d
            if m.any():
                st.src_brick[d].append(
                    (a, (z[m] - fb.z0s[d]) * fb.plane + rr[m], rows[m]))

    if nl_cols is not None:
        _nl_bundle(st, mesh, nl_tables, params, nl_cols)
    return st


def _nl_bundle(st, mesh, t, params, nl_cols):
    """Each rank's nonlinear elements (gmesh.py:_nl_gmesh_bundle): the
    rank and local fragment column of every element, verified corner
    order, and per rank the host plan of its subset pass (element
    indices into t.eidx, corner positions [n, 8] and bricks)."""
    plan, n_dev = st.plan, st.n_dev
    g = plan.gnid_cat
    Enl = len(t.eidx)
    brick_of = np.zeros(Enl, np.int64)
    rank = np.zeros(Enl, np.int64)
    pos = np.zeros((Enl, 8), np.int64)
    for bi, (b, fb) in enumerate(zip(plan.bricks, st.bricks)):
        m = (nl_cols >= b.off) & (nl_cols < b.off + b.nb)
        if not m.any():
            continue
        offs = np.asarray(b.corner_offsets())
        loc = nl_cols[m] - b.off
        if not (g[b.off + loc[:, None] + offs[None, :]]
                == mesh.elem_lnid[t.eidx[m]]).all():
            raise RuntimeError("brick corner order does not match "
                               "elem_lnid; unstructured path only")
        brick_of[m] = bi
        z = loc // fb.plane
        rank[m] = _owner(fb.z0s, z)
        lcol = loc - fb.z0s[rank[m]] * fb.plane
        pos[m] = lcol[:, None] + offs[None, :]
    st.nl_cfg = SimpleNamespace(tables=t, dt=params.delta_t)
    st.nl = []
    for d in range(n_dev):
        idx = np.flatnonzero(rank == d)
        st.nl.append({"idx": idx, "pos": pos[idx], "brick": brick_of[idx]})


def nl_masks(st):
    """masked(r, b): rank r's fragment columns of brick b whose element
    K1 leaves out (the nonlinear elements), or None without nonlinear
    soil."""
    if st.nl is None:
        return None

    def masked(r, b):
        fb = st.bricks[b]
        m = np.zeros((int(fb.ez_of[r]) + 1) * fb.plane, bool)
        h = st.nl[r]
        sel = h["brick"] == b
        m[h["pos"][sel, 0]] = True      # corner 0 is the element's column
        return m

    return masked


def gmesh_u_global(st: GMeshTables, Ss_ranks, S_l, N=None, row0=0):
    """Global [N, 3] field (numpy) from the ranks' per-brick arrays and
    the loose section (rank 0's copy; written first, so brick copies
    win at shared nodes -- all copies agree after the reconciliation):
    rows row0:row0 + 3 (u at 0, u- at 3)."""
    N = st.N if N is None else N
    loose = torch.as_tensor(S_l)[row0:row0 + 3].cpu().numpy()
    u = np.zeros((N, 3), loose.dtype)
    if st.NL:
        u[st.gnid_loose] = loose.T
    for r, Ss in enumerate(Ss_ranks):
        for fb, S in zip(st.bricks, Ss):
            g = fb.gnid_local[r]
            u[g] = torch.as_tensor(S)[row0:row0 + 3, :len(g)].cpu().numpy().T
    return u


def init_nl_gmesh_state(st: GMeshTables, dtype, devices):
    """Zero plastic state of every rank: (stresses, plastic strains, ep)
    [Enl_r, 8, 6], [Enl_r, 8, 6], [Enl_r, 8] (None where the rank's
    device is None: another process's rank)."""
    return [None if dev is None else
            tuple(torch.zeros(shape, dtype=dtype, device=dev)
                  for shape in ((n, 8, 6), (n, 8, 6), (n, 8)))
            for dev, n in zip(devices, (len(h["idx"]) for h in st.nl))]


class GMeshStep(FragmentSteps):
    """The general graded step of ``hercules_tpu/parallel/gmesh.py:
    gmesh_step_builder`` on a RankGroup (see the module docstring)."""

    def __init__(self, st: GMeshTables, group, dtype):
        self.st = st
        self._build_modules(st.plan, st.bricks, st.tables, group, dtype,
                            st.tier, masked=nl_masks(st))
        plan, tables = st.plan, st.tables
        i64 = lambda x, dev: torch.as_tensor(np.asarray(x, np.int64),
                                             device=dev)
        f = lambda x, dev: torch.as_tensor(np.asarray(x), dtype=dtype,
                                           device=dev)
        g = plan.gnid_cat
        off_loose = plan.total_nb - st.NL
        le = plan.loose_eidx
        P = group.size
        eps = {}
        self.ep, self.loose, self.ent = [None] * P, [None] * P, [None] * P
        self.src, self.src_loose = [None] * P, [None] * P
        self.nl = [None] * P if st.nl is not None else []
        pp, srows = st.src_loose
        for r in group.local_ranks:
            dev = group.devices[r]
            if dev not in eps:
                eps[dev] = (interface_epilogue_consts(
                    plan, tables, st.src_ids, dtype, dev) if st.K else None)
            self.ep[r] = eps[dev]
            lo = {"mm": f(tables.mass_minusaM[g[off_loose:]].T, dev),
                  "invm": f(tables.inv_mass[g[off_loose:]], dev)[None, :]}
            if st.El:
                rows = plan.loose_rows - off_loose
                lseg = rows.ravel()
                lperm = np.argsort(lseg, kind="stable")
                lo["rows"] = i64(rows, dev)
                lo["perm"] = i64(lperm, dev)
                lo["sum"] = SegmentSum(lseg[lperm], dev)
                lo["c"] = [f(getattr(tables, f"c{k}")[le], dev)
                           for k in range(1, 5)]
                lo["mcat"] = f(tables.m48.T, dev)
            self.loose[r] = lo
            self.ent[r] = (
                [tuple(i64(a, dev) for a in st.gather[r][b])
                 for b in range(len(st.bricks))],
                [tuple(i64(a, dev) for a in st.scatter[r][b])
                 for b in range(len(st.bricks))],
                tuple(i64(a, dev) for a in st.loose_ent))
            self.src[r] = [(b, i64(pos, dev), i64(rows, dev))
                           for b, pos, rows in st.src_brick[r]]
            if st.nl is not None:
                self.nl[r] = self._nl_rank(r, dev)
            if len(pp):
                self.src_loose[r] = (
                    i64(pp, dev), i64(srows, dev),
                    f(tables.inv_mass[g[off_loose + pp]], dev)[:, None])

    def _nl_rank(self, r, dev):
        """Rank r's subset-pass bundle (fused_mesh._nl_subset_pass's)."""
        st, dtype = self.st, self.dtype
        t, h = st.nl_cfg.tables, st.nl[r]
        dt = st.nl_cfg.dt
        d = nl_device_tables(t, dtype, dev)
        sel = torch.as_tensor(h["idx"], device=dev)
        for k in NL_KEYS:
            d[k] = d[k][sel]
        gnids = [fb.gnid_local[r] for fb in st.bricks]
        gth, sct = nl_subset_plans(h["pos"], h["brick"], gnids,
                                   st.tables.inv_mass, dtype, dev)
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        e = t.eidx[h["idx"]]
        return {"d": d, "n": len(h["idx"]), "dt": dt, "dt2": dt * dt,
                "c3": f(st.tables.c3[e]), "c4": f(st.tables.c4[e]),
                "mcat": f(st.tables.m48.T), "gather": gth, "scatter": sct,
                "geostatic": False}

    def init_state(self):
        out = [None] * self.group.size
        nls = (init_nl_gmesh_state(self.st, self.dtype, self.group.devices)
               if self.st.nl is not None else None)
        for r in self.group.local_ranks:
            dev = self.group.devices[r]
            Ss, convs = self.zero_bricks(r)
            s = (Ss, torch.zeros((8, self.st.NL), dtype=self.dtype,
                                 device=dev))
            if self.tier != "elastic":
                s += (convs,)
            elif nls is not None:
                s += (nls[r],)
            out[r] = s
        return out

    def _loose(self, r, S_l, srcf):
        """Rank r's replica of the loose section's update: the next-step
        [8, NL] array."""
        lo = self.loose[r]
        u_l, up_l = S_l[0:3], S_l[3:6]
        F_l = torch.zeros_like(u_l)
        if self.st.El:
            El = self.st.El
            ue = u_l.T[lo["rows"]].reshape(El, 24)
            upe = up_l.T[lo["rows"]].reshape(El, 24)
            lf = loose_elastic_force(ue, upe, lo["c"], lo["mcat"])
            flat = lf.reshape(-1, 3)[lo["perm"]]
            F_l.index_add_(1, lo["sum"].ids, lo["sum"](flat).T)
        Sn_l = torch.zeros_like(S_l)
        torch.add(u_l, (F_l + lo["mm"] * (u_l - up_l)) * lo["invm"],
                  out=Sn_l[0:3])
        Sn_l[3:6] = u_l
        sl = self.src_loose[r]
        if sl is not None and srcf is not None:
            pp, rows, iv = sl
            Sn_l[0:3].index_add_(1, pp, (srcf[rows] * iv).T)
        return Sn_l

    def step(self, states, srcf, step_idx=0, fb_disp=None):
        """One step of every local rank; srcf[r]: all L sources' forces
        [L, 3] (dt^2 applied) on rank r, or None.  (``fb_disp``, the
        sharded step's, is not used.)"""
        st, group = self.st, self.group
        NB, P, loc = len(st.bricks), group.size, group.local_ranks
        Ss = [None if s is None else s[0] for s in states]
        uns, convs, nls = [None] * P, [None] * P, [None] * P
        for r in loc:
            state = states[r]
            conv = state[2] if self.tier != "elastic" else ((),) * NB
            new = [self.launch(r, b, Ss[r][b], conv[b]) for b in range(NB)]
            un = [n[0] for n in new]
            if srcf[r] is not None:
                self.add_sources(r, un, self.src[r], srcf[r])
            if self.nl:
                nl = self.nl[r]
                nst = state[2]
                if nl["n"]:
                    ue = _gather_corners(Ss[r], nl["gather"], nl["n"],
                                         0).reshape(nl["n"], 24)
                    nst = nl_state_update(nl["d"], ue, nst, nl["dt"])
                    nst = _nl_subset_pass(SimpleNamespace(nl=nl), Ss[r], un,
                                          ue, nst, step_idx)
                nls[r] = nst
            uns[r] = un
            convs[r] = tuple(n[1] for n in new)
        self.halos(Ss, uns)
        loose = [None] * P
        for r in loc:
            loose[r] = self._loose(r, states[r][1], srcf[r])

        if st.K:
            bufs = [None] * P
            for r in loc:
                un, S_l = uns[r], states[r][1]
                gat, _, lent = self.ent[r]
                buf = un[0].new_zeros((st.K, 9))
                for b, (rows, cols) in enumerate(gat):
                    if len(rows):
                        buf[rows] = torch.cat([Ss[r][b][0:6, cols],
                                               un[b][0:3, cols]]).T
                if r == 0 and len(lent[0]):
                    rows, cols = lent
                    buf[rows] = torch.cat([S_l[0:6, cols],
                                           loose[r][0:3, cols]]).T
                bufs[r] = buf
            full = group.allsum(bufs)
            for r in loc:
                un = uns[r]
                _, sca, lent = self.ent[r]
                un_ex = interface_algebra(self.ep[r], full[r][:, 0:3],
                                          full[r][:, 3:6], full[r][:, 6:9],
                                          srcf[r])
                for b, (rows, cols) in enumerate(sca):
                    if len(rows):
                        un[b][0:3, cols] = un_ex[rows].T
                if len(lent[0]):
                    rows, cols = lent
                    loose[r][0:3, cols] = un_ex[rows].T

        out = [None] * P
        for r in loc:
            s = (tuple(uns[r]), loose[r])
            if self.tier != "elastic":
                s += (convs[r],)
            elif self.nl:
                s += (nls[r],)
            out[r] = s
        return out
