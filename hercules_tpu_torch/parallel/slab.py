"""Multi-chip brick solver: slab domain decomposition.

Counterpart of ``hercules_tpu/parallel/slab.py``; the JAX names are
kept (``SlabTables``, ``build_slab_tables``, ``slab_u_global``,
``slab_pallas_u_global``).  A mesh that is one uniform brick splits its
node grid into contiguous z-slabs, one per rank of a
``ranks.RankGroup``.  Each rank steps its fragment; the only exchange
is the force on the two node planes it shares with its neighbours, one
``shift`` up and one down per step.  After the exchange both copies of
a shared plane hold the same totals and the same mass tables, so their
updates agree bit for bit and no displacement is sent back.

The fragments (``build_slab_tables``): ranks own ez_lo or ez_lo + 1
element layers (the extras on the first nz % P ranks); each fragment
holds its layers' node planes plus the next one, padded to the
(ez_hi + 1)-plane buffer tot_local with zero coefficients and zero
inverse mass, and the elements of its last plane zeroed (they belong to
the next slab).  Its bottom shared plane starts at ez_of[r] * plane.  A
source belongs to the lowest rank holding its node.

Two steps run on the fragments:

- ``SlabStep`` ("slab", the counterpart of ``slab_step_builder``): the
  ``brickstep`` algebra in torch ops, state (u, u-[, (s0, s1, k0, k1)])
  per rank: [3, tot_local] fields and BKT memory variables [24, S] in
  the element-corner layout.  The plane forces are summed before the
  update.
- ``SlabKernelStep`` ("slab_pallas", the counterpart of
  ``slab_pallas_step_builder``): one launch per rank and step of the
  brick's step kernel on the fragment -- K1 (elastic), K2 (BKT with one
  Q set over the whole mesh, the JAX package's ``st.bk_scal``) or K4
  (BKT with several, ``slab.py:442-451``), never K3, so that the
  algebra is the JAX slab's -- built by the port's own machinery on a
  one-brick fragment plan (``fused_mesh.brick_step_module``).  Then the
  JAX halo algebra in torch ops: the sources added to the kernel's
  output (owning rank only), the two shared planes' forces recovered by
  linearity, F = (u+ - u) / inv_mass - mass_minusaM (u - u-) (exact:
  the update is linear; the planes are real nodes, inv_mass > 0), the
  bottom plane's force shifted down and the top plane's up, and each
  shared plane recomputed from scratch in the same operand order on
  both copies: u + (F_lower + F_upper + mass_minusaM (u - u-)) *
  inv_mass.  The end planes of the ring keep the kernel's update.  On
  the CPU the kernels' plain versions run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..solver.bricks import build_plan
from ..solver.brickstep import (BrickMeta, _elem_field, _scatter_back,
                                assemble_brick_tables, brick_force)
from ..solver.fused_bkt import bkt_kappa_zero, detect_bkt_uniform


@dataclass
class SlabTables:
    n_dev: int
    nzp: int            # global node planes
    nyp: int
    nxp: int
    tot_local: int      # local node count (incl. both shared planes)
    meta: BrickMeta
    dt: float
    damping: str
    m48: np.ndarray
    # per-rank owned layer counts; the bottom shared plane of rank r
    # starts at ez_of[r] * plane
    ez_of: np.ndarray = None
    # stacked per-rank arrays [n_dev, ...]
    c: dict = None
    inv_mass: np.ndarray = None
    mass_minusaM: np.ndarray = None
    src_lidx: np.ndarray = None     # [n_dev, L]
    src_mask: np.ndarray = None
    gnid_local: list = None         # per rank: global node ids
    bkt: dict = None                # [n_dev, tot_local] BKT coefficients
    kmu: np.ndarray = None          # [24, 24] BKT operators
    kkappa: np.ndarray = None
    # one global BKT coefficient set -> K2 on the kernel path
    bk_scal: dict = None
    # the brick plan and each rank's first global column (the kernel
    # path's fragment plans)
    plan: object = None
    n0: np.ndarray = None
    # the global SolverTables (the fragments' step modules read them)
    tables: object = None


def build_slab_tables(mesh, tables, n_dev, src_ids=None) -> SlabTables:
    """Split the single uniform brick into per-rank fragments along the
    z axis (the storage axes pinned to (z, y, x), as the JAX package
    pins them for its slabs).  Raises RuntimeError unless the mesh is
    one brick with no loose elements and at least one element layer per
    rank."""
    plan = build_plan(mesh, legacy_axes=True)
    if len(plan.bricks) != 1 or len(plan.loose_eidx):
        raise RuntimeError("slab decomposition requires a single "
                           "uniform brick covering the whole mesh")
    b = plan.bricks[0]
    nzp, nyp, nxp = b.node_shape
    nz = nzp - 1
    if nz < n_dev:
        raise RuntimeError(f"{nz} element layers cannot feed "
                           f"{n_dev} devices (each needs >= 1)")
    ez_lo, r = divmod(nz, n_dev)
    ez_hi = ez_lo + (1 if r else 0)
    ez_of = np.array([ez_lo + (1 if d < r else 0)
                      for d in range(n_dev)], np.int32)
    plane = nyp * nxp
    tot_local = (ez_hi + 1) * plane

    # global brick tables (node-grid order)
    t_host, metas, TOT = assemble_brick_tables(plan, tables,
                                               src_ids=src_ids)
    gm = metas[0]
    local_meta = BrickMeta(off=0, nb=tot_local,
                           S=tot_local - gm.offs[7], offs=gm.offs)
    st = SlabTables(
        n_dev=n_dev, nzp=nzp, nyp=nyp, nxp=nxp, tot_local=tot_local,
        meta=local_meta, dt=tables.dt, damping=tables.damping,
        m48=tables.m48, ez_of=ez_of, plan=plan, tables=tables)
    st.n0 = np.array([(d * ez_lo + min(d, r)) * plane
                      for d in range(n_dev)], np.int64)

    cs = {k: [] for k in ("c1", "c2", "c3", "c4")}
    bks = ({k: [] for k in t_host["bkt"]}
           if tables.damping == "bkt" else None)
    invm, m1 = [], []
    srcl, srcm = [], []
    L = len(src_ids) if src_ids is not None else 0

    def padded(v, real):
        """Zero-pad the last axis from `real` to tot_local."""
        if v.shape[-1] == tot_local:
            return v
        w = [(0, 0)] * (v.ndim - 1) + [(0, tot_local - v.shape[-1])]
        return np.pad(v, w)

    for d in range(n_dev):
        ez_d = int(ez_of[d])
        n0 = int(st.n0[d])
        real = (ez_d + 1) * plane
        n1 = n0 + real
        for k in cs:
            v = t_host[k][n0:n1].copy()
            # elements of the last local plane belong to the next slab
            v[ez_d * plane:] = 0.0
            cs[k].append(padded(v, real))
        if bks is not None:
            for k in bks:
                v = t_host["bkt"][k][n0:n1].copy()
                v[ez_d * plane:] = 0.0
                bks[k].append(padded(v, real))
        invm.append(padded(t_host["inv_mass"][n0:n1], real))
        m1.append(padded(t_host["mass_minusaM"][:, n0:n1], real))
        if L:
            pos = t_host["src_pos"].astype(np.int64)
            mine = (pos >= n0) & (pos < n1)
            # owner = lowest rank: the top shared plane of ranks > 0
            # belongs to the previous slab
            if d > 0:
                mine &= pos >= n0 + plane
            sl = np.where(mine, pos - n0, tot_local - 1)
            srcl.append(sl.astype(np.int32))
            srcm.append(mine)

    st.c = {k: np.stack(v) for k, v in cs.items()}
    st.inv_mass = np.stack(invm)
    st.mass_minusaM = np.stack(m1)
    st.gnid_local = [plan.gnid_cat[int(st.n0[d]):int(st.n0[d])
                                   + (int(ez_of[d]) + 1) * plane]
                     for d in range(n_dev)]
    if L:
        st.src_lidx = np.stack(srcl)
        st.src_mask = np.stack(srcm)
    if bks is not None:
        st.bkt = {k: np.stack(v) for k, v in bks.items()}
        st.kmu = t_host["kmu_cat"]
        st.kkappa = t_host["kkappa_cat"]
        E = len(np.asarray(tables.bkt["shear_c1"]))
        st.bk_scal = detect_bkt_uniform(
            tables.bkt, np.arange(E), np.ones(E, bool),
            bkt_kappa_zero(tables.bkt))
    return st


def slab_u_global(st: SlabTables, u_ranks, N, row0=0):
    """Global [N, 3] field (numpy) from the ranks' fragments: rows
    row0:row0 + 3 of each rank's [rows, >= tot_local] array (u at row0
    0, u- at row0 3 of a packed state)."""
    arrs = [torch.as_tensor(a)[row0:row0 + 3].cpu().numpy() for a in u_ranks]
    u = np.zeros((N, 3), arrs[0].dtype)
    for d, g in enumerate(st.gnid_local):
        u[g] = arrs[d][:, :len(g)].T
    return u


slab_pallas_u_global = slab_u_global


def rank_sources(st: SlabTables):
    """Per rank (local columns, indices among the L sources) of the
    sources it owns."""
    if st.src_lidx is None:
        return [(np.zeros(0, np.int64), np.zeros(0, np.int64))] * st.n_dev
    return [(st.src_lidx[d][st.src_mask[d]].astype(np.int64),
             np.flatnonzero(st.src_mask[d])) for d in range(st.n_dev)]


class SlabStep:
    """The plain slab step of ``hercules_tpu/parallel/slab.py:
    slab_step_builder`` in torch ops, on a RankGroup.  State per rank:
    (u, u-) [3, tot_local], then with BKT (s0, s1, k0, k1) [24, S]."""

    def __init__(self, st: SlabTables, group, dtype):
        self.st, self.group, self.dtype = st, group, dtype
        self.bkt = st.damping == "bkt"
        m = st.meta
        self.plane = st.nyp * st.nxp
        self.tabs = []
        for r, dev in enumerate(group.devices):
            f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                          device=dev)
            cut = lambda v: f(v[r][None, :m.S])
            t = {"mcat": f(st.m48.T), "inv_mass": f(st.inv_mass[r])[None],
                 "mass_minusaM": f(st.mass_minusaM[r])}
            if self.bkt:
                t["bkt"] = {k: cut(v) for k, v in st.bkt.items()}
                t["kmu_cat"] = f(st.kmu)
                t["kkappa_cat"] = f(st.kkappa)
            else:
                t.update({k: cut(v) for k, v in st.c.items()})
            lidx, _ = rank_sources(st)[r]
            t["src_lidx"] = torch.as_tensor(lidx, device=dev)
            self.tabs.append(t)

    def init_state(self):
        out = []
        for dev in self.group.devices:
            z = lambda shape: torch.zeros(shape, dtype=self.dtype,
                                          device=dev)
            u = z((3, self.st.tot_local))
            conv = (tuple(z((24, self.st.meta.S)) for _ in range(4)),) \
                if self.bkt else ()
            out.append((u, u) + conv)
        return out

    @staticmethod
    def fields(state):
        """(u, u-) [3, *] views of a rank's state."""
        return state[0], state[1]

    def step(self, states, srcf, step_idx=None, fb_disp=None):
        """One step of every rank; srcf[r]: rank r's owned sources'
        forces [Lr, 3] (dt^2 applied) or None.  (``step_idx`` and
        ``fb_disp``, the sharded step's, are not used.)"""
        st, m, pl, P = self.st, self.st.meta, self.plane, self.group.size
        forces, convs = [], []
        for r, state in enumerate(states):
            t = self.tabs[r]
            u, up = state[0], state[1]
            ue, upe = _elem_field(u, m), _elem_field(up, m)
            fe, cv = brick_force(t, lambda v: v, ue, upe,
                                 state[2] if self.bkt else None)
            force = u.new_zeros((3, st.tot_local))
            _scatter_back(force, fe, m)
            if srcf[r] is not None:
                force.index_add_(1, t["src_lidx"], srcf[r].T)
            forces.append(force)
            convs.append(cv)
        # halo exchange on the two shared node planes
        zbs = [int(st.ez_of[r]) * pl for r in range(P)]
        f_bot = [f[:, zb:zb + pl] for f, zb in zip(forces, zbs)]
        down = self.group.shift(f_bot, +1)
        up_ = self.group.shift([f[:, :pl] for f in forces], -1)
        out = []
        for r, (state, force, zb) in enumerate(zip(states, forces, zbs)):
            t = self.tabs[r]
            if r < P - 1:
                force[:, zb:zb + pl] = f_bot[r] + up_[r]
            if r > 0:
                force[:, :pl] = force[:, :pl] + down[r]
            u, up = state[0], state[1]
            # increment form (see solver/step.py)
            u_next = u + (force + t["mass_minusaM"] * (u - up)) \
                * t["inv_mass"]
            out.append((u_next, u) + ((convs[r],) if self.bkt else ()))
        return out


def fragment_plan(st: SlabTables, r):
    """Rank r's fragment as a one-brick plan: the brick's corner offsets
    over tot_local columns, and the columns' global node ids, element
    validity (the last local plane's elements zeroed: they belong to the
    next slab) and element ids -- what ``fused_mesh.brick_step_module``
    reads of a plan."""
    plan = st.plan
    plane = st.nyp * st.nxp
    n0, ez = int(st.n0[r]), int(st.ez_of[r])
    cut = slice(n0, n0 + (ez + 1) * plane)
    evalid = plan.evalid_cat[cut].copy()
    evalid[ez * plane:] = False
    return _FragmentPlan(bricks=[_Fragment(st.tot_local, st.meta.offs)],
                         gnid_cat=plan.gnid_cat[cut], evalid_cat=evalid,
                         eidx_cat=plan.eidx_cat[cut])


@dataclass
class _Fragment:
    nb: int
    offs: tuple
    off: int = 0

    def corner_offsets(self):
        return self.offs


@dataclass
class _FragmentPlan:
    bricks: list
    gnid_cat: np.ndarray
    evalid_cat: np.ndarray
    eidx_cat: np.ndarray


def slab_kernel_tier(st: SlabTables):
    """The step kernel of the slab's fragments: "elastic" (K1),
    "uniform" (K2: one BKT coefficient set over the whole mesh) or
    "corner" (K4: several)."""
    if st.damping != "bkt":
        return "elastic"
    return "uniform" if st.bk_scal is not None else "corner"


class SlabKernelStep:
    """The kernel slab step of ``hercules_tpu/parallel/slab.py:
    slab_pallas_step_builder`` on a RankGroup.  State per rank: (S,)
    elastic, (S, conv) BKT, S [8, LEN] = (u, u-, 0, 0) and conv the
    tier's memory variables (K2: node basis [6 | 12, LEN]; K4: corner
    basis [48 | 96, LEN])."""

    def __init__(self, st: SlabTables, group, dtype):
        from ..solver.fused_mesh import brick_step_module
        self.st, self.group, self.dtype = st, group, dtype
        self.tier = slab_kernel_tier(st)
        self.plane = st.nyp * st.nxp
        tier = None if self.tier == "elastic" else self.tier
        # K layout: elastic (c1, c2, beta, mm x 3, inv_mass, 0); BKT
        # (mm x 3, inv_mass, ...)
        self.invm_row, self.mm_rows = ((6, slice(3, 6))
                                       if self.tier == "elastic"
                                       else (3, slice(0, 3)))
        self.mods, self.views, self.src = [], [], []
        pl = self.plane
        for r, dev in enumerate(group.devices):
            mod, self.LEN = brick_step_module(fragment_plan(st, r), 0,
                                              st.tables, dtype, dev,
                                              tier=tier)
            self.mods.append(mod)
            K = mod.K
            zb = int(st.ez_of[r]) * pl
            iv, m1 = K[self.invm_row], K[self.mm_rows]
            # the two shared planes' inv_mass and mass_minusaM
            self.views.append(((iv[:pl], m1[:, :pl]),
                               (iv[zb:zb + pl], m1[:, zb:zb + pl]), zb))
            lidx, _ = rank_sources(st)[r]
            pos = torch.as_tensor(lidx, device=dev)
            self.src.append((pos, iv[pos]))
        self._spare = [None] * group.size

    def init_state(self):
        out = []
        for mod, dev in zip(self.mods, self.group.devices):
            S = torch.zeros((8, self.LEN), dtype=self.dtype, device=dev)
            parts = (() if self.tier == "elastic" else
                     tuple(torch.zeros(shape, dtype=dt, device=dev)
                           for shape, dt in mod.state_parts(self.LEN)))
            out.append((S,) + parts)
        return out

    @staticmethod
    def fields(state):
        return state[0][0:3], state[0][3:6]

    def _launch(self, r, state):
        """One launch of rank r's step kernel from ``state`` into the
        rank's spare buffers; returns the new state."""
        spare = self._spare[r]
        if spare is None or spare[0] is state[0]:
            spare = tuple(torch.empty_like(x) for x in state)
        mod = self.mods[r]
        if len(state) == 1:
            new = (mod(state[0], out=spare[0]),)
        else:
            new = tuple(mod(state[0], state[1], out=spare[0],
                            conv_out=spare[1]))
        self._spare[r] = state
        return new

    def step(self, states, srcf, step_idx=None, fb_disp=None):
        """One step of every rank; srcf[r]: rank r's owned sources'
        forces [Lr, 3] (dt^2 applied) or None.  (``step_idx`` and
        ``fb_disp``, the sharded step's, are not used.)"""
        P, pl = self.group.size, self.plane
        news, f_top, f_bot = [], [], []
        for r, state in enumerate(states):
            new = self._launch(r, state)
            un = new[0]
            if srcf[r] is not None:
                pos, ivs = self.src[r]
                un[0:3].index_add_(1, pos, srcf[r].T * ivs[None, :])
            S = state[0]
            (iv_t, m1_t), (iv_b, m1_b), zb = self.views[r]
            # plane forces from the rank's own update (linearity)
            f_top.append((un[0:3, :pl] - S[0:3, :pl]) / iv_t
                         - m1_t * (S[0:3, :pl] - S[3:6, :pl]))
            f_bot.append((un[0:3, zb:zb + pl] - S[0:3, zb:zb + pl]) / iv_b
                         - m1_b * (S[0:3, zb:zb + pl] - S[3:6, zb:zb + pl]))
            news.append(new)
        down = self.group.shift(f_bot, +1)
        up_ = self.group.shift(f_top, -1)
        # replica-symmetric plane update: both copies of a shared plane
        # recompute u+ from scratch with the same operand order (the
        # lower rank's force, then the upper rank's)
        for r, (state, new) in enumerate(zip(states, news)):
            S, un = state[0], new[0]
            (iv_t, m1_t), (iv_b, m1_b), zb = self.views[r]
            if r > 0:
                u, du = S[0:3, :pl], S[0:3, :pl] - S[3:6, :pl]
                un[0:3, :pl] = u + (down[r] + f_top[r] + m1_t * du) * iv_t
            if r < P - 1:
                b = slice(zb, zb + pl)
                u, du = S[0:3, b], S[0:3, b] - S[3:6, b]
                un[0:3, b] = u + (f_bot[r] + up_[r] + m1_b * du) * iv_b
        return news

