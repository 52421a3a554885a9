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
  algebra is the JAX slab's -- its constants packed from the tables'
  own stacked arrays (``slab_step_module``), as the JAX kernel step
  packs them: byte for byte the K that ``fused_mesh.brick_step_module``
  builds on the rank's one-brick fragment plan (``brick_fragment``), so
  that shard-built tables (``shardbuild.py``), which have no global
  plan, drive the kernels.  It is ``FragmentSteps``, which the graded
  paths ``gslab.py`` and ``gmesh.py`` run on every brick of their
  plans, on the slab's one brick.  Then the JAX halo algebra in
  torch ops (``halo_exchange``): the sources added to the kernel's
  output (owning rank only), the two shared planes' forces recovered by
  linearity, F = (u+ - u) / inv_mass - mass_minusaM (u - u-) (exact:
  the update is linear; the planes are real nodes, inv_mass > 0), the
  bottom plane's force shifted down and the top plane's up, and each
  shared plane recomputed from scratch in the same operand order on
  both copies: u + (F_lower + F_upper + mass_minusaM (u - u-)) *
  inv_mass.  The end planes of the ring keep the kernel's update.  On
  the CPU the kernels' plain versions run.

Both steps build modules and state only for the rank group's
``local_ranks`` (every rank of a ``ranks.RankGroup``; a process's own
of a ``ranks.DistRankGroup``) and index every per-rank list by global
rank, None at other processes' ranks; tables built with ``dev_slice``
(or by ``shardbuild.py``) hold the stacked arrays of ranks [dev0, dev0
+ n) only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.bkt_corner_step import corner_tab
from ..solver.bricks import build_plan
from ..solver.brickstep import (BrickMeta, _elem_field, _scatter_back,
                                assemble_brick_tables, brick_force)
from ..solver.fused_bkt import (BktStep, bk_row_names, bkt_kappa_zero,
                                detect_bkt_uniform, recursion_scalars)
from ..solver.fused_bktq import BktCornerStep, _unique_rows, bkt_fm
from ..solver.fused_brick import BrickStep, pallas_geometry
from ..solver.fused_mesh import brick_step_module


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
    # the stacked arrays below hold ranks [dev0, dev0 + their length)
    # (build_slab_tables' dev_slice, shardbuild's shard-local tables)
    dev0: int = 0
    # stacked per-rank arrays [n_ranks, ...]
    c: dict = None
    inv_mass: np.ndarray = None
    mass_minusaM: np.ndarray = None
    src_lidx: np.ndarray = None     # [n_ranks, L]
    src_mask: np.ndarray = None
    gnid_local: list = None         # per rank: global node ids (None
                                    # where the tables hold no rank)
    bkt: dict = None                # [n_ranks, tot_local] BKT coefficients
    kmu: np.ndarray = None          # [24, 24] BKT operators
    kkappa: np.ndarray = None
    # one global BKT coefficient set -> K2 on the kernel path
    bk_scal: dict = None
    # per rank: 1.0 at the columns of the elements it owns
    bkt_valid: np.ndarray = None    # [n_ranks, tot_local]
    # whether the bulk (kappa) attenuation is off over the whole mesh
    shear_only: bool = None

    def row(self, r):
        """Rank r's row in the stacked arrays."""
        i = r - self.dev0
        if not 0 <= i < len(self.inv_mass):
            raise ValueError(f"the slab tables hold ranks [{self.dev0}, "
                             f"{self.dev0 + len(self.inv_mass)}), not {r}")
        return i


def split_layers(nz, n_dev):
    """(ez_hi, ez_of, z0s) of nz element layers split over n_dev ranks:
    ez_of [n_dev] the layers each rank owns (ez_lo or ez_lo + 1, the
    extras on the first nz % n_dev ranks), z0s [n_dev] each rank's first
    layer, ez_hi the largest count (the fragments' buffer holds ez_hi +
    1 node planes).  Raises RuntimeError where a rank would get none."""
    if nz < n_dev:
        raise RuntimeError(f"{nz} element layers cannot feed "
                           f"{n_dev} devices (each needs >= 1)")
    ez_lo, r = divmod(nz, n_dev)
    ez_of = np.array([ez_lo + (1 if d < r else 0)
                      for d in range(n_dev)], np.int32)
    z0s = np.array([d * ez_lo + min(d, r) for d in range(n_dev)], np.int64)
    return ez_lo + (1 if r else 0), ez_of, z0s


@dataclass
class FragmentedBrick:
    """One brick split in layers of its outermost storage axis over the
    ranks (slab.split_layers): rank r owns ez_of[r] element layers from
    layer z0s[r], its fragment the (ez_of[r] + 1)-plane column range
    from b.off + z0s[r] * plane, padded to tot_local = (ez + 1) * plane
    columns (LEN with the kernels' padding)."""
    plane: int
    ez: int
    tot_local: int
    LEN: int
    ez_of: np.ndarray
    z0s: np.ndarray
    gnid_local: list = field(default_factory=list)

    def frag_cols(self, r):
        """Rank r's fragment's first column within the brick."""
        return int(self.z0s[r]) * self.plane


def split_bricks(plan, n_dev):
    """FragmentedBrick of every brick of the plan over n_dev ranks;
    RuntimeError naming the first brick with fewer element layers than
    ranks."""
    out = []
    for bi, b in enumerate(plan.bricks):
        n0, n1, n2 = b.node_shape
        try:
            ez, ez_of, z0s = split_layers(n0 - 1, n_dev)
        except RuntimeError as e:
            raise RuntimeError(f"brick {bi}: {e}") from None
        plane = n1 * n2
        fb = FragmentedBrick(plane=plane, ez=ez, tot_local=(ez + 1) * plane,
                             LEN=pallas_geometry((ez + 1) * plane),
                             ez_of=ez_of, z0s=z0s)
        for r in range(n_dev):
            c0 = b.off + fb.frag_cols(r)
            fb.gnid_local.append(
                plan.gnid_cat[c0:c0 + (int(ez_of[r]) + 1) * plane])
        out.append(fb)
    return out


def build_slab_tables(mesh, tables, n_dev, src_ids=None,
                      plan=None, dev_slice=None) -> SlabTables:
    """Split the single uniform brick into per-rank fragments along the
    z axis (the storage axes pinned to (z, y, x), as the JAX package
    pins them for its slabs; ``plan``: that plan where the caller has
    it).  Raises RuntimeError unless the mesh is one brick with no loose
    elements and at least one element layer per rank.

    dev_slice: optional (d0, d1) -- the stacked per-rank arrays only for
    ranks [d0, d1) (a process's ranks in a multi-process run), so no
    process holds the others' tables; gnid_local stays global (it is
    the gather map).  The tables carry d0 in ``dev0``."""
    if plan is None:
        plan = build_plan(mesh, legacy_axes=True)
    if len(plan.bricks) != 1 or len(plan.loose_eidx):
        raise RuntimeError("slab decomposition requires a single "
                           "uniform brick covering the whole mesh")
    b = plan.bricks[0]
    nzp, nyp, nxp = b.node_shape
    nz = nzp - 1
    ez_hi, ez_of, z0s = split_layers(nz, n_dev)
    plane = nyp * nxp
    tot_local = (ez_hi + 1) * plane

    # global brick tables (node-grid order)
    t_host, metas, TOT = assemble_brick_tables(plan, tables,
                                               src_ids=src_ids)
    gm = metas[0]
    local_meta = BrickMeta(off=0, nb=tot_local,
                           S=tot_local - gm.offs[7], offs=gm.offs)
    d0, d1 = dev_slice if dev_slice is not None else (0, n_dev)
    st = SlabTables(
        n_dev=n_dev, nzp=nzp, nyp=nyp, nxp=nxp, tot_local=tot_local,
        meta=local_meta, dt=tables.dt, damping=tables.damping,
        m48=tables.m48, ez_of=ez_of, dev0=d0)
    n0s = z0s * plane

    cs = {k: [] for k in ("c1", "c2", "c3", "c4")}
    bks = ({k: [] for k in t_host["bkt"]}
           if tables.damping == "bkt" else None)
    vals, invm, m1 = [], [], []
    srcl, srcm = [], []
    L = len(src_ids) if src_ids is not None else 0

    def padded(v, real):
        """Zero-pad the last axis from `real` to tot_local."""
        if v.shape[-1] == tot_local:
            return v
        w = [(0, 0)] * (v.ndim - 1) + [(0, tot_local - v.shape[-1])]
        return np.pad(v, w)

    for d in range(d0, d1):
        ez_d = int(ez_of[d])
        n0 = int(n0s[d])
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
            v = plan.evalid_cat[n0:n1].astype(np.float64)
            v[ez_d * plane:] = 0.0
            vals.append(padded(v, real))
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
    st.gnid_local = [plan.gnid_cat[int(n0s[d]):int(n0s[d])
                                   + (int(ez_of[d]) + 1) * plane]
                     for d in range(n_dev)]
    if L:
        st.src_lidx = np.stack(srcl)
        st.src_mask = np.stack(srcm)
    if bks is not None:
        st.bkt = {k: np.stack(v) for k, v in bks.items()}
        st.bkt_valid = np.stack(vals)
        st.kmu = t_host["kmu_cat"]
        st.kkappa = t_host["kkappa_cat"]
        st.shear_only = bkt_kappa_zero(tables.bkt)
        E = len(np.asarray(tables.bkt["shear_c1"]))
        st.bk_scal = detect_bkt_uniform(
            tables.bkt, np.arange(E), np.ones(E, bool), st.shear_only)
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
    sources it owns (none at the ranks the tables do not hold)."""
    none = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    out = [none] * st.n_dev
    if st.src_lidx is not None:
        for i, (sl, sm) in enumerate(zip(st.src_lidx, st.src_mask)):
            out[st.dev0 + i] = (sl[sm].astype(np.int64), np.flatnonzero(sm))
    return out


class SlabStep:
    """The plain slab step of ``hercules_tpu/parallel/slab.py:
    slab_step_builder`` in torch ops, on a RankGroup.  State per rank:
    (u, u-) [3, tot_local], then with BKT (s0, s1, k0, k1) [24, S]."""

    def __init__(self, st: SlabTables, group, dtype):
        self.st, self.group, self.dtype = st, group, dtype
        self.bkt = st.damping == "bkt"
        m = st.meta
        self.plane = st.nyp * st.nxp
        self.tabs = [None] * group.size
        srcs = rank_sources(st)
        for r in group.local_ranks:
            dev, i = group.devices[r], st.row(r)
            f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                          device=dev)
            cut = lambda v: f(v[i][None, :m.S])
            t = {"mcat": f(st.m48.T), "inv_mass": f(st.inv_mass[i])[None],
                 "mass_minusaM": f(st.mass_minusaM[i])}
            if self.bkt:
                t["bkt"] = {k: cut(v) for k, v in st.bkt.items()}
                t["kmu_cat"] = f(st.kmu)
                t["kkappa_cat"] = f(st.kkappa)
            else:
                t.update({k: cut(v) for k, v in st.c.items()})
            lidx, _ = srcs[r]
            t["src_lidx"] = torch.as_tensor(lidx, device=dev)
            self.tabs[r] = t

    def init_state(self):
        """The ranks' zero state (None at the ranks of other
        processes)."""
        out = [None] * self.group.size
        for r in self.group.local_ranks:
            dev = self.group.devices[r]
            z = lambda shape: torch.zeros(shape, dtype=self.dtype,
                                          device=dev)
            u = z((3, self.st.tot_local))
            conv = (tuple(z((24, self.st.meta.S)) for _ in range(4)),) \
                if self.bkt else ()
            out[r] = (u, u) + conv
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
        loc = self.group.local_ranks
        forces, convs = [None] * P, [None] * P
        for r in loc:
            state, t = states[r], self.tabs[r]
            u, up = state[0], state[1]
            ue, upe = _elem_field(u, m), _elem_field(up, m)
            fe, cv = brick_force(t, lambda v: v, ue, upe,
                                 state[2] if self.bkt else None)
            force = u.new_zeros((3, st.tot_local))
            _scatter_back(force, fe, m)
            if srcf[r] is not None:
                force.index_add_(1, t["src_lidx"], srcf[r].T)
            forces[r], convs[r] = force, cv
        # halo exchange on the two shared node planes
        zbs = [int(st.ez_of[r]) * pl for r in range(P)]
        f_bot, f_top = [None] * P, [None] * P
        for r in loc:
            f_bot[r] = forces[r][:, zbs[r]:zbs[r] + pl]
            f_top[r] = forces[r][:, :pl]
        down = self.group.shift(f_bot, +1)
        up_ = self.group.shift(f_top, -1)
        out = [None] * P
        for r in loc:
            state, force, zb, t = states[r], forces[r], zbs[r], self.tabs[r]
            if r < P - 1:
                force[:, zb:zb + pl] = f_bot[r] + up_[r]
            if r > 0:
                force[:, :pl] = force[:, :pl] + down[r]
            u, up = state[0], state[1]
            # increment form (see solver/step.py)
            u_next = u + (force + t["mass_minusaM"] * (u - up)) \
                * t["inv_mass"]
            out[r] = (u_next, u) + ((convs[r],) if self.bkt else ())
        return out


def brick_fragment(plan, b, col0, ez, plane, tot_local):
    """The fragment of brick ``b`` of the plan that starts at its column
    col0 and holds ez element layers (ez + 1 node planes of ``plane``
    columns) as a one-brick plan: the brick's corner offsets over
    tot_local columns, and the columns' global node ids, element
    validity (the last local plane's elements zeroed: they belong to the
    next fragment) and element ids -- what
    ``fused_mesh.brick_step_module`` reads of a plan."""
    brick = plan.bricks[b]
    cut = slice(brick.off + col0, brick.off + col0 + (ez + 1) * plane)
    evalid = plan.evalid_cat[cut].copy()
    evalid[ez * plane:] = False
    return _FragmentPlan(
        bricks=[_Fragment(tot_local, tuple(brick.corner_offsets()))],
        gnid_cat=plan.gnid_cat[cut], evalid_cat=evalid,
        eidx_cat=plan.eidx_cat[cut])


def halo_views(K, invm_row, mm_rows, zb, plane):
    """What the halo reads of a fragment's constant table K: the
    inv_mass row and mass_minusaM rows of its top plane and of its
    bottom shared plane, which starts at column zb."""
    iv, m1 = K[invm_row], K[mm_rows]
    return ((iv[:plane], m1[:, :plane]),
            (iv[zb:zb + plane], m1[:, zb:zb + plane]), zb)


def halo_exchange(group, plane, views, Ss, uns):
    """The halo of one brick split over the ranks of ``group``, after
    each rank's kernel launch: Ss[r] rank r's state before the step
    (rows 0:3 u, 3:6 u-), uns[r] its next-step array (rows 0:3 u+,
    updated in place), views[r] its halo_views.  Each shared plane's
    force is recovered by linearity from the rank's own update,
    F = (u+ - u) / inv_mass - mass_minusaM (u - u-) (exact: the update
    is linear; the planes are real nodes, inv_mass > 0), the bottom
    plane's force shifted down the ring and the top plane's up, and
    both copies of each shared plane recomputed from scratch in one
    operand order -- the lower rank's force, then the upper rank's:
    u + (F_lower + F_upper + mass_minusaM (u - u-)) * inv_mass -- so
    that they hold the same bits.  The ends of the ring keep the
    kernel's update.  The lists are indexed by global rank; only the
    group's local ranks are read."""
    P, pl = group.size, plane
    f_top, f_bot = [None] * P, [None] * P
    for r in group.local_ranks:
        S, un, ((iv_t, m1_t), (iv_b, m1_b), zb) = Ss[r], uns[r], views[r]
        f_top[r] = ((un[0:3, :pl] - S[0:3, :pl]) / iv_t
                    - m1_t * (S[0:3, :pl] - S[3:6, :pl]))
        f_bot[r] = ((un[0:3, zb:zb + pl] - S[0:3, zb:zb + pl]) / iv_b
                    - m1_b * (S[0:3, zb:zb + pl] - S[3:6, zb:zb + pl]))
    down = group.shift(f_bot, +1)
    up_ = group.shift(f_top, -1)
    for r in group.local_ranks:
        S, un = Ss[r], uns[r]
        (iv_t, m1_t), (iv_b, m1_b), zb = views[r]
        if r > 0:
            u, du = S[0:3, :pl], S[0:3, :pl] - S[3:6, :pl]
            un[0:3, :pl] = u + (down[r] + f_top[r] + m1_t * du) * iv_t
        if r < P - 1:
            b = slice(zb, zb + pl)
            u, du = S[0:3, b], S[0:3, b] - S[3:6, b]
            un[0:3, b] = u + (f_bot[r] + up_[r] + m1_b * du) * iv_b


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


class FragmentSteps:
    """The per-rank, per-brick step modules of a fragmented plan, their
    launches into spare buffers and their halos: what the kernel slab
    step (SlabKernelStep, one brick) and the graded steps
    (gslab.GSlabStep, gmesh.GMeshStep) share.  ``mods[r][b]`` is rank r's
    module for brick b, ``tier`` "elastic" (K1), "uniform" (K2) or
    "corner" (K4)."""

    def _setup(self, bricks, group, dtype, tier):
        self.group, self.dtype, self.tier = group, dtype, tier
        self.bricks = bricks
        # K layout: elastic (c1, c2, beta, mm x 3, inv_mass, 0); BKT
        # (mm x 3, inv_mass, ...)
        self.invm_row, self.mm_rows = ((6, slice(3, 6)) if tier == "elastic"
                                       else (3, slice(0, 3)))
        P = group.size
        self.mods, self.views, self._spare = [None] * P, [None] * P, \
            [None] * P

    def _add_rank(self, r, mods):
        """Rank r's step modules, one per brick, and their halo views."""
        self.mods[r] = mods
        self.views[r] = [halo_views(mod.K, self.invm_row, self.mm_rows,
                                    int(fb.ez_of[r]) * fb.plane, fb.plane)
                         for mod, fb in zip(mods, self.bricks)]
        self._spare[r] = [None] * len(self.bricks)

    def _build_modules(self, plan, bricks, tables, group, dtype, tier,
                       masked=None):
        """The local ranks' modules from the global plan and tables."""
        self._setup(bricks, group, dtype, tier)
        kt = None if tier == "elastic" else tier
        for r in group.local_ranks:
            mods = []
            for b, fb in enumerate(bricks):
                kw = {} if masked is None else {"masked": masked(r, b)}
                frag = brick_fragment(plan, b, fb.frag_cols(r),
                                      int(fb.ez_of[r]), fb.plane,
                                      fb.tot_local)
                mod, LEN = brick_step_module(frag, 0, tables, dtype,
                                             group.devices[r], tier=kt, **kw)
                assert LEN == fb.LEN
                mods.append(mod)
            self._add_rank(r, mods)

    def zero_bricks(self, r):
        """Rank r's zero (Ss, convs)."""
        dev = self.group.devices[r]
        Ss = tuple(torch.zeros((8, fb.LEN), dtype=self.dtype, device=dev)
                   for fb in self.bricks)
        convs = tuple(
            tuple(torch.zeros(shape, dtype=dt, device=dev)
                  for shape, dt in mod.state_parts(fb.LEN))
            for mod, fb in zip(self.mods[r], self.bricks)) \
            if self.tier != "elastic" else ()
        return Ss, convs

    def launch(self, r, b, S, conv):
        """One launch of rank r's brick-b kernel from (S, conv) into the
        spare buffers: (S', conv')."""
        spare = self._spare[r][b]
        if spare is None or spare[0] is S:
            spare = (torch.empty_like(S),) + tuple(torch.empty_like(c)
                                                   for c in conv)
        mod = self.mods[r][b]
        if not conv:
            new = (mod(S, out=spare[0]), ())
        else:
            Sn, *cv = mod(S, *conv, out=spare[0], conv_out=spare[1])
            new = (Sn, tuple(cv))
        self._spare[r][b] = (S,) + tuple(conv)
        return new

    def add_sources(self, r, uns, src, f):
        """Add rank r's sources (brick, local columns, rows into f) with
        forces f [rows, 3] (dt^2 applied) into its next-step arrays as F
        * inv_mass."""
        for b, pos, rows in src:
            iv = self.mods[r][b].K[self.invm_row]
            uns[b][0:3].index_add_(1, pos, f[rows].T * iv[pos][None, :])

    def halos(self, Ss, uns):
        """The within-brick halo of every brick (halo_exchange);
        Ss[r], uns[r]: local rank r's per-brick arrays before and after
        its launches (None at other processes' ranks)."""
        def pick(xs, b):
            return [None if x is None else x[b] for x in xs]
        for b, fb in enumerate(self.bricks):
            halo_exchange(self.group, fb.plane, pick(self.views, b),
                          pick(Ss, b), pick(uns, b))


def slab_brick(st: SlabTables) -> FragmentedBrick:
    """The slab's one brick as a FragmentedBrick (its gnid_local left
    empty: the tables hold it)."""
    ez, ez_of, z0s = split_layers(st.nzp - 1, st.n_dev)
    return FragmentedBrick(plane=st.nyp * st.nxp, ez=ez,
                           tot_local=st.tot_local,
                           LEN=pallas_geometry(st.tot_local), ez_of=ez_of,
                           z0s=z0s)


def slab_step_module(st: SlabTables, r, dtype, device):
    """Rank r's step module on its fragment (the tier of
    slab_kernel_tier), its constants packed from the tables' own
    stacked arrays, as the JAX kernel slab step packs them
    (hercules_tpu/parallel/slab.py:420-466) -- so that shard-built
    tables, which have no global plan, drive the kernels.  K is the
    one brick_step_module builds on the rank's fragment plan, byte for
    byte: elastic (c1, c2, beta = c3 / c1, mass_minusaM, inv_mass, 0);
    K2 (mass_minusaM, inv_mass, element valid, 0 x 3) with the global
    coefficient set bk_scal; K4 (mass_minusaM, inv_mass, mu_f, kappa_f,
    the shear and kappa set indices) with the fragment's distinct
    coefficient rows.  BKT modules carry ``evalid`` for a restart
    (solver/restart.fit_conv)."""
    i, n = st.row(r), st.tot_local
    LEN = pallas_geometry(n)
    offs = tuple(int(o) for o in st.meta.offs)
    as_t = lambda x: None if x is None else torch.as_tensor(
        x, dtype=dtype, device=device)
    tier = slab_kernel_tier(st)
    K = np.zeros((8, LEN))
    if tier == "elastic":
        c1, c3 = st.c["c1"][i], st.c["c3"][i]
        K[0, :n], K[1, :n] = c1, st.c["c2"][i]
        K[2, :n] = np.divide(c3, c1, out=np.zeros_like(c1), where=c1 != 0)
        K[3:6, :n] = st.mass_minusaM[i]
        K[6, :n] = st.inv_mass[i]
        return BrickStep(as_t(K), offs)
    K[0:3, :n] = st.mass_minusaM[i]
    K[3, :n] = st.inv_mass[i]
    so = st.shear_only
    if tier == "uniform":
        K[4, :n] = st.bkt_valid[i]
        sc = st.bk_scal
        mod = BktStep(as_t(K), offs, (sc["mu_f"], sc["kappa_f"]),
                      recursion_scalars(sc, so), so)
    else:
        names = bk_row_names(so)
        rows = np.zeros((len(names), LEN))
        for j, k in enumerate(names):
            rows[j, :n] = st.bkt[k][i]
        K[4:6] = rows[-2:]
        sets = []
        for ch in range(1 if so else 2):
            s_, inv = _unique_rows(rows[9 * ch:9 * ch + 9].T)
            K[6 + ch] = inv
            sets.append(s_)
        tab = corner_tab(as_t(bkt_fm()), as_t(sets[0]),
                         None if so else as_t(sets[1]))
        mod = BktCornerStep(as_t(K), tab, offs, so)
    mod.evalid = np.zeros(LEN, bool)
    mod.evalid[:n] = st.bkt_valid[i] != 0
    mod.node_src = mod.mixed_cols = None
    return mod


class SlabKernelStep(FragmentSteps):
    """The JAX kernel slab step (``hercules_tpu/parallel/slab.py``,
    its Pallas step at :400-466) on a rank group: FragmentSteps on the
    one brick, each local rank's module packed from the tables' stacked
    arrays (slab_step_module), so the tables may be global
    (build_slab_tables) or shard-built (shardbuild.py).  State per
    rank: (S,) elastic, (S, conv) BKT, S [8, LEN] = (u, u-, 0, 0) and
    conv the tier's memory variables (K2: node basis [6 | 12, LEN]; K4:
    corner basis [48 | 96, LEN])."""

    def __init__(self, st: SlabTables, group, dtype):
        self.st = st
        fb = slab_brick(st)
        self._setup([fb], group, dtype, slab_kernel_tier(st))
        self.LEN = fb.LEN
        # per local rank: its sources as (brick 0, local columns, rows
        # of srcf)
        self.src = [None] * group.size
        srcs = rank_sources(st)
        for r in group.local_ranks:
            dev = group.devices[r]
            self._add_rank(r, [slab_step_module(st, r, dtype, dev)])
            lidx = srcs[r][0]
            self.src[r] = ([(0, torch.as_tensor(lidx, device=dev),
                             torch.arange(len(lidx), device=dev))]
                           if len(lidx) else [])

    def init_state(self):
        out = [None] * self.group.size
        for r in self.group.local_ranks:
            Ss, convs = self.zero_bricks(r)
            out[r] = Ss + (convs[0] if convs else ())
        return out

    @staticmethod
    def fields(state):
        return state[0][0:3], state[0][3:6]

    def step(self, states, srcf, step_idx=None, fb_disp=None):
        """One step of every local rank; srcf[r]: rank r's owned
        sources' forces [Lr, 3] (dt^2 applied) or None.  (``step_idx``
        and ``fb_disp``, the sharded step's, are not used.)"""
        P = self.group.size
        news = [None] * P
        for r in self.group.local_ranks:
            state = states[r]
            S, conv = self.launch(r, 0, state[0], state[1:])
            if srcf[r] is not None:
                self.add_sources(r, [S], self.src[r], srcf[r])
            news[r] = (S,) + conv
        pick = lambda xs: [None if x is None else x[:1] for x in xs]
        self.halos(pick(states), pick(news))
        return news
