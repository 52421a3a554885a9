"""Multi-chip graded-mesh solver: the stacked slab decomposition.

Counterpart of ``hercules_tpu/parallel/gslab.py``; the JAX names are
kept (``GSlabTables``, ``build_gslab_tables``, ``gslab_u_global``).  The
production large-CVM configuration is a depth-graded octree: one brick
per resolution level, stacked in z, with 2:1 plane interfaces.  Here
every brick is split in z over all the ranks of a ``ranks.RankGroup``
(``slab.split_bricks``: the slab's uneven split, (ez_hi + 1)-plane padded
buffer, the last plane's elements masked), so each rank holds one
z-fragment of every brick.  Per step (``GSlabStep``):

- per brick and rank, one launch of the brick's step kernel on the
  fragment (``fused_mesh.brick_step_module`` on a one-brick fragment
  plan, ``slab.brick_fragment``): K1 (Rayleigh, mass or no damping:
  the port's K1 reads per-column coefficients, so the JAX package's
  ``_tier_kco`` specialisation, gslab.py:295-297, has no counterpart),
  K2 when every brick has one BKT coefficient set (the JAX package's
  ``st.bk_scal``), K4 on every brick otherwise (``gslab.py:112-139``
  decides for the whole plan; the single-device mesh route's per-brick
  tiers would be another algebra); the sources each rank owns added to
  its kernel output;
- per brick, the slab halo (``slab.halo_exchange``);
- per 2:1 hanging interface and per same-level interface of
  ``planerec.PlaneReconciler`` (every interface a full z-plane of both
  bricks: the fine or first plane on one end rank, the coarse or second
  on the other), the owner of the coarse plane ``send``s its (u, u-,
  u+) triplet to the fine plane's owner, which runs
  ``PlaneReconciler.hanging_algebra`` (or ``same_level_algebra``) once
  and ``send``s the reconciled plane back (``gslab.py:432-466``; JAX
  computes the algebra on every device and keeps it where idx == df,
  the same bits).

State per rank: (Ss,) elastic or (Ss, convs) with BKT, Ss the bricks'
packed S [8, LEN_b] = (u, u-, 0, 0), convs the bricks' memory-variable
tuples (K2: node basis [6 | 12, LEN_b]; K4: corner basis [48 | 96,
LEN_b]).  The JAX package's unpacked state (``HT_GSLAB_PACKED``,
``HT_BKT_UNIFORM``) is not ported: one layout, so K1' has no route of
its own.  On the CPU the kernels' plain versions run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..solver.bricks import build_plan
from ..solver.fused_bkt import bkt_kappa_zero, detect_bkt_uniform
from ..solver.fused_mesh import first_concat_copy
from ..solver.planerec import PlaneReconciler
from .slab import FragmentedBrick, FragmentSteps, split_bricks


def end_owner(fb, z_plane):
    """(rank, local plane) of a brick-end plane: plane 0 is rank 0's
    first; the last is the last rank's ez_of[-1]-th (the extra layers of
    an uneven split go to the first ranks)."""
    n_dev = len(fb.ez_of)
    return (0, 0) if z_plane == 0 else (n_dev - 1, int(fb.ez_of[-1]))


@dataclass
class GSlabTables:
    n_dev: int
    damping: str
    plan: object
    tables: object               # the global SolverTables
    bricks: List[FragmentedBrick]
    hang: list                   # PlaneReconciler.analyse's interfaces
    same: list
    hang_own: list               # per hang: (df, lzf, dc, lzc)
    same_own: list               # per same: (da, lza, db, lzb)
    tier: str = "elastic"        # "elastic" (K1), "uniform" (K2), "corner"
    # per rank: (brick, local columns, source rows) of the sources it
    # owns (a source at its node's first concat copy; the top plane of a
    # fragment after the first belongs to the rank below)
    src: list = None
    N: int = 0


def build_gslab_tables(mesh, tables, n_dev, src_ids=None,
                       min_brick_elems=2048, plan=None) -> GSlabTables:
    """Split every brick of a depth-graded plan over n_dev ranks (the
    storage axes pinned to (z, y, x), ``legacy_axes=True``, as
    gslab.py:96-97 does; ``plan``: that plan where the caller has it).
    Raises RuntimeError, so that the automatic path choice falls
    through, for fewer than 2 bricks or any loose element, interfaces
    that are not full z-planes, and a brick with fewer element layers
    than ranks."""
    if plan is None:
        plan = build_plan(mesh, min_brick_elems=min_brick_elems,
                          legacy_axes=True)
    if len(plan.bricks) < 2 or len(plan.loose_eidx):
        raise RuntimeError("graded slab needs >=2 dense bricks and no "
                           "loose elements")
    found = PlaneReconciler.analyse(plan)
    if found is None:
        raise RuntimeError("mesh interfaces do not decompose into full "
                           "z-planes; use the unstructured path")
    bricks = split_bricks(plan, n_dev)
    hang, same = found
    st = GSlabTables(n_dev=n_dev, damping=tables.damping, plan=plan,
                     tables=tables, bricks=bricks, hang=hang, same=same,
                     hang_own=[], same_own=[], N=mesh.nnum)
    if tables.damping == "bkt":
        shear_only = bkt_kappa_zero(tables.bkt)
        uniform = all(detect_bkt_uniform(
            tables.bkt, plan.eidx_cat[b.off:b.off + b.nb],
            plan.evalid_cat[b.off:b.off + b.nb], shear_only) is not None
            for b in plan.bricks)
        st.tier = "uniform" if uniform else "corner"

    # sources: the first concat copy's brick and the lowest rank holding
    # it (slab.py's rule, per brick)
    st.src = [[] for _ in range(n_dev)]
    if src_ids is not None and len(src_ids):
        pos = first_concat_copy(plan, src_ids, what="source node")
        for bi, (b, fb) in enumerate(zip(plan.bricks, bricks)):
            for r in range(n_dev):
                n0 = b.off + fb.frag_cols(r)
                mine = (pos >= n0) & (pos < n0 + (int(fb.ez_of[r]) + 1)
                                      * fb.plane)
                if r > 0:
                    mine &= pos >= n0 + fb.plane
                if mine.any():
                    st.src[r].append((bi, pos[mine] - n0,
                                      np.flatnonzero(mine)))

    for h in hang:
        st.hang_own.append(end_owner(bricks[h.fi], h.zf)
                           + end_owner(bricks[h.ci], h.zc))
    for s in same:
        st.same_own.append(end_owner(bricks[s.ai], s.za)
                           + end_owner(bricks[s.bi], s.zb))
    return st


def gslab_u_global(st, Ss_ranks, N=None, row0=0):
    """Global [N, 3] field (numpy) from the ranks' per-brick arrays:
    rows row0:row0 + 3 of Ss_ranks[r][b] (u at row0 0, u- at 3 of a
    packed state)."""
    N = st.N if N is None else N
    u = None
    for r, Ss in enumerate(Ss_ranks):
        for fb, S in zip(st.bricks, Ss):
            a = torch.as_tensor(S)[row0:row0 + 3].cpu().numpy()
            if u is None:
                u = np.zeros((N, 3), a.dtype)
            g = fb.gnid_local[r]
            u[g] = a[:, :len(g)].T
    return u


class GSlabStep(FragmentSteps):
    """The graded stacked-slab step of ``hercules_tpu/parallel/gslab.py:
    gslab_step_builder`` on a RankGroup (see the module docstring)."""

    def __init__(self, st: GSlabTables, group, dtype):
        self.st = st
        self._build_modules(st.plan, st.bricks, st.tables, group, dtype,
                            st.tier)
        # the plane reconcilers' tables on the devices of the local
        # ranks that run an interface's algebra
        self.recs = {}
        for own in st.hang_own + st.same_own:
            if not group.is_local(own[0]):
                continue
            dev = group.devices[own[0]]
            if dev not in self.recs:
                self.recs[dev] = PlaneReconciler.build(
                    st.plan, st.tables, dtype=dtype, device=dev)
        # per rank: the source rows it owns (its srcf's rows), and per
        # local rank and brick (local columns, positions among those
        # rows)
        self.rows = [np.unique(np.concatenate([rows for _, _, rows in s]))
                     if s else np.zeros(0, np.int64) for s in st.src]
        self.src = [None] * group.size
        for r in group.local_ranks:
            dev = group.devices[r]
            self.src[r] = [
                (b, torch.as_tensor(pos, device=dev),
                 torch.as_tensor(np.searchsorted(self.rows[r], rows),
                                 device=dev))
                for b, pos, rows in st.src[r]]

    def init_state(self):
        out = [None] * self.group.size
        for r in self.group.local_ranks:
            Ss, convs = self.zero_bricks(r)
            out[r] = (Ss,) if self.tier == "elastic" else (Ss, convs)
        return out

    def _plane(self, a, b, lz):
        pl = self.st.bricks[b].plane
        return a[0:3, lz * pl:(lz + 1) * pl]

    def step(self, states, srcf, step_idx=None, fb_disp=None):
        """One step of every local rank; srcf[r]: the forces [Lr, 3]
        (dt^2 applied) of rank r's source rows (``rows[r]``), or None.
        (``step_idx`` and ``fb_disp``, the sharded step's, are not
        used.)"""
        st, group = self.st, self.group
        NB, P = len(st.bricks), group.size
        Ss = [None if s is None else s[0] for s in states]
        uns, convs = [None] * P, [None] * P
        for r in group.local_ranks:
            state = states[r]
            conv = state[1] if len(state) > 1 else ((),) * NB
            new = [self.launch(r, b, Ss[r][b], conv[b]) for b in range(NB)]
            uns[r] = [n[0] for n in new]
            if srcf[r] is not None:
                self.add_sources(r, uns[r], self.src[r], srcf[r])
            convs[r] = tuple(n[1] for n in new)
        self.halos(Ss, uns)

        def triplet(r, b, lz):
            return torch.cat([self._plane(Ss[r][b], b, lz),
                              self._plane(Ss[r][b][3:6], b, lz),
                              self._plane(uns[r][b], b, lz)])

        def put(r, b, lz, v):
            self._plane(uns[r][b], b, lz).copy_(v.reshape(3, -1))

        def buffer(r, b, rows):
            """What rank r receives of brick b's plane: [rows, plane]."""
            return torch.empty((rows, st.bricks[b].plane), dtype=self.dtype,
                               device=group.devices[r])

        # each interface: its coarse (or second) plane's triplet to the
        # fine (or first) plane's rank, the algebra there, the result
        # back; a process runs the parts of its own ranks
        for i, (df, lzf, dc, lzc) in enumerate(st.hang_own):
            fi, ci = st.hang[i].fi, st.hang[i].ci
            if group.is_local(dc):
                coarse = triplet(dc, ci, lzc)
            elif group.is_local(df):
                coarse = buffer(df, ci, 9)
            else:
                continue
            if df != dc:
                coarse = group.send(coarse, dc, df)
            if group.is_local(df):
                h = self.recs[group.devices[df]].hang[i]
                fine = triplet(df, fi, lzf).view(9, h.nyf, h.nxf)
                coarse = coarse.view(9, h.nyc, h.nxc)
                v2 = PlaneReconciler.hanging_algebra(
                    fine[0:3], fine[3:6], fine[6:9],
                    coarse[0:3], coarse[3:6], coarse[6:9], h)
                put(df, fi, lzf, v2)
                v2c = v2[:, ::2, ::2].contiguous()
            else:
                v2c = buffer(dc, ci, 3)
            if df != dc:
                v2c = group.send(v2c, df, dc)
            if group.is_local(dc):
                put(dc, ci, lzc, v2c)

        for i, (da, lza, db, lzb) in enumerate(st.same_own):
            ai, bi = st.same[i].ai, st.same[i].bi
            if group.is_local(db):
                tb = triplet(db, bi, lzb)
            elif group.is_local(da):
                tb = buffer(da, bi, 9)
            else:
                continue
            if da != db:
                tb = group.send(tb, db, da)
            if group.is_local(da):
                s = self.recs[group.devices[da]].same[i]
                ta = triplet(da, ai, lza).view(9, s.ny, s.nx)
                tb = tb.view(9, s.ny, s.nx)
                unv = PlaneReconciler.same_level_algebra(
                    ta[0:3], ta[3:6], ta[6:9], tb[0:3], tb[3:6], tb[6:9], s)
                put(da, ai, lza, unv)
            else:
                unv = buffer(db, bi, 3)
            if da != db:
                unv = group.send(unv, da, db)
            if group.is_local(db):
                put(db, bi, lzb, unv)

        out = [None] * P
        for r in group.local_ranks:
            out[r] = ((tuple(uns[r]),) if self.tier == "elastic"
                      else (tuple(uns[r]), convs[r]))
        return out
