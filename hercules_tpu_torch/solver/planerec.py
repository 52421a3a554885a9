"""Dense plane reconciliation for depth-graded brick meshes.

Counterpart of ``hercules_tpu/solver/planerec.py``: ``build`` is its
numpy host side, copied (the device tables become torch tensors), and
the algebra (``hanging_algebra``, ``same_level_algebra``, ``_plane``,
``_put``, ``_upsample``, ``apply``) is ported to torch.  The JAX
package's ``HT_PLANE_RECONCILE`` switch is not ported: the mesh tables
take the reconciler as an argument (``fused_mesh.MeshPallasTables``).

On a depth-graded octree (the production terashake/CVM shape) every
brick interface is a full horizontal z-plane of both bricks' node
grids, so the interface algebra is dense arithmetic on [3, ny, nx]
plane arrays instead of gathers, segment sums and scatters:

- 2:1 hanging interface (fine brick F over/under coarse brick C, level
  difference 1): coarse plane nodes coincide with even-even fine plane
  nodes; odd-parity fine nodes are the dangling nodes
  (octor.c:3294-3857 classification).  The reference's 4-exchange
  reconciliation (schedule_senddata + compute_adjust DISTRIBUTION /
  ASSIGNMENT, psolve.c:4296-4316, 5936-6039) collapses to:

    F_f, F_c     force recovery by linearity from the per-brick kernel
                 outputs: F = (u_next - u)*mass - mass_minusaM*(u-up)
    tot          F_f + upsample(F_c) (+ source forces)
    distribute   two separable shifted-add passes (y then x): edge
                 dangling spread 1/2 to their 2 anchors, face dangling
                 1/4 to their 4 corner anchors (via the composition)
    update       u+ = u + (tot + mass_minusaM*(u-up)) / mass (anchors)
    assign       reverse separable passes: dangling = mean of anchors

- same-level interface (two bricks of one level sharing a z-plane):
  tot = F_a + F_b, update, write both sides.

Everything is verified exhaustively at build time against the generic
plan's group/dangling tables (gnid identity of coincident nodes,
anchor sets, weights); any mesh that does not decompose into such
planes returns None and the index-based epilogue runs instead.

A plane of a brick is a view of its [C, LEN] state (``_plane``): the
brick's first nb columns as its (outer, mid, inner) node grid in the
storage order of ``Brick.axes``, at one index of the z axis, wherever
that axis sits.  ``apply`` writes the reconciled planes into rows 0:3
of the next-step states in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..mesh.octree import PIXELLEVEL


@dataclass
class _Hanging:
    fi: int                  # fine brick index
    ci: int                  # coarse brick index
    zf: int                  # fine plane index (0 or nzf)
    zc: int                  # coarse plane index
    nyf: int                 # fine plane node dims (storage order)
    nxf: int
    nyc: int
    nxc: int
    # storage geometry for plane extraction (Brick.axes ordering)
    nbf: int = 0             # fine brick node count
    dims_f: tuple = ()       # fine storage dims
    zpos_f: int = 0          # position of the z axis in storage order
    nbc: int = 0
    dims_c: tuple = ()
    zpos_c: int = 0
    # device tables, shaped [*, nyf, nxf] on the fine plane grid
    mass: object = None      # [1, nyf, nxf]
    mm: object = None        # [3, nyf, nxf]
    invm: object = None      # [1, nyf, nxf]
    mass_c: object = None    # [1, nyc, nxc]
    mm_c: object = None      # [3, nyc, nxc]
    src: list = field(default_factory=list)   # (srcf row, iy, ix)
    src_t: object = None     # src as index tensors (rows, iy, ix)
    my: object = None        # [1, nyf, 1] 1.0 at odd rows of the plane
    mx: object = None        # [1, 1, nxf] 1.0 at odd columns


@dataclass
class _SameLevel:
    ai: int
    bi: int
    za: int
    zb: int
    ny: int
    nx: int
    nba: int = 0
    dims_a: tuple = ()
    zpos_a: int = 0
    nbb: int = 0
    dims_b: tuple = ()
    zpos_b: int = 0
    mass: object = None
    mm: object = None
    invm: object = None
    mass_b: object = None
    mm_b: object = None
    src: list = field(default_factory=list)
    src_t: object = None


def _brick_tickbox(b):
    sh = PIXELLEVEL - b.level
    lo = np.asarray(b.origin, np.int64) << sh
    hi = (np.asarray(b.origin, np.int64)
          + np.asarray(b.shape, np.int64)) << sh
    return lo, hi


def _src_tensors(src, device):
    """(rows, iy, ix) int64 index tensors of a plane's source list, or
    None without sources."""
    if not src:
        return None
    return tuple(torch.as_tensor(np.asarray(c, np.int64), device=device)
                 for c in zip(*src))


class PlaneReconciler:
    """Dense-plane replacement for the index reconciliation epilogue.

    Use build(); returns None unless the plan decomposes into verified
    full z-plane interfaces."""

    def __init__(self, hang, same):
        self.hang = hang
        self.same = same

    # -- construction -----------------------------------------------------

    @staticmethod
    def analyse(plan):
        """(hanging planes, same-level planes) of a plan whose shared
        copies are all full z-plane interfaces, else None: the geometry
        of build() without its tables (the routing rules read it)."""
        mesh = plan.mesh
        bricks = plan.bricks
        NB = len(bricks)
        if NB < 2 or len(plan.loose_eidx) or len(plan.grp_node) == 0:
            return None

        g = plan.gnid_cat
        N = mesh.nnum
        # global node -> group id (or -1)
        node2grp = -np.ones(N, np.int64)
        node2grp[plan.grp_node] = np.arange(len(plan.grp_node))
        copies = np.bincount(plan.ex_seg,
                             minlength=len(plan.grp_node))

        # dangling info keyed by global node id
        dn_of = -np.ones(N, np.int64)
        dn_of[mesh.dn_ids] = np.arange(len(mesh.dn_ids))

        sh_of = [PIXELLEVEL - b.level for b in bricks]

        def plane_gnid(b, z):
            """Global node ids of brick b's z-plane, [dA, dB] in the
            brick's storage order of the two non-z axes (Brick.axes
            may put an elongated x or y axis outermost)."""
            zpos = b.axes.index(2)
            grid = g[b.off: b.off + b.nb].reshape(b.node_shape)
            return np.take(grid, z, axis=zpos)

        def plane_axes(b):
            return tuple(a for a in b.axes if a != 2)

        explained_pairs = 0
        explained_dn = np.zeros(len(mesh.dn_ids), bool)
        hang: List[_Hanging] = []
        same: List[_SameLevel] = []

        for i in range(NB):
            for j in range(i + 1, NB):
                bi, bj = bricks[i], bricks[j]
                loi, hii = _brick_tickbox(bi)
                loj, hij = _brick_tickbox(bj)
                lo = np.maximum(loi, loj)
                hi = np.minimum(hii, hij)
                if (lo > hi).any():
                    continue                      # no contact
                deg = lo == hi
                if deg.sum() != 1:
                    continue                      # corner/edge contact
                if not deg[2]:
                    return None                   # x/y-face: not dense
                if (lo[:2] != loi[:2]).any() or (hi[:2] != hii[:2]).any() \
                        or (lo[:2] != loj[:2]).any() \
                        or (hi[:2] != hij[:2]).any():
                    return None                   # partial face overlap
                zt = lo[2]
                if bi.level == bj.level:
                    za = int((zt >> sh_of[i]) - bi.origin[2])
                    zb = int((zt >> sh_of[j]) - bj.origin[2])
                    if plane_axes(bi) != plane_axes(bj):
                        return None   # incompatible in-plane orders
                    ga = plane_gnid(bi, za)
                    gb = plane_gnid(bj, zb)
                    if ga.shape != gb.shape or not (ga == gb).all():
                        return None
                    grp = node2grp[ga.ravel()]
                    if (grp < 0).any() or not (copies[grp] == 2).all():
                        return None
                    if dn_of[ga.ravel()].max() >= 0:
                        return None   # dangling on a conforming plane
                    explained_pairs += ga.size
                    same.append(_SameLevel(
                        ai=i, bi=j, za=za, zb=zb,
                        ny=ga.shape[0], nx=ga.shape[1],
                        nba=bi.nb, dims_a=bi.node_shape,
                        zpos_a=bi.axes.index(2),
                        nbb=bj.nb, dims_b=bj.node_shape,
                        zpos_b=bj.axes.index(2)))
                    continue
                # hanging: level difference must be exactly 1
                fi, ci = (i, j) if bi.level > bj.level else (j, i)
                bf, bc = bricks[fi], bricks[ci]
                if bf.level != bc.level + 1:
                    return None
                if plane_axes(bf) != plane_axes(bc):
                    return None       # incompatible in-plane orders
                zf = int((zt >> sh_of[fi]) - bf.origin[2])
                zc = int((zt >> sh_of[ci]) - bc.origin[2])
                gf = plane_gnid(bf, zf)
                gc = plane_gnid(bc, zc)
                nyf, nxf = gf.shape
                nyc, nxc = gc.shape
                if nyf != 2 * nyc - 1 or nxf != 2 * nxc - 1:
                    return None
                if not (gf[::2, ::2] == gc).all():
                    return None                   # grids misaligned
                # coincident (anchor) nodes: exactly 2 copies each
                grp = node2grp[gc.ravel()]
                if (grp < 0).any() or not (copies[grp] == 2).all():
                    return None
                if dn_of[gc.ravel()].max() >= 0:
                    return None
                explained_pairs += gc.size
                # odd-parity fine nodes: dangling with the expected
                # anchors and weights
                iy, ix = np.meshgrid(np.arange(nyf), np.arange(nxf),
                                     indexing="ij")
                odd = (iy % 2 == 1) | (ix % 2 == 1)
                dids = dn_of[gf[odd]]
                if (dids < 0).any():
                    return None
                if explained_dn[dids].any():
                    return None                   # double-explained
                # expected anchors per parity class
                ys, xs = iy[odd], ix[odd]
                anc = np.zeros((len(ys), 4), np.int64)
                wgt = np.zeros((len(ys), 4))
                xe = (ys % 2 == 0)                # x-edge: odd x only
                ye = (xs % 2 == 0)                # y-edge: odd y only
                fa = ~(xe | ye)                   # face: both odd
                anc[xe, 0] = gf[ys[xe], xs[xe] - 1]
                anc[xe, 1] = gf[ys[xe], xs[xe] + 1]
                wgt[xe, :2] = 0.5
                anc[ye, 0] = gf[ys[ye] - 1, xs[ye]]
                anc[ye, 1] = gf[ys[ye] + 1, xs[ye]]
                wgt[ye, :2] = 0.5
                anc[fa, 0] = gf[ys[fa] - 1, xs[fa] - 1]
                anc[fa, 1] = gf[ys[fa] - 1, xs[fa] + 1]
                anc[fa, 2] = gf[ys[fa] + 1, xs[fa] - 1]
                anc[fa, 3] = gf[ys[fa] + 1, xs[fa] + 1]
                wgt[fa, :] = 0.25
                have_a = mesh.dn_anchors[dids]
                have_w = mesh.dn_weights[dids]
                # compare as weight-keyed sets (order-insensitive)
                def keyed(a, w):
                    return np.sort(np.where(w > 0, a * 8
                                            + (w * 8).astype(np.int64),
                                            -1), axis=1)
                if not (keyed(anc, wgt) == keyed(have_a, have_w)).all():
                    return None
                explained_dn[dids] = True
                hang.append(_Hanging(
                    fi=fi, ci=ci, zf=zf, zc=zc,
                    nyf=nyf, nxf=nxf, nyc=nyc, nxc=nxc,
                    nbf=bf.nb, dims_f=bf.node_shape,
                    zpos_f=bf.axes.index(2),
                    nbc=bc.nb, dims_c=bc.node_shape,
                    zpos_c=bc.axes.index(2)))

        if not explained_dn.all():
            return None
        if explained_pairs + int(explained_dn.sum()) \
                != len(plan.grp_node):
            return None
        return hang, same

    @staticmethod
    def build(plan, tables, src_ids=None, dtype=torch.float32,
              device="cpu"):
        found = PlaneReconciler.analyse(plan)
        if found is None:
            return None
        hang, same = found
        bricks = plan.bricks
        g = plan.gnid_cat
        node2grp = -np.ones(plan.mesh.nnum, np.int64)
        node2grp[plan.grp_node] = np.arange(len(plan.grp_node))

        def plane_gnid(b, z):
            zpos = b.axes.index(2)
            grid = g[b.off: b.off + b.nb].reshape(b.node_shape)
            return np.take(grid, z, axis=zpos)

        # ---- device tables ------------------------------------------
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                      device=device)
        mass = 1.0 / tables.inv_mass

        def tabs(gn):
            return (f(mass[gn])[None], f(tables.mass_minusaM[gn]
                                         ).permute(2, 0, 1),
                    f(tables.inv_mass[gn])[None])

        src_pos = {}
        if src_ids is not None:
            for r, sid in enumerate(np.asarray(src_ids)):
                if node2grp[sid] >= 0:
                    src_pos.setdefault(int(sid), []).append(r)

        used_rows = []
        for h in hang:
            gf = plane_gnid(bricks[h.fi], h.zf)
            gc = plane_gnid(bricks[h.ci], h.zc)
            h.mass, h.mm, h.invm = tabs(gf)
            h.mass_c = f(mass[gc])[None]
            h.mm_c = f(tables.mass_minusaM[gc]).permute(2, 0, 1)
            for (iy, ix), sid in np.ndenumerate(gf):
                if int(sid) in src_pos:
                    for r in src_pos[int(sid)]:
                        h.src.append((r, int(iy), int(ix)))
                        used_rows.append(r)
            h.src_t = _src_tensors(h.src, device)
            h.my = f(np.arange(h.nyf) % 2)[None, :, None]
            h.mx = f(np.arange(h.nxf) % 2)[None, None, :]
        for s in same:
            ga = plane_gnid(bricks[s.ai], s.za)
            gb = plane_gnid(bricks[s.bi], s.zb)
            s.mass, s.mm, s.invm = tabs(ga)
            s.mass_b = f(mass[gb])[None]
            s.mm_b = f(tables.mass_minusaM[gb]).permute(2, 0, 1)
            for (iy, ix), sid in np.ndenumerate(ga):
                if int(sid) in src_pos:
                    for r in src_pos[int(sid)]:
                        s.src.append((r, int(iy), int(ix)))
                        used_rows.append(r)
            s.src_t = _src_tensors(s.src, device)

        # every group-level source must land on exactly one interface
        want = sorted(r for rows in src_pos.values() for r in rows)
        if sorted(used_rows) != want:
            return None

        return PlaneReconciler(hang, same)

    # -- device step -------------------------------------------------------

    @staticmethod
    def _add_sources(tot, srcf, src):
        """tot [3, ny, nx] with srcf's rows added at their plane nodes
        (src: the (rows, iy, ix) index tensors, or None)."""
        if src is None:
            return tot
        rows, iy, ix = src
        ch = torch.arange(3, device=tot.device)[:, None]
        return tot.index_put_((ch, iy[None], ix[None]),
                              srcf[rows].T.to(tot.dtype), accumulate=True)

    @staticmethod
    def hanging_algebra(uf, upf, unf, uc, upc, unc, h, srcf=None,
                        src=None):
        """The full 2:1 plane reconciliation on gathered plane fields:
        force recovery, coarse upsample, separable distribute, nodal
        update, separable assign.  Returns the reconciled fine-plane
        field [3, nyf, nxf] (coarse plane = its [::2, ::2])."""
        my, mx = h.my, h.mx

        def nby(v):
            """v[:, i-1] + v[:, i+1], zero past the edges."""
            p = F.pad(v, (0, 0, 1, 1))
            return p[:, :-2] + p[:, 2:]

        def nbx(v):
            p = F.pad(v, (1, 1))
            return p[:, :, :-2] + p[:, :, 2:]

        duf = uf - upf
        mmdu = h.mm * duf
        Ff = (unf - uf) * h.mass - mmdu
        Fc = (unc - uc) * h.mass_c - h.mm_c * (uc - upc)
        tot = Ff + PlaneReconciler._upsample(Fc, h.nyf, h.nxf)
        tot = PlaneReconciler._add_sources(tot, srcf, src)
        # distribute (y then x): edge 1/2, face 1/4 via composition
        t1 = tot + 0.5 * nby(tot * my)
        t2 = t1 + 0.5 * nbx(t1 * mx)
        unv = uf + (t2 + mmdu) * h.invm
        # assign (y then x): dangling = mean of anchors
        a = unv * (1 - my)
        v1 = a + 0.5 * my * nby(a)
        b = v1 * (1 - mx)
        return b + 0.5 * mx * nbx(b)

    @staticmethod
    def same_level_algebra(ua, upa, una, ub, upb, unb, s, srcf=None,
                           src=None):
        """Conforming shared-plane reconciliation: sum the two sides'
        forces and update once.  Returns the reconciled plane field."""
        dua = ua - upa
        tot = ((una - ua) * s.mass - s.mm * dua
               + (unb - ub) * s.mass_b - s.mm_b * (ub - upb))
        tot = PlaneReconciler._add_sources(tot, srcf, src)
        return ua + (tot + s.mm * dua) * s.invm

    @staticmethod
    def _plane(arr, nb, dims, zpos, z):
        """[C, dA, dB] view of the plane at index z along the storage z
        axis (position zpos of dims) of a (padded) flat brick field [C,
        >=nb]."""
        return arr[:, :nb].view(arr.shape[0], *dims).select(1 + zpos, z)

    @staticmethod
    def _put(arr, vals, nb, dims, zpos, z):
        """Write the plane vals [Cv, dA, dB] into rows 0:Cv of arr in
        place (the other rows pass through); returns arr."""
        PlaneReconciler._plane(arr[:vals.shape[0]], nb, dims, zpos,
                               z).copy_(vals)
        return arr

    @staticmethod
    def _upsample(c, nyf, nxf):
        """[3, nyc, nxc] -> [3, nyf, nxf] zeros at odd positions."""
        out = c.new_zeros((c.shape[0], nyf, nxf))
        out[:, ::2, ::2] = c
        return out

    def apply(self, us, ups, uns, srcf):
        """Reconcile the per-brick next-step fields.  us/ups are [3, *]
        displacement arrays (or row views); uns entries may be packed
        [8, *] states, whose rows 0:3 take the reconciled planes in
        place.  srcf [L, 3] the step's source forces (times dt^2), or
        None without sources."""
        for h in self.hang:
            pf = lambda a: self._plane(a[:3], h.nbf, h.dims_f, h.zpos_f,
                                       h.zf)
            pc = lambda a: self._plane(a[:3], h.nbc, h.dims_c, h.zpos_c,
                                       h.zc)
            v2 = self.hanging_algebra(
                pf(us[h.fi]), pf(ups[h.fi]), pf(uns[h.fi]),
                pc(us[h.ci]), pc(ups[h.ci]), pc(uns[h.ci]),
                h, srcf=srcf, src=h.src_t)
            self._put(uns[h.fi], v2, h.nbf, h.dims_f, h.zpos_f, h.zf)
            self._put(uns[h.ci], v2[:, ::2, ::2], h.nbc, h.dims_c,
                      h.zpos_c, h.zc)

        for s in self.same:
            pa = lambda a: self._plane(a[:3], s.nba, s.dims_a, s.zpos_a,
                                       s.za)
            pb = lambda a: self._plane(a[:3], s.nbb, s.dims_b, s.zpos_b,
                                       s.zb)
            unv = self.same_level_algebra(
                pa(us[s.ai]), pa(ups[s.ai]), pa(uns[s.ai]),
                pb(us[s.bi]), pb(ups[s.bi]), pb(uns[s.bi]),
                s, srcf=srcf, src=s.src_t)
            self._put(uns[s.ai], unv, s.nba, s.dims_a, s.zpos_a, s.za)
            self._put(uns[s.bi], unv, s.nbb, s.dims_b, s.zpos_b, s.zb)

        return uns
