"""Block-structured ("brick") reorganization of the octree mesh.

Why: on TPU, XLA gathers/scatters run ~50M rows/s while dense slices
and elementwise ops run at HBM bandwidth (~100x faster).  The
reference's unstructured element tables (octor.c mesh extraction) are
therefore the wrong layout for the hot loop.  An octree mesh is
piecewise *uniform*: grouping same-level leaves into rectangular,
fully-occupied bricks turns the element kernel into shifted dense
slices + one small-matrix MXU contraction per brick, with irregular
gather/scatter only on the (small) brick-interface node set.

This module builds the decomposition and the per-brick device tables:

- recursive bisection of each level's cell set into fully-occupied
  boxes (empty boxes dropped), so no masking is needed for occupancy
- per brick: a flat node grid (row-major z, y, x) whose 8 stencil
  offsets are constant flat strides; element coefficient grids padded
  onto the node grid (zero on the last row/col/slab)
- a copy table mapping brick-grid nodes to global mesh nodes, from
  which the inter-brick reconciliation plan (shared copies, dangling
  dependence groups) is derived.

Physics semantics are identical to the unstructured solver
(solver/step.py), which remains the cross-check oracle.

A numpy copy of ``hercules_tpu/solver/bricks.py`` (whose package
imports jax).  One difference: the storage-axis rule reads the JAX
package's default tile (32768 columns) instead of ``HT_PALLAS_TILE``,
so the plans equal the JAX package's default ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from hercules_tpu.etree import morton
from hercules_tpu.mesh.extract import MeshArrays, _key128
from hercules_tpu.mesh.octree import PIXELLEVEL

# the JAX fused kernel's default column tile: bricks whose legacy
# stencil reach exceeds it get the reordered storage axes (Brick.axes)
JAX_DEFAULT_TILE = 32768


@dataclass
class Brick:
    level: int
    origin: np.ndarray        # [3] cell coords (ix, iy, iz) on level grid
    shape: np.ndarray         # [3] (nx, ny, nz) in elements
    # filled by build_brick_tables:
    off: int = 0              # offset into the concatenated node buffer
    nb: int = 0               # node count (nz+1)(ny+1)(nx+1)
    gnid: Optional[np.ndarray] = None     # [nb] global node ids
    eidx: Optional[np.ndarray] = None     # [nb] global element idx or -1

    # storage axis order, set mesh-globally by build_plan (all bricks
    # of a plan share one permutation so interface planes align)
    _axes: tuple = (2, 1, 0)

    @property
    def axes(self):
        """Storage axis order, outermost -> innermost, as indices into
        (x, y, z) = (0, 1, 2).  The legacy (z, y, x) order is kept
        whenever every brick's stencil reach (o7 ~ one xy node plane)
        fits the fused kernel's VMEM tile -- it is what the slab/gslab
        decompositions assume.  When any brick's xy plane exceeds the
        tile (terashake's 960x480x15), build_plan reorders ALL bricks
        largest-extent-outermost, so o7 becomes the product of the two
        *smallest* dims and interface planes keep matching in-plane
        axis order across bricks."""
        return self._axes

    @property
    def node_shape(self):
        """Node-grid dims in storage order (outer, mid, inner)."""
        n = [int(v) + 1 for v in self.shape]
        a = self.axes
        return (n[a[0]], n[a[1]], n[a[2]])

    @property
    def strides(self):
        """Flat strides in storage order (outer, mid, inner)."""
        d0, d1, d2 = self.node_shape
        return (d1 * d2, d2, 1)

    def strides_xyz(self):
        """Flat stride of each physical axis (x, y, z)."""
        s = self.strides
        out = [0, 0, 0]
        for k, a in enumerate(self.axes):
            out[a] = s[k]
        return tuple(out)

    def corner_offsets(self):
        """Flat node-grid offset of element corner j (which-order:
        bit0=x, bit1=y, bit2=z, octor.c:1583-1588)."""
        sx, sy, sz = self.strides_xyz()
        return [(w & 1) * sx + ((w >> 1) & 1) * sy + ((w >> 2) & 1) * sz
                for w in range(8)]


def decompose(mesh: MeshArrays, max_bricks=512) -> List[Brick]:
    """Split the leaf set into fully-occupied rectangular bricks."""
    bricks: List[Brick] = []
    levels = np.unique(mesh.elem_level)
    for L in levels:
        sel = mesh.elem_level == L
        shift = PIXELLEVEL - int(L)
        cx = mesh.elem_x[sel].astype(np.int64) >> shift
        cy = mesh.elem_y[sel].astype(np.int64) >> shift
        cz = mesh.elem_z[sel].astype(np.int64) >> shift
        cells = np.stack([cx, cy, cz], axis=1)
        _bisect(cells, int(L), bricks)
    if len(bricks) > max_bricks:
        raise RuntimeError(
            f"brick decomposition produced {len(bricks)} bricks "
            f"(cap {max_bricks}); mesh too fragmented for the "
            f"structured path")
    return bricks


def _bisect(cells: np.ndarray, level: int, out: List[Brick]):
    """Recursive bisection: emit fully-occupied boxes."""
    stack = [cells]
    while stack:
        c = stack.pop()
        if len(c) == 0:
            continue
        lo = c.min(axis=0)
        hi = c.max(axis=0)
        shape = hi - lo + 1
        if len(c) == int(np.prod(shape)):
            out.append(Brick(level=level, origin=lo.astype(np.int64),
                             shape=shape.astype(np.int64)))
            continue
        ax = int(np.argmax(shape))
        mid = lo[ax] + shape[ax] // 2
        m = c[:, ax] < mid
        stack.append(c[m])
        stack.append(c[~m])


@dataclass
class BrickPlan:
    """Everything the brick step needs, host-side."""

    bricks: List[Brick]
    total_nb: int
    mesh: MeshArrays
    # per-concat-node global ids (for masses etc.)
    gnid_cat: np.ndarray = None           # [total_nb]
    evalid_cat: np.ndarray = None         # [total_nb] bool (valid element)
    eidx_cat: np.ndarray = None           # [total_nb] global element or 0
    # "loose" elements: too-small bricks handled by gather/scatter
    # (the graded-transition slivers of an adaptive octree)
    loose_eidx: np.ndarray = None         # [El] global element indices
    loose_rows: np.ndarray = None         # [El, 8] concat positions
    # reconciliation plan (see solver/brickstep.py)
    ex_pos: np.ndarray = None             # [K] concat positions of copies
    ex_seg: np.ndarray = None             # [K] group index (sorted)
    grp_rep: np.ndarray = None            # [G] one concat pos per group
    grp_node: np.ndarray = None           # [G] global node id per group
    # dangling adjust at group level
    dn_grp: np.ndarray = None             # [D] group index of dangling node
    dn_anc_grp: np.ndarray = None         # [D, 4] group idx of anchors
    dn_wgt: np.ndarray = None             # [D, 4]


def build_plan(mesh: MeshArrays, max_bricks=512,
               min_brick_elems=2048, legacy_axes=False) -> BrickPlan:
    """legacy_axes=True pins the (z, y, x) storage order regardless of
    brick aspect (the slab/gslab decompositions require contiguous
    z-planes; their XLA kernels have no VMEM envelope to satisfy)."""
    all_bricks = decompose(mesh, max_bricks=1_000_000)
    bricks = [b for b in all_bricks
              if int(np.prod(b.shape)) >= min_brick_elems]
    small = [b for b in all_bricks
             if int(np.prod(b.shape)) < min_brick_elems]
    if not bricks:
        # tiny meshes: keep the largest brick dense so the fast path
        # still exercises the stencil kernel
        all_bricks.sort(key=lambda b: -int(np.prod(b.shape)))
        bricks = all_bricks[:8]
        small = all_bricks[8:]
    if len(bricks) > max_bricks:
        raise RuntimeError(
            f"{len(bricks)} dense bricks exceed the cap {max_bricks}")

    # ---- storage axis order (mesh-global; see Brick.axes) -----------
    # When some brick's xy plane exceeds the fused kernel's VMEM tile,
    # reorder to (largest xy axis, z, smaller xy axis): o7 becomes
    # nz1 * min(nx1, ny1) (small for flat production bricks) AND the
    # interface z-planes stay dense middle-axis slices for the plane
    # reconciler (an inner z would force full-buffer strided reads).
    tile = JAX_DEFAULT_TILE

    def legacy_o7(b):
        nx1, ny1 = int(b.shape[0]) + 1, int(b.shape[1]) + 1
        return ny1 * nx1 + nx1 + 1

    if (not legacy_axes
            and any(legacy_o7(b) + 129 > tile for b in bricks)):
        ext = [max(int(b.shape[a]) + 1 for b in bricks)
               for a in range(3)]
        inner = 0 if ext[0] <= ext[1] else 1
        perm = (1 - inner, 2, inner)
        for b in bricks:
            b._axes = perm

    # ---- global node lookup (clamped-coordinate morton keys) --------
    far = mesh.farendp
    nhi, nlo = morton.interleave3(
        np.minimum(mesh.node_x.astype(np.int64), far[0] - 1).astype(
            np.uint64),
        np.minimum(mesh.node_y.astype(np.int64), far[1] - 1).astype(
            np.uint64),
        np.minimum(mesh.node_z.astype(np.int64), far[2] - 1).astype(
            np.uint64))
    nkeys = _key128(nhi, nlo)

    def node_lookup(x, y, z):
        qhi, qlo = morton.interleave3(
            np.minimum(x, far[0] - 1).astype(np.uint64),
            np.minimum(y, far[1] - 1).astype(np.uint64),
            np.minimum(z, far[2] - 1).astype(np.uint64))
        pos = np.searchsorted(nkeys, _key128(qhi, qlo))
        pos = np.clip(pos, 0, len(nkeys) - 1)
        ok = (nhi[pos] == qhi) & (nlo[pos] == qlo)
        return np.where(ok, pos, -1)

    # element lookup by (corner key, level)
    ehi, elo = morton.interleave3(
        mesh.elem_x.astype(np.uint64), mesh.elem_y.astype(np.uint64),
        mesh.elem_z.astype(np.uint64))
    ekeys = _key128(ehi, elo)
    eorder = np.argsort(ekeys)
    ekeys_s = ekeys[eorder]

    def elem_lookup(x, y, z):
        qhi, qlo = morton.interleave3(
            x.astype(np.uint64), y.astype(np.uint64), z.astype(np.uint64))
        qk = _key128(qhi, qlo)
        pos = np.clip(np.searchsorted(ekeys_s, qk), 0, len(ekeys_s) - 1)
        cand = eorder[pos]
        ok = ekeys[cand] == qk
        return np.where(ok, cand, -1)

    off = 0
    gnid_parts = []
    evalid_parts = []
    eidx_parts = []
    for b in bricks:
        d0, d1, d2 = b.node_shape
        axes = b.axes
        b.nb = d0 * d1 * d2
        b.off = off
        off += b.nb
        shift = PIXELLEVEL - b.level
        # node coords on the storage-ordered grid (Brick.axes)
        dims = (d0, d1, d2)
        C = np.meshgrid(*[(b.origin[a] + np.arange(dims[k])) << shift
                          for k, a in enumerate(axes)], indexing="ij")
        cxyz = {a: C[k] for k, a in enumerate(axes)}
        g = node_lookup(cxyz[0].ravel(), cxyz[1].ravel(),
                        cxyz[2].ravel())
        if (g < 0).any():
            raise RuntimeError("brick node missing from global mesh")
        b.gnid = g
        # element validity: cells with local index < shape
        I = np.meshgrid(*[np.arange(dims[k]) for k in range(3)],
                        indexing="ij")
        ixyz = {a: I[k] for k, a in enumerate(axes)}
        valid = ((ixyz[0] < b.shape[0]) & (ixyz[1] < b.shape[1])
                 & (ixyz[2] < b.shape[2])).ravel()
        eid = np.zeros(b.nb, np.int64)
        if valid.any():
            lx = ((b.origin[0] + ixyz[0].ravel()[valid]) << shift)
            ly = ((b.origin[1] + ixyz[1].ravel()[valid]) << shift)
            lz = ((b.origin[2] + ixyz[2].ravel()[valid]) << shift)
            ge = elem_lookup(lx, ly, lz)
            if (ge < 0).any():
                raise RuntimeError("brick cell missing from element table")
            eid[valid] = ge
        b.eidx = eid
        gnid_parts.append(g)
        evalid_parts.append(valid)
        eidx_parts.append(eid)

    # ---- loose elements (cells of the dropped small bricks) ----------
    loose_cells = []
    for b in small:
        shift = PIXELLEVEL - b.level
        nx, ny, nz = (int(v) for v in b.shape)
        ez, ey, ex_ = np.meshgrid(np.arange(nz), np.arange(ny),
                                  np.arange(nx), indexing="ij")
        loose_cells.append(np.stack([
            (b.origin[0] + ex_.ravel()) << shift,
            (b.origin[1] + ey.ravel()) << shift,
            (b.origin[2] + ez.ravel()) << shift], axis=1))
    if loose_cells:
        lc = np.concatenate(loose_cells)
        le = elem_lookup(lc[:, 0], lc[:, 1], lc[:, 2])
        if (le < 0).any():
            raise RuntimeError("loose cell missing from element table")
        loose_eidx = le
        lnids = mesh.elem_lnid[le]                   # [El, 8] global
        uniq, inv = np.unique(lnids, return_inverse=True)
        loose_rows = (off + inv.reshape(len(le), 8)).astype(np.int32)
        gnid_parts.append(uniq.astype(np.int64))
        evalid_parts.append(np.zeros(len(uniq), dtype=bool))
        eidx_parts.append(np.zeros(len(uniq), np.int64))
        off += len(uniq)
    else:
        loose_eidx = np.zeros(0, np.int64)
        loose_rows = np.zeros((0, 8), np.int32)

    plan = BrickPlan(bricks=bricks, total_nb=off, mesh=mesh)
    plan.gnid_cat = np.concatenate(gnid_parts)
    plan.evalid_cat = np.concatenate(evalid_parts)
    plan.eidx_cat = np.concatenate(eidx_parts)
    plan.loose_eidx = loose_eidx
    plan.loose_rows = loose_rows

    _build_reconciliation(plan, mesh)
    return plan


def _build_reconciliation(plan: BrickPlan, mesh: MeshArrays):
    """Shared-copy groups: global nodes with >1 brick copy, dangling
    nodes, and dangling anchors.  The per-step irregular phase operates
    only on these."""
    N = mesh.nnum
    copies = np.bincount(plan.gnid_cat, minlength=N)
    assert (copies > 0).all(), "mesh node missing from all bricks"
    in_group = copies > 1
    in_group[mesh.dn_ids] = True
    in_group[mesh.dn_anchors[mesh.dn_weights > 0]] = True
    grp_node = np.flatnonzero(in_group)
    G = len(grp_node)
    node2grp = -np.ones(N, np.int64)
    node2grp[grp_node] = np.arange(G)

    member = in_group[plan.gnid_cat]
    ex_pos = np.flatnonzero(member)
    ex_seg = node2grp[plan.gnid_cat[ex_pos]]
    order = np.argsort(ex_seg, kind="stable")
    ex_pos = ex_pos[order].astype(np.int32)
    ex_seg = ex_seg[order].astype(np.int32)

    # representative copy per group = first occurrence
    first = np.searchsorted(ex_seg, np.arange(G))
    grp_rep = ex_pos[first]

    plan.ex_pos = ex_pos
    plan.ex_seg = ex_seg
    plan.grp_rep = grp_rep.astype(np.int32)
    plan.grp_node = grp_node.astype(np.int32)

    D = len(mesh.dn_ids)
    if D:
        plan.dn_grp = node2grp[mesh.dn_ids].astype(np.int32)
        anc = node2grp[mesh.dn_anchors]
        # anchors with zero weight may be the padding slot; point them
        # at group 0 with weight 0
        anc = np.where(mesh.dn_weights > 0, anc, 0)
        if (anc < 0).any():
            raise RuntimeError("dangling anchor not in reconcile groups")
        plan.dn_anc_grp = anc.astype(np.int32)
        plan.dn_wgt = mesh.dn_weights
    else:
        plan.dn_grp = np.zeros(0, np.int32)
        plan.dn_anc_grp = np.zeros((0, 4), np.int32)
        plan.dn_wgt = np.zeros((0, 4))
