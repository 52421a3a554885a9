"""Mesh extraction: octree leaves -> flat SoA element/node tables.

Replaces octor_extractmesh (octor.c:5267-6651).  The reference runs a
distributed touch-count + message protocol to classify vertices; with the
whole tree on host the same information falls out of exact integer
geometry:

- nodes = unique element corners, Z-order sorted (gnid = sorted rank,
  matching the reference's Z-sort + scan, octor.c:6065-6240)
- a node is *dangling* iff it coincides with an edge midpoint (deps = the
  2 edge endpoints) or face center (deps = the 4 face corners) of some
  larger adjacent element — exactly the dependence sets dnode_correlate
  builds from the master-level mask (octor.c:3867-3912, 6511-6612).

The port's copy of ``hercules_tpu/mesh/extract.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..etree import morton
from .octree import Octree, PIXELLEVEL


@dataclass
class MeshArrays:
    """Frozen flat mesh, single global view."""

    ticksize: float
    farendp: np.ndarray          # [3] int64 ticks
    # elements
    elem_x: np.ndarray           # [E] int32 low-corner ticks
    elem_y: np.ndarray
    elem_z: np.ndarray
    elem_level: np.ndarray       # [E] uint8
    elem_lnid: np.ndarray        # [E, 8] int32 node indices
    # nodes (Z-order sorted; index == gnid)
    node_x: np.ndarray           # [N] int32 ticks
    node_y: np.ndarray
    node_z: np.ndarray
    dangling: np.ndarray         # [N] bool
    # dangling dependence table
    dn_ids: np.ndarray           # [D] int32 node index of each dangling node
    dn_anchors: np.ndarray       # [D, 4] int32 anchor node indices (padded 0)
    dn_weights: np.ndarray       # [D, 4] float64 1/deps for real slots else 0
    # per-element material (filled by material layer)
    edge_m: Optional[np.ndarray] = None   # [E] element edge size in meters
    props: dict = field(default_factory=dict)
    origin: object = None                 # MeshOrigin (set by meshgen)
    buildings: object = None              # Buildings (set by meshgen)

    @property
    def lenum(self):
        return len(self.elem_level)

    @property
    def nnum(self):
        return len(self.node_x)

    def edgeticks(self):
        return np.int64(1) << (PIXELLEVEL - self.elem_level.astype(np.int64))


def _corner_offsets(e):
    """[8] corner tick offsets of an element with edge e (which-order:
    bit0 = x, bit1 = y, bit2 = z, octor.c:1583-1588)."""
    w = np.arange(8)
    return (e[:, None] * (w & 1), e[:, None] * ((w >> 1) & 1),
            e[:, None] * ((w >> 2) & 1))


def _pack(x, y, z):
    """Pack node tick coords into one sortable uint64 (coords < 2**31
    exclusive; 21 bits would overflow, so use Morton hi/lo instead)."""
    hi, lo = morton.interleave3(
        np.asarray(x, np.uint64), np.asarray(y, np.uint64),
        np.asarray(z, np.uint64))
    return hi, lo


def extract_mesh(tree: Octree) -> MeshArrays:
    from ..utils.timers import GLOBAL_TIMERS as TM
    x, y, z = tree.coords()
    lv = tree.level
    e = tree.edgeticks()
    E = tree.n

    # ---- build node table -------------------------------------------
    # (memory-lean: eager frees and no 8E-sized coordinate temporaries
    # — peak stays ~0.4 KB/element so 1e8+-element meshes fit one
    # host; see bench.py mesh_scale_bench)
    from .. import native
    with TM.span("extract: corner keys"):
        ck = native.corner_keys(x, y, z, e, tree.farendp)
    if ck is not None:
        # fused corner generation + far-boundary clamp + interleave
        # (octor.c:1583-1588 which-order, :6100-6106 clamping)
        chi, clo = ck
    else:
        ox, oy, oz = _corner_offsets(e)
        cx = (x[:, None] + ox).ravel().astype(np.int32)
        cy = (y[:, None] + oy).ravel().astype(np.int32)
        cz = (z[:, None] + oz).ravel().astype(np.int32)
        del ox, oy, oz
        # Nodes on the far domain boundary are clamped inward by one
        # tick for ordering (and ownership) purposes (octor.c:
        # 6100-6106); the clamp is injective because real node coords
        # have trailing zeros.
        chi, clo = _pack(np.minimum(cx, tree.farendp[0] - 1),
                         np.minimum(cy, tree.farendp[1] - 1),
                         np.minimum(cz, tree.farendp[2] - 1))
        del cx, cy, cz
    # unique corners in Z order -> node table; gnid = index
    with TM.span("extract: zorder argsort"):
        order = morton.zorder_argsort(chi, clo)
    with TM.span("extract: group ids"):
        gg = native.group_ids(chi, clo, order)
    if gg is not None:
        # fused single pass: per-corner node ids + group starts (no
        # full-key gathers, no cumsum, no id scatter)
        gid, newgrp = gg
        rep = order[newgrp]
        nhi = chi[rep]             # keys at the group representatives
        nlo = clo[rep]
        del chi, clo, order, newgrp
    else:
        shi, slo = chi[order], clo[order]
        del chi, clo
        newgrp = np.ones(len(shi), dtype=bool)
        newgrp[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
        gid_sorted = (np.cumsum(newgrp, dtype=np.int64) - 1).astype(
            np.int32)
        gid = np.empty(len(shi), dtype=np.int32)
        gid[order] = gid_sorted
        del gid_sorted
        nhi = shi[newgrp]      # adjusted keys (sort/lookup space)
        nlo = slo[newgrp]
        del shi, slo
        # representative corner of each group (corner rep%8 of
        # element rep//8)
        rep = order[newgrp]
        del order, newgrp
    elem_lnid = gid.reshape(E, 8)
    del gid
    # real (unclamped) coordinates of each node, reconstructed
    # arithmetically from the representative corner — no 8E coord
    # arrays
    rj = rep & 7
    re_ = rep >> 3
    ee = e[re_]
    nx = (x[re_] + (rj & 1) * ee).astype(np.int64)
    ny = (y[re_] + ((rj >> 1) & 1) * ee).astype(np.int64)
    nz = (z[re_] + ((rj >> 2) & 1) * ee).astype(np.int64)
    del rep, rj, re_, ee
    N = len(nx)
    far = tree.farendp

    # ---- dangling classification ------------------------------------
    # candidate hanging locations: edge midpoints and face centers of
    # every element with edge >= 2 ticks.  Only elements coarser than
    # the finest level can host hanging nodes (a hanging node is a
    # corner of a *finer* neighbor), so uniform meshes skip the 18
    # candidate lookups entirely.
    big = (e >= 2) & (lv < lv.max())
    bx, by, bz, be = x[big], y[big], z[big], e[big]
    h = be // 2

    dn_entries = {}  # node id -> (anchor ids tuple)
    dn_direct = None  # vectorized (ids, anchors, deps) from the scan
    with TM.span("extract: dangling scan"):
        scan = (native.dangling_scan(nhi, nlo, bx, by, bz, be,
                                     tree.farendp)
                if len(bx) else ((), (), ()))
    if len(bx) and scan is not None:
        # fused native scan: candidate rows in the same case order as
        # the numpy path below; edges (cases 0:12) processed first so
        # the edge classification wins ties exactly like the
        # insertion-ordered dict build.  The first-win dedup runs
        # VECTORIZED (round 5: the per-candidate python dict loop was
        # ~1/3 of extract time on interface-heavy production meshes)
        # and reproduces the dict's insertion order exactly, so the
        # dn tables — and every downstream accumulation order — are
        # bit-identical.
        nid18, anc18, deps18 = scan
        c_ids, c_anc, c_deps = [], [], []
        for k in range(18):       # k-major == dict insertion order
            ids = nid18[:, k]
            m = ids >= 0
            if not m.any():
                continue
            c_ids.append(ids[m])
            c_anc.append(anc18[m, k])
            c_deps.append(np.full(int(m.sum()),
                                  2 if k < 12 else 4, np.int64))
        if c_ids:
            idsf = np.concatenate(c_ids)
            ancf = np.concatenate(c_anc)
            depf = np.concatenate(c_deps)
            uq_s, first = np.unique(idsf, return_index=True)
            o = np.argsort(first, kind="stable")   # insertion order
            win = first[o]
            dn_direct = (idsf[win].astype(np.int32),
                         ancf[win].astype(np.int64), depf[win])
        else:
            dn_direct = (np.zeros(0, np.int32),
                         np.zeros((0, 4), np.int64),
                         np.zeros(0, np.int64))
        # numpy candidate path skipped
        bx, by, bz, be, h = bx[:0], by[:0], bz[:0], be[:0], h[:0]

    em_x, em_y, em_z = [], [], []   # edge midpoints
    em_a1 = []                      # anchor corner offsets (2 endpoints)
    em_a2 = []
    # 12 edges: for each axis pair fixed at 0/e, varying axis at h
    for axis in range(3):
        for f1 in (0, 1):
            for f2 in (0, 1):
                off = [None, None, None]
                a, b_ = (axis + 1) % 3, (axis + 2) % 3
                off[axis] = h
                off[a] = f1 * be
                off[b_] = f2 * be
                em_x.append(bx + off[0])
                em_y.append(by + off[1])
                em_z.append(bz + off[2])
                lo_off = list(off)
                hi_off = list(off)
                lo_off[axis] = 0 * be
                hi_off[axis] = be
                em_a1.append((bx + lo_off[0], by + lo_off[1], bz + lo_off[2]))
                em_a2.append((bx + hi_off[0], by + hi_off[1], bz + hi_off[2]))

    fc_x, fc_y, fc_z = [], [], []   # face centers
    fc_anchors = []                 # 4 corner coords per face
    for axis in range(3):
        for f in (0, 1):
            off = [h, h, h]
            off[axis] = f * be
            fc_x.append(bx + off[0])
            fc_y.append(by + off[1])
            fc_z.append(bz + off[2])
            corners = []
            a, b_ = (axis + 1) % 3, (axis + 2) % 3
            for c1 in (0, 1):
                for c2 in (0, 1):
                    co = [None, None, None]
                    co[axis] = f * be
                    co[a] = c1 * be
                    co[b_] = c2 * be
                    corners.append((bx + co[0], by + co[1], bz + co[2]))
            fc_anchors.append(corners)

    def node_lookup(qx, qy, qz):
        """Exact node index for each query coord, -1 if no node there."""
        from .. import native
        qhi, qlo = _pack(np.minimum(qx, far[0] - 1),
                         np.minimum(qy, far[1] - 1),
                         np.minimum(qz, far[2] - 1))
        pos = native.exact_search(nhi, nlo, qhi, qlo)
        if pos is not None:
            return pos
        pos = np.searchsorted(_key128(nhi, nlo), _key128(qhi, qlo))
        pos = np.clip(pos, 0, N - 1)
        hit = (nhi[pos] == qhi) & (nlo[pos] == qlo)
        return np.where(hit, pos, -1)

    # edge-dangling (numpy fallback when the native scan is absent)
    if len(bx):
        for k in range(12):
            ids = node_lookup(em_x[k], em_y[k], em_z[k])
            m = ids >= 0
            if not m.any():
                continue
            a1 = node_lookup(*(c[m] for c in em_a1[k]))
            a2 = node_lookup(*(c[m] for c in em_a2[k]))
            for nid, i1, i2 in zip(ids[m], a1, a2):
                if nid not in dn_entries:
                    dn_entries[int(nid)] = (int(i1), int(i2))
        # face-dangling (edge classification wins if already present)
        for k in range(6):
            ids = node_lookup(fc_x[k], fc_y[k], fc_z[k])
            m = ids >= 0
            if not m.any():
                continue
            anchors = [node_lookup(*(c[m] for c in fc_anchors[k][j]))
                       for j in range(4)]
            for row, nid in enumerate(ids[m]):
                nid = int(nid)
                if nid not in dn_entries:
                    dn_entries[nid] = tuple(int(anchors[j][row])
                                            for j in range(4))

    if dn_direct is not None:
        d_ids, d_anc, d_deps = dn_direct
        D = len(d_ids)
        dn_ids = d_ids
        dn_anchors = np.zeros((D, 4), np.int32)
        dn_weights = np.zeros((D, 4), np.float64)
        cols = np.arange(4)[None, :]
        live = cols < d_deps[:, None]
        if D and (d_anc[live] < 0).any():
            raise RuntimeError(
                "dangling node: anchor corner missing from mesh")
        dn_anchors[live] = d_anc[live]
        dn_weights[live] = np.repeat(1.0 / d_deps, d_deps)
    else:
        D = len(dn_entries)
        dn_ids = np.fromiter(dn_entries.keys(), np.int32, count=D)
        dn_anchors = np.zeros((D, 4), np.int32)
        dn_weights = np.zeros((D, 4), np.float64)
        for i, (nid, anc) in enumerate(dn_entries.items()):
            deps = len(anc)
            for j, a in enumerate(anc):
                if a < 0:
                    raise RuntimeError(
                        f"dangling node {nid}: anchor corner missing "
                        f"from mesh")
                dn_anchors[i, j] = a
                dn_weights[i, j] = 1.0 / deps
    dangling = np.zeros(N, dtype=bool)
    dangling[dn_ids] = True
    if D and dangling[dn_anchors[dn_weights > 0]].any():
        raise RuntimeError("dangling node anchored to a dangling node; "
                           "mesh is not 2:1 balanced")

    return MeshArrays(
        ticksize=tree.ticksize,
        farendp=tree.farendp,
        elem_x=x.astype(np.int32), elem_y=y.astype(np.int32),
        elem_z=z.astype(np.int32), elem_level=lv.copy(),
        elem_lnid=elem_lnid,
        node_x=nx.astype(np.int32), node_y=ny.astype(np.int32),
        node_z=nz.astype(np.int32),
        dangling=dangling,
        dn_ids=dn_ids, dn_anchors=dn_anchors, dn_weights=dn_weights,
        edge_m=(np.asarray(e, np.float64) * tree.ticksize),
    )


def _key128(hi, lo):
    """Big-endian (hi, lo) packed into a lexicographically sortable
    structured view for searchsorted."""
    # NumPy S-type comparison strips trailing NULs, but for equal-length
    # buffers that never creates false equality or misordering, so this
    # sorts exactly like the 128-bit integer (hi << 64 | lo).
    n = len(hi)
    buf = np.empty((n, 16), dtype=np.uint8)
    buf[:, :8] = hi.astype(">u8").view(np.uint8).reshape(n, 8)
    buf[:, 8:] = lo.astype(">u8").view(np.uint8).reshape(n, 8)
    return buf.view("S16").ravel()
