"""Host-side vectorized octree meshing.

Re-implements the octor library's meshing semantics (octor.c: newtree
:4057, refinetree :4336, balancetree :4397, carvebuildings :4817) as
whole-array NumPy passes over a sorted linear octree instead of pointer
surgery + MPI ripple messages.  The TPU solver only needs the final flat
element/node arrays; meshing happens once on host.

Conventions (identical to octor):
- integer tick grid, PIXELLEVEL = 30: a level-L octant has edge
  2**(30-L) ticks (octor.h:36-44)
- domain far endpoint from GCD/log2 scaling of the physical lengths
  (octor.c:4122-4146); octants are clipped to the domain exactly like
  oct_sprout drops out-of-domain children (octor.c:1589-1604)
- leaf order = Morton (Z) order, x least significant (octor_zcompare)

The port's copy of ``hercules_tpu/mesh/octree.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..etree import morton
from ..etree.reader import floor_indices

PIXELLEVEL = 30


def domain_ticks(x_m: float, y_m: float, z_m: float):
    """octor_newtree's domain -> tick mapping (octor.c:4122-4146).

    The reference uses floor(log2(max)) (LOG2_32b), which silently
    leaves part of the domain outside the level-0 root octant whenever
    the reduced max dimension is not a power of two (farendp > 2^30 and
    octants never exceed 2^30 ticks).  All shipped configs reduce to a
    power of two (e.g. terashake 600000:300000:84375 -> 64:32:9); for
    the rest we use ceil(log2) so the root always covers the domain —
    identical to the reference on every valid config.

    Returns (farendp[3] ticks, ticksize meters/tick).
    """
    u = [int(x_m), int(y_m), int(z_m)]
    gcd = math.gcd(math.gcd(u[0], u[1]), u[2])
    u = [v // gcd for v in u]
    mx = max(u)
    pw = (mx - 1).bit_length()  # ceil(log2)
    far = [v << (PIXELLEVEL - pw) for v in u]
    ticksize = x_m / far[0]
    return np.array(far, dtype=np.int64), ticksize


@dataclass
class Octree:
    """A linear octree: sorted Morton keys + level per leaf."""

    hi: np.ndarray      # uint64 [n]
    lo: np.ndarray      # uint64 [n]
    level: np.ndarray   # uint8  [n]
    farendp: np.ndarray  # int64 [3] domain far endpoint in ticks
    ticksize: float

    @property
    def n(self):
        return len(self.level)

    def coords(self):
        x, y, z = morton.deinterleave3(self.hi, self.lo)
        return (x.astype(np.int64), y.astype(np.int64), z.astype(np.int64))

    def edgeticks(self):
        return (np.int64(1) << (PIXELLEVEL - self.level.astype(np.int64)))

    def sort(self):
        order = morton.zorder_argsort(self.hi, self.lo, self.level)
        self.hi = self.hi[order]
        self.lo = self.lo[order]
        self.level = self.level[order]
        return order

    # ------------------------------------------------------------------
    @classmethod
    def newtree(cls, x_m, y_m, z_m):
        """Root octree covering the domain, clipped to the far endpoint
        (the serial newtree path: a single root leaf, with boundary
        octants force-split so every leaf lies inside the domain)."""
        far, ticksize = domain_ticks(x_m, y_m, z_m)
        t = cls(
            hi=np.zeros(1, np.uint64), lo=np.zeros(1, np.uint64),
            level=np.zeros(1, np.uint8), farendp=far, ticksize=ticksize)
        t._clip_to_domain()
        return t

    def _overlapping(self):
        """Mask of leaves whose upper corner exceeds the domain
        (oct_expand's isOverlapped, octor.c:1692-1704)."""
        x, y, z = self.coords()
        e = self.edgeticks()
        return ((x + e > self.farendp[0]) | (y + e > self.farendp[1])
                | (z + e > self.farendp[2]))

    def _clip_to_domain(self):
        """Split boundary-crossing leaves until all lie inside the
        domain, dropping out-of-domain children (oct_sprout)."""
        while True:
            ov = self._overlapping()
            if not ov.any():
                break
            keep_hi, keep_lo, keep_lv = (
                self.hi[~ov], self.lo[~ov], self.level[~ov])
            ch, cl, clv = _children(self.hi[ov], self.lo[ov], self.level[ov])
            x, y, z = morton.deinterleave3(ch, cl)
            inb = ((x.astype(np.int64) < self.farendp[0])
                   & (y.astype(np.int64) < self.farendp[1])
                   & (z.astype(np.int64) < self.farendp[2]))
            self.hi = np.concatenate([keep_hi, ch[inb]])
            self.lo = np.concatenate([keep_lo, cl[inb]])
            self.level = np.concatenate([keep_lv, clv[inb]])
        self.sort()

    # ------------------------------------------------------------------
    def refine(self, setrec, toexpand, max_level=PIXELLEVEL,
               max_leaves=300_000_000):
        """octor_refinetree: recursively split every leaf for which
        ``toexpand`` is true.

        setrec(tree, hi, lo, level) -> per-leaf record dict of arrays;
        toexpand(tree, hi, lo, level, rec) -> bool mask.
        Returns the final per-leaf records (aligned with sorted leaves).
        """
        hi, lo, lv = self.hi, self.lo, self.level
        if not len(lv):                  # empty shard (distributed)
            return {}
        done_h, done_l, done_v = [], [], []
        rec_parts = []
        total = 0
        while len(lv):
            total += len(lv)
            if total > max_leaves:
                raise RuntimeError(
                    f"refinement exploded past {max_leaves} leaves — "
                    f"check that the CVM covers the mesh region (failed "
                    f"queries force maximal refinement, psolve.c:1386)")
            rec = setrec(self, hi, lo, lv)
            split = toexpand(self, hi, lo, lv, rec) & (lv < max_level)
            keep = ~split
            done_h.append(hi[keep])
            done_l.append(lo[keep])
            done_v.append(lv[keep])
            rec_parts.append({k: v[keep] for k, v in rec.items()})
            hi, lo, lv = _children(hi[split], lo[split], lv[split])
        self.hi = np.concatenate(done_h)
        self.lo = np.concatenate(done_l)
        self.level = np.concatenate(done_v)
        rec = {k: np.concatenate([p[k] for p in rec_parts])
               for k in rec_parts[0]}
        order = self.sort()
        return {k: v[order] for k, v in rec.items()}

    # ------------------------------------------------------------------
    def balance(self, frontier_keys=None):
        """Enforce the 2-to-1 constraint across all 26 directions
        (octor_balancetree:4397-4776, prioritized ripple propagation).

        Each leaf probes one tick just outside itself toward each of
        the 26 neighbor regions; any containing leaf more than one
        level coarser is split.  The first sweep probes every leaf
        (one fused native pass, no materialized probe arrays); ripple
        iterations probe only the NEW children plus the TRIGGERING
        sources — a probe's containing leaf only changes when that
        leaf splits, so new violations can involve only a new child
        (as source) or a source whose probe just caused a split (its
        point now lands in a child that may still be too coarse).
        Returns the split count for stats.

        frontier_keys: optional (hi, lo) keys restricting the FIRST
        sweep's probe sources.  Sound when the tree was balanced
        before a refine pass that only SPLIT leaves (the progressive
        meshing loop, psolve.c:2002-2090): a violation's source must
        be ≥2 levels finer than its neighbor, old leaves' levels are
        unchanged and their neighbors only got finer, so every new
        violation has a NEW child as its source.  The result is
        identical to a full first sweep (tested).
        """
        nsplits = 0
        frontier = None           # (hi, lo) keys to probe next sweep
        if frontier_keys is not None:
            frontier = frontier_keys
        while True:
            if self.n == 0:
                break
            self.sort()
            lv = self.level.astype(np.int64)
            maxlv = int(lv.max())
            minlv = int(lv.min())
            if maxlv <= minlv + 1:
                break
            if frontier is None:
                src = np.arange(self.n, dtype=np.int64)
            else:
                src = self._positions_of(*frontier)
            to_split, trig = self._balance_probe(src)
            if not to_split.any():
                break
            nsplits += int(to_split.sum())
            ch, cl, clv = _children(
                self.hi[to_split], self.lo[to_split], self.level[to_split])
            # next sweep's sources: the new children (they can force
            # THEIR neighbors) plus the triggering sources — one
            # split may not close a multi-level gap, so the probe
            # that found it must look again at the new children
            tsrc = src[trig]
            keep_t = ~to_split[tsrc]        # (sources are unsplit,
            tsrc = tsrc[keep_t]             #  but be safe)
            fhi = np.concatenate([ch, self.hi[tsrc]])
            flo = np.concatenate([cl, self.lo[tsrc]])
            # children are always in-domain: the parent was
            self.hi = np.concatenate([self.hi[~to_split], ch])
            self.lo = np.concatenate([self.lo[~to_split], cl])
            self.level = np.concatenate([self.level[~to_split], clv])
            frontier = (fhi, flo)
        self.sort()
        return nsplits

    def _positions_of(self, khi, klo):
        """Indices of the given (unique) leaf keys in the sorted
        arrays."""
        from .. import native
        pos = native.exact_search(self.hi, self.lo, khi, klo)
        if pos is None:
            from .extract import _key128
            pos = np.searchsorted(_key128(self.hi, self.lo),
                                  _key128(khi, klo))
        return np.asarray(pos, np.int64)

    def _balance_probe(self, src):
        """(split mask over the sorted leaves, triggered mask over
        src) from the 26-probe scan of the src leaf indices (native
        fused pass; NumPy fallback)."""
        from .. import native
        got = native.balance_scan(self.hi, self.lo, self.level, src,
                                  self.farendp,
                                  minlv=int(self.level.min())
                                  if self.n else 0)
        if got is not None:
            return got
        x, y, z = self.coords()
        e = self.edgeticks()
        lv = self.level.astype(np.int64)
        qx, qy, qz = _neighbor_probes(x[src], y[src], z[src], e[src],
                                      self.farendp)
        qhi, qlo = morton.interleave3(
            qx.astype(np.uint64), qy.astype(np.uint64),
            qz.astype(np.uint64))
        idx = floor_indices(self.hi, self.lo, qhi, qlo)
        ok = idx >= 0
        safe = np.maximum(idx, 0)
        srclv = np.tile(lv[src], 26)
        # containment: on interval-sharded trees the key space has
        # gaps, so the floor leaf may not contain the probe point
        # (a probe past the shard's interval end floors onto its
        # last leaf) — require the probe inside the leaf's box
        contains = ((qx >= x[safe]) & (qx < x[safe] + e[safe])
                    & (qy >= y[safe]) & (qy < y[safe] + e[safe])
                    & (qz >= z[safe]) & (qz < z[safe] + e[safe]))
        viol = ok & contains & (lv[safe] < srclv - 1)
        mask = np.zeros(self.n, dtype=bool)
        mask[safe[viol]] = True
        trig = viol.reshape(26, len(src)).any(axis=0)
        return mask, trig

    # ------------------------------------------------------------------
    def carve(self, delete_mask):
        """octor_carvebuildings: delete the masked leaves."""
        keep = ~delete_mask
        self.hi = self.hi[keep]
        self.lo = self.lo[keep]
        self.level = self.level[keep]


def _children(hi, lo, level):
    """Split each leaf into its 8 children (Morton order)."""
    x, y, z = morton.deinterleave3(hi, lo)
    x = x.astype(np.int64)
    y = y.astype(np.int64)
    z = z.astype(np.int64)
    lv = level.astype(np.int64)
    h = np.int64(1) << (PIXELLEVEL - lv - 1)
    xs, ys, zs, lvs = [], [], [], []
    for w in range(8):
        xs.append(x + h * (w & 1))
        ys.append(y + h * ((w >> 1) & 1))
        zs.append(z + h * ((w >> 2) & 1))
        lvs.append(lv + 1)
    cx = np.concatenate(xs).astype(np.uint64)
    cy = np.concatenate(ys).astype(np.uint64)
    cz = np.concatenate(zs).astype(np.uint64)
    chi, clo = morton.interleave3(cx, cy, cz)
    return chi, clo, np.concatenate(lvs).astype(np.uint8)


def _neighbor_probes(x, y, z, e, farendp):
    """For each leaf (low corner x,y,z, edge e) return the 26 probe
    points (one tick into each neighbor region), flattened and clipped
    to the domain (out-of-domain probes are clamped onto the leaf
    itself, where they harmlessly find the leaf)."""
    qs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                px = x + (-1 if dx < 0 else (0 if dx == 0 else e))
                py = y + (-1 if dy < 0 else (0 if dy == 0 else e))
                pz = z + (-1 if dz < 0 else (0 if dz == 0 else e))
                qs.append((px, py, pz))
    qx = np.concatenate([q[0] for q in qs])
    qy = np.concatenate([q[1] for q in qs])
    qz = np.concatenate([q[2] for q in qs])
    inb = ((qx >= 0) & (qy >= 0) & (qz >= 0)
           & (qx < farendp[0]) & (qy < farendp[1]) & (qz < farendp[2]))
    # clamp out-of-domain probes back inside their own leaf
    n = len(x)
    ox = np.tile(x, 26)
    oy = np.tile(y, 26)
    oz = np.tile(z, 26)
    return (np.where(inb, qx, ox), np.where(inb, qy, oy),
            np.where(inb, qz, oz))
