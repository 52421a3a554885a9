"""etree mutation API: insert / delete / update / search / cursor
(etree.h:328-398, 590-653 semantics) over an in-memory octant set,
committed back through the bulk B-tree writer.

The reference mutates the on-disk B-tree in place (btree.c insert/
delete page surgery); the solver never does — the only production
mutation need is offline database editing (patching a CVM region,
appending octants, trimming).  The TPU-native shape is therefore an
EDITOR: load the sorted leaf arrays, mutate them as whole-array NumPy
operations (single ops AND vectorized batches), and commit with
EtreeWriter's bottom-up bulk build — which produces a
reference-readable file and is how the reference's own transputil
tools rebuild databases.  Schema and application metadata round-trip.

Addresses are (x, y, z, level) exactly like etree_addr_t; duplicate
detection, ET_NOT_FOUND-style errors, and the preorder (Z-order)
cursor match etree.c's contracts.

The port's copy of ``hercules_tpu/etree/edit.py``: the same edits on
the same database commit the same bytes (tests/test_torch_etree_edit.py).
"""

from __future__ import annotations

import numpy as np

from . import morton
from .reader import EtreeReader, floor_indices
from .writer import EtreeWriter


class EtreeError(RuntimeError):
    """ET_DUPLICATE / ET_NOT_FOUND-style failures (etree.h:160-180)."""


class EtreeEditor:
    """Mutable in-memory octant set with etree mutation semantics."""

    def __init__(self, payload_size, dimensions=3, asciischema=None,
                 appmeta=None, pagesize=4096):
        self.payload_size = int(payload_size)
        self.dimensions = dimensions
        self.asciischema = asciischema
        self.appmeta = appmeta
        self.pagesize = pagesize
        self.x = np.zeros(0, np.uint32)
        self.y = np.zeros(0, np.uint32)
        self.z = np.zeros(0, np.uint32)
        self.level = np.zeros(0, np.uint8)
        self.payload = np.zeros((0, self.payload_size), np.uint8)
        self._cursor = 0
        self._sorted = True

    # ------------------------------------------------------------------
    @classmethod
    def open(cls, path) -> "EtreeEditor":
        """Load an existing database into the editor (etree_open with
        O_RDWR intent)."""
        r = EtreeReader(path, out_of_core=False)
        ed = cls(r.valuesize, dimensions=r.dimensions,
                 asciischema=r.asciischema, appmeta=r.appmeta,
                 pagesize=r.pagesize)
        x, y, z = morton.deinterleave3(r.hi, r.lo)
        ed.x = x.astype(np.uint32)
        ed.y = y.astype(np.uint32)
        ed.z = z.astype(np.uint32)
        ed.level = r.level.copy()
        pay = r.payload
        if pay.dtype != np.uint8:
            pay = np.ascontiguousarray(pay).view(np.uint8).reshape(
                len(pay), r.valuesize)
        ed.payload = pay.reshape(-1, r.valuesize).copy()
        return ed

    @property
    def n(self):
        return len(self.level)

    def _keys(self):
        hi, lo = morton.interleave3(self.x.astype(np.uint64),
                                    self.y.astype(np.uint64),
                                    self.z.astype(np.uint64))
        return hi, lo

    def _find(self, x, y, z, level):
        """Exact positions of the given addresses; -1 where absent."""
        x = np.atleast_1d(np.asarray(x, np.uint64))
        y = np.atleast_1d(np.asarray(y, np.uint64))
        z = np.atleast_1d(np.asarray(z, np.uint64))
        level = np.broadcast_to(
            np.asarray(level, np.uint8), x.shape)
        if self.n == 0:
            return np.full(len(x), -1, np.int64)
        hi, lo = self._keys()
        qhi, qlo = morton.interleave3(x, y, z)
        pos = floor_indices(hi, lo, qhi, qlo)
        # same Morton key may hold several levels (an octant and its
        # ancestors share the low corner): scan the small run
        out = np.full(len(x), -1, np.int64)
        for i in range(len(x)):
            p = pos[i]
            while p >= 0 and hi[p] == qhi[i] and lo[p] == qlo[i]:
                if self.level[p] == level[i]:
                    out[i] = p
                    break
                p -= 1
        return out

    def _coerce_payload(self, payload, n):
        p = np.asarray(payload)
        if p.dtype != np.uint8:
            p = np.ascontiguousarray(p).view(np.uint8)
        p = p.reshape(n, self.payload_size)
        return p

    # ------------------------------------------------------------------
    def insert(self, x, y, z, level, payload):
        """etree_insert (etree.h:328-352): add octants; duplicates
        (same address already present) raise EtreeError.  Accepts
        scalars or arrays."""
        x = np.atleast_1d(np.asarray(x, np.uint32))
        y = np.atleast_1d(np.asarray(y, np.uint32))
        z = np.atleast_1d(np.asarray(z, np.uint32))
        level = np.broadcast_to(np.asarray(level, np.uint8),
                                x.shape).copy()
        if (self._find(x, y, z, level) >= 0).any():
            raise EtreeError("ET_DUPLICATE: octant already in the "
                             "etree (etree_insert)")
        pay = self._coerce_payload(payload, len(x))
        self.x = np.concatenate([self.x, x])
        self.y = np.concatenate([self.y, y])
        self.z = np.concatenate([self.z, z])
        self.level = np.concatenate([self.level, level])
        self.payload = np.concatenate([self.payload, pay], axis=0)
        self._resort()

    def delete(self, x, y, z, level):
        """etree_delete (etree.h:355-373): remove octants; missing
        addresses raise EtreeError."""
        pos = self._find(x, y, z, level)
        if (pos < 0).any():
            raise EtreeError("ET_NOT_FOUND: octant absent "
                             "(etree_delete)")
        keep = np.ones(self.n, bool)
        keep[pos] = False
        for name in ("x", "y", "z", "level"):
            setattr(self, name, getattr(self, name)[keep])
        self.payload = self.payload[keep]
        self._cursor = min(self._cursor, self.n)

    def update(self, x, y, z, level, payload):
        """etree_update (etree.h:376-398): replace the payload of
        existing octants; missing addresses raise EtreeError."""
        pos = self._find(x, y, z, level)
        if (pos < 0).any():
            raise EtreeError("ET_NOT_FOUND: octant absent "
                             "(etree_update)")
        self.payload[pos] = self._coerce_payload(payload, len(pos))

    def search(self, x, y, z, level=None):
        """etree_search (etree.c:563-615): exact address when level
        given, else the leaf REGION containing the max-level point
        (floor + ancestor test).  Returns (found mask, payload rows,
        positions)."""
        if level is not None:
            pos = self._find(x, y, z, level)
            ok = pos >= 0
            return ok, self.payload[np.maximum(pos, 0)], pos
        x = np.atleast_1d(np.asarray(x, np.uint64))
        y = np.atleast_1d(np.asarray(y, np.uint64))
        z = np.atleast_1d(np.asarray(z, np.uint64))
        hi, lo = self._keys()
        qhi, qlo = morton.interleave3(x, y, z)
        pos = floor_indices(hi, lo, qhi, qlo)
        ok = pos >= 0
        safe = np.maximum(pos, 0)
        anc = morton.is_ancestor(
            hi[safe], lo[safe], self.level[safe].astype(np.int64),
            qhi, qlo, np.full(qhi.shape, 31, np.int64))
        ok = ok & anc
        return ok, self.payload[safe], np.where(ok, pos, -1)

    # ---- preorder cursor (etree.h:590-653) ---------------------------
    def initcursor(self, x=0, y=0, z=0, level=0):
        """etree_initcursor: position the preorder (Z-order) cursor at
        the first octant >= the given address."""
        if self.n == 0:
            self._cursor = 0
            return
        hi, lo = self._keys()
        qhi, qlo = morton.interleave3(
            np.atleast_1d(np.asarray(x, np.uint64)),
            np.atleast_1d(np.asarray(y, np.uint64)),
            np.atleast_1d(np.asarray(z, np.uint64)))
        pos = int(floor_indices(hi, lo, qhi, qlo)[0])
        # floor gives last <= query; step back over the same-key run
        # to its first entry, then adjust to >= semantics
        while pos >= 0 and (hi[pos], lo[pos]) == (qhi[0], qlo[0]):
            pos -= 1
        self._cursor = pos + 1

    def getcursor(self):
        """etree_getcursor: (addr dict, payload row) at the cursor, or
        None at the end."""
        if self._cursor >= self.n:
            return None
        i = self._cursor
        return ({"x": int(self.x[i]), "y": int(self.y[i]),
                 "z": int(self.z[i]), "level": int(self.level[i])},
                self.payload[i])

    def advcursor(self):
        """etree_advcursor: advance; False at the end of the tree."""
        self._cursor += 1
        return self._cursor < self.n

    # ------------------------------------------------------------------
    def _resort(self):
        hi, lo = self._keys()
        order = morton.zorder_argsort(hi, lo, self.level)
        for name in ("x", "y", "z", "level"):
            setattr(self, name, getattr(self, name)[order])
        self.payload = self.payload[order]

    def commit(self, path):
        """Write the edited octant set as a reference-readable etree
        database (bulk bottom-up build, writer.py); schema and
        application metadata carry over."""
        w = EtreeWriter(path, self.payload_size,
                        dimensions=self.dimensions,
                        pagesize=self.pagesize,
                        appmeta=self.appmeta,
                        asciischema=self.asciischema)
        w.write(self.x, self.y, self.z, self.level, self.payload)
