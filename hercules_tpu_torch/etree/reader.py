"""Reader for the reference on-disk etree (linear octree B-tree) format.

Layout (verified against the reference's etree/etree.c:53 readheader,
etree/btree.c:121,204,764-890 and the bytes of
examples/simple/simple_case.e):

  offset 0: etree meta header (273 bytes)
      'L'/'B' endian (1) | version u32 | dimensions u32 | rootlevel u32 |
      appmetasize u32 | [leafcount u32, indexcount u32] x 32 levels
  offset 273: btree meta header (33 bytes)
      'L'/'B' (1) | pagesize u32 | pagecount u64 | rootpagenum u64 |
      keysize u32 | valuesize u32 | asciischemasize u32
  offset 306: ASCII schema (asciischemasize bytes), e.g.
      "L 3 Vp float 4 0 Vs float 4 4 density float 4 8 "
  page p (p = rootpagenum..): at p*pagesize, 25-byte header
      rightsibnum i64 | parent-ptr junk u64 | count i32 | pentry i32 |
      type char ('l' leaf / 'i' index)   (btree.c setheader)
      entries follow: leaf = key(keysize)+value(valuesize),
      index = key(keysize)+childpagenum(i64)
  appmeta: appmetasize bytes at pagesize*(rootpagenum+pagecount)

Keys are 13 bytes for 3-D etrees: level|0x80 byte then 96-bit Morton code
(see morton.py).  Point search = floor lookup in key order + ancestor test
(etree.c:563-615).

The port's copy of ``hercules_tpu/etree/reader.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from . import morton

_ETREE_HDR = 1 + 4 * 4 + 2 * 4 * 32  # 273 (BIGINT = uint32, etree.h:68)
_BTREE_HDR = 1 + 4 + 8 + 8 + 4 + 4 + 4  # 33
_PAGE_HDR = 25


@dataclass
class Schema:
    """Typed field list parsed from the ASCII schema string."""

    names: list = field(default_factory=list)
    types: list = field(default_factory=list)
    sizes: list = field(default_factory=list)
    offsets: list = field(default_factory=list)

    @classmethod
    def from_ascii(cls, text: str) -> "Schema":
        toks = text.split()
        # "<endian> <nfields> (<name> <type> <size> <offset>)*"
        n = int(toks[1])
        s = cls()
        for i in range(n):
            name, typ, size, off = toks[2 + 4 * i : 6 + 4 * i]
            s.names.append(name)
            s.types.append(typ)
            s.sizes.append(int(size))
            s.offsets.append(int(off))
        return s

    def dtype(self) -> np.dtype:
        m = {"float": "<f4", "double": "<f8", "int32_t": "<i4",
             "int64_t": "<i8", "uint32_t": "<u4", "uint64_t": "<u8",
             "char": "S1"}
        return np.dtype({
            "names": self.names,
            "formats": [m[t] if t in m else f"V{s}"
                        for t, s in zip(self.types, self.sizes)],
            "offsets": self.offsets,
        })


class EtreeReader:
    """Answers vectorized point/ancestor queries over an etree database.

    Two modes (the solver only ever queries the CVM read-only at mesh
    time, SURVEY.md section 2.1):

    - in-memory (default for small DBs): every leaf record is loaded
      into sorted arrays; queries are pure binary search.
    - out-of-core (DBs larger than HT_ETREE_MEM_LIMIT, default 256 MB,
      or HT_ETREE_MMAP=1): the file is memory-mapped and only a
      per-page index (first key, offset, count) is held in RAM.  The
      OS page cache plus a small decoded-page LRU stand in for the
      reference's buffer pool (etree/buffer.c:21-116), so tens-of-GB
      SCEC CVMs are served without loading the DB.
    """

    def __init__(self, path: str, out_of_core: bool = None):
        self.path = path
        size = os.path.getsize(path)
        if out_of_core is None:
            limit = int(os.environ.get("HT_ETREE_MEM_LIMIT", 1 << 28))
            out_of_core = (os.environ.get("HT_ETREE_MMAP", "") == "1"
                           or size > limit)
        self.out_of_core = bool(out_of_core)
        if not self.out_of_core:
            with open(path, "rb") as f:
                raw = f.read()
            self._parse_headers(raw)
            self._load_leaves(raw)
            return
        self._mm = np.memmap(path, np.uint8, mode="r")
        head = bytes(self._mm[: min(size, 1 << 20)])
        self._parse_headers(head, appmeta_src=self._mm)
        self._build_page_index()
        self._page_cache = {}
        self._page_cache_cap = int(os.environ.get("HT_ETREE_PAGE_CACHE",
                                                  1024))

    def _parse_headers(self, raw: bytes, appmeta_src=None):
        if raw[0:1] not in (b"L", b"B"):
            raise ValueError("bad etree endian byte")
        self.endian = "<" if raw[0:1] == b"L" else ">"
        (self.version, self.dimensions, self.rootlevel,
         self.appmetasize) = struct.unpack_from(self.endian + "4I", raw, 1)
        if self.version != 1:
            raise ValueError(f"unsupported etree version {self.version}")
        off = _ETREE_HDR
        if raw[off:off + 1] not in (b"L", b"B"):
            raise ValueError("bad btree endian byte")
        (self.pagesize,) = struct.unpack_from(self.endian + "I", raw, off + 1)
        (self.pagecount, self.rootpagenum) = struct.unpack_from(
            self.endian + "2q", raw, off + 5)
        (self.keysize, self.valuesize, self.asciischemasize) = (
            struct.unpack_from(self.endian + "3I", raw, off + 21))
        self.asciischema = None
        self.schema = None
        if self.asciischemasize:
            text = raw[off + 33 : off + 33 + self.asciischemasize]
            self.asciischema = text.rstrip(b"\x00").decode()
            self.schema = Schema.from_ascii(self.asciischema)
        end = self.pagesize * (self.rootpagenum + self.pagecount)
        self.appmeta = None
        if self.appmetasize:
            src = raw if appmeta_src is None else appmeta_src
            self.appmeta = bytes(
                src[end : end + self.appmetasize]).rstrip(
                    b"\x00").decode()

    def _load_leaves(self, raw: bytes):
        """Walk all pages; collect leaf entries, then Z-order sort."""
        ps, ks, vs = self.pagesize, self.keysize, self.valuesize
        entsize = ks + vs
        cap = (ps - _PAGE_HDR) // entsize
        keys = []
        vals = []
        for p in range(self.rootpagenum, self.rootpagenum + self.pagecount + 1):
            off = p * ps
            if off + _PAGE_HDR > len(raw):
                break
            count, = struct.unpack_from(self.endian + "i", raw, off + 16)
            ptype = raw[off + 24 : off + 25]
            if ptype != b"l" or count <= 0 or count > cap:
                continue
            page = np.frombuffer(
                raw, dtype=np.uint8, count=count * entsize,
                offset=off + _PAGE_HDR).reshape(count, entsize)
            keys.append(page[:, :ks].copy())
            vals.append(page[:, ks:].copy())
        if not keys:
            self.n = 0
            self.hi = np.zeros(0, np.uint64)
            self.lo = np.zeros(0, np.uint64)
            self.level = np.zeros(0, np.uint8)
            self.payload = np.zeros(0, np.uint8)
            return
        kb = np.concatenate(keys, axis=0)
        vb = np.concatenate(vals, axis=0)
        hi, lo, lbyte = morton.bytes_to_key(kb)
        order = morton.zorder_argsort(hi, lo, lbyte & 0x7F)
        self.hi = hi[order]
        self.lo = lo[order]
        self.level = (lbyte[order] & 0x7F).astype(np.uint8)
        raw_payload = vb[order]
        if self.schema is not None:
            self.payload = raw_payload.reshape(-1).view(
                self.schema.dtype()).reshape(len(order))
        else:
            self.payload = raw_payload
        self.n = len(order)

    # ---- out-of-core machinery ---------------------------------------
    def _build_page_index(self):
        """One pass over the page headers: (first key, file offset,
        record count) per leaf page, sorted by first key.  Memory is
        O(pagecount); the leaf bytes stay on disk."""
        ps, ks, vs = self.pagesize, self.keysize, self.valuesize
        entsize = ks + vs
        cap = (ps - _PAGE_HDR) // entsize
        size = len(self._mm)
        pnums = np.arange(self.rootpagenum,
                          self.rootpagenum + self.pagecount + 1,
                          dtype=np.int64)
        offs = pnums * ps
        pnums = pnums[offs + _PAGE_HDR <= size]
        offs = offs[offs + _PAGE_HDR <= size]
        hdr_cols = offs[:, None] + np.arange(16, 25)
        hdr = np.asarray(self._mm[hdr_cols])
        counts = hdr[:, 0:4].copy().view("<i4").ravel()
        types = hdr[:, 8]
        leaf = (types == ord("l")) & (counts > 0) & (counts <= cap)
        offs = offs[leaf]
        counts = counts[leaf].astype(np.int64)
        kb = np.asarray(self._mm[offs[:, None]
                                 + (_PAGE_HDR + np.arange(ks))])
        hi, lo, lbyte = morton.bytes_to_key(kb)
        order = np.lexsort((lo, hi))
        self.pg_hi = hi[order]
        self.pg_lo = lo[order]
        self.pg_off = offs[order]
        self.pg_count = counts[order]
        self.pg_base = np.concatenate(
            [[0], np.cumsum(self.pg_count)])
        self.n = int(self.pg_base[-1])
        self._rec_dtype = (self.schema.dtype()
                           if self.schema is not None else None)

    def _decode_page(self, pi: int):
        """(hi, lo, level, payload) arrays of leaf page pi (cached)."""
        got = self._page_cache.get(pi)
        if got is not None:
            return got
        ks, vs = self.keysize, self.valuesize
        entsize = ks + vs
        off = int(self.pg_off[pi])
        count = int(self.pg_count[pi])
        page = np.asarray(self._mm[off + _PAGE_HDR:
                                   off + _PAGE_HDR + count * entsize]
                          ).reshape(count, entsize)
        hi, lo, lbyte = morton.bytes_to_key(page[:, :ks].copy())
        vals = page[:, ks:].copy()
        if self._rec_dtype is not None:
            vals = vals.reshape(-1).view(self._rec_dtype).reshape(count)
        got = (hi, lo, (lbyte & 0x7F).astype(np.uint8), vals)
        if len(self._page_cache) >= self._page_cache_cap:
            self._page_cache.pop(next(iter(self._page_cache)))
        self._page_cache[pi] = got
        return got

    def _search_points_ooc(self, x, y, z):
        qhi, qlo = morton.interleave3(x, y, z)
        qhi = np.atleast_1d(qhi)
        qlo = np.atleast_1d(qlo)
        nq = len(qhi)
        # floor page: last page whose first key <= query
        pidx = floor_indices(self.pg_hi, self.pg_lo, qhi, qlo)
        ok = pidx >= 0
        idx = np.zeros(nq, np.int64)
        lvl = np.zeros(nq, np.uint8)
        rhi = np.zeros(nq, np.uint64)
        rlo = np.zeros(nq, np.uint64)
        for pi in np.unique(pidx[ok]):
            sel = np.flatnonzero(pidx == pi)
            hi, lo, level, _ = self._decode_page(int(pi))
            li = floor_indices(hi, lo, qhi[sel], qlo[sel])
            # first key <= query, so the floor exists in this page
            li = np.maximum(li, 0)
            idx[sel] = self.pg_base[pi] + li
            lvl[sel] = level[li]
            rhi[sel] = hi[li]
            rlo[sel] = lo[li]
        anc = morton.is_ancestor(rhi, rlo, lvl, qhi, qlo,
                                 np.full(qhi.shape, 31, np.int64))
        return ok & anc, idx

    def records(self, idx):
        """Leaf payload records at global indices idx (both modes)."""
        if not self.out_of_core:
            return self.payload[idx]
        idx = np.atleast_1d(np.asarray(idx, np.int64))
        pis = np.searchsorted(self.pg_base, idx, side="right") - 1
        out = None
        for pi in np.unique(pis):
            sel = np.flatnonzero(pis == pi)
            _, _, _, vals = self._decode_page(int(pi))
            got = vals[idx[sel] - self.pg_base[pi]]
            if out is None:
                out = np.zeros(len(idx), got.dtype)
            out[sel] = got
        if out is None:
            out = np.zeros(
                0, self._rec_dtype if self._rec_dtype is not None
                else np.uint8)
        return out

    # ------------------------------------------------------------------
    def total_count(self) -> int:
        return self.n

    def octants(self):
        """All leaf octants as (x, y, z, level, payload) arrays.
        Out-of-core readers materialize (tools only — scancvm/dumpcvm
        semantics require a full scan anyway)."""
        if self.out_of_core:
            his, los, lvls, vals = [], [], [], []
            for pi in range(len(self.pg_off)):
                hi, lo, level, v = self._decode_page(pi)
                his.append(hi)
                los.append(lo)
                lvls.append(level)
                vals.append(v)
            hi = np.concatenate(his)
            lo = np.concatenate(los)
            level = np.concatenate(lvls)
            payload = np.concatenate(vals)
            order = morton.zorder_argsort(hi, lo, level)
            x, y, z = morton.deinterleave3(hi[order], lo[order])
            return x, y, z, level[order], payload[order]
        x, y, z = morton.deinterleave3(self.hi, self.lo)
        return x, y, z, self.level, self.payload

    # threshold for the dense lookup acceleration: total level-Lmax
    # cells of the DB cube (8^Lmax).  2^24 cells = 64 MB of int32 —
    # covers every shallow CVM (synthetic layered DBs, simple_case);
    # deep DBs (real SCEC etrees, Lmax > 8) keep the floor search.
    _DENSE_MAX_CELLS = 1 << 24

    def _dense_lut(self):
        """Lazy dense Morton-order record index: collapses the whole
        ancestor-floor search (etree.c:563-615) to ONE integer gather
        per query point for shallow DBs.

        The dense cell level Ld is chosen so (a) every leaf corner is
        cell-aligned and (b) cells are at least as fine as every
        leaf's NOMINAL cube (side 2^(31-level)); then all max-level
        query keys inside one cell share their floor record AND their
        ancestor-test outcome, so both precompute per cell.  Coverage
        comes from the Z-order key gaps — NOT from the stored levels —
        because mesh.e-style databases understate the octant side in
        the level byte (psolve.c mesh_output keys elements with the
        octor level in the etree address space); the gap construction
        reproduces the reference's floor semantics for those exactly.
        Cells whose floor fails the ancestor test hold -1.
        Returns (dense, sh): cell = morton(x >> sh, y >> sh, z >> sh)."""
        if getattr(self, "_dense", None) is not None:
            return self._dense
        if self.n == 0:
            self._dense = (None, 0)
            return self._dense
        x, y, z = morton.deinterleave3(self.hi, self.lo)
        orall = int(np.bitwise_or.reduce(x) | np.bitwise_or.reduce(y)
                    | np.bitwise_or.reduce(z))
        # cell shift: corners must be cell-aligned (>= lowbit zeros)
        # and cells at least as fine as every nominal cube; hb covers
        # full 32-bit address spaces (makecvm layered dbs use them)
        hb = orall.bit_length() if orall else 1
        lowbit = (orall & -orall).bit_length() - 1 if orall else 31
        lmax = int(np.max(self.level))
        sh = max(min(lowbit, 31 - lmax), 0)
        ld = max(hb - sh, 1)
        cells = 1 << (3 * ld)
        if ld > 20 or cells > self._DENSE_MAX_CELLS:
            self._dense = (None, 0)
            return self._dense
        chi, clo = morton.interleave3(
            (x >> sh).astype(np.uint32), (y >> sh).astype(np.uint32),
            (z >> sh).astype(np.uint32))
        starts = clo.astype(np.int64)     # 3*ld <= 60 bits -> lo only
        gaps = np.diff(np.append(starts, cells))
        # ancestor bound: cells past the leaf's nominal cube (side
        # 2^(31-level) ticks = 2^(31-level-sh) cells) fail the
        # ancestor test (floor still lands on this leaf, found=False)
        s = 3 * (31 - self.level.astype(np.int64) - sh)
        s = np.maximum(s, 0)
        nominal_end = ((starts >> s) + 1) << s
        valid = np.minimum(gaps, nominal_end - starts)
        dense = np.full(cells, -1, np.int32)
        total = int(valid.sum())
        cum = np.concatenate([[0], np.cumsum(valid)[:-1]])
        pos = np.repeat(starts, valid) + (
            np.arange(total, dtype=np.int64) - np.repeat(cum, valid))
        dense[pos] = np.repeat(np.arange(self.n, dtype=np.int32),
                               valid)
        self._dense = (dense, sh)
        return self._dense

    def search_points(self, x, y, z):
        """Vectorized etree_search at ETREE_MAXLEVEL: for each tick coord,
        return (found mask, index into payload arrays).

        Classic linear-octree lookup (etree.c:563-615): Morton key of the
        query point, floor search, hit iff the floor record is an ancestor.
        """
        if self.out_of_core:
            return self._search_points_ooc(x, y, z)
        dense, sh = self._dense_lut()
        if dense is not None:
            x = np.atleast_1d(np.asarray(x)).astype(np.uint32)
            y = np.atleast_1d(np.asarray(y)).astype(np.uint32)
            z = np.atleast_1d(np.asarray(z)).astype(np.uint32)
            chi, clo = morton.interleave3(x >> sh, y >> sh, z >> sh)
            cell = clo.astype(np.int64)
            inb = (chi == 0) & (cell < len(dense))
            idx = dense[np.where(inb, cell, 0)]
            ok = inb & (idx >= 0)
            return ok, np.maximum(idx, 0)
        if len(np.atleast_1d(x)) >= 1 << 12:
            from .. import native
            idx = native.etree_search(self.hi, self.lo, self.level,
                                      x, y, z)
            if idx is not None:
                ok = idx >= 0
                return ok, np.maximum(idx, 0)
        qhi, qlo = morton.interleave3(x, y, z)
        # floor search on (hi, lo); a max-level query key always compares
        # >= any leaf key with the same Morton prefix, so a plain Morton
        # floor is exact here.
        idx = floor_indices(self.hi, self.lo, qhi, qlo)
        ok = idx >= 0
        safe = np.maximum(idx, 0)
        anc = morton.is_ancestor(
            self.hi[safe], self.lo[safe], self.level[safe],
            qhi, qlo, np.full(qhi.shape, 31, np.int64))
        return ok & anc, safe


def floor_indices(store_hi, store_lo, q_hi, q_lo):
    """For each 128-bit query key, index of the last stored key <= it
    (-1 if none).  Stored keys must be sorted.  Uses the native binary
    search when available, else a vectorized merge sort."""
    q_hi = np.atleast_1d(q_hi)
    q_lo = np.atleast_1d(q_lo)
    if len(q_hi) >= 1 << 12:
        from .. import native
        r = native.floor_search(store_hi, store_lo, q_hi, q_lo)
        if r is not None:
            return r
    ns, nq = len(store_hi), len(q_hi)
    all_hi = np.concatenate([store_hi, q_hi])
    all_lo = np.concatenate([store_lo, q_lo])
    is_q = np.concatenate(
        [np.zeros(ns, dtype=bool), np.ones(nq, dtype=bool)])
    # order queries after equal stored keys so floor includes exact hits
    order = np.lexsort((is_q, all_lo, all_hi))
    stored_before = np.cumsum(~is_q[order])
    pos = np.empty(len(order), np.int64)
    pos[order] = np.arange(len(order))
    return stored_before[pos[ns:]] - 1
