"""Writer for the reference on-disk etree format (see reader.py for the
layout).  Produces databases readable both by this package and by the
reference tools (q4, single_query, querycvm): a packed B-tree built
bottom-up from Z-order-sorted records, equivalent to the reference's bulk
append path (etree_beginappend with fill ratio 1, etree.c:484,
btree.c append routines).

The port's copy of ``hercules_tpu/etree/writer.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import struct

import numpy as np

from . import morton

_ETREE_HDR = 1 + 4 * 4 + 2 * 4 * 32  # 273 (BIGINT = uint32, etree.h:68)
_BTREE_HDR = 33
_PAGE_HDR = 25


class EtreeWriter:
    """Bulk-build an etree database from sorted leaf octants."""

    def __init__(self, path, payload_size, dimensions=3, pagesize=4096,
                 appmeta=None, asciischema=None):
        self.path = path
        self.payload_size = payload_size
        self.dimensions = dimensions
        self.pagesize = pagesize
        self.appmeta = appmeta
        self.asciischema = asciischema
        self.keysize = dimensions * 4 + 1

    def write(self, x, y, z, level, payload_bytes):
        """x, y, z uint32 [n]; level uint8 [n]; payload_bytes uint8 [n, P].

        Records must be unique; they are sorted into Z-order here.
        """
        n = len(x)
        ks, vs, ps = self.keysize, self.payload_size, self.pagesize
        assert payload_bytes.shape == (n, vs)
        hi, lo, lbyte = morton.morton_key(x, y, z, level, leaf=True)
        order = morton.zorder_argsort(hi, lo, np.asarray(level))
        keys = morton.key_to_bytes(hi[order], lo[order], lbyte[order])
        payload = np.ascontiguousarray(payload_bytes[order])

        schema = self.asciischema.encode() if self.asciischema else b""
        rootstart = _ETREE_HDR + _BTREE_HDR + len(schema)
        rootpagenum = -(-rootstart // ps)  # ceil

        leafcap = (ps - _PAGE_HDR) // (ks + vs)
        idxcap = (ps - _PAGE_HDR) // (ks + 8)

        # split records into leaf pages
        nleaf = max(1, -(-n // leafcap))
        # level histogram for the etree header
        levels = np.asarray(level)
        leafcount = np.bincount(levels.astype(np.int64), minlength=32)

        # build index levels bottom-up: each level is a list of
        # (firstkey, child_page_slot) where slots are assigned later.
        # page slot plan: slot 0 = root page, then remaining pages in
        # BFS order (index levels top-down, leaves last).
        leaf_first_keys = [keys[i * leafcap] for i in range(nleaf)]

        levels_nodes = [list(range(nleaf))]  # leaf slots (relative)
        while len(levels_nodes[-1]) > 1:
            prev = levels_nodes[-1]
            levels_nodes.append(
                [prev[i] for i in range(0, len(prev), idxcap)])
            if len(levels_nodes) > 32:
                raise RuntimeError("btree too deep")
        depth = len(levels_nodes)  # 1 = single leaf page is root

        # assign absolute page numbers: root = rootpagenum; then each
        # level below gets consecutive pages top-down, leaves last.
        pagenums = {}  # (level_idx, position) -> pagenum
        nextpage = rootpagenum
        for li in range(depth - 1, -1, -1):
            cnt = len(levels_nodes[li])
            for pos in range(cnt):
                pagenums[(li, pos)] = nextpage
                nextpage += 1
        pagecount = nextpage - rootpagenum

        buf = bytearray(nextpage * ps)

        def page_header(off, count, rightsib, typ):
            struct.pack_into("<q", buf, off, rightsib)
            struct.pack_into("<i", buf, off + 16, count)
            struct.pack_into("<i", buf, off + 20, -1)
            buf[off + 24] = ord(typ)

        # leaf pages (entries packed vectorized: one [n, ks+vs] table,
        # then per-page block copies)
        entries = np.concatenate([keys, payload], axis=1)  # [n, ks+vs]
        esz = ks + vs
        for i in range(nleaf):
            pnum = pagenums[(0, i)]
            off = pnum * ps
            s, e = i * leafcap, min((i + 1) * leafcap, n)
            rightsib = pagenums[(0, i + 1)] if i + 1 < nleaf else -1
            page_header(off, e - s, rightsib, "l")
            blk = entries[s:e].tobytes()
            buf[off + _PAGE_HDR : off + _PAGE_HDR + len(blk)] = blk

        # index pages
        def first_key_of(li, pos):
            if li == 0:
                return keys[pos * leafcap].tobytes()
            return first_key_of(li - 1, pos * idxcap)

        for li in range(1, depth):
            nchild = len(levels_nodes[li - 1])
            for pos in range(len(levels_nodes[li])):
                pnum = pagenums[(li, pos)]
                off = pnum * ps
                cs, ce = pos * idxcap, min((pos + 1) * idxcap, nchild)
                page_header(off, ce - cs, -1, "i")
                ent = off + _PAGE_HDR
                for c in range(cs, ce):
                    buf[ent : ent + ks] = first_key_of(li - 1, c)
                    struct.pack_into("<q", buf, ent + ks,
                                     pagenums[(li - 1, c)])
                    ent += ks + 8

        # etree meta header
        appmeta = (self.appmeta.encode() + b"\x00") if self.appmeta else b""
        struct.pack_into("<c4I", buf, 0, b"L", 1, self.dimensions, 0,
                         len(appmeta))
        for lv in range(32):
            struct.pack_into("<2I", buf, 17 + 8 * lv,
                             int(leafcount[lv]), 0)
        # btree meta header
        struct.pack_into("<cI2q3I", buf, _ETREE_HDR, b"L", ps,
                         pagecount, rootpagenum, ks, vs, len(schema))
        if schema:
            buf[_ETREE_HDR + _BTREE_HDR : rootstart] = schema

        with open(self.path, "wb") as f:
            f.write(bytes(buf))
            if appmeta:
                f.write(appmeta)
        return n
