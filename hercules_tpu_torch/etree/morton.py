"""Vectorized Morton (Z-order) locational codes.

The reference implements octant locational keys as byte strings produced by
bit-interleaving three 32-bit tick coordinates LSB-first (x at bit offset 0,
y at 1, z at 2), plus a leading level/type byte
(the reference's etree/code.c:57-95, 382-434).  It uses 196k lines of
generated lookup tables; here the same transform is three table lookups per
byte in NumPy, vectorized over whole arrays.

A 96-bit Morton code is represented as a pair of uint64 arrays ``(hi, lo)``:
``lo`` holds interleaved bits 0..63, ``hi`` holds bits 64..95.

The port's copy of ``hercules_tpu/etree/morton.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "interleave3",
    "deinterleave3",
    "morton_key",
    "key_to_bytes",
    "bytes_to_key",
    "zorder_argsort",
    "is_ancestor",
]


def _make_spread_table() -> np.ndarray:
    """T[b] = 8 bits of b spread to every 3rd bit (bit i -> bit 3*i)."""
    t = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        v = 0
        for i in range(8):
            if b & (1 << i):
                v |= 1 << (3 * i)
        t[b] = v
    return t


def _make_compact_table() -> np.ndarray:
    """C[m] = bits of m at positions 0,3,6,... compacted to bits 0,1,2,..

    m ranges over 9-bit chunks (3 coordinate bits interleaved with 6 others).
    """
    t = np.zeros(512, dtype=np.uint64)
    for m in range(512):
        v = 0
        for i in range(3):
            if m & (1 << (3 * i)):
                v |= 1 << i
        t[m] = v
    return t


_SPREAD = _make_spread_table()
_COMPACT = _make_compact_table()


def interleave3(x, y, z):
    """Interleave three uint32/int arrays into 96-bit Morton codes.

    Bit ``i`` of x lands at Morton bit ``3*i``, y at ``3*i+1``, z at
    ``3*i+2`` (matches code_coord2morton_port, code.c:390-434).

    Returns (hi, lo) uint64 arrays.
    """
    n = np.size(x)
    if n >= 1 << 14:
        from .. import native
        r = native.interleave3(x, y, z)
        if r is not None:
            return r
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    z = np.asarray(z, dtype=np.uint64)
    hi = np.zeros(x.shape, dtype=np.uint64)
    lo = np.zeros(x.shape, dtype=np.uint64)
    for j in range(4):  # byte j of each coordinate
        shift = np.uint64(8 * j)
        sx = _SPREAD[((x >> shift) & np.uint64(0xFF)).astype(np.int64)]
        sy = _SPREAD[((y >> shift) & np.uint64(0xFF)).astype(np.int64)]
        sz = _SPREAD[((z >> shift) & np.uint64(0xFF)).astype(np.int64)]
        chunk = sx | (sy << np.uint64(1)) | (sz << np.uint64(2))  # 24 bits
        s = 24 * j  # chunk goes to Morton bits [24j, 24j+24)
        if s < 64:
            lo |= chunk << np.uint64(s)
            if s + 24 > 64:
                hi |= chunk >> np.uint64(64 - s)
        else:
            hi |= chunk << np.uint64(s - 64)
    return hi, lo


def deinterleave3(hi, lo):
    """Inverse of :func:`interleave3`. Returns (x, y, z) uint32 arrays."""
    if np.size(hi) >= 1 << 14:
        from .. import native
        r = native.deinterleave3(hi, lo)
        if r is not None:
            return r
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    x = np.zeros(hi.shape, dtype=np.uint64)
    y = np.zeros(hi.shape, dtype=np.uint64)
    z = np.zeros(hi.shape, dtype=np.uint64)
    # process 9 Morton bits (3 coordinate bits) at a time: chunks k=0..10
    # cover bits [9k, 9k+9) of the 96-bit code.
    for k in range(11):
        s = 9 * k
        if s + 9 <= 64:
            chunk = (lo >> np.uint64(s)) & np.uint64(0x1FF)
        elif s < 64:
            chunk = ((lo >> np.uint64(s)) | (hi << np.uint64(64 - s))) & np.uint64(0x1FF)
        else:
            chunk = (hi >> np.uint64(s - 64)) & np.uint64(0x1FF)
        ci = chunk.astype(np.int64)
        x |= _COMPACT[ci] << np.uint64(3 * k)
        y |= _COMPACT[(ci >> 1) & 0x1FF] << np.uint64(3 * k)
        z |= _COMPACT[(ci >> 2) & 0x1FF] << np.uint64(3 * k)
    return (
        x.astype(np.uint32),
        y.astype(np.uint32),
        z.astype(np.uint32),
    )


def morton_key(x, y, z, level, leaf=True):
    """Full etree locational key: (hi, lo, lbyte).

    lbyte = level | 0x80 for leaves (code.c:57-95).
    """
    hi, lo = interleave3(x, y, z)
    level = np.asarray(level, dtype=np.uint8)
    lbyte = level | np.uint8(0x80) if leaf else level
    return hi, lo, np.broadcast_to(lbyte, hi.shape).copy()


def key_to_bytes(hi, lo, lbyte):
    """Serialize keys to the 13-byte on-disk format (level byte first,
    then 12 Morton bytes little-endian)."""
    hi = np.atleast_1d(np.asarray(hi, dtype="<u8"))
    lo = np.atleast_1d(np.asarray(lo, dtype="<u8"))
    lbyte = np.atleast_1d(np.asarray(lbyte, dtype=np.uint8))
    n = hi.shape[0]
    out = np.zeros((n, 13), dtype=np.uint8)
    out[:, 0] = lbyte
    out[:, 1:9] = lo.view(np.uint8).reshape(n, 8)
    out[:, 9:13] = hi.view(np.uint8).reshape(n, 8)[:, :4]
    return out


def bytes_to_key(buf):
    """Parse an (n, 13) uint8 array of on-disk keys -> (hi, lo, lbyte)."""
    buf = np.asarray(buf, dtype=np.uint8)
    if buf.ndim == 1:
        buf = buf.reshape(1, -1)
    n = buf.shape[0]
    lbyte = buf[:, 0].copy()
    lo = buf[:, 1:9].copy().view("<u8").reshape(n)
    hi8 = np.zeros((n, 8), dtype=np.uint8)
    hi8[:, :4] = buf[:, 9:13]
    hi = hi8.view("<u8").reshape(n)
    return hi, lo, lbyte


def zorder_argsort(hi, lo, level=None):
    """Argsort by Morton code (then level), matching code_comparekey
    (code.c:288-319): Morton bytes most-significant first, level last."""
    if level is None:
        from .. import native
        perm = native.sort_perm(hi, lo)   # parallel C++ (hi, lo) sort
        if perm is not None:
            return perm
        return np.lexsort((lo, hi))
    return np.lexsort((np.asarray(level), lo, hi))


def is_ancestor(anc_hi, anc_lo, anc_level, ch_hi, ch_lo, ch_level, bits=32):
    """Vectorized code_isancestorkey (code.c): the ancestor octant at level
    ``l`` shares the top ``3*(l+1)`` Morton bits (of ``3*bits`` total) with
    the child."""
    anc_level = np.asarray(anc_level, dtype=np.int64)
    ch_level = np.asarray(ch_level, dtype=np.int64)
    # number of low bits that may differ
    nbits = 3 * bits - 3 * (anc_level + 1)
    ok = ch_level >= anc_level
    lo_bits = np.minimum(nbits, 64)
    hi_bits = np.maximum(nbits - 64, 0)

    def same_above(a, b, nb):
        """True where a and b agree above their low nb bits (one xor +
        one shift instead of two mask-and-compare passes)."""
        x = np.asarray(a, np.uint64) ^ np.asarray(b, np.uint64)
        full = nb >= 64
        sh = np.where(full, 0, nb).astype(np.uint64)
        return full | ((x >> sh) == 0)

    return (ok & same_above(anc_lo, ch_lo, lo_bits)
            & same_above(anc_hi, ch_hi, hi_bits))
