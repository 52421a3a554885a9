"""The tiles of ``csrc/bkt_tile.cuh`` as the host needs them: the corner
offsets the BKT kernels take, and K6's per-tile source lists.

K2, K3 and K6 read the node grid as planes: of the three strides of the
corner offsets one is 1 (the inner axis), one the inner extent (the mid
stride) and one a plane (the plane stride).  A block's tile owns OX x OY
nodes (inner x mid) on every plane of its slab; the tiles of a plane are
numbered inner axis first (``make_geom``).  K6's host side lists each
tile's sources (``tile_sources``), so that the thread that updates a
source node adds its increments.  The slab depths and the work items
live in the kernels alone.
"""

from __future__ import annotations

import numpy as np

# threads of a block: one per element of a TX x TY element tile; the
# owned nodes are all but its first column and row (bkt_tile.cuh)
TX, TY = 32, 8
OX, OY = TX - 1, TY - 1


def brick_strides(offs):
    """(mid stride, plane stride) of the flat node grid whose element
    corners are ``offs``; raises unless offs are the 8 corners of such a
    grid (one stride 1, one the inner extent, one a plane of at least
    two rows), which the tiled kernels read as planes of tiles."""
    s = sorted((offs[1], offs[2], offs[4]))
    corners = tuple((j & 1) * offs[1] + (j >> 1 & 1) * offs[2]
                    + (j >> 2 & 1) * offs[4] for j in range(8))
    if (tuple(offs) != corners or s[0] != 1 or s[1] < 2
            or s[2] % s[1] or s[2] // s[1] < 2):
        raise ValueError(f"corner offsets {offs} are not those of a "
                         f"brick's node grid")
    return s[1], s[2]


def tile_counts(offs):
    """(tiles along the inner axis, tiles along the mid axis) of a
    plane."""
    s_mid, s_out = brick_strides(offs)
    return -(-s_mid // OX), -(-(s_out // s_mid) // OY)


def tile_of(offs, n):
    """The tile of each node column of ``n``."""
    s_mid, s_out = brick_strides(offs)
    y, x = np.divmod(np.asarray(n, np.int64) % s_out, s_mid)
    return x // OX + (y // OY) * tile_counts(offs)[0]


def tile_sources(offs, src_pos):
    """(tile_ptr [tiles + 1], tile_src [L]) int32: the sources on tile i
    (on any slab) are tile_src[tile_ptr[i]:tile_ptr[i + 1]], in source
    order."""
    src_pos = np.asarray(src_pos, np.int64).reshape(-1)
    tiles = tile_of(offs, src_pos)
    order = np.argsort(tiles, kind="stable")
    tx, ty = tile_counts(offs)
    counts = np.bincount(tiles, minlength=tx * ty)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return ptr.astype(np.int32), order.astype(np.int32)
