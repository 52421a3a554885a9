"""The tiles of ``csrc/bkt_tile.cuh`` as the host needs them: the corner
offsets the tiled kernels take, and the chunk kernels' per-tile source
lists.

K1, K2, K3, K5 and K6 read the node grid as planes: of the three
strides of the corner offsets one is 1 (the inner axis), one the inner
extent (the mid stride) and one a plane (the plane stride).  A block's
tile owns OX x OY nodes (inner x mid) on every plane of its slab; the
tiles of a plane are numbered inner axis first (``make_geom``).  The
chunk kernels' host side lists each tile's sources (``tile_sources``,
kept per ``src_pos`` tensor and version by ``source_lists``), so that
the thread that updates a source node adds its increments.  The slab
depths and the work items live in the kernels; ``corner_grid`` mirrors
K4's rule (``csrc/bkt_corner.cu:corner_geom``) and ``step_grid`` K1's
(``csrc/brick_step.cu:step_slab``), which the tests and the card's
phases hold against the kernels' own counts.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

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


# K4's deepest slab (bkt_corner.cu's kCornerSlab)
CORNER_SLAB = 2


def corner_grid(offs, LEN, resident):
    """(slab depth, work items) of K4 on the brick of ``offs`` and LEN
    columns with ``resident`` blocks on the card at once: CORNER_SLAB
    planes, thinned until there is a work item for every resident
    block, one plane where even that falls short
    (bkt_corner.cu:corner_geom); item i is tile i % tiles on slab i //
    tiles."""
    tiles = int(np.prod(tile_counts(offs)))
    nplanes = -(-LEN // brick_strides(offs)[1])
    slab = max(1, min(CORNER_SLAB, tiles * nplanes // resident))
    return slab, tiles * -(-nplanes // slab)


# K1's deepest slab and the state planes its ring holds
# (brick_step.cu's kStepSlabMax, brick_tile.cuh's kStepStages)
STEP_SLAB_MAX = 12
STEP_STAGES = 3


def step_makespan(tiles, nplanes, slab, resident):
    """How long K1's work items of slabs of ``slab`` planes keep the
    card, in half planes: ``resident`` blocks take the items in order
    (every tile of slab 0, then of slab 1, ...), each the next as one
    ends; an item of p planes takes 2 p + 1."""
    ends, last = [], 0
    for a0 in range(0, nplanes, slab):
        d = 2 * min(slab, nplanes - a0) + 1
        for _ in range(tiles):
            start = heapq.heappop(ends) if len(ends) == resident else 0
            heapq.heappush(ends, start + d)
            last = max(last, start + d)
    return last


def step_grid(offs, LEN, resident):
    """(slab depth, work items) of K1 on the brick of ``offs`` and LEN
    columns with ``resident`` blocks on the card at once: of 1 ..
    STEP_SLAB_MAX planes (at most the brick's), the slab whose items end
    first (step_makespan), the deepest of equals
    (brick_step.cu:step_slab); item i is tile i % tiles on slab i //
    tiles."""
    tiles = int(np.prod(tile_counts(offs)))
    nplanes = -(-LEN // brick_strides(offs)[1])
    best = None
    for slab in range(1, min(STEP_SLAB_MAX, nplanes) + 1):
        t = step_makespan(tiles, nplanes, slab, resident)
        if best is None or t <= best[0]:
            best = (t, slab)
    return best[1], tiles * -(-nplanes // best[1])


def step_items(offs, LEN, slab):
    """K1's work items on slabs of ``slab`` planes, in launch order:
    (the node columns each owns, its first plane, its end plane)."""
    s_mid, s_out = brick_strides(offs)
    ny = s_out // s_mid
    tx, ty = tile_counts(offs)
    nplanes = -(-LEN // s_out)
    for a0 in range(0, nplanes, slab):
        a1 = min(a0 + slab, nplanes)
        for t in range(tx * ty):
            x0, y0 = (t % tx) * OX, (t // tx) * OY
            x = np.arange(x0, min(x0 + OX, s_mid))
            y = np.arange(y0, min(y0 + OY, ny))
            a = np.arange(a0, a1)
            n = (a[:, None, None] * s_out + y[None, :, None] * s_mid
                 + x[None, None, :]).ravel()
            yield n[n < LEN], a0, a1


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


# the last source_lists result, with the src_pos tensor it was made from
# and that tensor's version counter: the lists are read from src_pos's
# values, so they are kept by the tensor itself (held here, so that its
# memory is not handed to another tensor) and not by its address
_SOURCES = {}


def source_lists(src_pos, offs, LEN, device):
    """(int32 positions or None, tile_ptr, tile_src) of the sources at
    src_pos [L] (or None) on ``device``, as the chunk kernels (K5, K6)
    take them (see tile_sources); made again unless src_pos is the
    tensor of the last call, unmodified, on the same grid and device."""
    key = (offs, LEN, device)
    held = _SOURCES.get("last")
    if (held is not None and held[0] is src_pos and held[1] == key
            and (src_pos is None or held[2] == src_pos._version)):
        return held[3]
    L = 0 if src_pos is None else src_pos.shape[0]
    ptr, order = tile_sources(offs, [] if not L else src_pos.cpu().numpy())
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    # the kernel indexes with 32-bit ints
    got = (None if not L else as_dev(src_pos), as_dev(ptr), as_dev(order))
    _SOURCES["last"] = (src_pos, key,
                        None if src_pos is None else src_pos._version, got)
    return got
