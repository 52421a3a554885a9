"""The host side of the tiled kernels (csrc/bkt_tile.cuh): the (tile,
slab) work items of make_geom own every node column exactly once, with
K1's and K2's 8-plane slabs, with the chunk kernels' deeper ones and
with K4's slab rule (kernels/tiles.py:corner_grid); the
wrappers refuse corner offsets that are not a brick's; the chunk
kernels' per-tile source lists (kernels/tiles.py) hold every source
once, in source order, and are made from src_pos's values, never from
its address.  CPU only."""

import numpy as np
import pytest
import torch

from hercules_tpu_torch.kernels import tiles
from hercules_tpu_torch.kernels.brick_chunk import brick_chunk
from hercules_tpu_torch.kernels.brick_step import brick_step
from hercules_tpu_torch.kernels.tiles import source_lists
from hercules_tpu_torch.solver.fused_brick import pallas_geometry


def corner_offsets(sx, sy, sz):
    """The 8 corners of a flat node grid with axis strides (sx, sy, sz),
    in Brick.corner_offsets' order."""
    return tuple((j & 1) * sx + (j >> 1 & 1) * sy + (j >> 2 & 1) * sz
                 for j in range(8))


# (node extents inner x mid x planes, corner offsets): the 2^20-element
# box (129 x 129 x 65 nodes, x the inner axis as its brick has it), the
# 2048-element box, and a grid with an odd inner extent whose x axis is
# the plane axis
GRIDS = {
    "2^20": ((129, 129, 65), corner_offsets(1, 129, 129 * 129)),
    "2048": ((17, 17, 9), corner_offsets(1, 17, 289)),
    "odd": ((33, 12, 5), corner_offsets(33 * 12, 1, 33)),
}


def test_small_box_offsets_are_its_bricks(tmp_path):
    """The 2048-element box's brick has the corner offsets GRIDS uses
    (x inner, then y, then z)."""
    from hercules_tpu_torch.fixtures import box_simulation
    from hercules_tpu_torch.solver.bricks import build_plan
    sim = box_simulation(str(tmp_path), steps=2, damping="bkt")
    b = build_plan(sim.mesh).bricks[0]
    assert tuple(b.corner_offsets()) == GRIDS["2048"][1]
    assert b.nb == 17 * 17 * 9


def items(offs, LEN, slab):
    """The work items of make_geom's grid with slabs of ``slab`` planes
    (tile_items)."""
    nplanes = -(-LEN // tiles.brick_strides(offs)[1])
    tx, ty = tiles.tile_counts(offs)
    return tx * ty * -(-nplanes // slab)


def owned(offs, LEN, slab, item):
    """The node columns work item ``item`` owns, ascending, as the tile
    march of bkt_tile.cuh stores them: item i is tile i % tiles on slab
    i // tiles, a tile the OX x OY nodes after its first element column
    and row."""
    s_mid, s_out = tiles.brick_strides(offs)
    tx, ty = tiles.tile_counts(offs)
    tile, sl = item % (tx * ty), item // (tx * ty)
    x0, y0 = (tile % tx) * tiles.OX, (tile // tx) * tiles.OY
    a = np.arange(sl * slab, min((sl + 1) * slab, -(-LEN // s_out)))
    y = np.arange(y0, min(y0 + tiles.OY, s_out // s_mid))
    x = np.arange(x0, min(x0 + tiles.OX, s_mid))
    n = (a[:, None, None] * s_out + y[None, :, None] * s_mid
         + x[None, None, :]).ravel()
    return n[n < LEN]


# slab depths: K1's, K2's and K3's kSlab, the chunk kernels' at 2^20 elements in float32 (3
# blocks per SM on 132 SMs) and in float64 (2), one plane, and K4's rule
# (corner_grid) for its resident blocks on an H100 in float32 (two per
# SM: 264) and in float64 (one per SM: 132).  K4 stores each element
# column's memory variables where it owns the element's lowest corner,
# the node column of the same index, so these items also store every
# element column exactly once.
SLABS = (8, 17, 33, 1, "corner 264", "corner 132")
# K4's (slab, work items) by grid and resident blocks: one plane on the
# small grids, two at 2^20 elements
CORNER_GRIDS = {("2^20", 264): (2, 3135), ("2^20", 132): (2, 3135),
                ("2048", 264): (1, 33), ("2048", 132): (1, 33),
                ("odd", 264): (1, 24), ("odd", 132): (1, 24)}


@pytest.mark.parametrize("slab", SLABS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_items_partition_the_columns(grid, slab):
    (nx, ny, nz), offs = GRIDS[grid]
    nb = nx * ny * nz
    LEN = pallas_geometry(nb)
    assert tiles.brick_strides(offs) == (nx, nx * ny)
    if isinstance(slab, str):
        resident = int(slab.split()[1])
        slab, n_items = tiles.corner_grid(offs, LEN, resident)
        assert (slab, n_items) == CORNER_GRIDS[(grid, resident)]
    n_items = items(offs, LEN, slab)
    if grid == "2^20":
        assert LEN == 1082368
        assert n_items == {8: 855, 17: 380, 33: 190, 1: 6270, 2: 3135}[slab]
    tiles_n = np.prod(tiles.tile_counts(offs))
    got = [owned(offs, LEN, slab, i) for i in range(n_items)]
    cols = np.concatenate(got)
    # every column of [0, LEN), the brick's nodes [0, nb) among them,
    # exactly once
    assert len(cols) == LEN >= nb
    assert np.array_equal(np.sort(cols), np.arange(LEN))
    for i, n in enumerate(got):
        assert (tiles.tile_of(offs, n) == i % tiles_n).all()
        assert len(n) <= tiles.OX * tiles.OY * slab


def test_refuses_offsets_not_a_bricks():
    """tiles.brick_strides refuses corner offsets that are not a brick's,
    and so do the K1 and K5 wrappers' checks, before any launch."""
    bad = (0, 1, 17, 18, 289, 290, 306, 308)
    with pytest.raises(ValueError, match="brick's node grid"):
        tiles.brick_strides(bad)
    S = torch.zeros((8, 1024), device="meta")
    ops = torch.zeros((48, 24), device="meta")
    srcf = torch.zeros((4, 3, 0), device="meta")
    before = brick_step.launches, brick_chunk.launches
    with pytest.raises(ValueError, match="brick's node grid"):
        brick_step(S, S.clone(), bad, ops)
    with pytest.raises(ValueError, match="brick's node grid"):
        brick_chunk(S, torch.empty_like(S), S.clone(), bad, ops, srcf)
    assert (brick_step.launches, brick_chunk.launches) == before


def sources_at(grid):
    """Source positions on ``grid``: two at one node, one on each side of
    a tile edge, twelve at random and one more at the first edge's."""
    (nx, ny, nz), _ = GRIDS[grid]
    rng = np.random.default_rng(5)
    edge = tiles.OX                      # the first node of the 2nd tile
    return np.array([nx * ny + 3, edge - 1, nx * ny + 3, edge % nx,
                     *rng.integers(0, nx * ny * nz, 12), edge - 1])


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tile_sources_in_source_order(grid):
    """Every source index is in exactly one tile's list, the tile of its
    node, in source order; two sources at one node (and one on each side
    of a tile edge) included.  The chunk kernels' rule -- each work
    item's threads add, at the nodes they own, the sources of the item's
    tile in list order -- is the step route's source add in source
    order."""
    (nx, ny, nz), offs = GRIDS[grid]
    LEN = pallas_geometry(nx * ny * nz)
    slab = 17
    pos = sources_at(grid)
    ptr, lst = tiles.tile_sources(offs, pos)
    tiles_n = np.prod(tiles.tile_counts(offs))
    assert ptr.dtype == lst.dtype == np.int32
    assert len(ptr) == tiles_n + 1 and ptr[0] == 0 and ptr[-1] == len(pos)
    assert np.array_equal(np.sort(lst), np.arange(len(pos)))
    for t in range(tiles_n):
        mine = lst[ptr[t]:ptr[t + 1]]
        assert (np.diff(mine) > 0).all()
        assert (tiles.tile_of(offs, pos[mine]) == t).all()
    rng = np.random.default_rng(6)
    inc = rng.standard_normal(len(pos))
    got = np.zeros(LEN)
    for i in range(items(offs, LEN, slab)):
        t = i % tiles_n
        mine = owned(offs, LEN, slab, i)
        for m in lst[ptr[t]:ptr[t + 1]]:
            if np.isin(pos[m], mine):
                got[pos[m]] = got[pos[m]] + inc[m]
    want = np.zeros(LEN)
    for m in range(len(pos)):
        want[pos[m]] = want[pos[m]] + inc[m]
    assert np.array_equal(got, want)
    empty_ptr, empty = tiles.tile_sources(offs, [])
    assert len(empty) == 0 and not empty_ptr.any()


def test_source_lists_follow_the_values():
    """The chunk kernels' source arrays are made again when src_pos's values change at
    the same address: changed in place, or another tensor on the same
    memory; the same tensor, unchanged, reuses them."""
    (nx, ny, nz), offs = GRIDS["2048"]
    LEN = pallas_geometry(nx * ny * nz)
    cpu = torch.device("cpu")

    def want(pos):
        ptr, lst = tiles.tile_sources(offs, pos.numpy())
        return pos.to(torch.int32), ptr, lst

    def check(got, pos):
        for g, w in zip(got, want(pos)):
            assert g.dtype == torch.int32 and g.device == cpu
            assert np.array_equal(g.numpy(), np.asarray(w))

    buf = torch.as_tensor(sources_at("2048"))
    pos = buf[:4]
    first = source_lists(pos, offs, LEN, cpu)
    check(first, pos)
    assert source_lists(pos, offs, LEN, cpu) is first
    buf[:4] = torch.as_tensor([5, 40, 40, 2000])   # in place, same address
    check(source_lists(pos, offs, LEN, cpu), pos)
    again = buf[:4]                                # same address, new tensor
    assert again.data_ptr() == pos.data_ptr()
    buf[1] = 300
    check(source_lists(again, offs, LEN, cpu), again)
    assert source_lists(None, offs, LEN, cpu)[0] is None
    assert not source_lists(None, offs, LEN, cpu)[1].any()
