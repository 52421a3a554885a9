"""The port's single-brick solver (plain versions on the CPU) against
the JAX package's brick solver and fused Pallas kernel, float64, on the
homogeneous box and on the four-layer Rayleigh box (one brick with
per-element c1, c2 and beta); the zero rows 6:8 of every [8, LEN] state
the routes that step the layout S are given; the elastic spectral
header the K1 and K5 kernels form each element's force from; and K1's
launch geometry as kernels/tiles.py mirrors it."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.assemble import assemble as jax_assemble
from hercules_tpu.solver.bricks import build_plan as jax_build_plan
from hercules_tpu.solver.brickstep import brick_u_global, run_brick_solver
from hercules_tpu.solver.pallas_brick import \
    PallasBrickTables as JaxPallasBrickTables
from hercules_tpu.solver.pallas_brick import \
    init_packed_state as jax_init_packed_state
from hercules_tpu.solver.pallas_brick import make_packed_pallas_step
from hercules_tpu.solver.pallas_brick import \
    pallas_u_global as jax_pallas_u_global
from hercules_tpu.solver.pallas_brick import \
    run_pallas_solver as jax_run_pallas_solver
from hercules_tpu_torch.convert import state_from_jax
from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, GRADED_LAYERS,
                                         box_simulation, four_q_freq)
from hercules_tpu_torch.kernels import tiles
from hercules_tpu_torch.kernels.brick_step import (brick_step,
                                                   brick_step_lean,
                                                   brick_step_lean_plain,
                                                   brick_step_plain)
from hercules_tpu_torch.parallel.driver import choose_path
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_mesh import (MeshPallasTables,
                                                  restore_mesh_state)
from hercules_tpu_torch.solver.restart import Checkpoint
from hercules_tpu_torch.physics.kmats import (hadamard8_stages,
                                              spectral_factors)
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   operators,
                                                   pallas_u_global,
                                                   restore_packed_state,
                                                   run_pallas_solver)

T = 40


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp("box")), steps=T)
    return (sim, build_plan(sim.mesh), jax_assemble(sim.mesh, sim.params),
            jax_build_plan(sim.mesh))


@pytest.fixture(scope="module")
def layered(tmp_path_factory):
    """The four-layer box at 62.5 m with Rayleigh damping: 2048 elements
    in one brick, four sets of (c1, c2, beta)."""
    sim = box_simulation(str(tmp_path_factory.mktemp("layered")), steps=T,
                         damping="rayleigh", layers=FOUR_Q_LAYERS,
                         freq=four_q_freq(62.5))
    return (sim, build_plan(sim.mesh), jax_assemble(sim.mesh, sim.params),
            jax_build_plan(sim.mesh))


def _port(sim, plan, src_ids, forces, **kw):
    st = sim.stations
    return run_pallas_solver(plan, sim.tables, src_ids, forces, T,
                             sim.params.delta_t, st_nodes=st.nodes,
                             st_phi=st.phi, dtype=torch.float64,
                             device="cpu", **kw)


def _plain_matches_jax(case, monkeypatch):
    """Point source and 2 stations, 40 steps: the port's plain route
    against run_brick_solver and the Pallas kernel (interpret mode),
    2e-13 max|u| on the field and 2e-13 max(|samples|, 1) on the
    samples; the padding stays exactly zero."""
    monkeypatch.setenv("HT_PALLAS_TILE", "1024")
    sim, plan, jtab, jplan = case
    st, dt, N = sim.stations, sim.params.delta_t, sim.mesh.nnum
    (u, _), samp = _port(sim, plan, sim.src_ids, sim.src_forces)
    u_t = pallas_u_global(plan, u, N)
    assert not u[:, plan.bricks[0].nb:].any()
    state_b, samp_b = run_brick_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float64)
    state_p, samp_p = jax_run_pallas_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float64,
        interpret=True)
    for u_ref, s_ref in ((brick_u_global(jplan, state_b[0], N), samp_b),
                         (jax_pallas_u_global(jplan, state_p[0], N),
                          samp_p)):
        scale = np.abs(u_ref).max()
        assert scale > 0
        np.testing.assert_allclose(u_t, u_ref, rtol=0, atol=2e-13 * scale)
        np.testing.assert_allclose(
            samp, np.asarray(s_ref), rtol=0,
            atol=2e-13 * max(np.abs(s_ref).max(), 1))


def test_plain_matches_jax(box, monkeypatch):
    """_plain_matches_jax on the homogeneous box."""
    _plain_matches_jax(box, monkeypatch)


def test_plain_matches_jax_layered(layered, monkeypatch):
    """_plain_matches_jax on the four-layer Rayleigh box, whose elements
    carry four different (c1, c2, beta)."""
    sim, plan = layered[:2]
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                           device="cpu")
    valid = pt.K[0] != 0
    for r in range(3):
        assert len(torch.unique(pt.K[r][valid])) == 4
    _plain_matches_jax(layered, monkeypatch)


def test_plain_matches_jax_legacy_layout(box, monkeypatch):
    """The JAX package's legacy 3-row route (HT_PALLAS_STATE=legacy:
    make_pallas_step -> build_call, interpret mode) against the port's
    brick_step_plain route, 40 steps: 2e-13 max|u| and 2e-13
    max(|samples|, 1).  The port's K1 is that kernel's counterpart."""
    monkeypatch.setenv("HT_PALLAS_TILE", "1024")
    monkeypatch.setenv("HT_PALLAS_STATE", "legacy")
    sim, plan, jtab, jplan = box
    st, N = sim.stations, sim.mesh.nnum
    (u, _), samp = _port(sim, plan, sim.src_ids, sim.src_forces,
                         route="step")
    state_p, samp_p = jax_run_pallas_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, sim.params.delta_t,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float64,
        interpret=True)
    assert len(state_p) == 2 and state_p[0].shape[0] == 3
    u_ref = jax_pallas_u_global(jplan, state_p[0], N)
    scale = np.abs(u_ref).max()
    assert scale > 0
    np.testing.assert_allclose(pallas_u_global(plan, u, N), u_ref, rtol=0,
                               atol=2e-13 * scale)
    np.testing.assert_allclose(samp, np.asarray(samp_p), rtol=0,
                               atol=2e-13 * max(np.abs(samp_p).max(), 1))


@pytest.mark.parametrize("route", ["step", "chunk"])
def test_duplicate_sources_summed(box, route):
    """Sources that share a node add up on both routes, as the JAX
    package's .at[].add does."""
    sim, plan, jtab, jplan = box
    mid = sim.mesh.elem_lnid[sim.mesh.lenum // 2]
    src = np.array([mid[0], mid[3], mid[0], mid[5], mid[3]], np.int32)
    forces = np.random.default_rng(11).standard_normal((T, 5, 3)) * 1e10
    (u, _), samp = _port(sim, plan, src, forces, route=route, chunk=16)
    state_b, samp_b = run_brick_solver(
        jplan, jtab, src, forces, T, sim.params.delta_t,
        st_nodes=sim.stations.nodes, st_phi=sim.stations.phi,
        dtype=jnp.float64)
    u_ref = brick_u_global(jplan, state_b[0], sim.mesh.nnum)
    scale = np.abs(u_ref).max()
    assert scale > 0
    np.testing.assert_allclose(pallas_u_global(plan, u, sim.mesh.nnum),
                               u_ref, rtol=0, atol=2e-13 * scale)
    np.testing.assert_allclose(samp, np.asarray(samp_b), rtol=0,
                               atol=2e-13 * max(np.abs(samp_b).max(), 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_runs_plain(box, dtype):
    """brick_step on a CPU tensor is brick_step_plain, with or without
    ``out``, and counts no launch."""
    sim, plan, _, _ = box
    pt = PallasBrickTables(plan, sim.tables, dtype=dtype, device="cpu")
    rng = np.random.default_rng(2)
    S = torch.zeros((8, pt.LEN), dtype=dtype)
    S[0:6, :pt.nb] = torch.as_tensor(rng.standard_normal((6, pt.nb)))
    before = brick_step.launches
    ref = brick_step_plain(S, pt.K, pt.offs, pt.step.ops)
    assert torch.equal(brick_step(S, pt.K, pt.offs, pt.step.ops), ref)
    out = torch.empty_like(S)
    assert brick_step(S, pt.K, pt.offs, pt.step.ops, out=out) is out
    assert torch.equal(out, ref)
    assert torch.equal(pt.step(S), ref)
    assert brick_step.launches == before
    assert not ref[:, pt.nb:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lean_plain_is_the_step_rows(layered, dtype):
    """K1's lean form on CPU tensors (brick_step_lean_plain, through
    brick_step_lean) gives brick_step_plain's rows 0:3 bit for bit from
    u and u- in blocks of their own, writing nothing else of its out;
    with ``canonical`` the layout (u+, u, 0, 0); on the four-layer
    Rayleigh box (beta != 0) and counting no launch."""
    sim, plan, _, _ = layered
    pt = PallasBrickTables(plan, sim.tables, dtype=dtype, device="cpu")
    rng = np.random.default_rng(4)
    S = torch.zeros((8, pt.LEN), dtype=dtype)
    S[0:6, :pt.nb] = torch.as_tensor(rng.standard_normal((6, pt.nb)))
    ref = brick_step_plain(S, pt.K, pt.offs, pt.step.ops)
    U, Um = S[0:3].clone(), S[3:6].clone()
    assert torch.equal(brick_step_lean_plain(U, Um, pt.K, pt.offs,
                                             pt.step.ops), ref[0:3])
    before = brick_step.launches, brick_step.lean_launches
    buf = torch.full((8, pt.LEN), float("nan"), dtype=dtype)
    assert brick_step_lean(U, Um, pt.K, pt.offs, pt.step.ops,
                           buf[0:3]) is not None
    assert torch.equal(buf[0:3], ref[0:3])
    assert buf[3:8].isnan().all()
    out = torch.full((8, pt.LEN), float("nan"), dtype=dtype)
    pt.step.lean(U, Um, out, canonical=True)
    assert torch.equal(out, ref)
    assert (brick_step.launches, brick_step.lean_launches) == before


@pytest.fixture(scope="module")
def graded(tmp_path_factory):
    """GRADED_LAYERS at 62.5 m: three bricks, 592 elements."""
    sim = box_simulation(str(tmp_path_factory.mktemp("graded")), steps=T,
                         layers=GRADED_LAYERS, freq=four_q_freq(62.5))
    return sim, build_plan(sim.mesh)


def _fields(sim):
    """Seeded global fields u and u- [N, 3]."""
    g = np.random.default_rng(5)
    u = g.standard_normal((sim.mesh.nnum, 3))
    return u, u - 0.1 * g.standard_normal(u.shape)


def _layout_s_states(maker, dtype, box, graded, monkeypatch):
    """(states, modules): [8, LEN] states from ``maker``'s constructor
    of a route that steps the layout S, and the BrickStep modules that
    step the first of them (the mesh's loose section has none)."""
    if maker == "mesh":
        sim, plan = graded
        mt = MeshPallasTables(plan, sim.tables, dtype=dtype, device="cpu")
        Ss, _, _ = restore_mesh_state(mt, Checkpoint(*_fields(sim)))
        return Ss, mt.steps
    sim, plan, jtab, jplan = box
    if maker == "slab":
        path, _ = choose_path(sim.mesh, sim.tables, RankGroup(["cpu"] * 2),
                              src_ids=sim.src_ids, dtype=dtype,
                              prefer="slab_pallas")
        states = path.state_from_global(*_fields(sim), ())
        return [s[0] for s in states], [m[0] for m in path.step.mods]
    pt = PallasBrickTables(plan, sim.tables, dtype=dtype, device="cpu")
    if maker == "packed":
        return restore_packed_state(pt, plan, Checkpoint(*_fields(sim))), \
            [pt.step]
    # convert.state_from_jax: a packed state written by the JAX
    # package's step (interpret mode) from its zero state given seeded
    # u and u-, and a pair of global fields
    monkeypatch.setenv("HT_PALLAS_TILE", "1024")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jpt = JaxPallasBrickTables(jplan, jtab, sim.src_ids, dtype=jdt)
    (S0,) = jax_init_packed_state(jpt)
    nb = jplan.bricks[0].nb
    for r, x in zip((0, 3), _fields(sim)):
        S0 = S0.at[r:r + 3, :nb].set(
            jnp.asarray(x[jplan.gnid_cat[:nb]].T, jdt))
    step, consts = make_packed_pallas_step(jpt, interpret=True)
    (S_jax,), _ = step(consts, (S0,),
                       (jnp.zeros((len(sim.src_ids), 3), jdt), 0))
    states = [torch.as_tensor(state_from_jax(x, plan)).to(dtype)
              for x in (np.asarray(S_jax), _fields(sim))]
    return states, [pt.step, pt.step]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("maker", ["packed", "mesh", "slab", "jax"])
def test_layout_s_states_have_zero_rows(maker, dtype, box, graded,
                                        monkeypatch):
    """Every constructor of an [8, LEN] state on the routes that step
    the layout S (fused_brick's packed state and its restore, the mesh
    route's restore, the slab ranks', convert.state_from_jax) leaves
    rows 6:8 zero, so K1's canonical form, which writes zeros there, is
    brick_step_plain, which carries them: BrickStep on the CPU equals it
    bit for bit."""
    states, mods = _layout_s_states(maker, dtype, box, graded, monkeypatch)
    for S in states:
        assert S.dtype == dtype and S.shape[0] == 8
        assert not S[6:8].any()
    for S, mod in zip(states, mods):
        assert S[0:6].any()
        assert torch.equal(mod(S), brick_step_plain(S, mod.K, mod.offs,
                                                    mod.ops))


def _elastic_header():
    """The (M1, M2) entry lists of csrc/elastic_spectral.cuh."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "hercules_tpu_torch", "csrc",
        "elastic_spectral.cuh")
    text = open(path).read()
    lists = []
    for name in ("HT_ELASTIC_SPECTRAL_M1", "HT_ELASTIC_SPECTRAL_M2"):
        body = text.split(f"#define {name}(X)")[1].split("\n\n")[0]
        lists.append([(int(a), int(b), int(c), int(d), float(v))
                      for a, b, c, d, v in re.findall(
                          r"X\((\d), (\d), (\d), (\d), ([-0-9.e]+)\)", body)])
    return lists


def _hadamard(x):
    """The 8-corner butterflies of a 24-vector (hadamard8_stages)."""
    x = x.copy()
    for stage in hadamard8_stages():
        for j, h in stage:
            if j < h:
                x[3 * j:3 * j + 3], x[3 * h:3 * h + 3] = (
                    x[3 * j:3 * j + 3] + x[3 * h:3 * h + 3],
                    x[3 * j:3 * j + 3] - x[3 * h:3 * h + 3])
    return x


def test_elastic_spectral_header_matches_factors():
    """K1 and K5 form each element's force from the spectral factors as
    compiled-in constants: the header's lists are the port's
    spectral_factors() bit for bit, and the kernels' sequence -- W = u +
    beta du at the 8 corners, the Hadamard butterflies, the
    multiply-adds of the M1 and M2 nonzeros with the minus of A = -[M1;
    M2] folded in, scaled by c1 and c2, the inverse butterflies --
    reproduces the plain version's c1 A1 W + c2 A2 W (ops) within 1e-14
    on random u, du, c1, c2 and beta."""
    header = _elastic_header()
    assert header == [list(f) for f in spectral_factors()]
    assert [len(f) for f in header] == [33, 24]
    ops = operators(torch.float64, "cpu").numpy()
    rng = np.random.default_rng(12)
    for _ in range(8):
        u, du = rng.standard_normal(24), rng.standard_normal(24)
        c1, c2 = rng.uniform(-2.0, 2.0, 2) * 1e5
        beta = rng.uniform(0.0, 1.0)
        w = u + beta * du
        z = _hadamard(w)
        y1, y2 = np.zeros(24), np.zeros(24)
        for y, ents in zip((y1, y2), header):
            for mo, co, mi, ci, v in ents:
                y[3 * mo + co] += -v * z[3 * mi + ci]
        got = _hadamard(c1 * y1 + c2 * y2)
        want = c1 * ops[:24] @ w + c2 * ops[24:] @ w
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-14 * np.abs(want).max())


# Bricks for K1's geometry mirror (kernels/tiles.py:step_grid,
# step_items): corner offsets and LEN of validation B1 at 1 Hz (128^3
# elements), a fragment of one element layer, and the graded route's
# fine brick (GRADED_LAYERS at 3.90625 m: 257 x 33 x 257 nodes, y the
# planes); the four-layer box comes from its fixture.
_B1_OFFS = (0, 1, 129, 130, 16641, 16642, 16770, 16771)
_K1_BRICKS = {
    "b1": (_B1_OFFS, 2147328),
    "two_planes": ((0, 1, 33, 34, 1320, 1321, 1353, 1354), 3072),
    "graded_fine": ((0, 1, 8481, 8482, 257, 258, 8738, 8739), 2180096),
}


def _k1_brick(name, layered):
    if name == "layered":
        sim, plan, _, _ = layered
        pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                               device="cpu")
        return tuple(pt.offs), pt.LEN
    return _K1_BRICKS[name]


def _slab_of(offs, LEN, resident, width):
    """K1's slab (tiles.step_slab) for tiles ``width`` wide."""
    nplanes = -(-LEN // tiles.brick_strides(offs)[1])
    return tiles.step_slab(int(np.prod(tiles.tile_counts(offs, width))),
                           nplanes, resident)


@pytest.mark.parametrize("resident", [264, 396])
@pytest.mark.parametrize("name", ["b1", "two_planes", "layered",
                                  "graded_fine"])
def test_step_items_own_every_column_once(name, resident, layered):
    """K1's work items on the slab its rule chooses for an H100's
    resident blocks (132 SMs x 2, or x 3 for float32's 32-wide tile),
    with tiles of either width, own every node column of [0, LEN)
    exactly once, and there are as many as the rule counts where the
    brick's own width is taken."""
    offs, LEN = _k1_brick(name, layered)
    for width in (tiles.TX, tiles.STEP_WIDE):
        slab = _slab_of(offs, LEN, resident, width)
        got = list(tiles.step_items(offs, LEN, slab, width))
        for dtype in (torch.float32, torch.float64):
            grid = tiles.step_grid(offs, LEN, resident, dtype)
            if grid[2] == width:
                assert grid[:2] == (slab, len(got))
        owned = np.concatenate([n for n, _, _ in got])
        assert len(owned) == LEN
        np.testing.assert_array_equal(np.sort(owned), np.arange(LEN))


@pytest.mark.parametrize("resident", [1, 264, 396, 100000])
@pytest.mark.parametrize("name", ["b1", "two_planes", "layered",
                                  "graded_fine"])
def test_step_ring_within_item_planes(name, resident, layered):
    """Every K1 work item reads at least as many node planes (its slab,
    the halo plane below and the plane above) as the ring holds, on a
    slab of 1 to STEP_SLAB_MAX planes, with tiles of either width."""
    offs, LEN = _k1_brick(name, layered)
    for width in (tiles.TX, tiles.STEP_WIDE):
        slab = _slab_of(offs, LEN, resident, width)
        assert 1 <= slab <= tiles.STEP_SLAB_MAX
        for _, a0, a1 in tiles.step_items(offs, LEN, slab, width):
            assert 1 <= a1 - a0 <= slab
            assert tiles.STEP_STAGES <= a1 - a0 + 2


@pytest.mark.parametrize("dtype, resident, key, tiles_a_plane",
                         [(torch.float64, 264, (3, 2, 12, 32), 95),
                          (torch.float32, 264, (3, 2, 10, 44), 57)])
def test_step_config_key_of_b1(dtype, resident, key, tiles_a_plane):
    """The configuration ``brick_step.configs`` counts the B1 brick's
    launches under on an H100 (132 SMs; two blocks an SM in float64 and
    in float32's 44-wide tile, which B1's rows take): (ring stages,
    blocks per SM, slab depth, tile width)."""
    slab, items, width = tiles.step_grid(_B1_OFFS, 2147328, resident,
                                         dtype)
    assert (tiles.STEP_STAGES, resident // 132, slab, width) == key
    assert items == tiles_a_plane * -(-130 // slab)


def _lane_heavy_warps(n_in, n_mid, width):
    """The heavy warps of a plane counted lane by lane: every thread of
    every tile, its element on the brick or not, warps of 32 threads in
    thread order."""
    ox, oy, ty = width - 1, tiles.OY, tiles.TY
    t = np.arange(width * ty)
    ex = (np.arange(-(-n_in // ox)) * ox - 1)[:, None] + t % width
    ey = (np.arange(-(-n_mid // oy)) * oy - 1)[:, None] + t // width
    on = (((ey >= 0) & (ey <= n_mid - 2))[:, None, :]
          & ((ex >= 0) & (ex <= n_in - 2))[None, :, :])
    warps = -(-len(t) // 32)
    on = np.pad(on, ((0, 0), (0, 0), (0, 32 * warps - len(t))))
    return int(on.reshape(*on.shape[:2], warps, 32).any(axis=3).sum())


def _offs_of(n_in, n_mid):
    return tuple((j & 1) + (j >> 1 & 1) * n_in + (j >> 2 & 1) * n_in * n_mid
                 for j in range(8))


@pytest.mark.parametrize("n_mid", [2, 3, 8, 9, 33, 129])
def test_step_width_never_adds_heavy_warps(n_mid):
    """For every row length of 3-520 nodes, K1's float32 tile width
    (tiles.step_width, brick_step.cu:step_width's mirror) counts no more
    heavy warps a plane than the 32 x 8 tile, counted lane by lane: 44
    where its heavy warps over the 22 warps an SM holds of it are fewer
    than 32's over 24, else 32; float64 keeps 32.  tiles.heavy_warps
    counts as the lanes do."""
    for n_in in range(3, 521):
        offs = _offs_of(n_in, n_mid)
        narrow = _lane_heavy_warps(n_in, n_mid, 32)
        wide = _lane_heavy_warps(n_in, n_mid, 44)
        assert (tiles.heavy_warps(n_in, n_mid, 32),
                tiles.heavy_warps(n_in, n_mid, 44)) == (narrow, wide)
        width = tiles.step_width(offs, torch.float32)
        assert width == (44 if wide / 22 < narrow / 24 else 32)
        assert (wide if width == 44 else narrow) <= narrow
        assert tiles.step_width(offs, torch.float64) == 32


@pytest.mark.parametrize("n_in, n_mid, narrow, wide, width",
                         [(129, 129, 730, 606, 44), (257, 257, 2628, 2412, 32),
                          (33, 33, 72, 50, 44), (49, 129, 292, 366, 32),
                          (145, 129, 730, 807, 32), (257, 33, 324, 300, 32)])
def test_step_width_counts(n_in, n_mid, narrow, wide, width):
    """The heavy warps a plane of either tile on B1's 129-node rows, the
    2 Hz fragments' and the graded fine brick's 257 (8 % fewer at 44
    wide: too few for two blocks an SM instead of three, so 32), and rows
    that keep 32 wide, and the width the rule takes in float32; B1's
    heavy-warp shares, 0.701 at 32 wide and 0.845 at 44."""
    offs = _offs_of(n_in, n_mid)
    assert (_lane_heavy_warps(n_in, n_mid, 32),
            _lane_heavy_warps(n_in, n_mid, 44)) == (narrow, wide)
    assert tiles.step_width(offs, torch.float32) == width
    if n_in == n_mid == 129:
        assert offs == _B1_OFFS
        assert round(tiles.heavy_warp_share(offs, 32), 3) == 0.701
        assert round(tiles.heavy_warp_share(offs, 44), 3) == 0.845
        assert tiles.step_width(offs, torch.float64) == 32


def test_note_k1_tile_counts_on_tables_span(monkeypatch):
    """note_k1_tile counts the width the library gives (step_grid_of's
    sixth value) and its heavy-warp share on the open "Solver tables"
    span: on B1 in float32 44 and 0.845."""
    from types import SimpleNamespace

    from hercules_tpu_torch.solver import fused_brick
    from hercules_tpu_torch.utils.timers import GLOBAL_TIMERS
    asked = []

    def grid(offs, LEN, dtype, device):
        asked.append((offs, LEN, dtype))
        return (3, 2, 264) + tiles.step_grid(offs, LEN, 264, dtype)

    monkeypatch.setattr(fused_brick, "step_grid_of", grid)
    pt = SimpleNamespace(offs=_B1_OFFS, LEN=2147328, dtype=torch.float32,
                         K=torch.zeros(1))
    with GLOBAL_TIMERS.span("Solver tables") as rec:
        fused_brick.note_k1_tile(pt)
    assert asked == [(_B1_OFFS, 2147328, torch.float32)]
    assert rec.counts["k1_tile_width"] == 44
    assert round(rec.counts["k1_heavy_warp_share"], 3) == 0.845
