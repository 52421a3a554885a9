"""The port's numpy table assembly, brick plan and packed tables against
the JAX package's, on the in-repo box case with Rayleigh damping and
with BKT damping."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.assemble import assemble as jax_assemble
from hercules_tpu.solver.bricks import build_plan as jax_build_plan
from hercules_tpu.solver.pallas_brick import \
    PallasBrickTables as JaxPallasBrickTables
from hercules_tpu.solver.pallas_brick import pallas_u_global as jax_u_global
from hercules_tpu_torch.convert import (state_from_jax, state_to_global,
                                        tables_from_jax)
from hercules_tpu.solver import pallas_brick as jpb
from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, SOFT_FREQ,
                                         TWO_LAYERS, box_simulation,
                                         box_stats, four_q_freq)
from hercules_tpu_torch.kernels.bkt_corner_step import (corner_rows,
                                                       unpack_corner_tab)
from hercules_tpu_torch.kernels.bkt_node_step import unpack_tab
from hercules_tpu_torch.solver.assemble import assemble
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   pallas_geometry,
                                                   plan_applies)

EDGES = (62.5, 31.25)
# (edge, damping); the Rayleigh cases keep their edge as their id
BOXES = [(e, "rayleigh") for e in EDGES] + [(e, "bkt") for e in EDGES]


@pytest.fixture(scope="module", params=BOXES,
                ids=[f"{e}" if d == "rayleigh" else f"{e}-{d}"
                     for e, d in BOXES])
def box(request, tmp_path_factory):
    edge, damping = request.param
    sim = box_simulation(str(tmp_path_factory.mktemp("box")),
                         edge_m=edge, steps=10, damping=damping)
    return sim


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


def test_assemble_matches_jax(box):
    mine = assemble(box.mesh, box.params)
    ref = jax_assemble(box.mesh, box.params)
    for f in dataclasses.fields(ref):
        _assert_same(getattr(mine, f.name), getattr(ref, f.name), f.name)


def test_build_plan_matches_jax(box):
    mine = build_plan(box.mesh)
    ref = jax_build_plan(box.mesh)
    E, N = box_stats(float(np.max(box.mesh.edge_m)))
    assert box.mesh.lenum == E and box.mesh.nnum == N
    assert len(mine.bricks) == len(ref.bricks) == 1
    assert plan_applies(mine, box.tables.damping)
    for bm, br in zip(mine.bricks, ref.bricks):
        for name in ("level", "origin", "shape", "off", "nb", "gnid",
                     "eidx", "axes"):
            _assert_same(getattr(bm, name), getattr(br, name), name)
        assert bm.corner_offsets() == br.corner_offsets()
    for f in dataclasses.fields(ref):
        if f.name not in ("bricks", "mesh"):
            _assert_same(getattr(mine, f.name), getattr(ref, f.name),
                         f.name)


def test_tables_from_jax_equal_port_K(box):
    """K from the JAX package's tables equals the port's own, and its
    rows equal the JAX fused kernel's streamed tables column for column
    (elastic: cm, mm, invm; BKT: mm, invm, element valid)."""
    plan = build_plan(box.mesh)
    jtab = jax_assemble(box.mesh, box.params)
    jplan = jax_build_plan(box.mesh)
    K = tables_from_jax(jtab, jplan, dtype=torch.float64, device="cpu")
    mine = PallasBrickTables(plan, box.tables, dtype=torch.float64,
                             device="cpu").K
    assert torch.equal(K, mine)
    nb = plan.bricks[0].nb
    assert K.shape == (8, pallas_geometry(nb))
    jpt = JaxPallasBrickTables(jplan, jtab, dtype=jnp.float64)
    if box.tables.damping == "bkt":
        rows = ((slice(0, 3), jpt.mm), (slice(3, 4), jpt.invm),
                (slice(4, 5), jpt.evalid_row))
        zero = slice(5, 8)
    else:
        rows = ((slice(0, 3), jpt.cm), (slice(3, 6), jpt.mm),
                (slice(6, 7), jpt.invm))
        zero = slice(7, 8)
    for r, ref in rows:
        np.testing.assert_array_equal(K[r, :nb].numpy(),
                                      np.asarray(ref)[:, :nb])
    assert not K[:, nb:].any() and not K[zero].any()


def test_state_round_trip(box):
    """state_from_jax / state_to_global carry a JAX packed state (and a
    pair of global fields) into the port's layout and back."""
    plan = build_plan(box.mesh)
    nb, N = plan.bricks[0].nb, box.mesh.nnum
    rng = np.random.default_rng(5)
    LEN_jax = 3 * 32768
    S_jax = np.zeros((8, LEN_jax))
    S_jax[0:6, :nb] = rng.standard_normal((6, nb))
    S = state_from_jax(S_jax, plan)
    assert S.shape == (8, pallas_geometry(nb))
    np.testing.assert_array_equal(state_to_global(S, plan, N),
                                  jax_u_global(plan, S_jax[0:3], N))
    u, up = rng.standard_normal((2, N, 3))
    S2 = state_from_jax((u, up), plan)
    np.testing.assert_array_equal(state_to_global(S2, plan, N), u)
    np.testing.assert_array_equal(
        state_to_global(S2[3:6], plan, N), up)


# layered BKT boxes: (name, write_box_case arguments, the tier they take)
LAYERED = {"two": ({"layers": TWO_LAYERS, "freq": SOFT_FREQ}, "node"),
           "four": ({"layers": FOUR_Q_LAYERS, "freq": four_q_freq(62.5)},
                    "corner")}


@pytest.fixture(scope="module", params=sorted(LAYERED))
def layered(request, tmp_path_factory):
    case, tier = LAYERED[request.param]
    sim = box_simulation(str(tmp_path_factory.mktemp(request.param)),
                         steps=10, damping="bkt", **case)
    return sim, tier


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bkt_tier_tables_match_jax(layered, dtype, monkeypatch):
    """The node tier's K, fm and sets (two-layer box) and the corner
    tier's K, element rows (bk, from its set indices), fm and conv shape
    and type (four-layer box) equal the JAX PallasBrickTables' and its
    kernel factories' (unpermuted fm: HT_BKT_ALIGN8=0; unsplit sets:
    HT_BKT_CF3=0)."""
    monkeypatch.setenv("HT_BKT_ALIGN8", "0")
    monkeypatch.setenv("HT_BKT_CF3", "0")
    sim, tier = layered
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jplan = jax_build_plan(sim.mesh)
    jpt = JaxPallasBrickTables(jplan, jax_assemble(sim.mesh, sim.params),
                               dtype=jdt)
    pt = PallasBrickTables(build_plan(sim.mesh), sim.tables, dtype=dtype,
                           device="cpu")
    assert pt.bkt_tier == tier
    nb, K = pt.nb, pt.K.numpy()
    so = jpt.bkt_shear_only
    if tier == "node":
        np.testing.assert_array_equal(K[:, :nb],
                                      np.asarray(jpt.bkn_K)[:, :nb])
        assert not K[:6, nb:].any() and not K[7].any()
        _, fm_j, _, sets_j = jpb._make_bkt_node_kernel(
            jpt.offs, jpt.B, jpt.o7, jpt.T, jdt, jpt.bkn_sets,
            shear_only=so, conv_dtype=jpt.conv_dtype_node, interpret=True)
        rc = 9 if so else 18
        fm, sets = unpack_tab(pt.step.tab, rc)
        nsets = len(jpt.bkn_sets)
        np.testing.assert_array_equal(sets[:nsets].numpy().T,
                                      np.asarray(sets_j))
        assert not sets[nsets:].any()
    else:
        K_j = np.concatenate([np.asarray(jpt.mm), np.asarray(jpt.invm)])
        np.testing.assert_array_equal(K[:4, :nb], K_j[:, :nb])
        assert not K[:6, nb:].any()
        # the element rows the JAX tier keeps (bk) come back from K's
        # set indices and mu_f, kappa_f rows, value for value
        E = pt.LEN - pt.offs[7]
        rows = corner_rows(pt.step.K, pt.step.tab, E, not so).numpy()
        np.testing.assert_array_equal(rows[:, :nb],
                                      np.asarray(jpt.bk)[:, :nb])
        assert not rows[:, nb:].any()
        _, fm_j = jpb._make_bkt_kernel(jpt.offs, jpt.B, jpt.o7, jpt.T, 2048,
                                       jdt, shear_only=so,
                                       conv_dtype=jpt.conv_dtype,
                                       interpret=True)
        fm = unpack_corner_tab(pt.step.tab)[0]
        assert pt.step.conv_rows == jpt.conv_rows
        assert pt.step.conv_dtype == {jnp.bfloat16: torch.bfloat16,
                                      jnp.float64: torch.float64}[
                                          jpt.conv_dtype]
    np.testing.assert_array_equal(fm.numpy(), np.asarray(fm_j))
