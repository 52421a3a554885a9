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
from hercules_tpu_torch.fixtures import box_simulation, box_stats
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
    K = tables_from_jax(jtab, jplan, dtype=torch.float64)
    mine = PallasBrickTables(plan, box.tables, dtype=torch.float64).K
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
