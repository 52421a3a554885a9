"""The port's single-brick solver (plain versions on the CPU) against
the JAX package's brick solver and fused Pallas kernel, float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.assemble import assemble as jax_assemble
from hercules_tpu.solver.bricks import build_plan as jax_build_plan
from hercules_tpu.solver.brickstep import brick_u_global, run_brick_solver
from hercules_tpu.solver.pallas_brick import \
    pallas_u_global as jax_pallas_u_global
from hercules_tpu.solver.pallas_brick import \
    run_pallas_solver as jax_run_pallas_solver
from hercules_tpu_torch.fixtures import box_simulation
from hercules_tpu_torch.kernels.brick_step import (brick_step,
                                                   brick_step_plain)
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   pallas_u_global,
                                                   run_pallas_solver)

T = 40


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp("box")), steps=T)
    return (sim, build_plan(sim.mesh), jax_assemble(sim.mesh, sim.params),
            jax_build_plan(sim.mesh))


def _port(sim, plan, src_ids, forces, **kw):
    st = sim.stations
    return run_pallas_solver(plan, sim.tables, src_ids, forces, T,
                             sim.params.delta_t, st_nodes=st.nodes,
                             st_phi=st.phi, dtype=torch.float64,
                             device="cpu", **kw)


def test_plain_matches_jax(box, monkeypatch):
    """Point source and 2 stations, 40 steps: the port's plain route
    against run_brick_solver and the Pallas kernel (interpret mode),
    2e-13 max|u| on the field and 2e-13 max(|samples|, 1) on the
    samples; the padding stays exactly zero."""
    monkeypatch.setenv("HT_PALLAS_TILE", "1024")
    sim, plan, jtab, jplan = box
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
