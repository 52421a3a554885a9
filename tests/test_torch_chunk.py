"""brick_chunk's plain version: against a loop of the plain step, across
the two routes, and against the JAX package's resident chunk loop in
float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.assemble import assemble as jax_assemble
from hercules_tpu.solver.bricks import build_plan as jax_build_plan
from hercules_tpu.solver.pallas_brick import \
    pallas_u_global as jax_pallas_u_global
from hercules_tpu.solver.pallas_brick import \
    run_pallas_solver as jax_run_pallas_solver
from hercules_tpu_torch.fixtures import box_simulation
from hercules_tpu_torch.kernels.brick_chunk import (brick_chunk,
                                                    brick_chunk_plain,
                                                    sample_stations)
from hercules_tpu_torch.kernels.brick_step import brick_step_plain
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   pallas_u_global,
                                                   run_pallas_solver,
                                                   source_increments)

T = 37


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp("box")), steps=T)
    return sim, build_plan(sim.mesh)


def _random_state(pt, seed):
    rng = np.random.default_rng(seed)
    S = torch.zeros((8, pt.LEN), dtype=pt.dtype)
    u = rng.standard_normal((3, pt.nb))
    S[0:3, :pt.nb] = torch.as_tensor(u)
    S[3:6, :pt.nb] = torch.as_tensor(u - 0.1 * rng.standard_normal(u.shape))
    return S


def test_chunk_plain_equals_step_loop(box):
    """Bit-identical in float64: sample, step, then add the sources."""
    sim, plan = box
    st = sim.stations
    pt = PallasBrickTables(plan, sim.tables, src_ids=sim.src_ids,
                           st_nodes=st.nodes, st_phi=st.phi,
                           dtype=torch.float64, device="cpu")
    S0 = _random_state(pt, 1)
    srcf = source_increments(pt, sim.src_forces * 1e3,
                             sim.params.delta_t ** 2, 0, T)
    S, samples = S0, []
    for t in range(T):
        samples.append(sample_stations(S, pt.st_pos, pt.st_phi))
        S = brick_step_plain(S, pt.K, pt.offs, pt.step.ops)
        S[0:3].index_add_(1, pt.src_pos, srcf[t])
    Sc, smp = brick_chunk_plain(S0, pt.K, pt.offs, pt.step.ops, srcf,
                                pt.src_pos, pt.st_pos, pt.st_phi)
    assert torch.equal(Sc, S)
    assert torch.equal(smp, torch.stack(samples))
    # the wrapper on CPU tensors is the plain version
    Sw, smw = brick_chunk(S0, torch.empty_like(S0), pt.K, pt.offs,
                          pt.step.ops, srcf, pt.src_pos, pt.st_pos,
                          pt.st_phi)
    assert torch.equal(Sw, S) and torch.equal(smw, smp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_routes_bit_identical(box, dtype):
    """The chunk route's host pre-scaled source increments round exactly
    as the step route's on-device srcf.T * inv_mass: the two routes give
    the same state and samples (on the card this is what lets
    brick_chunk match the brick_step loop bit for bit)."""
    sim, plan = box
    st = sim.stations
    res = {}
    for route in ("chunk", "step"):
        (u, up), smp = run_pallas_solver(
            plan, sim.tables, sim.src_ids, sim.src_forces, T,
            sim.params.delta_t, st_nodes=st.nodes, st_phi=st.phi,
            dtype=dtype, device="cpu", chunk=16, route=route)
        res[route] = (torch.cat([u, up]), smp)
    assert res["chunk"][0].abs().max() > 0
    assert torch.equal(res["chunk"][0], res["step"][0])
    np.testing.assert_array_equal(res["chunk"][1], res["step"][1])


def test_float32_matches_jax_resident(box, monkeypatch):
    """float32, chunks of 16, 37 steps: the port (brick_chunk route)
    against the JAX resident chunk loop in exact float32
    (HT_MXU_PREC=highest), field within 1e-4 max|u|."""
    monkeypatch.setenv("HT_PALLAS_TILE", "1024")
    monkeypatch.setenv("HT_MXU_PREC", "highest")
    sim, plan = box
    jtab, jplan = jax_assemble(sim.mesh, sim.params), \
        jax_build_plan(sim.mesh)
    rng = np.random.default_rng(3)
    nid = sim.mesh.elem_lnid[sim.mesh.lenum // 2, :2].astype(np.int32)
    forces = rng.standard_normal((T, 2, 3)) * 1e8
    st = sim.stations
    state_j, samp_j = jax_run_pallas_solver(
        jplan, jtab, nid, forces, T, sim.params.delta_t,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float32,
        interpret=True, chunk=16)
    (u, _), samp = run_pallas_solver(
        plan, sim.tables, nid, forces, T, sim.params.delta_t,
        st_nodes=st.nodes, st_phi=st.phi, dtype=torch.float32,
        device="cpu", chunk=16)
    N = sim.mesh.nnum
    u_j = jax_pallas_u_global(jplan, state_j[0], N)
    u_t = pallas_u_global(plan, u, N)
    scale = np.abs(u_j).max()
    assert scale > 0
    err = np.abs(u_t - u_j).max() / scale
    assert err <= 1e-4, f"field error {err:.3e} of max|u|"
    serr = np.abs(samp - np.asarray(samp_j)).max() / np.abs(samp_j).max()
    assert serr <= 1e-4, f"samples error {serr:.3e} of max|samples|"
