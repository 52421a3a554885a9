"""Uniform-Q BKT attenuation on one brick: the port's tables, plain step
and chunk loop against the JAX package's, on the CPU (float64 unless
stated).  Fixtures: the box with BKT damping (shear attenuation only)
and the soft box (the bulk attenuation on)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.assemble import assemble as jax_assemble
from hercules_tpu.solver.bricks import build_plan as jax_build_plan
from hercules_tpu.solver.brickstep import brick_u_global, run_brick_solver
from hercules_tpu.solver import pallas_brick as jpb
from hercules_tpu_torch.convert import conv_from_jax, state_from_jax
from hercules_tpu_torch.fixtures import (SOFT_FREQ, SOFT_LAYERS,
                                         box_simulation)
from hercules_tpu_torch.kernels.bkt_chunk import (bkt_chunk,
                                                  bkt_chunk_plain)
from hercules_tpu_torch.kernels.bkt_step import (bkt_recursion_plain,
                                                 bkt_step, bkt_step_plain)
from hercules_tpu_torch.kernels.brick_chunk import sample_stations
from hercules_tpu_torch.solver import fused_bkt
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   pallas_u_global,
                                                   run_pallas_solver,
                                                   source_increments)

T = 40
CASES = {"box": {}, "soft": {"layers": SOFT_LAYERS, "freq": SOFT_FREQ}}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp(request.param)),
                         steps=T, damping="bkt", **CASES[request.param])
    return (request.param, sim, build_plan(sim.mesh),
            jax_assemble(sim.mesh, sim.params), jax_build_plan(sim.mesh))


def _random_state(pt, seed, scale=1.0):
    """(S, conv): u, u- and the memory variables random on the brick's
    nodes, zero on the padding."""
    rng = np.random.default_rng(seed)
    S = np.zeros((8, pt.LEN))
    u = scale * rng.standard_normal((3, pt.nb))
    S[0:3, :pt.nb] = u
    S[3:6, :pt.nb] = u - 0.1 * scale * rng.standard_normal(u.shape)
    cv = np.zeros((pt.step.conv_rows, pt.LEN))
    cv[:, :pt.nb] = scale * rng.standard_normal((pt.step.conv_rows, pt.nb))
    return (torch.as_tensor(S, dtype=pt.dtype),
            torch.as_tensor(cv, dtype=pt.dtype).to(pt.step.conv_dtype))


def test_plain_matches_jax(case):
    """Point source and 2 stations, 40 steps: the port's plain route
    against run_brick_solver (the corner-basis oracle) at 2e-12 max|u|
    and 2e-12 max(|samples|, 1), against the uniform-tier Pallas kernel
    (interpret mode) at 2e-13 max|u|, and its final node conv at 2e-12
    of its max; the padding stays exactly zero."""
    name, sim, plan, jtab, jplan = case
    st, dt, N = sim.stations, sim.params.delta_t, sim.mesh.nnum
    (u, _, cv), samp = run_pallas_solver(
        plan, sim.tables, sim.src_ids, sim.src_forces, T, dt,
        st_nodes=st.nodes, st_phi=st.phi, dtype=torch.float64,
        device="cpu")
    nb = plan.bricks[0].nb
    assert cv.shape[0] == (6 if name == "box" else 12)
    assert not u[:, nb:].any() and not cv[:, nb:].any()
    u_t = pallas_u_global(plan, u, N)
    state_b, samp_b = run_brick_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float64)
    u_b = brick_u_global(jplan, state_b[0], N)
    scale = np.abs(u_b).max()
    assert scale > 0
    np.testing.assert_allclose(u_t, u_b, rtol=0, atol=2e-12 * scale)
    np.testing.assert_allclose(samp, np.asarray(samp_b), rtol=0,
                               atol=2e-12 * max(np.abs(samp_b).max(), 1))
    state_p, samp_p = jpb.run_pallas_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float64,
        interpret=True)
    u_p = jpb.pallas_u_global(jplan, state_p[0], N)
    np.testing.assert_allclose(u_t, u_p, rtol=0,
                               atol=2e-13 * np.abs(u_p).max())
    np.testing.assert_allclose(samp, np.asarray(samp_p), rtol=0,
                               atol=2e-13 * max(np.abs(samp_p).max(), 1))
    cv_p = conv_from_jax(state_p[2], plan)
    cscale = np.abs(cv_p).max()
    assert cscale > 0
    np.testing.assert_allclose(cv.numpy(), cv_p, rtol=0,
                               atol=2e-12 * cscale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tables_match_jax(case, dtype, monkeypatch):
    """detect_bkt_uniform, bkt_kappa_zero, the conv storage type, K and
    fm equal the JAX PallasBrickTables' values (fm: the unpermuted
    operator of _make_bkt_uniform_kernel)."""
    monkeypatch.setenv("HT_BKT_ALIGN8", "0")
    name, sim, plan, jtab, jplan = case
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jpt = jpb.PallasBrickTables(jplan, jtab, dtype=jdt)
    pt = PallasBrickTables(plan, sim.tables, dtype=dtype, device="cpu")
    shear_only = fused_bkt.bkt_kappa_zero(sim.tables.bkt)
    assert shear_only == jpb.bkt_kappa_zero(jtab.bkt) == (name == "box")
    assert jpt.bkt_uniform and pt.step.shear_only == jpt.bkt_shear_only
    assert fused_bkt.bk_row_names(shear_only) == \
        jpb.bk_row_names(shear_only)
    scal = fused_bkt.detect_bkt_uniform(sim.tables.bkt, plan.eidx_cat,
                                        plan.evalid_cat, shear_only)
    assert scal == jpb.detect_bkt_uniform(jtab.bkt, jplan.eidx_cat,
                                          jplan.evalid_cat, shear_only)
    assert scal == jpt.bk_scal
    conv_dt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
               jnp.float64: torch.float64}[jpt.conv_dtype_node]
    assert pt.step.conv_dtype == conv_dt
    assert fused_bkt.bkt_conv_dtype(dtype) == \
        {jnp.bfloat16: torch.bfloat16, jnp.float64: torch.float64}[
            jpb.bkt_conv_dtype(jdt)]
    nb = pt.nb
    K_j = np.concatenate([np.asarray(jpt.mm), np.asarray(jpt.invm),
                          np.asarray(jpt.evalid_row),
                          np.zeros((3, jpt.LEN))])
    K = pt.K.numpy()
    np.testing.assert_array_equal(K[:, :nb], K_j[:, :nb].astype(K.dtype))
    assert not K[:, nb:].any()
    _, fm_j, R2s, _, _ = jpb._make_bkt_uniform_kernel(
        jpt.offs, jpt.B, jpt.o7, jpt.T, jdt, jpt.bk_scal,
        shear_only=shear_only, conv_dtype=jpt.conv_dtype_node,
        interpret=True)
    assert R2s == {6: 8, 12: 16}[pt.step.conv_rows]
    np.testing.assert_array_equal(pt.step.fm.numpy(), np.asarray(fm_j))
    assert pt.step.rec == tuple(
        float(np.asarray(v, K.dtype))
        for v in fused_bkt.recursion_scalars(scal, shear_only))


def test_single_step_matches_jax(case):
    """The same random (S, conv), carried across with state_from_jax /
    conv_from_jax, gives the same step in both packages (the JAX
    uniform-Q kernel in interpret mode): 1e-13 of each field's max."""
    name, sim, plan, jtab, jplan = case
    jpt = jpb.PallasBrickTables(jplan, jtab, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    nb = plan.bricks[0].nb
    R2 = 6 if jpt.bkt_shear_only else 12
    S_j = np.zeros((8, jpt.LEN))
    S_j[0:6, :nb] = rng.standard_normal((6, nb))
    cv_j = np.zeros((jpt.conv_rows_node, jpt.LEN))
    cv_j[:R2, :nb] = rng.standard_normal((R2, nb))
    call = jpb.build_bkt_uniform_call(
        jpt.offs, jpt.B, jpt.o7, jpt.T, jpt.LEN, jnp.float64, jpt.bk_scal,
        shear_only=jpt.bkt_shear_only, conv_dtype=jpt.conv_dtype_node,
        interpret=True)
    K_j = jnp.concatenate([jpt.mm, jpt.invm, jpt.evalid_row,
                           jnp.zeros((3, jpt.LEN), jnp.float64)])
    Sn_j, cvn_j = call(jnp.asarray(S_j), jnp.asarray(S_j), K_j,
                       jnp.asarray(cv_j), jnp.asarray(cv_j))
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64, device="cpu")
    S = torch.as_tensor(state_from_jax(S_j, plan))
    cv = torch.as_tensor(conv_from_jax(cv_j, plan))
    Sn, cvn = pt.step(S, cv)
    ref = state_from_jax(np.asarray(Sn_j), plan)
    np.testing.assert_allclose(Sn.numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref[0:3]).max())
    cref = conv_from_jax(np.asarray(cvn_j), plan)
    np.testing.assert_allclose(cvn.numpy(), cref, rtol=0,
                               atol=1e-13 * np.abs(cref).max())


def test_chunk_plain_equals_step_loop(case):
    """Bit for bit: sample, step, then add the sources, with duplicate
    source positions summed in source order."""
    name, sim, plan, _, _ = case
    mid = sim.mesh.elem_lnid[sim.mesh.lenum // 2]
    src = np.array([mid[0], mid[3], mid[0], mid[5], mid[3]], np.int32)
    forces = np.random.default_rng(11).standard_normal((T, 5, 3)) * 1e10
    st = sim.stations
    pt = PallasBrickTables(plan, sim.tables, src_ids=src,
                           st_nodes=st.nodes, st_phi=st.phi,
                           dtype=torch.float64, device="cpu")
    S0, cv0 = _random_state(pt, 1, 1e-3)
    srcf = source_increments(pt, forces, sim.params.delta_t ** 2, 0, T)
    args = (pt.K, pt.offs, pt.step.fm, pt.step.rec)
    S, cv, samples = S0, cv0, []
    for t in range(T):
        samples.append(sample_stations(S, pt.st_pos, pt.st_phi))
        S, cv = bkt_step_plain(S, cv, *args)
        S[0:3].index_add_(1, pt.src_pos, srcf[t])
    Sc, cvc, smp = bkt_chunk_plain(S0, cv0, *args, srcf, pt.src_pos,
                                   pt.st_pos, pt.st_phi)
    assert torch.equal(Sc, S) and torch.equal(cvc, cv)
    assert torch.equal(smp, torch.stack(samples))
    Sw, cvw, smw = bkt_chunk(S0, torch.empty_like(S0), cv0,
                             torch.empty_like(cv0), *args, srcf,
                             pt.src_pos, pt.st_pos, pt.st_phi)
    assert torch.equal(Sw, S) and torch.equal(cvw, cv)
    assert torch.equal(smw, smp)
    # both routes of the solver carry the duplicates the same way
    res = {}
    for route in ("chunk", "step"):
        (u, up, c), s = run_pallas_solver(
            plan, sim.tables, src, forces, T, sim.params.delta_t,
            st_nodes=st.nodes, st_phi=st.phi, dtype=torch.float64,
            device="cpu", chunk=16, route=route, state=(S0, cv0))
        res[route] = (torch.cat([u, up]), c, s)
    assert torch.equal(res["chunk"][0], res["step"][0])
    assert torch.equal(res["chunk"][1], res["step"][1])
    np.testing.assert_array_equal(res["chunk"][2], res["step"][2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_on_cpu_run_plain(case, dtype):
    """bkt_step and bkt_chunk on CPU tensors are the plain versions,
    with or without outputs given, and count no launch."""
    _, sim, plan, _, _ = case
    pt = PallasBrickTables(plan, sim.tables, dtype=dtype, device="cpu")
    S, cv = _random_state(pt, 2, 1e-3)
    args = (pt.K, pt.offs, pt.step.fm, pt.step.rec)
    before = (bkt_step.launches, bkt_chunk.launches)
    ref = bkt_step_plain(S, cv, *args)
    for got in (bkt_step(S, cv, *args), pt.step(S, cv)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    out, cout = torch.empty_like(S), torch.empty_like(cv)
    got = bkt_step(S, cv, *args, out=out, conv_out=cout)
    assert got[0] is out and got[1] is cout
    assert torch.equal(out, ref[0]) and torch.equal(cout, ref[1])
    srcf = torch.zeros((3, 3, 0), dtype=dtype)
    Sc, cvc, _ = pt.step.chunk(S, cv, srcf)
    Sp, cvp, _ = bkt_chunk_plain(S, cv, *args, srcf, None, None, None)
    assert torch.equal(Sc, Sp) and torch.equal(cvc, cvp)
    assert (bkt_step.launches, bkt_chunk.launches) == before
    assert not ref[0][:, pt.nb:].any() and not ref[1][:, pt.nb:].any()


def test_float32_soft_box_stores_bfloat16(case):
    """float32 runs with the bulk attenuation on keep conv in bfloat16,
    as the JAX package does; the stored values are the float32
    recursion rounded once; the run stays within 1e-3 of float64."""
    name, sim, plan, jtab, jplan = case
    jpt = jpb.PallasBrickTables(jplan, jtab, dtype=jnp.float32)
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float32, device="cpu")
    want = torch.bfloat16 if name == "soft" else torch.float32
    assert pt.step.conv_dtype == want
    assert (jpt.conv_dtype_node == jnp.bfloat16) == (name == "soft")
    S, cv = _random_state(pt, 3, 1e-3)
    cn, _, _ = bkt_recursion_plain(S, cv, pt.step.rec)
    _, cvn = pt.step(S, cv)
    assert cvn.dtype == want and torch.equal(cvn, cn.to(want))
    st = sim.stations
    runs = {}
    for dtype in (torch.float32, torch.float64):
        (u, _, c), smp = run_pallas_solver(
            plan, sim.tables, sim.src_ids, sim.src_forces, 20,
            sim.params.delta_t, st_nodes=st.nodes, st_phi=st.phi,
            dtype=dtype, device="cpu")
        runs[dtype] = (u.double(), c, smp)
    assert runs[torch.float32][1].dtype == want
    u32, u64 = runs[torch.float32][0], runs[torch.float64][0]
    err = ((u32 - u64).abs().max() / u64.abs().max()).item()
    assert err <= 1e-3, f"float32 vs float64 field {err:.3e}"
