"""General-Q BKT attenuation on one brick: the port's node tier (K3's
plain version and the mixed-element epilogue) and corner tier (K4's
plain version) against the JAX package's, on the CPU (float64).

Fixtures: the two-layer box (two Q sets, 271 mixed elements in one run:
the node tier), its shear-only variant (``use_infinite_qk``), and the
four-layer box at 62.5 m (four Q sets, 37 % of the elements mixed: the
node tier declines, the corner tier runs it)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.assemble import assemble as jax_assemble
from hercules_tpu.solver.bricks import build_plan as jax_build_plan
from hercules_tpu.solver.brickstep import brick_u_global, run_brick_solver
from hercules_tpu.solver import pallas_brick as jpb
from hercules_tpu_torch.convert import conv_from_jax, state_from_jax
from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, SOFT_FREQ,
                                         TWO_LAYERS, box_simulation,
                                         four_q_freq)
from hercules_tpu_torch.kernels.bkt_corner_step import (
    bkt_corner_step, bkt_corner_step_plain)
from hercules_tpu_torch.kernels.bkt_node_step import (bkt_node_step,
                                                      bkt_node_step_plain)
from hercules_tpu_torch.solver import fused_bktq
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   pallas_u_global,
                                                   run_pallas_solver)

T = 40
CASES = {
    "two": {"layers": TWO_LAYERS, "freq": SOFT_FREQ},
    "two_shear": {"layers": TWO_LAYERS, "freq": SOFT_FREQ,
                  "use_infinite_qk": True},
    "four": {"layers": FOUR_Q_LAYERS, "freq": four_q_freq(62.5)},
}
# the tier each package picks by its rule
TIER = {"two": "node", "two_shear": "node", "four": "corner"}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp(request.param)),
                         steps=T, damping="bkt", **CASES[request.param])
    return (request.param, sim, build_plan(sim.mesh),
            jax_assemble(sim.mesh, sim.params), jax_build_plan(sim.mesh))


def _jax_tables(jplan, jtab, monkeypatch, tier=None):
    """The JAX PallasBrickTables, with its environment switches set as
    the port's forced ``tier`` is."""
    if tier == "corner":
        monkeypatch.setenv("HT_BKT_NODEQ", "0")
    elif tier == "node":
        monkeypatch.setenv("HT_BKT_NODEQ_MAX_MIXED", "1.0")
    return jpb.PallasBrickTables(jplan, jtab, dtype=jnp.float64)


def _jax_tier(jpt):
    return ("uniform" if jpt.bkt_uniform
            else "node" if jpt.bkt_nodeq else "corner")


def _run(sim, plan, **kw):
    st = sim.stations
    return run_pallas_solver(plan, sim.tables, sim.src_ids, sim.src_forces,
                             T, sim.params.delta_t, st_nodes=st.nodes,
                             st_phi=st.phi, dtype=torch.float64,
                             device="cpu", **kw)


def _close(a, b, bound, what):
    scale = np.abs(b).max()
    assert scale > 0, what
    np.testing.assert_allclose(a, b, rtol=0, atol=bound * scale,
                               err_msg=what)


def test_tier_matches_jax(case, monkeypatch):
    """Both packages pick the same tier; the port's route name says so."""
    name, sim, plan, jtab, jplan = case
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64, device="cpu")
    jpt = _jax_tables(jplan, jtab, monkeypatch)
    assert pt.bkt_tier == _jax_tier(jpt) == TIER[name]
    assert pt.step.shear_only == jpt.bkt_shear_only == (name == "two_shear")
    names = []
    _run(sim, plan, on_route=names.append)
    assert names == ["torch_plain"]


MIX_KEYS = ("mix_idx", "mix_ce", "mix_cn", "mix_invm", "mix_muf",
            "mix_kaf", "mix_fm")


def test_node_tables_match_jax(case, monkeypatch):
    """assign_bkt_node_coeffs and bkt_nodeq_tables equal the JAX
    functions array for array on the same inputs, and the port's tables
    equal the JAX PallasBrickTables' on the brick's columns."""
    name, sim, plan, jtab, jplan = case
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64, device="cpu")
    nb, LEN, offs = pt.nb, pt.LEN, pt.offs
    shear_only = fused_bktq.bkt_kappa_zero(sim.tables.bkt)
    assert fused_bktq.bkn_coef_keys(shear_only) == \
        jpb.bkn_coef_keys(shear_only)
    args = fused_bktq.nodeq_inputs(plan, sim.tables, LEN)
    coef_e, ev = args[0], args[-1]
    mine = fused_bktq.assign_bkt_node_coeffs(coef_e, ev, offs)
    ref = jpb.assign_bkt_node_coeffs(coef_e, ev, offs)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    nq = fused_bktq.bkt_nodeq_tables(*args, offs, shear_only)
    jq = jpb.bkt_nodeq_tables(*args, offs, shear_only, jnp.float64)
    assert nq["declined"] == jq["declined"] == (TIER[name] == "corner")
    assert nq["M"] == jq["M"]
    for k in ("node_src", "mixed_cols", "sets", "node_bin"):
        np.testing.assert_array_equal(nq[k], jq[k], err_msg=k)
    if not nq["declined"]:
        assert nq["mix_runs"] == jq["mix_runs"] == [(1156, 0, 271)]
        for k in ("K",) + MIX_KEYS:
            np.testing.assert_array_equal(nq[k], np.asarray(jq[k]),
                                          err_msg=k)
    # the port's own tables against the JAX PallasBrickTables
    jpt = _jax_tables(jplan, jtab, monkeypatch)
    np.testing.assert_array_equal(nq["node_src"][:nb],
                                  jpt.bkn_node_src[:nb])
    np.testing.assert_array_equal(nq["mixed_cols"], jpt.bkn_mixed_cols)
    if TIER[name] == "node":
        K = pt.K.numpy()
        np.testing.assert_array_equal(K[:, :nb], np.asarray(jpt.bkn_K)[:, :nb])
        np.testing.assert_array_equal(K[6, nb:], len(jpt.bkn_sets))
        assert not K[:6, nb:].any() and not K[7].any()
        assert pt.step.mix_runs == jpt.mix_runs
        for k in MIX_KEYS:
            np.testing.assert_array_equal(pt.step.mix[k].numpy(),
                                          np.asarray(getattr(jpt, k)),
                                          err_msg=k)


def test_plain_route_matches_jax(case, monkeypatch):
    """Point source and 2 stations, 40 steps, on the tier the rule
    picks: the port's plain route against JAX run_pallas_solver (the
    same tier, interpret mode) at 2e-13 max|u| and 2e-13 max(|samples|,
    1), against run_brick_solver (the corner-basis oracle) at 2e-12,
    and its final memory variables (conv, and conv_mix on the node tier)
    at 2e-12 of their max; the padding stays exactly zero."""
    name, sim, plan, jtab, jplan = case
    st, dt, N = sim.stations, sim.params.delta_t, sim.mesh.nnum
    (u, _, *mem), samp = _run(sim, plan)
    nb = plan.bricks[0].nb
    assert not u[:, nb:].any() and not mem[0][:, nb:].any()
    assert len(mem) == (2 if TIER[name] == "node" else 1)
    u_t = pallas_u_global(plan, u, N)
    state_p, samp_p = jpb.run_pallas_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt, st_nodes=st.nodes,
        st_phi=st.phi, dtype=jnp.float64, interpret=True)
    _close(u_t, jpb.pallas_u_global(jplan, state_p[0], N), 2e-13, "u")
    np.testing.assert_allclose(samp, np.asarray(samp_p), rtol=0,
                               atol=2e-13 * max(np.abs(samp_p).max(), 1))
    ref = conv_from_jax(tuple(state_p[2:]), plan)
    assert len(ref) == len(mem)
    for a, b in zip(mem, ref):
        assert a.shape == b.shape
        _close(a.numpy(), b, 2e-12, "memory variables")
    state_b, samp_b = run_brick_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt, st_nodes=st.nodes,
        st_phi=st.phi, dtype=jnp.float64)
    _close(u_t, brick_u_global(jplan, state_b[0], N), 2e-12, "u vs brick")
    np.testing.assert_allclose(samp, np.asarray(samp_b), rtol=0,
                               atol=2e-12 * max(np.abs(samp_b).max(), 1))


def test_forced_tier_matches_jax(case, monkeypatch):
    """Each box forced to the tier its rule does not pick: the two-layer
    boxes to the corner tier (bkt_tier="corner"; HT_BKT_NODEQ=0 in the
    JAX package), the four-layer box to the node tier ("node";
    HT_BKT_NODEQ_MAX_MIXED=1): the same bounds as above."""
    name, sim, plan, jtab, jplan = case
    tier = "node" if TIER[name] == "corner" else "corner"
    st, dt, N = sim.stations, sim.params.delta_t, sim.mesh.nnum
    (u, _, *mem), samp = _run(sim, plan, bkt_tier=tier)
    assert len(mem) == (2 if tier == "node" else 1)
    assert _jax_tier(_jax_tables(jplan, jtab, monkeypatch, tier)) == tier
    state_p, samp_p = jpb.run_pallas_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt, st_nodes=st.nodes,
        st_phi=st.phi, dtype=jnp.float64, interpret=True)
    u_t = pallas_u_global(plan, u, N)
    _close(u_t, jpb.pallas_u_global(jplan, state_p[0], N), 2e-13, "u")
    np.testing.assert_allclose(samp, np.asarray(samp_p), rtol=0,
                               atol=2e-13 * max(np.abs(samp_p).max(), 1))
    for a, b in zip(mem, conv_from_jax(tuple(state_p[2:]), plan)):
        assert a.shape == b.shape
        _close(a.numpy(), b, 2e-12, "memory variables")
    state_b, _ = run_brick_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T, dt, dtype=jnp.float64)
    _close(u_t, brick_u_global(jplan, state_b[0], N), 2e-12, "u vs brick")


def test_node_tier_matches_corner_tier(case):
    """Node tier against corner tier on the same mesh, as the JAX
    package's test_nodeq_matches_corner_kernel_* (5e-13 max|u|): the
    two-layer boxes (full and shear-only) and the four-layer box forced
    to the node tier (its 3 mixed runs)."""
    name, sim, plan, _, _ = case
    (u_n, _, *mem), samp_n = _run(sim, plan, bkt_tier="node")
    (u_c, _, _), samp_c = _run(sim, plan, bkt_tier="corner")
    assert mem[1].shape[2] > 0
    scale = u_c.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(u_n, u_c, rtol=0, atol=5e-13 * scale)
    np.testing.assert_allclose(samp_n, samp_c, rtol=0,
                               atol=5e-13 * max(np.abs(samp_c).max(), 1))


def test_mix_runs_equal_gather_form(case):
    """The epilogue's dense run form against its gather form (the same
    tables with mix_runs dropped): the same trajectory within 1e-14."""
    name, sim, plan, _, _ = case
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                           bkt_tier="node", device="cpu")
    assert pt.step.mix_runs
    rng = np.random.default_rng(3)
    S = torch.zeros((8, pt.LEN), dtype=torch.float64)
    S[0:6, :pt.nb] = torch.as_tensor(rng.standard_normal((6, pt.nb)))
    cv = torch.zeros((pt.step.conv_rows, pt.LEN), dtype=torch.float64)
    cv[:, :pt.nb] = torch.as_tensor(
        rng.standard_normal((pt.step.conv_rows, pt.nb)))
    cm = torch.as_tensor(rng.standard_normal(
        (pt.step.conv_rows, 8, pt.step.mix_M)))
    runs = pt.step.mix_runs
    res = {}
    for form in ("runs", "gather"):
        pt.step.mix_runs = runs if form == "runs" else None
        state = (S, cv, cm)
        for _ in range(12):
            state = pt.step(*state)
        res[form] = state
    for a, b in zip(res["runs"], res["gather"]):
        scale = b.abs().max().item()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14 * scale)


def _random_jax_state(jpt, nb, rng, tier):
    """A random JAX carry of the tier (zero padding; the node conv's
    set-index row filled as nodeq_conv_init does)."""
    S = np.zeros((8, jpt.LEN))
    S[0:6, :nb] = rng.standard_normal((6, nb))
    if tier == "corner":
        cv = np.zeros((jpt.conv_rows, jpt.LEN))
        cv[:, :nb] = rng.standard_normal((jpt.conv_rows, nb))
        return S, (cv,)
    R2 = 6 if jpt.bkt_shear_only else 12
    cv = np.zeros((jpt.conv_rows_node, jpt.LEN))
    cv[:R2, :nb] = rng.standard_normal((R2, nb))
    cv[R2, :len(jpt.bkn_bin)] = jpt.bkn_bin
    return S, (cv, rng.standard_normal((R2, 8, jpt.mix_M)))


@pytest.mark.parametrize("tier", ["node", "corner"])
def test_single_step_matches_jax(case, tier, monkeypatch):
    """The same random state, carried across with state_from_jax and
    conv_from_jax, gives the same step in both packages (the JAX
    kernels in interpret mode, with the mixed-element epilogue on the
    node tier): 1e-13 of each field's max."""
    name, sim, plan, jtab, jplan = case
    jpt = _jax_tables(jplan, jtab, monkeypatch, tier)
    assert _jax_tier(jpt) == tier
    nb = plan.bricks[0].nb
    S_j, conv_j = _random_jax_state(jpt, nb, np.random.default_rng(7), tier)
    x = (jnp.zeros((0, 3)), jnp.int32(0))
    if tier == "node":
        step, consts = jpb._make_packed_bkt_node_step(jpt, interpret=True)
        new_j, _ = step(consts, (jnp.asarray(S_j),)
                        + tuple(jnp.asarray(c) for c in conv_j), x)
        Sn_j, mem_j = np.asarray(new_j[0]), tuple(new_j[1:])
    else:
        step, consts = jpb.make_pallas_step(jpt, interpret=True)
        new_j, _ = step(consts, (jnp.asarray(S_j[0:3]),
                                 jnp.asarray(S_j[3:6]),
                                 jnp.asarray(conv_j[0])), x)
        Sn_j = np.concatenate([np.asarray(new_j[0]), np.asarray(new_j[1]),
                               np.zeros((2, jpt.LEN))])
        mem_j = (new_j[2],)
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                           bkt_tier=tier, device="cpu")
    S = torch.as_tensor(state_from_jax(S_j, plan))
    mem = conv_from_jax(conv_j, plan)
    new = pt.step(S, *(torch.as_tensor(m) for m in mem))
    ref = state_from_jax(Sn_j, plan)
    np.testing.assert_allclose(new[0].numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref[0:3]).max())
    mem_ref = conv_from_jax(mem_j, plan)
    assert len(new) == 1 + len(mem_ref)
    for a, b in zip(new[1:], mem_ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-13 * np.abs(b).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_on_cpu_run_plain(case, dtype):
    """bkt_node_step and bkt_corner_step on CPU tensors are the plain
    versions, with or without outputs given, and count no launch; the
    padding stays zero; float32 keeps the corner conv in bfloat16 (shear-
    only too) and the node conv as the uniform tier does."""
    name, sim, plan, _, _ = case
    before = (bkt_node_step.launches, bkt_corner_step.launches)
    rng = np.random.default_rng(2)
    for tier in ("node", "corner"):
        pt = PallasBrickTables(plan, sim.tables, dtype=dtype, bkt_tier=tier,
                               device="cpu")
        want = (torch.float64 if dtype == torch.float64
                else torch.bfloat16 if tier == "corner"
                or name != "two_shear" else torch.float32)
        assert pt.step.conv_dtype == want
        S = torch.zeros((8, pt.LEN), dtype=dtype)
        S[0:6, :pt.nb] = torch.as_tensor(1e-3 * rng.standard_normal(
            (6, pt.nb)))
        cv = torch.zeros((pt.step.conv_rows, pt.LEN), dtype=dtype)
        cv[:, :pt.nb] = torch.as_tensor(1e-3 * rng.standard_normal(
            (pt.step.conv_rows, pt.nb)))
        cv = cv.to(want)
        if tier == "node":
            args = (pt.K, pt.offs, pt.step.tab)
            plain, wrapper = bkt_node_step_plain, bkt_node_step
        else:
            args = (pt.K, pt.step.bk, pt.offs, pt.step.fm)
            plain, wrapper = bkt_corner_step_plain, bkt_corner_step
        ref = plain(S, cv, *args)
        got = wrapper(S, cv, *args)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        out, cout = torch.empty_like(S), torch.empty_like(cv)
        got = wrapper(S, cv, *args, out=out, conv_out=cout)
        assert got[0] is out and got[1] is cout
        assert torch.equal(out, ref[0]) and torch.equal(cout, ref[1])
        assert ref[1].dtype == want
        assert not ref[0][:, pt.nb:].any() and not ref[1][:, pt.nb:].any()
    assert (bkt_node_step.launches, bkt_corner_step.launches) == before


def test_forcing_a_tier_that_cannot_hold_the_brick_raises(case):
    name, sim, plan, _, _ = case
    with pytest.raises(ValueError, match="more than one BKT coefficient"):
        PallasBrickTables(plan, sim.tables, bkt_tier="uniform", device="cpu")
    with pytest.raises(ValueError, match="bkt_tier must be"):
        PallasBrickTables(plan, sim.tables, bkt_tier="nodeq", device="cpu")
    with pytest.raises(ValueError, match="no chunk kernel"):
        _run(sim, plan, route="chunk")


@pytest.mark.parametrize("n_distinct", [1, 4, 18, 500])
def test_unique_rows_equals_numpy(n_distinct):
    """The set grouping of assign_bkt_node_coeffs gives np.unique's
    sets and inverse (rows drawn from a few distinct ones, in random
    order; zero rows and near-equal rows included)."""
    rng = np.random.default_rng(n_distinct)
    base = rng.standard_normal((n_distinct, 18))
    base[0] = 0.0
    if n_distinct > 1:
        base[1] = np.nextafter(base[2], np.inf)
    rows = base[rng.integers(0, n_distinct, 5000)]
    sets, inv = fused_bktq._unique_rows(rows)
    ref_sets, ref_inv = np.unique(rows, axis=0, return_inverse=True)
    np.testing.assert_array_equal(sets, ref_sets)
    np.testing.assert_array_equal(inv, ref_inv.ravel())
