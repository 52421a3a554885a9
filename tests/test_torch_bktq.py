"""General-Q BKT attenuation on one brick: the port's node tier (K3's
plain version, the mixed elements in their direct form) and corner tier
(K4's plain version) against the JAX package's (the node kernel plus its
mixed-element epilogue), on the CPU (float64).

Fixtures: the two-layer box (two Q sets, 271 mixed elements in one run:
the node tier), its shear-only variant (``use_infinite_qk``), the
four-layer box at 62.5 m (four Q sets, 37 % of the elements mixed: the
node tier declines, the corner tier runs it), and the thin-layer box
(``THIN_Q_LAYERS``, 32 layers through the same four sets) at 15.625 m,
131,072 elements of which 97 % are mixed: the corner tier by the rule,
as at 2^20 elements (48 % there).  Also K4's arithmetic and checks on
the CPU: its spectral element force on per-element corner vectors, and
its wrapper's refusals."""

import os

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
                                         THIN_Q_LAYERS, TWO_LAYERS,
                                         box_simulation, four_q_freq,
                                         one_torch_thread)
from hercules_tpu_torch.kernels import bkt_corner_step as k4
from hercules_tpu_torch.kernels.bkt_corner_step import (
    bkt_corner_step, bkt_corner_step_plain)
from hercules_tpu_torch.kernels.bkt_node_step import (bkt_node_step,
                                                      bkt_node_step_plain,
                                                      node_mix)
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


_one_torch_thread = one_torch_thread()


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
        # the brick's tables (node_tables) against the JAX ones, and the
        # step module's mixed set from them
        bq = fused_bktq.node_tables(plan, sim.tables, LEN, offs)
        assert bq["mix_runs"] == jpt.mix_runs
        for k in MIX_KEYS:
            np.testing.assert_array_equal(bq[k], np.asarray(getattr(jpt, k)),
                                          err_msg=k)
        np.testing.assert_array_equal(pt.step.mix["cols"].numpy(),
                                      jpt.bkn_mixed_cols)
        np.testing.assert_array_equal(pt.step.mix["ce"].numpy(),
                                      np.asarray(jpt.mix_ce)[:, 0, :])


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


def test_direct_form_matches_jax_epilogue(case, monkeypatch):
    """The port's node tier forms the mixed elements' force in its direct
    form; the JAX package adds a correction after its node kernel, in
    its dense run form (the tables' mix_runs) or its gather form
    (mix_runs=None).  From one random state, 3 steps of each (the JAX
    kernel in interpret mode) agree within 1e-13 of each field's max:
    the two-layer boxes and the four-layer box forced to the node tier
    (bridged columns in its coalesced mixed set)."""
    name, sim, plan, jtab, jplan = case
    jpt = _jax_tables(jplan, jtab, monkeypatch, "node")
    assert _jax_tier(jpt) == "node" and jpt.mix_runs
    nb = plan.bricks[0].nb
    S_j, conv_j = _random_jax_state(jpt, nb, np.random.default_rng(3),
                                    "node")
    x = (jnp.zeros((0, 3)), jnp.int32(0))
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                           bkt_tier="node", device="cpu")
    state = (torch.as_tensor(state_from_jax(S_j, plan)),) + tuple(
        torch.as_tensor(m) for m in conv_from_jax(conv_j, plan))
    for _ in range(3):
        state = pt.step(*state)
    for runs in (jpt.mix_runs, None):
        jpt.mix_runs = runs
        step, consts = jpb._make_packed_bkt_node_step(jpt, interpret=True)
        carry = (jnp.asarray(S_j),) + tuple(jnp.asarray(c) for c in conv_j)
        for _ in range(3):
            carry, _ = step(consts, carry, x)
        ref = [state_from_jax(np.asarray(carry[0]), plan)[0:6]]
        ref += conv_from_jax(tuple(carry[1:]), plan)
        assert len(ref) == len(state) == 3
        for a, b in zip(state, ref):
            a = a.numpy()[:b.shape[0]]
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-13 * np.abs(b).max(),
                                       err_msg=f"mix_runs={runs}")


def test_mix_slots_match_mixed_cols(case):
    """The step module's slot array names each mixed element's place in
    conv_mix: slot[mixed_cols[m]] = m, -1 at every other column; its rows
    are the element columns' own recursion rows."""
    name, sim, plan, _, _ = case
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                           bkt_tier="node", device="cpu")
    nq = fused_bktq.node_tables(plan, sim.tables, pt.LEN, pt.offs,
                                force=True)
    mix = pt.step.mix
    cols = nq["mixed_cols"]
    assert pt.step.mix_M == nq["M"] == len(cols) > 0
    np.testing.assert_array_equal(mix["cols"].numpy(), cols)
    slot = mix["slot"].numpy()
    assert slot.dtype == np.int32 and slot.shape == (pt.LEN,)
    np.testing.assert_array_equal(slot[cols], np.arange(len(cols)))
    rest = np.ones(pt.LEN, bool)
    rest[cols] = False
    assert (slot[rest] == -1).all()
    coef_e = fused_bktq.nodeq_inputs(plan, sim.tables, pt.LEN)[0]
    np.testing.assert_array_equal(mix["ce"].numpy(), coef_e[:, cols])
    # node_mix builds the same from the columns and rows alone
    again = node_mix(cols, coef_e[:, cols], pt.LEN, torch.float64, "cpu")
    for k in ("cols", "slot", "ce"):
        assert torch.equal(again[k], mix[k]), k


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
    """bkt_node_step (with its mixed elements and their conv_mix) and
    bkt_corner_step on CPU tensors are the plain versions, with or
    without outputs given, and count no launch; the padding stays zero;
    float32 keeps the corner conv in bfloat16 (shear-only too) and the
    node conv and conv_mix as the uniform tier does."""
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
        kw = {}
        if tier == "node":
            args = (pt.K, pt.offs, pt.step.tab)
            plain, wrapper = bkt_node_step_plain, bkt_node_step
            cm = torch.as_tensor(1e-3 * rng.standard_normal(
                (pt.step.conv_rows, 8, pt.step.mix_M)), dtype=dtype)
            kw = {"mix": pt.step.mix, "conv_mix": cm.to(want)}
        else:
            args = (pt.K, pt.offs, pt.step.tab)
            plain, wrapper = bkt_corner_step_plain, bkt_corner_step
        ref = plain(S, cv, *args, **kw)
        assert len(ref) == (3 if tier == "node" else 2)
        got = wrapper(S, cv, *args, **kw)
        assert len(got) == len(ref)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        outs = [torch.empty_like(r) for r in ref]
        names = ("out", "conv_out", "conv_mix_out")
        got = wrapper(S, cv, *args, **kw, **dict(zip(names, outs)))
        assert all(g is o for g, o in zip(got, outs))
        assert all(torch.equal(o, r) for o, r in zip(outs, ref))
        assert all(r.dtype == want for r in ref[1:])
        assert not ref[0][:, pt.nb:].any() and not ref[1][:, pt.nb:].any()
        if tier == "node":
            # the step module is one wrapper call
            mod = pt.step(S, cv, kw["conv_mix"])
            assert all(torch.equal(m, r) for m, r in zip(mod, ref))
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


def _spectral_header():
    """The (KMU, KKAPPA) entry lists of csrc/bkt_spectral.cuh."""
    import re
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "hercules_tpu_torch", "csrc",
        "bkt_spectral.cuh")
    text = open(path).read()
    lists = []
    for name in ("HT_BKT_SPECTRAL_MU", "HT_BKT_SPECTRAL_KAPPA"):
        body = text.split(f"#define {name}(X)")[1].split("\n\n")[0]
        lists.append([(int(a), int(b), int(c), int(d), float(v))
                      for a, b, c, d, v in re.findall(
                          r"X\((\d), (\d), (\d), (\d), ([-0-9.e]+)\)", body)])
    return lists


def test_spectral_header_matches_factors():
    """K3's element force uses the spectral factors as compiled-in
    constants: the header's lists are the port's spectral_bkt_factors()
    bit for bit, and the kernel's sequence (Hadamard butterflies, a
    multiply-add per nonzero, the inverse butterflies) reproduces KMU
    and KKAPPA on random vectors within 1e-14."""
    from hercules_tpu_torch.physics.kmats import (bkt_matrices_24,
                                                  hadamard8_stages,
                                                  spectral_bkt_factors)
    header = _spectral_header()
    assert header == [list(f) for f in spectral_bkt_factors()]
    assert [len(f) for f in header] == [45, 24]

    def hadamard(x):
        x = x.copy()
        for stage in hadamard8_stages():
            for j, h in stage:
                if j < h:
                    x[3 * j:3 * j + 3], x[3 * h:3 * h + 3] = (
                        x[3 * j:3 * j + 3] + x[3 * h:3 * h + 3],
                        x[3 * j:3 * j + 3] - x[3 * h:3 * h + 3])
        return x

    rng = np.random.default_rng(11)
    for ents, M in zip(header, bkt_matrices_24()):
        for _ in range(4):
            x = rng.standard_normal(24)
            s = hadamard(x)
            y = np.zeros(24)
            for mo, co, mi, ci, v in ents:
                y[3 * mo + co] += v * s[3 * mi + ci]
            np.testing.assert_allclose(hadamard(y), M @ x, rtol=0,
                                       atol=1e-14 * np.abs(M @ x).max())


# the thin-layer box: 131,072 elements, 10 steps
THIN_EDGE, T_THIN = 15.625, 10


@pytest.fixture(scope="module")
def thin(tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp("thin")), THIN_EDGE,
                         steps=T_THIN, damping="bkt", layers=THIN_Q_LAYERS,
                         freq=four_q_freq(THIN_EDGE))
    return (sim, build_plan(sim.mesh), jax_assemble(sim.mesh, sim.params),
            jax_build_plan(sim.mesh))


def test_thin_layers_pick_the_corner_tier(thin, monkeypatch):
    """The thin-layer box is one brick with four Q sets whose mixed
    elements exceed NODEQ_MAX_MIXED (25 %) of the valid ones, so the
    port's bkt_step_module and the JAX tier rule both take the corner
    tier without being forced."""
    sim, plan, jtab, jplan = thin
    assert sim.mesh.lenum == 131072 and len(plan.bricks) == 1
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                           device="cpu")
    args = fused_bktq.nodeq_inputs(plan, sim.tables, pt.LEN)
    _, _, mixed, sets, _ = fused_bktq.assign_bkt_node_coeffs(
        args[0], args[-1], pt.offs)
    share = len(mixed) / args[-1].sum()
    assert len(sets) == 4
    assert fused_bktq.NODEQ_MAX_MIXED < share == 31 / 32
    mod, _ = fused_bktq.bkt_step_module(plan, sim.tables, pt.LEN, pt.offs,
                                        torch.float64, "cpu")
    assert mod.tier == pt.bkt_tier == "corner"
    jpt = _jax_tables(jplan, jtab, monkeypatch)
    assert _jax_tier(jpt) == "corner"
    np.testing.assert_array_equal(
        jpb.assign_bkt_node_coeffs(args[0], args[-1], pt.offs)[2], mixed)


def test_thin_layers_corner_route_matches_jax(thin):
    """Point source and 2 stations, 10 steps on the thin-layer box: the
    port's plain corner route against JAX run_pallas_solver (its corner
    kernel in interpret mode) at 2e-13 max|u| and 2e-13 max(|samples|,
    1), the memory variables at 2e-12 of their max; the padding stays
    zero."""
    sim, plan, jtab, jplan = thin
    st, dt, N = sim.stations, sim.params.delta_t, sim.mesh.nnum
    (u, _, conv), samp = run_pallas_solver(
        plan, sim.tables, sim.src_ids, sim.src_forces, T_THIN, dt,
        st_nodes=st.nodes, st_phi=st.phi, dtype=torch.float64, device="cpu")
    nb = plan.bricks[0].nb
    assert conv.shape[0] == 96
    assert not u[:, nb:].any() and not conv[:, nb:].any()
    state_p, samp_p = jpb.run_pallas_solver(
        jplan, jtab, sim.src_ids, sim.src_forces, T_THIN, dt,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float64, interpret=True)
    _close(pallas_u_global(plan, u, N),
           jpb.pallas_u_global(jplan, state_p[0], N), 2e-13, "u")
    np.testing.assert_allclose(samp, np.asarray(samp_p), rtol=0,
                               atol=2e-13 * max(np.abs(samp_p).max(), 1))
    (ref,) = conv_from_jax(tuple(state_p[2:]), plan)
    _close(conv.numpy(), ref, 2e-12, "memory variables")


def _hadamard_cols(x):
    """The 8-corner butterflies (hadamard8_stages) of x [24, E], rows
    3 j + c, as bkt_tile.cuh:hadamard8 runs them per element."""
    from hercules_tpu_torch.physics.kmats import hadamard8_stages
    x = x.copy()
    for stage in hadamard8_stages():
        for j, h in stage:
            if j < h:
                lo, hi = x[3 * j:3 * j + 3].copy(), x[3 * h:3 * h + 3].copy()
                x[3 * j:3 * j + 3], x[3 * h:3 * h + 3] = lo + hi, lo - hi
    return x


@pytest.mark.parametrize("shear_only", [True, False],
                         ids=["shear_only", "kappa"])
def test_spectral_force_on_element_vectors(shear_only):
    """K4 forms each element's force from its own corner-basis damping
    vectors X = [dvs; dvk] [48, E] (not from node-gathered ones) in the
    spectral form of bkt_tile.cuh:element_force_spectral: the
    butterflies of dvs and dvk, a multiply-add per nonzero of the
    header's lists, mu_f and kappa_f, the inverse butterflies.  On random
    per-element vectors and scales it equals the plain version's
    bkt_fm() @ [mu_f dvs; kappa_f dvk] within 1e-14 of the result's max
    (float64), shear-only (dvk = u) and with kappa."""
    rng = np.random.default_rng(17)
    E = 64
    dvs = rng.standard_normal((24, E))
    dvk = rng.standard_normal((24, E))       # u when shear-only
    mu, ka = rng.uniform(0.5, 2.0, E), rng.uniform(0.5, 2.0, E)
    if shear_only:
        ka = ka * 1e-3                       # a small bulk term on u
    want = fused_bktq.bkt_fm() @ np.concatenate([dvs * mu, dvk * ka])
    xs, xk = _hadamard_cols(dvs), _hadamard_cols(dvk)
    ym, yk = np.zeros((24, E)), np.zeros((24, E))
    mu_list, kappa_list = _spectral_header()
    for y, x, ents in ((ym, xs, mu_list), (yk, xk, kappa_list)):
        for mo, co, mi, ci, v in ents:
            y[3 * mo + co] += v * x[3 * mi + ci]
    got = _hadamard_cols(mu * ym + ka * yk)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


def _corner_args(dtype=torch.float32, conv_dtype=torch.bfloat16, R=96,
                 LEN=3072):
    """Arguments K4's check_args takes, on the CPU: the 2048-element
    box's grid."""
    offs = (0, 1, 17, 18, 289, 290, 306, 307)
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt)
    S, K, tab = z(8, LEN), z(8, LEN), z(k4.TAB_SIZE)
    conv = z(R, LEN, dt=conv_dtype)
    return dict(S=S, conv=conv, K=K, offs=offs, tab=tab,
                out=torch.empty_like(S), conv_out=torch.empty_like(conv))


REFUSALS = {
    "device": (lambda a: a, ValueError, "no kernel for device cpu"),
    "types": (lambda a: {**a, "conv": a["conv"].float(),
                         "conv_out": a["conv_out"].float()},
              TypeError, "working type"),
    "rows": (lambda a: {**a, "conv": a["conv"][:24].contiguous()},
             ValueError, "conv has 24 rows"),
    "table": (lambda a: {**a, "tab": a["tab"][:-9]}, ValueError,
              "tab must be a contiguous"),
    "shape": (lambda a: {**a, "K": torch.zeros(8, 3000)}, ValueError,
              "K must be a contiguous"),
    "contiguous": (lambda a: {**a, "K": torch.zeros(3072, 8).t()},
                   ValueError, "K must be a contiguous"),
    "aliasing": (lambda a: {**a, "out": a["S"]}, ValueError,
                 "must not alias"),
    "offsets": (lambda a: {**a, "offs": (0, 1, 17, 18, 289, 290, 306, 308)},
                ValueError, "brick's node grid"),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_corner_wrapper_refusals(what, monkeypatch):
    """K4's checks (no element-force scratch among its arguments) refuse
    a tensor on a device without the kernel, a (working, storage) type
    pair it has no entry for, a conv of other than 48 or 96 rows, a
    coefficient table of the wrong size, a wrong shape, a non-contiguous
    tensor, an output that aliases its input, and corner offsets that
    are not a brick's.  CPU tensors reach
    every refusal after the first with the kernel's device set to the
    CPU; the same arguments, made right, pass the checks."""
    edit, err, match = REFUSALS[what]
    args = _corner_args()
    if what != "device":
        monkeypatch.setattr(k4, "KERNEL_DEVICE", "cpu")
        assert k4.check_args("k4", **args) == "f32_bf16"
        assert k4.check_args("k4", **_corner_args(
            torch.float64, torch.float64, R=48)) == "f64_f64"
    with pytest.raises(err, match=match):
        k4.check_args("k4", **edit(args))


def test_corner_sets_give_back_the_element_rows(case):
    """The corner tier keeps each channel's distinct coefficient rows
    and an index per element column into them (K rows 6 and 7) beside
    mu_f and kappa_f (rows 4 and 5): every element column's rows come
    back exactly (zero at padding and invalid elements), one table per
    channel (none for kappa when shear-only), each of at most
    CORNER_SETS sets; corner_tab refuses more."""
    from hercules_tpu_torch.solver.fused_bkt import bk_row_names
    name, sim, plan, _, _ = case
    pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                           bkt_tier="corner", device="cpu")
    so = pt.step.shear_only
    assert so == (name == "two_shear")
    K, shear_sets, kappa_sets = fused_bktq.corner_tables(plan, sim.tables,
                                                         pt.LEN)
    assert (kappa_sets is None) == so
    assert 1 < len(shear_sets) <= 19 and (so or len(kappa_sets) <= 19)
    np.testing.assert_array_equal(pt.step.K.numpy(), K)
    E = pt.LEN - pt.offs[7]
    rows = fused_bktq._element_rows(plan, sim.tables, bk_row_names(so),
                                    pt.LEN)
    got = k4.corner_rows(pt.step.K, pt.step.tab, E, not so).numpy()
    np.testing.assert_array_equal(got, rows[:, :E])
    fm, table = k4.unpack_corner_tab(pt.step.tab)
    np.testing.assert_array_equal(fm.numpy(), fused_bktq.bkt_fm())
    assert not table[0, len(shear_sets):].any() and (
        not table[1].any() if so else not table[1, len(kappa_sets):].any())
    with pytest.raises(ValueError, match="coefficient sets"):
        k4.corner_tab(fm, torch.zeros((k4.CORNER_SETS + 1, 9),
                                      dtype=torch.float64))
