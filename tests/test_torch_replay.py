"""The step route's chunks and the kernel slab path's, in one
``SourceSample`` call a step and replayed from CUDA graphs: on the CPU
the plain version against the torch operations it replaces, the
chunks' buffers through the uncaptured path (short last chunks, an odd
k, the samples of each chunk), the step route's ring of displacement
blocks (``ring_plan``: K1's lean form, the layout S at every chunk
boundary), the allocation-free halo against its expression, the
multi-card ``advance`` returning a tensor bit for bit the numpy sum of
the rank loop; on a card (marker ``card``) the kernel against the torch
operations, K1's lean form against its canonical form, and the replayed
chunks bit for bit the uncaptured ones, in both types, on
one card and on two.

On a card: ``python -m pytest --noconftest -m card
tests/test_torch_replay.py`` (this file imports no JAX)."""

import numpy as np
import pytest
import torch

from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, box_simulation,
                                         four_q_freq, one_torch_thread)
from hercules_tpu_torch.kernels import build, tiles
from hercules_tpu_torch.kernels.brick_chunk import sample_stations
from hercules_tpu_torch.kernels.brick_step import (brick_step,
                                                   brick_step_lean)
from hercules_tpu_torch.kernels.source_sample import (SourceSample,
                                                      increments,
                                                      source_groups)
from hercules_tpu_torch.parallel import driver
from hercules_tpu_torch.parallel.driver import choose_path, run_multichip
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.parallel.slab import HaloWork, halo_exchange
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.chunking import run_chunked
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   init_packed_state,
                                                   pallas_geometry,
                                                   ring_plan,
                                                   run_pallas_solver,
                                                   step_advance)
from hercules_tpu_torch.utils import timers as TM

_one_torch_thread = one_torch_thread()

STEPS = 30
TYPES = [torch.float64, torch.float32]


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp("box")), steps=STEPS,
                         n_stations=4)
    return sim, build_plan(sim.mesh)


def _tables(box, dtype, device="cpu"):
    sim, plan = box
    st = sim.stations
    return PallasBrickTables(plan, sim.tables, src_ids=sim.src_ids,
                             st_nodes=st.nodes, st_phi=st.phi, dtype=dtype,
                             device=device)


def _torch_route(box, dtype, device="cpu", steps=STEPS):
    """The step route as torch operations, one loop over every step:
    the samples' gather and einsum before each step, K1 (its plain
    version on the CPU), then the sources' index_add_ of srcf.T *
    inv_mass.  Returns (S, samples)."""
    sim, _ = box
    pt = _tables(box, dtype, device)
    dt2 = sim.params.delta_t ** 2
    invm = pt.K[pt.invm_row, pt.src_pos]
    srcf = torch.as_tensor(np.asarray(sim.src_forces[:steps]) * dt2,
                           dtype=dtype, device=pt.device)
    S, = init_packed_state(pt)
    samples = []
    for i in range(steps):
        samples.append(sample_stations(S, pt.st_pos, pt.st_phi))
        S = pt.step(S)
        S[0:3].index_add_(1, pt.src_pos, srcf[i].T * invm[None, :])
    return S, torch.stack(samples)


def _run(box, dtype, chunk, device="cpu", steps=STEPS):
    sim, plan = box
    st = sim.stations
    (u, up), samples = run_pallas_solver(
        plan, sim.tables, sim.src_ids, sim.src_forces, steps,
        sim.params.delta_t, st_nodes=st.nodes, st_phi=st.phi, dtype=dtype,
        device=device, chunk=chunk, route="step")
    return torch.cat([u, up]).cpu(), samples


@pytest.mark.parametrize("dtype", TYPES)
def test_plain_source_sample_is_the_torch_ops(box, dtype):
    """source_sample_plain adds the increments of ``increments`` as the
    torch route adds srcf.T * inv_mass (bit for bit) and samples as
    sample_stations does."""
    sim, _ = box
    pt = _tables(box, dtype)
    dt2 = sim.params.delta_t ** 2
    k = 5
    inc = torch.from_numpy(increments(sim.src_forces[3:3 + k], dt2,
                                      pt.src_invm))
    srcf = torch.as_tensor(np.asarray(sim.src_forces[3:3 + k]) * dt2,
                           dtype=dtype)
    invm = pt.K[pt.invm_row, pt.src_pos]
    S0 = torch.randn((8, pt.LEN), generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64).to(dtype)
    io = SourceSample(pt.src_pos, pt.st_pos, pt.st_phi)
    samples = torch.full((k, pt.n_st, 3), np.nan, dtype=dtype)
    for i in range(k):
        want = S0.clone()
        want[0:3].index_add_(1, pt.src_pos, srcf[i].T * invm[None, :])
        got = S0.clone()
        io(got, inc[i], samples[i])
        assert torch.equal(got, want)
        assert torch.equal(samples[i],
                           sample_stations(want, pt.st_pos, pt.st_phi))
    S = S0.clone()
    io(S)
    assert torch.equal(S, S0)
    io(S, samples=samples[0])
    assert torch.equal(S, S0)
    assert torch.equal(samples[0], sample_stations(S0, pt.st_pos, pt.st_phi))


def test_source_groups_add_as_index_add():
    """The kernel's source add, one thread per (component, distinct
    position) adding that position's increments in source order
    (source_groups), is index_add_'s sum with sources sharing nodes."""
    rng = np.random.default_rng(3)
    pos = np.array([7, 2, 7, 9, 2, 7, 4])
    inc = rng.standard_normal((3, len(pos))).astype(np.float32) * 1e-3
    u = rng.standard_normal((3, 12)).astype(np.float32)
    want = torch.from_numpy(u.copy())
    want.index_add_(1, torch.from_numpy(pos), torch.from_numpy(inc))
    upos, gptr, gsrc = source_groups(pos)
    assert list(upos) == [2, 4, 7, 9]
    got = u.copy()
    for c in range(3):
        for q, p in enumerate(upos):
            acc = got[c, p]
            for j in gsrc[gptr[q]:gptr[q + 1]]:
                acc = np.float32(acc + inc[c, j])
            got[c, p] = acc
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("chunk", [8, 7, STEPS, 1, 2, 3, 4])
def test_step_route_chunks_are_the_step_loop(box, dtype, chunk):
    """The step route over its ring of displacement blocks in chunks of
    8 (a short last chunk of 6), 7 (odd, a last chunk of 2), 30, 1 and
    2 (every step canonical), 3 and 4 (a last chunk of 2; chunks of 4
    end in the spare buffer): the state and every chunk's samples bit
    for bit the torch route's one loop, the ping-pong of two [8, LEN]
    states."""
    S, samples = _torch_route(box, dtype)
    got, got_samples = _run(box, dtype, chunk)
    assert torch.equal(got, S[0:6])
    assert got_samples.shape == tuple(samples.shape)
    assert np.array_equal(got_samples, samples.numpy())


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 1000])
@pytest.mark.parametrize("lean", [True, False])
def test_ring_plan_reads_and_writes_apart(k, lean):
    """Every step of ``ring_plan`` reads the blocks the steps before it
    left u and u- in (the chunk's first, blocks 0 and 1) and writes
    into blocks that hold neither; the last step is canonical.  With
    ``lean`` all but the last are lean (k - 1 lean launches a chunk)
    except at k = 2, two canonical steps, and the chunk ends in the
    state's own buffer at every k but 1 and 4; without, every step is
    canonical, the state and its spare in turn."""
    plan = ring_plan(k, lean)
    assert len(plan) == k
    at = (0, 1)
    for u, um, out, canon in plan:
        assert (u, um) == at
        wrote = (out, out + 1) if canon else (out,)
        assert out in (0, 2) or not canon
        assert not set(wrote) & {u, um}
        at = (out, out + 1) if canon else (out, u)
    assert plan[-1][3]
    lean_steps = sum(not c for *_, c in plan)
    if not lean:
        assert lean_steps == 0
        assert [p[2] for p in plan] == [2, 0] * (k // 2) + [2] * (k % 2)
    else:
        assert lean_steps == (0 if k == 2 else k - 1)
        assert (plan[-1][2] == 0) == (k not in (1, 4))


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_step_route_boundaries_are_canonical(box, dtype, chunk):
    """At every chunk boundary the step route's state is the layout S:
    rows 0:3 u and 3:6 u- bit for bit the torch route's at that step,
    rows 6:8 zero, whichever buffer the chunk ended in."""
    sim, _ = box
    pt = _tables(box, dtype)
    seen = []
    advance = step_advance(pt, sim.src_forces, sim.params.delta_t ** 2,
                           chunk)
    run_chunked(advance, init_packed_state(pt), STEPS, chunk=chunk,
                on_chunk=lambda done, st: seen.append((done,
                                                       st[0].clone())))
    assert [d for d, _ in seen] == list(range(chunk, STEPS, chunk)) + [
        STEPS]
    for done, S in seen:
        want, _ = _torch_route(box, dtype, steps=done)
        assert torch.equal(S[0:6], want[0:6])
        assert not S[6:8].any()


def _slab(box, dtype, devices):
    sim, _ = box
    path, _ = choose_path(sim.mesh, sim.tables, RankGroup(devices),
                          src_ids=sim.src_ids, dtype=dtype,
                          prefer="slab_pallas")
    st = sim.stations
    path.attach_stations(st.nodes, st.phi)
    return path


def _rank_loop(box, dtype, devices, chunk):
    """The kernel slab path's chunks as run_multichip stepped them
    before its sources and stations went through SourceSample: per step
    each rank's stations sampled (gather and einsum), then each rank's
    kernel launch and its sources' index_add_ of srcf.T * inv_mass, then
    the halo; the chunk's samples summed on the host into numpy."""
    sim, _ = box
    path = _slab(box, dtype, devices)
    step = path.step
    state = path.init_state()
    dt2 = sim.params.delta_t ** 2
    cols = path.src_cols()
    pos = [io.src_pos for io in step.io]
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out = []
    for s in range(0, STEPS, chunk):
        k = min(chunk, STEPS - s)
        f = np.asarray(sim.src_forces[s:s + k]) * dt2
        srcf = [torch.as_tensor(f[:, c], dtype=dtype, device=d)
                if len(c) else None for c, d in zip(cols, devices)]
        rows = [[] for _ in devices]
        for i in range(k):
            for r, got in enumerate(path._st):
                if got is not None:
                    rows[r].append(sample_stations(state[r][0], *got[1:]))
            news = [None] * len(devices)
            for r in range(len(devices)):
                S, _ = step.launch(r, 0, state[r][0], ())
                if srcf[r] is not None:
                    iv = step.mods[r][0].K[step.invm_row][pos[r]]
                    S[0:3].index_add_(1, pos[r], srcf[r][i].T * iv[None, :])
                news[r] = (S,)
            step.halos(state, news)
            state = news
        ys = np.zeros((k, path.n_st, 3), np_dtype)
        for r, rr in enumerate(rows):
            if rr:
                ys[:, path._st[r][0]] += torch.stack(rr).cpu().numpy()
        out.append(ys)
    return [s[0].cpu() for s in state], np.concatenate(out)


def _slab_run(box, dtype, devices, chunk):
    sim, _ = box
    path = _slab(box, dtype, devices)
    assert path.graph_chunks == (torch.device(devices[0]).type == "cuda")
    state, samples = run_multichip(path, sim.src_forces, STEPS,
                                   sim.params.delta_t, chunk=chunk)
    return [s[0].cpu() for s in state], samples


@pytest.mark.parametrize("dtype", TYPES)
def test_slab_chunks_are_the_rank_loop(box, dtype, monkeypatch):
    """run_multichip on four CPU ranks of the kernel slab path (chunks
    of 8, the sources and stations through SourceSample's plain
    version): every chunk's samples come back from ``advance`` as a
    tensor, and the ranks' states and the samples are bit for bit the
    rank-by-rank loop's with the host's numpy sum."""
    seen = []
    real = driver.run_chunked

    def watch(advance, *a, **kw):
        def wrapped(state, s, k):
            state, ys = advance(state, s, k)
            seen.append(type(ys))
            return state, ys
        return real(wrapped, *a, **kw)

    monkeypatch.setattr(driver, "run_chunked", watch)
    devices = ["cpu"] * 4
    want, want_samples = _rank_loop(box, dtype, devices, 8)
    got, samples = _slab_run(box, dtype, devices, 8)
    assert seen == [torch.Tensor] * 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert samples.dtype == want_samples.dtype
    assert np.array_equal(samples, want_samples)
    assert np.abs(samples).max() > 0


def _halo_expression(group, plane, views, Ss, uns):
    """The halo exchange as torch expressions, each allocating its
    result (the form slab.halo_exchange had before it wrote into
    HaloWork)."""
    P, pl = group.size, plane
    f_top, f_bot = [None] * P, [None] * P
    single = [((iv[0], m1[:, 0]), (iv[1], m1[:, 1]), zb)
              for iv, m1, zb in views]
    for r in range(P):
        S, un, ((iv_t, m1_t), (iv_b, m1_b), zb) = Ss[r], uns[r], single[r]
        f_top[r] = ((un[0:3, :pl] - S[0:3, :pl]) / iv_t
                    - m1_t * (S[0:3, :pl] - S[3:6, :pl]))
        f_bot[r] = ((un[0:3, zb:zb + pl] - S[0:3, zb:zb + pl]) / iv_b
                    - m1_b * (S[0:3, zb:zb + pl] - S[3:6, zb:zb + pl]))
    down = group.shift(f_bot, +1)
    up_ = group.shift(f_top, -1)
    for r in range(P):
        S, un = Ss[r], uns[r]
        (iv_t, m1_t), (iv_b, m1_b), zb = single[r]
        if r > 0:
            u, du = S[0:3, :pl], S[0:3, :pl] - S[3:6, :pl]
            un[0:3, :pl] = u + (down[r] + f_top[r] + m1_t * du) * iv_t
        if r < P - 1:
            b = slice(zb, zb + pl)
            u, du = S[0:3, b], S[0:3, b] - S[3:6, b]
            un[0:3, b] = u + (f_bot[r] + up_[r] + m1_b * du) * iv_b


@pytest.mark.parametrize("dtype", TYPES)
def test_halo_writes_the_expression(box, dtype):
    """slab.halo_exchange, one operation at a time on both planes of a
    rank into HaloWork, gives the bits of the expression form on random
    states."""
    path = _slab(box, dtype, ["cpu"] * 4)
    step = path.step
    fb = step.bricks[0]
    gen = torch.Generator().manual_seed(5)
    rand = lambda: torch.randn((8, step.LEN), generator=gen,
                               dtype=torch.float64).to(dtype)
    Ss = [rand() for _ in range(4)]
    uns = [rand() for _ in range(4)]
    views = [v[0] for v in step.views]
    want = [u.clone() for u in uns]
    _halo_expression(path.group, fb.plane, views, Ss, want)
    before = [u.clone() for u in uns]
    work = [HaloWork(S, fb.plane) for S in Ss]
    halo_exchange(path.group, fb.plane, views, Ss, uns, work)
    assert all(torch.equal(a, b) for a, b in zip(uns, want))
    assert not any(torch.equal(a, b) for a, b in zip(uns, before))


def test_launches_under_capture_count_at_replay():
    """A launch counted while a capture is tallied counts nowhere but in
    the tally, configuration included; each replay of the tally counts
    it once."""
    def counter():
        pass
    counter.launches, counter.configs = 0, {}
    build.launched(counter, "a")
    with build.tally() as held:
        build.launched(counter, "a")
        build.launched(counter)
        build.launched(counter, "b", n=2)
    assert (counter.launches, counter.configs) == (1, {"a": 1})
    assert held == {(counter, "a"): 1, (counter, None): 1,
                    (counter, "b"): 2}
    for _ in range(3):
        build.replayed(held)
    assert (counter.launches, counter.configs) == (13, {"a": 4, "b": 6})
    build.launched(counter)
    assert counter.launches == 14


# ------------------------------------------------------------- on a card

def _cuda(n=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


@pytest.mark.card
@pytest.mark.parametrize("dtype", TYPES)
def test_card_source_sample_kernel(box, dtype):
    """The kernel's source add bit for bit index_add_ on the card (and,
    with sources sharing nodes, the plain version's sequential add);
    its samples within rounding of the einsum."""
    _cuda()
    sim, _ = box
    pt = _tables(box, dtype, "cuda")
    dt2 = sim.params.delta_t ** 2
    k = 4
    inc = torch.as_tensor(increments(sim.src_forces[2:2 + k], dt2,
                                     pt.src_invm), device="cuda")
    S0 = torch.randn((8, pt.LEN), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2)).to(
                         dtype).cuda()
    io = SourceSample(pt.src_pos, pt.st_pos, pt.st_phi)
    samples = torch.zeros((k, pt.n_st, 3), dtype=dtype, device="cuda")
    for i in range(k):
        want = S0.clone()
        want[0:3].index_add_(1, pt.src_pos, inc[i])
        got = S0.clone()
        io(got, inc[i], samples[i])
        assert torch.equal(got, want)
        ref = sample_stations(want, pt.st_pos, pt.st_phi)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        assert torch.allclose(samples[i], ref, rtol=tol,
                              atol=tol * ref.abs().max().item())
    pos = torch.tensor([5, 9, 5, 5, 1], device="cuda")
    many = torch.randn((k, 3, 5), dtype=torch.float64).to(dtype).cuda()
    io = SourceSample(pos)
    got = S0.clone()
    io(got, many[1])
    want = S0.cpu()
    want[0:3].index_add_(1, pos.cpu(), many[1].cpu())
    assert torch.equal(got.cpu(), want)


# K1's forms on bricks whose node grids are stored in each of the six
# orders (corner roles): the box and the four-layer Rayleigh box of
# 2048 elements, and validation B1 at 1 Hz (128^3 elements, seeded)
ROLES = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


@pytest.fixture(scope="module")
def layered(tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp("layered")),
                         steps=STEPS, damping="rayleigh",
                         layers=FOUR_Q_LAYERS, freq=four_q_freq(62.5))
    return sim, build_plan(sim.mesh)


def _seeded_b1(gen):
    """K [8, LEN] and nb of a 129^3-node brick: (c1, c2, beta) per
    element whose corners lie on the grid (2 % of them zero), K rows 3:7
    per node, seeded."""
    n = 129
    nb = n ** 3
    K = torch.zeros((8, pallas_geometry(nb)), dtype=torch.float64)
    i = torch.arange(nb)
    ok = (i // (n * n) < n - 1) & (i // n % n < n - 1) & (i % n < n - 1)
    c = (0.5 + 1.5 * torch.rand((3, nb), generator=gen, dtype=torch.float64)
         ) * torch.tensor([[1e-2], [2e-2], [0.3]], dtype=torch.float64)
    c[:, torch.rand(nb, generator=gen) < 0.02] = 0.0
    K[0:3, :nb] = torch.where(ok, c, 0.0)
    K[3:6, :nb] = 2e-3 * torch.rand((3, nb), generator=gen,
                                    dtype=torch.float64) - 1e-3
    K[6, :nb] = 0.5 + torch.rand(nb, generator=gen, dtype=torch.float64)
    return K, (0, 1, n, n + 1, n * n, n * n + 1, n * n + n, n * n + n + 1), nb


def _roles_case(name, roles, dtype, request):
    """(S, K, offs) on the card: the brick ``name`` with its node grid
    (planes, mid, inner) stored in the order ``roles``; S's u and u- ~
    N(0, 1) (u- within 0.1 of u) and its rows 6:8 ~ N(0, 1) on the
    nodes."""
    gen = torch.Generator().manual_seed(7)
    if name == "b1":
        K, offs, nb = _seeded_b1(gen)
    else:
        sim, plan = request.getfixturevalue(name)
        pt = PallasBrickTables(plan, sim.tables, dtype=torch.float64,
                               device="cpu")
        K, offs, nb = pt.K.clone(), pt.offs, pt.nb
    s_mid, s_out = tiles.brick_strides(offs)
    dims = (nb // s_out, s_out // s_mid, s_mid)
    order = torch.arange(nb).reshape(dims).permute(roles).reshape(-1)
    col = torch.empty_like(order)
    col[order] = torch.arange(nb)
    offs = tuple(int(col[o]) for o in offs)
    K[:, :nb] = K[:, order]
    S = torch.zeros_like(K)
    S[0:3, :nb] = torch.randn((3, nb), generator=gen, dtype=torch.float64)
    S[3:6, :nb] = S[0:3, :nb] - 0.1 * torch.randn(
        (3, nb), generator=gen, dtype=torch.float64)
    S[6:8, :nb] = torch.randn((2, nb), generator=gen, dtype=torch.float64)
    return S.to(dtype).cuda(), K.to(dtype).cuda(), offs


@pytest.mark.card
@pytest.mark.parametrize("roles", ROLES)
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", ["box", "layered", "b1"])
def test_card_lean_form_is_the_canonical_form(name, dtype, roles, request):
    """K1's lean form, from u and u- in tensors of their own, writes
    u+ bit for bit the canonical form's rows 0:3 and nothing else (a NaN
    in rows 3:8 of its out's buffer stays); the canonical form writes u
    in rows 3:6 and zeros in rows 6:8 (the seeded S's are not zero), and
    brick_step on S gives it; each counts one launch, the lean one also
    in ``lean_launches``."""
    _cuda()
    S, K, offs = _roles_case(name, roles, dtype, request)
    want = brick_step(S, K, offs, None)
    before = brick_step.launches, brick_step.lean_launches
    buf = torch.full_like(S, float("nan"))
    brick_step_lean(S[0:3].clone(), S[3:6].clone(), K, offs, None,
                    buf[0:3])
    canon = torch.full_like(S, float("nan"))
    brick_step_lean(S[0:3].clone(), S[3:6].clone(), K, offs, None, canon,
                    canonical=True)
    torch.cuda.synchronize()
    assert torch.equal(buf[0:3], canon[0:3])
    assert buf[3:8].isnan().all()
    assert torch.equal(canon[3:6], S[0:3])
    assert not canon[6:8].any()
    assert S[6:8].any()
    assert torch.equal(want, canon)
    assert (brick_step.launches - before[0],
            brick_step.lean_launches - before[1]) == (2, 1)


@pytest.mark.card
@pytest.mark.parametrize("dtype", TYPES)
def test_card_replay_is_the_uncaptured_route(box, dtype):
    """On a card the step route's chunks of 8 replay from a CUDA graph
    over the ring of displacement blocks (captured after the first
    chunk, 17 nodes: 8 K1 launches and 9 SourceSample launches) and give
    the bits of chunks of 4, which end in the spare buffer and never
    replay; the samples within rounding of the torch route's."""
    _cuda()
    TM.GLOBAL_TIMERS.log.clear()
    got, got_samples = _run(box, dtype, 8, "cuda")
    log = list(TM.GLOBAL_TIMERS.log)
    caps = [r for r in log if r.name == "Solver graph capture"]
    assert [(r.counts["k"], r.counts["nodes"]) for r in caps] == [(8, 17)]
    assert [r.counts["replays"] for r in log if r.name == TM.CHUNK] == \
        [0, 1, 1, 0]
    TM.GLOBAL_TIMERS.log.clear()
    want, want_samples = _run(box, dtype, 4, "cuda")
    assert not any(r.name == "Solver graph capture"
                   for r in TM.GLOBAL_TIMERS.log)
    assert torch.equal(got, want)
    assert np.array_equal(got_samples, want_samples)
    S, samples = _torch_route(box, dtype, "cuda")
    assert torch.equal(got, S[0:6].cpu())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got_samples, samples.cpu().numpy(), rtol=0,
                               atol=tol * np.abs(got_samples).max())


@pytest.mark.card
@pytest.mark.parametrize("cards", [1, 2])
@pytest.mark.parametrize("dtype", TYPES)
def test_card_slab_replay_is_the_rank_loop(box, dtype, cards):
    """The kernel slab path on four ranks over one card, and on two
    ranks over two cards: chunks of 8 replayed from one CUDA graph give
    the state of chunks of 7 and of the rank-by-rank loop bit for bit,
    and their samples."""
    _cuda(cards)
    devices = (["cuda:0"] * 4 if cards == 1 else ["cuda:0", "cuda:1"])
    TM.GLOBAL_TIMERS.log.clear()
    got, samples = _slab_run(box, dtype, devices, 8)
    assert [r.counts["replays"] for r in TM.GLOBAL_TIMERS.log
            if r.name == TM.CHUNK] == [0, 1, 1, 0]
    again, samples7 = _slab_run(box, dtype, devices, 7)
    want, want_samples = _rank_loop(box, dtype, devices, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(samples, samples7)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(samples, want_samples, rtol=0,
                               atol=tol * np.abs(samples).max())


@pytest.mark.card
@pytest.mark.parametrize("dtype", TYPES)
def test_card_replay_counts_every_launch(box, dtype):
    """The launch counters of a run whose chunks replay count each
    launch the card ran once: the step route's 30 steps in chunks of 8
    (captured once, replayed twice) count 30 K1 launches, under their
    configuration, and 34 SourceSample launches (k + 1 a chunk); the
    kernel slab path on four ranks of one card counts 4 x 30 K1
    launches and one SourceSample launch a step for each rank with
    sources and each with stations.  Of the step route's K1 launches all
    but each chunk's last are lean (7 + 7 + 7 + 5), the slab path's
    none."""
    _cuda()
    before = (brick_step.launches, sum(brick_step.configs.values()),
              SourceSample.launches, brick_step.lean_launches)
    _run(box, dtype, 8, "cuda")
    after = (brick_step.launches, sum(brick_step.configs.values()),
             SourceSample.launches, brick_step.lean_launches)
    assert [b - a for a, b in zip(before, after)] == [STEPS, STEPS,
                                                      STEPS + 4, STEPS - 4]
    path = _slab(box, dtype, ["cuda:0"] * 4)
    users = (sum(io.L > 0 for io in path.step.io)
             + sum(got is not None for got in path._st))
    before = brick_step.launches, SourceSample.launches
    sim, _ = box
    lean = brick_step.lean_launches
    run_multichip(path, sim.src_forces, STEPS, sim.params.delta_t, chunk=8)
    assert (brick_step.launches - before[0],
            SourceSample.launches - before[1]) == (4 * STEPS,
                                                   users * STEPS)
    assert brick_step.lean_launches == lean
