"""The port's spans (``utils/timers.py``): nesting, the report's
totals, the bounded log, the fence of ``measure``, the chunk spans of the time loop
on the CPU routes, the device clock at chunk boundaries (on stand-in
CUDA events), the spans in a profiler trace, and the set-up spans of
``Simulation.setup``."""

import collections
import io
import json
import time
import types

import numpy as np
import pytest
import torch

from hercules_tpu_torch.fixtures import (GRADED_LAYERS, box_simulation,
                                         four_q_freq, one_torch_thread,
                                         write_box_case)
from hercules_tpu_torch.sim import Simulation
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.chunking import run_chunked
from hercules_tpu_torch.solver.fused_brick import run_pallas_solver
from hercules_tpu_torch.solver.fused_mesh import run_mesh_solver
from hercules_tpu_torch.utils import timers as TM

_one_torch_thread = one_torch_thread()

STEPS, CHUNK = 50, 20
SETUP_SPANS = ("Read parameters", "Material db open", "Solver assemble",
               "Source forces", "Stations locate")
CHUNK_SPANS = ("Solver advance", "Solver samples to host", "Solver hooks")
ADVANCE_SPANS = ("Solver forces upload", "Solver issue")


def _children(log, rec):
    return [r for r in log if r.parent is rec]


def test_spans_nest_with_parent_and_step():
    t = TM.Timers()
    with t.span("run", step=3) as run:
        with t.span("phase") as phase:
            with t.span("inner", step=7, rows=2) as inner:
                assert t.open == [run, phase, inner]
        with t.span("other") as other:
            pass
    assert list(t.log) == [inner, phase, other, run]
    assert run.parent is None and run.step == 3
    assert phase.parent is run and phase.step == 3
    assert inner.parent is phase and inner.step == 7
    assert other.parent is run and other.step == 3
    assert inner.counts == {"rows": 2} and t.open == []
    for r in t.log:
        assert r.t0_ns <= r.t1_ns
        assert t.counts[r.name] == 1
        assert t.acc[r.name] == pytest.approx((r.t1_ns - r.t0_ns) * 1e-9)
    assert run.t0_ns <= phase.t0_ns <= inner.t0_ns <= inner.t1_ns \
        <= phase.t1_ns <= other.t0_ns <= other.t1_ns <= run.t1_ns


def test_a_span_ends_when_its_block_raises():
    t = TM.Timers()
    with pytest.raises(KeyError):
        with t.span("outer"):
            with t.span("failing"):
                raise KeyError("x")
    assert [r.name for r in t.log] == ["failing", "outer"]
    assert t.open == [] and t.counts == {"failing": 1, "outer": 1}


def test_report_totals_the_top_spans_once():
    """The report's TOTAL counts each top-level span once, not again the
    spans that ran inside it; the breakdown shows a solver span indented
    under the solver spans it ran inside."""
    from hercules_tpu_torch.utils.timers import print_timing_stat
    t = TM.Timers()
    t.start("wall")
    with t.span("Solver assemble"):
        time.sleep(0.002)
    with t.span("Solver"):
        with t.span("Solver time loop"):
            with t.span(TM.CHUNK, step=0):
                with t.span("Solver advance"):
                    time.sleep(0.003)
    t.stop("wall")
    assert t.parent_of == {"Solver assemble": None, "Solver": None,
                           "Solver time loop": "Solver",
                           TM.CHUNK: "Solver time loop",
                           "Solver advance": TM.CHUNK}
    assert t.path("Solver advance") == ["Solver", "Solver time loop",
                                        TM.CHUNK, "Solver advance"]
    out = io.StringIO()
    t.report(out=out)
    total = float(out.getvalue().split("TOTAL")[1].split()[0])
    assert total == pytest.approx(t.value("wall") + t.value("Solver")
                                  + t.value("Solver assemble"), abs=1e-3)
    # counted again, the nested spans would add at least "Solver time
    # loop" (TOTAL is printed to 1e-3)
    assert total < (t.value("wall") + t.value("Solver")
                    + t.value("Solver assemble")
                    + t.value("Solver time loop") - 5e-4)
    out = io.StringIO()
    params = types.SimpleNamespace(freq=1.0, vscut=100.0, total_steps=1,
                                   end_time=1.0, start_time=0.0,
                                   delta_t=1.0)
    print_timing_stat(params, types.SimpleNamespace(lenum=8), timers=t,
                      out=out)
    lines = out.getvalue().split("TOTAL SOLVER")[1].splitlines()[1:]
    assert [ln.split(":")[0].rstrip() for ln in lines] == [
        "    time loop", "      chunk", "        advance", "    assemble"]


def test_report_shares_are_of_the_wall_clock():
    """Where the run kept ``Total Wall Clock``, the report's shares are
    of it."""
    from hercules_tpu_torch.utils.timers import print_timing_stat
    t = TM.Timers()
    with t.span("Solver"):
        pass
    t.acc["Total Wall Clock"] = 10.0
    t.acc["Solver"] = 2.5
    out = io.StringIO()
    params = types.SimpleNamespace(freq=1.0, vscut=100.0, total_steps=1,
                                   end_time=1.0, start_time=0.0,
                                   delta_t=1.0)
    print_timing_stat(params, types.SimpleNamespace(lenum=8), timers=t,
                      out=out)
    raw = out.getvalue()
    assert float(raw.split("TOTAL")[1].split()[0]) == 10.0
    assert "Solver" in raw and " 25.0%" in raw


def test_a_span_path_ends_at_a_cycle():
    t = TM.Timers()
    with t.span("a"):
        with t.span("b"):
            pass
    with t.span("b"):
        with t.span("a"):
            pass
    assert t.parent_of == {"a": None, "b": "a"}
    t.parent_of["a"] = "b"
    assert t.path("a") == ["b", "a"] and t.path("b") == ["a", "b"]


def test_the_log_stays_at_its_bound():
    t = TM.Timers()
    assert t.log.maxlen == TM.SPAN_LOG
    t.log = collections.deque(maxlen=8)
    for i in range(20):
        with t.span("x", step=i):
            pass
    assert len(t.log) == 8
    assert [r.step for r in t.log] == list(range(12, 20))
    # the cumulative timers count every span, logged or not
    assert t.counts["x"] == 20
    assert TM.GLOBAL_TIMERS.log.maxlen == TM.SPAN_LOG


def test_measure_fences_and_feeds_acc(monkeypatch):
    t = TM.Timers()
    synced = []

    def synchronize(device=None):
        synced.append((device, [r.name for r in t.open]))
        time.sleep(0.02)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    with TM.measure("fenced", torch.device("cuda", 0), timers=t) as rec:
        pass
    # the fence runs inside the span, so the span is charged its wait
    assert synced == [(torch.device("cuda", 0), ["fenced"])]
    assert t.acc["fenced"] >= 0.02 and t.counts["fenced"] == 1
    assert list(t.log) == [rec] and rec.parent is None
    with TM.measure("host", "cpu", timers=t):
        with t.span("plain"):
            pass
    assert len(synced) == 1
    assert [r.name for r in t.log] == ["fenced", "plain", "host"]
    assert t.log[1].parent is t.log[2]
    assert t.value("host") >= t.value("plain") > 0


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    sim = box_simulation(str(tmp_path_factory.mktemp("box")),
                         steps=STEPS)
    return sim, build_plan(sim.mesh)


@pytest.fixture(scope="module")
def graded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("graded"))
    cv, ph, nu = write_box_case(d, 62.5, STEPS, 3, layers=GRADED_LAYERS,
                                freq=four_q_freq(62.5))
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    return sim, build_plan(sim.mesh)


def _run(case, route, on_chunk=None, on_samples=None):
    sim, plan = case
    st = sim.stations
    args = (plan, sim.tables, sim.src_ids, sim.src_forces, STEPS,
            sim.params.delta_t)
    kw = dict(st_nodes=st.nodes, st_phi=st.phi, dtype=torch.float64,
              device="cpu", chunk=CHUNK, on_chunk=on_chunk,
              on_samples=on_samples)
    if route == "mesh":
        return run_mesh_solver(*args, **kw)
    return run_pallas_solver(*args, route=route, **kw)


@pytest.mark.parametrize("route", ["step", "chunk", "mesh"])
def test_one_chunk_span_per_chunk(box, graded, route):
    """run_pallas_solver (step and chunk routes) and run_mesh_solver on
    the CPU: one ``Solver chunk`` per chunk with its first step and
    steps, around ``Solver advance`` (the upload and the launches),
    ``Solver samples to host`` (the samples' one copy) and ``Solver
    hooks`` (the caller's hooks, which get numpy rows); no device clock
    on the CPU."""
    case = graded if route == "mesh" else box
    log = TM.GLOBAL_TIMERS.log
    log.clear()
    seen = []

    def open_spans():
        return [r.name for r in TM.GLOBAL_TIMERS.open]

    def on_chunk(done, state):
        seen.append(("chunk", done, open_spans()))

    def on_samples(s0, ys):
        assert isinstance(ys, np.ndarray)
        seen.append(("samples", s0, open_spans()))
        return ys

    _, samples = _run(case, route, on_chunk, on_samples)
    n_st = len(case[0].stations.nodes)
    assert samples.shape == (STEPS, n_st, 3)
    chunks = [r for r in log if r.name == TM.CHUNK]
    starts = list(range(0, STEPS, CHUNK))
    assert [r.step for r in chunks] == starts
    assert [r.counts["steps"] for r in chunks] == \
        [min(CHUNK, STEPS - s) for s in starts]
    inside = ["Solver time loop", TM.CHUNK, "Solver hooks"]
    assert seen == [x for s in starts for x in (
        ("samples", s, inside), ("chunk", min(s + CHUNK, STEPS), inside))]
    for rec in chunks:
        assert rec.counts == {"steps": rec.counts["steps"],
                              "device_s": None, "gap_s": None}
        assert rec.parent.name == "Solver time loop"
        kids = _children(log, rec)
        assert [r.name for r in kids] == list(CHUNK_SPANS)
        assert kids[0].t1_ns <= kids[1].t0_ns <= kids[1].t1_ns \
            <= kids[2].t0_ns
        parts = _children(log, kids[0])
        assert [r.name for r in parts] == list(ADVANCE_SPANS)
        assert all(r.step == rec.step and r.counts == {}
                   for r in kids + parts)


class _Event:
    """A stand-in for torch.cuda.Event on a stand-in stream: complete
    once the stream has drained past it (``_Stream.drain``, as a samples
    copy that returned); ``elapsed_time`` refuses an incomplete one, as
    CUDA does."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream):
        self.t = stream.now
        self.done = False
        stream.events.append(self)

    def elapsed_time(self, other):
        assert self.done and other.done, "read an incomplete event"
        return (other.t - self.t) * 1e3

    def query(self):
        return self.done


class _Stream:
    def __init__(self):
        self.now, self.events = 0.0, []

    def drain(self):
        for ev in self.events:
            ev.done = True


def test_chunk_clock_reads_complete_events_and_never_waits(monkeypatch):
    """run_chunked on a CUDA device (stand-in events): each chunk gets
    its gap since the previous chunk's end, and its device span once the
    next chunk's copy has returned; the chunk ends as soon as its samples'
    copy returns, so the host's work after it (here the caller's hooks)
    falls in the gap; only complete events are read and nothing
    synchronises."""
    stream = _Stream()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: stream)

    def refuse(*a, **k):
        raise AssertionError("the time loop synchronised")

    def copy(t):
        stream.now += 0.0625            # the samples' copy
        stream.drain()                  # ... has returned
        return t

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", copy)
    busy = {0: 0.5, 10: 0.25, 20: 0.75, 30: 0.5}

    def advance(state, s, k):
        stream.now += busy[s]           # the chunk's device work
        return state, torch.zeros((k, 1, 3))

    def on_samples(s0, ys):
        assert isinstance(ys, np.ndarray)
        stream.now += 0.125 * (s0 + 10) / 10   # the boundary's host work
        return ys

    TM.GLOBAL_TIMERS.log.clear()
    _, ys = run_chunked(advance, (), 40, chunk=10, on_samples=on_samples,
                        device=torch.device("cuda", 0))
    assert ys.shape == (40, 1, 3)
    chunks = [r for r in TM.GLOBAL_TIMERS.log if r.name == TM.CHUNK]
    assert chunks[0].counts["gap_s"] is None
    assert [r.counts["gap_s"] for r in chunks[1:]] == \
        pytest.approx([0.125, 0.25, 0.375])
    assert [r.counts["device_s"] for r in chunks[:-1]] == \
        pytest.approx([0.5625, 0.3125, 0.8125])
    assert chunks[-1].counts["device_s"] is None


def test_chunk_clock_without_samples_leaves_its_counts(monkeypatch):
    """run_chunked on a CUDA device (stand-in events) whose chunks have
    no samples to copy: nothing completes their events, so no chunk gets
    a gap or a device span, and nothing raises or synchronises; once
    the stream has drained, the next chunk's end reads them again."""
    stream = _Stream()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: stream)

    def refuse(*a, **k):
        raise AssertionError("the time loop synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: t)

    def advance(state, s, k):
        stream.now += 0.5
        if s == 30:
            stream.drain()              # the device caught up
        return state, torch.zeros((k, 0, 3))

    TM.GLOBAL_TIMERS.log.clear()
    run_chunked(advance, (), 50, chunk=10, device=torch.device("cuda", 0))
    chunks = [r for r in TM.GLOBAL_TIMERS.log if r.name == TM.CHUNK]
    assert [r.counts["gap_s"] for r in chunks] == [None] * 3 + [0.0, None]
    assert [r.counts["device_s"] for r in chunks] == \
        [None, None, pytest.approx(0.5), None, None]


def test_spans_in_the_profiler_trace(box, tmp_path):
    """Under torch.profiler on the CPU, the time loop's spans appear in
    the exported trace as ranges of the same names, one chunk range per
    chunk, on the profiler's clock around the chunk's operations."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(box, "step")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in ranges}
    assert {TM.CHUNK, *CHUNK_SPANS, *ADVANCE_SPANS} <= names
    chunk = sorted((e for e in ranges if e["name"] == TM.CHUNK),
                   key=lambda e: e["ts"])
    assert len(chunk) == len(range(0, STEPS, CHUNK))
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] == "aten::index_add_"]
    first = chunk[0]
    assert any(first["ts"] <= e["ts"] <= first["ts"] + first["dur"]
               for e in ops)


def test_setup_spans(tmp_path):
    """Simulation.setup leaves its five set-up spans beside the meshing
    spans, each once, and the timing report prints them."""
    from hercules_tpu_torch.utils.timers import print_timing_stat
    log = TM.GLOBAL_TIMERS.log
    log.clear()
    sim = box_simulation(str(tmp_path), steps=STEPS)
    sim.route("auto")
    names = [r.name for r in log]
    for name in SETUP_SPANS + ("Octor Newtree", "Octor Extractmesh",
                               "Mesh correct properties", "Solver plan"):
        assert names.count(name) == 1, name
    top = {r.name for r in log if r.parent is None}
    assert set(SETUP_SPANS) <= top
    extract = next(r for r in log if r.name == "Octor Extractmesh")
    assert {r.name for r in _children(log, extract)} >= {
        "extract: corner keys"}
    out = io.StringIO()
    print_timing_stat(sim.params, sim.mesh, out=out)
    text = out.getvalue()
    for name in SETUP_SPANS:
        assert name in text
