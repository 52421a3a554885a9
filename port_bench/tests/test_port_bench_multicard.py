"""The harness on a cell of several cards: a tiny run of the four-card
configuration on four CPU ranks, the trace's reduction card by card,
and the readers and roofline counts that take a run's cards, which on
one card give what they gave before cards were counted."""

import types

import pytest

from port_bench import cell as C
from port_bench import roofline as R
from port_bench.trace import WINDOW, reduce


def _op(name, ts, dur, card, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": card, "tid": 7, "args": {"device": card, "stream": 7}}


def _window(ts, dur):
    return {"ph": "X", "name": WINDOW, "cat": "user_annotation", "ts": ts,
            "dur": dur, "pid": 1, "tid": 1}


def _host(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "cpu_op", "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


# one card: K1 twice, a copy overlapping the second, an operation cut by
# the window's end; the host's issue loop over the gaps
ONE = [_window(1000, 1000), _host("Solver issue", 1000, 1000),
       _op("brick_step_kernel<float,0,1,2>", 1100, 200, 0),
       _op("Memcpy DtoD (Device -> Device)", 1350, 100, 0, "gpu_memcpy"),
       _op("brick_step_kernel<float,0,1,2>", 1400, 200, 0),
       _op("index_add_kernel", 1900, 300, 0)]


def test_one_card_reduction_is_unchanged():
    got = reduce(ONE)
    # busy: [1100, 1300) + [1350, 1600) + [1900, 2000) = 550 us of 1000
    assert got["window_s"] == 1000 * 1e-6
    assert got["busy_s"] == 550 * 1e-6
    assert got["busy_by_card"] == [550 * 1e-6]
    assert got["device_ops"][0] == ["brick_step_kernel<float,0,1,2>",
                                    200 * 1e-6 + 200 * 1e-6]
    assert [s for _, s in got["idle_gaps"]] == [300 * 1e-6, 100 * 1e-6,
                                                50 * 1e-6]
    assert {n for n, _ in got["idle_gaps"]} == {"Solver issue"}
    # a one-card run counts every device operation as its card's, whatever
    # the trace names
    moved = [dict(e, args={"device": 3}, pid=3) if "dur" in e and
             e["cat"] == "kernel" else e for e in ONE]
    assert reduce(moved) == got


def _ctx(trace, steps, ranks=1, cards=1, bricks=((2 ** 21, 129 ** 3),),
         untraced=(1000, 0.5)):
    return types.SimpleNamespace(
        trace=trace, steps=steps, ranks=ranks, cards=cards,
        bricks=list(bricks), untraced=untraced, precision="float32",
        launch_steps=1, chunk=1000,
        kernel_of=lambda n: "brick_step_kernel"
        if "brick_step_kernel" in n else None)


def test_one_card_readers_are_unchanged():
    trace = reduce(ONE)
    ctx = _ctx(trace, steps=2)
    busy, window = 550 * 1e-6, 1000 * 1e-6
    assert C.reader("device.idle_share")(ctx) == \
        100.0 * (1.0 - busy / window)
    least = 2 * R.least_seconds(2 ** 21, 129 ** 3, 1, "float32")
    assert C.reader("kernel.brick_step_roofline")(ctx) == \
        100.0 * least / (200 * 1e-6 + 200 * 1e-6)
    E, N = 2 ** 21, 129 ** 3
    assert C.reader("loop.step_mfu")(ctx) == \
        100.0 * (1000 * (R.least_seconds(E, N, 1, "float32") / 1)) / 0.5
    assert C.reader("comm.peer_copy_share")(ctx) is None
    # three launches for two steps: K1 is read only at one a step
    assert C.reader("kernel.brick_step_roofline")(_ctx(trace, 3)) is None


def test_roofline_on_one_card_is_unchanged():
    E, N = 2 ** 21, 129 ** 3
    for steps in (1, 1000):
        for p in ("float32", "float64"):
            assert R.least_step_seconds([(E, N)], steps, p) == \
                R.least_seconds(E, N, steps, p) / steps
            assert R.least_step_seconds([(E, N)], steps, p, 1) == \
                R.least_seconds(E, N, steps, p) / steps
    assert R.floor_step_seconds([(E, N)], "float32") == \
        R.call_flop(E, N, 1) / R.PEAK_FLOP_PER_S["float32"]
    assert R.floor_step_seconds([(E, N)], "float64", 1) == \
        R.call_flop(E, N, 1) / R.PEAK_FLOP_PER_S["float64"]


def test_roofline_counts_every_card():
    E, N = 256 ** 3, 257 ** 3
    one = R.least_step_seconds([(E, N)], 1, "float32")
    assert R.least_step_seconds([(E, N)], 1, "float32", 4) == \
        pytest.approx(one / 4)
    assert R.floor_step_seconds([(E, N)], "float32", 4) == \
        pytest.approx(R.floor_step_seconds([(E, N)], "float32") / 4)
    cfg = C.load_json(f"{C.HERE}/configs/b1_2hz_x4.json")
    traffic = {"chunk_steps": 1000}
    rows = [(i * 30000.0 / 256, 30000.0 / 256) for i in range(256)]
    four = C.run_steps(cfg, traffic, rows, 20.0)
    assert four == 1000 * (int(20.0 / R.floor_step_seconds(
        [(E, N)], "float32", 4) / 1000) + 1 + 2)


# two cards: each runs K1 on its fragment, then copies a plane to the
# other; card 1 also idles longer
TWO = [_window(0, 1000), _host("Solver issue", 0, 1000),
       _op("brick_step_kernel<float,0,1,2>", 100, 300, 0),
       _op("brick_step_kernel<float,0,1,2>", 150, 300, 1),
       _op("Memcpy PtoP (Device -> Device)", 400, 50, 0, "gpu_memcpy"),
       _op("Memcpy PtoP (Device -> Device)", 450, 50, 1, "gpu_memcpy"),
       _op("brick_step_kernel<float,0,1,2>", 600, 300, 0),
       _op("brick_step_kernel<float,0,1,2>", 700, 200, 1)]


def test_two_card_reduction_keeps_each_cards_busy_time():
    got = reduce(TWO, cards=[0, 1])
    assert got["busy_by_card"] == pytest.approx([650e-6, 550e-6])
    assert got["busy_s"] == pytest.approx(600e-6)
    assert len(got["device"]) == 6
    # idle stretches are those in which neither card was busy
    assert sorted(s for _, s in got["idle_gaps"]) == pytest.approx(
        [100e-6, 100e-6, 100e-6])
    # a card with nothing in the window counts, idle
    assert reduce(TWO, cards=[0, 1, 2])["busy_by_card"][2] == 0.0


def test_two_card_readers():
    trace = reduce(TWO, cards=[0, 1])
    E, N = 2 ** 21, 129 ** 3
    ctx = _ctx(trace, steps=2, ranks=2, cards=2, bricks=[(E, N)])
    assert C.reader("device.idle_share")(ctx) == pytest.approx(
        (35.0 + 45.0) / 2)
    # K1 once per fragment and step: the whole brick's least time over
    # the launches' time summed over the cards
    assert C.reader("kernel.brick_step_roofline")(ctx) == pytest.approx(
        100.0 * 2 * R.least_seconds(E, N, 1, "float32") / 1100e-6)
    assert C.reader("kernel.brick_step_roofline")(
        _ctx(trace, steps=2, ranks=1, bricks=[(E, N)])) is None
    assert C.reader("comm.peer_copy_share")(ctx) == pytest.approx(
        100.0 * 100 / 1200)
    assert C.reader("loop.step_mfu")(ctx) == pytest.approx(
        C.reader("loop.step_mfu")(_ctx(trace, 2, bricks=[(E, N)])) / 2)


def test_held_forces_have_the_jobs_shape():
    import numpy as np
    f = np.arange(2 * 4 * 3, dtype=np.float64).reshape(2, 4, 3)
    held = C.HeldForces(f)
    assert held.shape == (2, 4, 3)
    assert (held[1:4] == f[[1, 1, 1]]).all()


def test_tiny_four_card_run_on_cpu_ranks(tiny):
    """The four-card configuration at a reduced frequency on four CPU
    ranks: the program's multi-card pipeline ("mc:slab", the plain slab
    path the CPU takes), correct, with the cell's card count."""
    result, lines = tiny("b1_2hz_x4", 0.125, 2 ** 32 + 21)
    assert result["route"] == "mc:slab"
    assert result["correct"], lines
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"elem_updates_per_s", "setup_s"}
    traced, lines = tiny("b1_2hz_x4", 0.125, 2 ** 32 + 22, trace=1)
    assert traced["correct"], lines
    assert set(traced["metrics"]) == {"setup.mesh_s", "setup.plan_tables_s",
                                      "setup.assemble_s",
                                      "setup.source_forces_s"}
