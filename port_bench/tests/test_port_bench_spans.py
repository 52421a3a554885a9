"""The readers of the program's spans: ``loop.boundary_idle_share`` on
synthetic span logs, and the set-up readers ``setup.assemble_s`` and
``setup.source_forces_s`` on synthetic timers; then a traced run of the
harness on the CPU, where the set-up spans are read and the device
clock, which only a CUDA device has, is not."""

import types

import pytest

from port_bench import cell as C

IDLE = "loop.boundary_idle_share"


def _chunk(step, device_s, gap_s, name="Solver chunk"):
    return types.SimpleNamespace(name=name, step=step, counts={
        "steps": 10, "device_s": device_s, "gap_s": gap_s})


def _ctx(chunk=10, untraced=(30, 1.0), **kw):
    return types.SimpleNamespace(chunk=chunk, untraced=untraced, **kw)


@pytest.fixture
def span_log(monkeypatch):
    """span_log(records): the program's span log holds ``records``."""
    from hercules_tpu_torch.utils import timers

    def put(records):
        monkeypatch.setattr(timers, "GLOBAL_TIMERS",
                            types.SimpleNamespace(log=list(records)))

    return put


def test_boundary_idle_reads_the_untraced_stretch_alone(span_log):
    # steps [10, 40) are the untraced stretch: chunks 10, 20, 30; the
    # set-up's chunk (0) and the traced chunks (40, 50) are left out,
    # and so is the gap before the stretch's first chunk
    span_log([_chunk(0, 5.0, None), _chunk(10, 1.0, 9.0),
              _chunk(20, 2.0, 0.5), _chunk(30, 3.0, 1.5),
              _chunk(40, 4.0, 7.0), _chunk(50, None, 8.0)])
    v = C.reader(IDLE)(_ctx())
    assert v == pytest.approx(100.0 * 2.0 / (2.0 + 6.0))


def test_boundary_idle_reads_the_last_run_and_chunks_alone(span_log):
    first_run = [_chunk(0, 1.0, None), _chunk(10, 1.0, 1.0),
                 _chunk(20, 1.0, 1.0), _chunk(30, 1.0, 1.0)]
    other = [types.SimpleNamespace(name="Solver hooks", step=20,
                                   counts={})]
    span_log(first_run + [_chunk(0, 2.0, None), _chunk(10, 2.0, 4.0)]
             + other + [_chunk(20, 2.0, 0.25), _chunk(30, 2.0, 0.75)])
    v = C.reader(IDLE)(_ctx())
    assert v == pytest.approx(100.0 * 1.0 / 7.0)


def test_boundary_idle_none_without_device_times(span_log):
    read = C.reader(IDLE)
    # on the CPU the chunks carry no device times
    span_log([_chunk(s, None, None) for s in range(0, 60, 10)])
    assert read(_ctx()) is None
    # a chunk of the stretch without its device span or its gap
    span_log([_chunk(0, 1.0, None), _chunk(10, 1.0, 1.0),
              _chunk(20, None, 1.0), _chunk(30, 1.0, 1.0)])
    assert read(_ctx()) is None
    span_log([_chunk(0, 1.0, None), _chunk(10, 1.0, 1.0),
              _chunk(20, 1.0, None), _chunk(30, 1.0, 1.0)])
    assert read(_ctx()) is None
    # no chunk in the stretch, no stretch, an empty log
    span_log([_chunk(0, 1.0, None), _chunk(40, 1.0, 1.0)])
    assert read(_ctx()) is None
    span_log([_chunk(0, 1.0, None), _chunk(10, 1.0, 1.0)])
    assert read(_ctx(untraced=None)) is None
    assert read(_ctx(untraced=(0, 0.0))) is None
    span_log([])
    assert read(_ctx()) is None


def test_boundary_idle_none_where_the_program_keeps_no_log(monkeypatch):
    """A program whose timers keep no span log (as before spans): the
    reader finds nothing and does not raise."""
    from hercules_tpu_torch.utils import timers
    monkeypatch.setattr(timers, "GLOBAL_TIMERS",
                        types.SimpleNamespace(acc={}, counts={}))
    assert C.reader(IDLE)(_ctx()) is None


@pytest.mark.parametrize("name, span", [
    ("setup.assemble_s", "Solver assemble"),
    ("setup.source_forces_s", "Source forces")])
def test_setup_readers(name, span):
    read = C.reader(name)
    assert read(_ctx(timers={span: 1.25, "Solver plan": 2.0})) == 1.25
    # without their span (a program that has none) they read nothing
    assert read(_ctx(timers={"Solver plan": 2.0})) is None
    assert read(_ctx(timers={})) is None


def test_traced_run_reads_the_setup_spans(tiny):
    """A traced run on the CPU: the set-up spans are read; the device
    clock is not there, so the boundary's share is left out."""
    result, _ = tiny("b1_1hz", 0.125, 2 ** 33 + 5, trace=1)
    got = result["metrics"]
    assert got["setup.assemble_s"]["value"] > 0
    assert got["setup.assemble_s"]["unit"] == "s"
    assert got["setup.source_forces_s"]["value"] > 0
    assert IDLE not in got
