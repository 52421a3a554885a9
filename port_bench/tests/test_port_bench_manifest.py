"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name: configurations, traffic mixes, limits and the
per-layer metrics' readers."""

import json
import os
import re

import pytest

from port_bench import cell as C

ROOT = os.path.dirname(C.HERE)
MAN = C.manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_manifest_keys_and_limits():
    assert set(MAN) == KEYS
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["port_bench"]
    assert len(MAN["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [c["name"] for c in MAN["configs"]]
    names += [w["name"] for w in MAN["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(w):
    entry, cfg, traffic, limits = C.find(MAN, w)
    assert cfg["name"] == entry["config"]
    assert cfg["chips"] == entry["chips"]
    assert set(limits) >= {"first_chunk", "window_chunk", "window_field"}
    assert len(entry["why"]) <= 200
    e2e, per = C.cell_metrics(MAN, w)
    assert {m["name"] for m in e2e} >= {"setup_s", "elem_updates_per_s"}
    assert per
    for m in per:
        assert callable(C.reader(m["name"]))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    path = os.path.join(ROOT, c["file"])
    assert path.startswith(os.path.join(ROOT, "port_bench") + os.sep)
    cfg = json.load(open(path))
    assert cfg["name"] == c["name"]
    assert set(c["reduced"]) == set(cfg["reduced"])
    assert cfg["precision"] in ("float32", "float64")
    assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_a_new_config_and_metric_by_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix, limits and a
    per-layer metric as files and manifest entries: the harness finds
    them by name without an edit."""
    for d in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / d).mkdir()
    cfg = json.load(open(os.path.join(C.HERE, "configs", "b1_1hz.json")))
    cfg["name"] = "b1_halfhz"
    cfg["fmax_hz"] = 0.5
    (tmp_path / "configs" / "b1_halfhz.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "quiet.json").write_text(json.dumps(
        {"chunk_steps": 500, "job_steps": 2000, "rate_seconds": 1.0,
         "trace_seconds": 1.0}))
    (tmp_path / "limits" / "b1_halfhz.quiet.json").write_text(json.dumps(
        {"first_chunk": 1e-3, "window_chunk": 1e-3, "window_field": 1e-3}))
    (tmp_path / "metrics" / "loop.chunks.py").write_text(
        "def read(ctx):\n    return ctx.steps / ctx.chunk\n")
    man = dict(MAN)
    man["workloads"] = MAN["workloads"] + [
        {"name": "b1_halfhz.quiet", "config": "b1_halfhz",
         "traffic": "quiet", "chips": 1, "why": "a test"}]
    man["per_layer"] = MAN["per_layer"] + [
        {"name": "loop.chunks", "unit": "chunks", "better": "higher",
         "source": "host_clock", "layer": "time loop",
         "moves": "elem_updates_per_s", "workloads": ["b1_halfhz.quiet"]}]
    entry, got, traffic, limits = C.find(man, "b1_halfhz.quiet",
                                         base=str(tmp_path))
    assert got["fmax_hz"] == 0.5 and traffic["chunk_steps"] == 500
    _, per = C.cell_metrics(man, "b1_halfhz.quiet")
    assert [m["name"] for m in per] == ["loop.chunks"]
    read = C.reader("loop.chunks", str(tmp_path / "metrics"))
    assert read(type("Ctx", (), {"steps": 3000, "chunk": 500})) == 6


@pytest.mark.parametrize("t", sorted(os.listdir(os.path.join(C.HERE,
                                                              "traffic"))))
def test_every_traffic_key_is_read(t):
    """A traffic mix holds only keys the harness reads: each is read as
    ``traffic["<key>"]`` in its sources ("what" is the mix's prose)."""
    traffic = C.load_json(os.path.join(C.HERE, "traffic", t))
    assert set(traffic) <= set(C.TRAFFIC_KEYS)
    src = ""
    for d, _, files in os.walk(C.HERE):
        if os.path.basename(d) != "tests":
            src += "".join(open(os.path.join(d, f)).read()
                           for f in files if f.endswith(".py"))
    for k in traffic:
        assert k == "what" or f'traffic["{k}"]' in src, k


def test_a_traffic_key_nothing_reads_is_refused(tmp_path):
    for d in ("configs", "traffic", "limits"):
        (tmp_path / d).mkdir()
    entry = MAN["workloads"][0]
    for d, name in (("configs", entry["config"]),
                    ("limits", entry["name"])):
        (tmp_path / d / (name + ".json")).write_text(
            open(os.path.join(C.HERE, d, name + ".json")).read())
    traffic = C.load_json(os.path.join(C.HERE, "traffic",
                                       entry["traffic"] + ".json"))
    traffic["sample_every_steps"] = 10
    (tmp_path / "traffic" / (entry["traffic"] + ".json")).write_text(
        json.dumps(traffic))
    with pytest.raises(KeyError, match="sample_every_steps"):
        C.find(MAN, entry["name"], base=str(tmp_path))


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    import hercules_tpu_torch  # noqa: F401
    assert "hercules_tpu_torch" not in C.FORBIDDEN
    before = set(C.forbidden_modules())
    monkeypatch.setitem(sys.modules, "hercules_tpu_torchy",
                        types.ModuleType("hercules_tpu_torchy"))
    assert set(C.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "hercules_tpu.sim",
                        types.ModuleType("hercules_tpu.sim"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert set(C.forbidden_modules()) == before | {"hercules_tpu", "jaxlib"}


def test_no_jax_in_the_harness_sources():
    """No file of the benchmark imports JAX or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|hercules_tpu)"
                     r"(\s|\.|$)", re.M)
    for d, _, files in os.walk(C.HERE):
        for f in files:
            if f.endswith(".py"):
                assert not pat.search(open(os.path.join(d, f)).read()), f
