"""pytest settings of the benchmark's own tests (``port_bench/tests``):
the marker of the tests that need a CUDA card, which skip without one,
and the tiny runs the CPU tests drive."""

import tempfile
import types

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (the "
        "test decides when it runs, never at import)")


@pytest.fixture
def tiny():
    """tiny(config, fmax, seed, **run_kw) -> (result, lines): one run of
    the harness on the CPU, on the port's plain versions, at a reduced
    frequency, with chunks of 20 steps, a run of 2000 steps and the
    set-up of a job of 300 (so the window runs past the job's end); on
    as many CPU ranks as the configuration's cell has cards."""
    import torch
    from port_bench import cell as C
    from port_bench import run as R

    def go(config, fmax, seed, limits=None, seconds=0.3, trace=0,
           steps=2000, job=300, **kw):
        torch.set_num_threads(2)
        cfg = C.load_json(f"{C.HERE}/configs/{config}.json")
        cfg["fmax_hz"] = fmax
        traffic = C.load_json(f"{C.HERE}/traffic/stations.json")
        traffic["chunk_steps"] = 20
        traffic["trace_seconds"] = seconds
        traffic["rate_seconds"] = seconds
        traffic["job_steps"] = job
        cellname = config + ".stations"
        man = C.manifest(C.os.path.dirname(C.HERE))
        entry = {"name": cellname, "config": config, "traffic": "stations",
                 "chips": cfg["chips"], "why": "a test"}
        if all(w["name"] != cellname for w in man["workloads"]):
            # a configuration with no cell (loh1_4hz): the first cell's
            # metrics and limits
            first = man["workloads"][0]["name"]
            man = dict(man, workloads=man["workloads"] + [entry],
                       per_layer=[dict(m, workloads=m["workloads"]
                                       + [cellname])
                                  for m in man["per_layer"]
                                  if first in m["workloads"]])
            cellname_limits = first
        else:
            cellname_limits = cellname
        limits = limits or C.load_json(
            f"{C.HERE}/limits/{cellname_limits}.json")
        args = types.SimpleNamespace(workload=cellname, seed=seed,
                                     seconds=seconds, trace=trace)
        real = C.run_steps
        C.run_steps = lambda *a: steps
        try:
            with tempfile.TemporaryDirectory() as work:
                return R.run(args, man, entry, cfg, traffic, limits, work,
                             [torch.device("cpu")] * cfg["chips"], **kw)[:2]
        finally:
            C.run_steps = real

    return go
