"""Run one cell of the port's benchmark once and print its result.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``python3 port_bench/run.py ...`` works
too).  The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's chunks), ``failed`` (checked chunks over
their limits), ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, ``route`` (the program's name of the
route it took; ``mc:<path>`` on a cell of several cards, which runs a
rank on each of cuda:0 ... cuda:chips-1), ``kernel_build_s`` (the seconds of
``setup_s`` in which the program compiled its CUDA kernels: 0 unless the
checkout had not built them yet), and last ``checks``: each number
compared beside its limit, which also end standard error.  The run
exits non-zero and prints no result without enough CUDA devices, or if
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches(root):
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc build is ``build/hercules_tpu_torch/`` by itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "port_bench", sub)
    os.environ.setdefault("USE_FLAX", "0")


def one_core():
    """The run on one core, with one thread in each math library: the
    host thread that feeds the card stays where it is and no thread pool
    competes with it (each run's median chunk of the float32 step route
    then varied by 0.3-0.5 % from run to run, against 1.1 % unpinned, on
    an 8-core H100 host)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    caches(ROOT)
    one_core()
    import numpy as np
    import torch
    from port_bench import cell as C
    man = C.manifest(ROOT)
    entry, cfg, traffic, limits = C.find(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"port_bench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="port_bench_") as work:
        out = run(args, man, entry, cfg, traffic, limits, work,
                  [torch.device("cuda", i) for i in range(entry["chips"])])
    if out is None:
        return 3
    result, lines, chunks = out
    print(f"window chunks {len(chunks)}: seconds min {chunks.min():.6f} "
          f"median {np.median(chunks):.6f} max {chunks.max():.6f}",
          file=sys.stderr)
    print(f"route {result['route']}; kernels compiled in set-up: "
          f"{result['kernel_build_s']!r} s", file=sys.stderr)
    for name, v, limit, good in lines:
        print(f"check {name} {v!r} limit {limit!r} "
              f"{'ok' if good else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _clone(tree):
    """A copy of every tensor of a (nested) tuple or list of tensors."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(x) for x in tree)
    return tree.clone()


def run(args, man, entry, cfg, traffic, limits, work, devices,
        breaker=None, control=None):
    """One run on ``devices``, one rank on each (the cell's cards; a
    single device takes the single-device routes, several the program's
    multi-card pipeline); returns (result, check lines, the window's
    chunk seconds) or None where the import guard fails.  ``breaker``,
    for the tests, wraps the route function that the window drives.
    ``control`` (a torch type), for ``control.py`` alone, adds the
    readings of the reference computed in that type in the program's
    place (``result["control"]``)."""
    import torch
    from hercules_tpu_torch.kernels import build as kernel_build
    from hercules_tpu_torch.sim import Simulation
    from hercules_tpu_torch.solver.fused_brick import (pallas_u_global,
                                                       run_pallas_solver)
    from hercules_tpu_torch.solver.fused_mesh import (mesh_u_global,
                                                      run_mesh_solver)
    from hercules_tpu_torch.utils.timers import GLOBAL_TIMERS
    from port_bench import cell as C
    from port_bench import check, roofline
    from port_bench.reference import fem
    from port_bench.trace import Tracer

    device = devices[0]
    cards = sorted({d.index or 0 for d in devices})

    marks = [("imports", time.perf_counter())]
    rows = fem.element_rows(cfg)
    bricks = roofline.bricks(rows, C.extents(cfg))
    src = C.draw_source(cfg, args.seed, rows)
    recv = C.receivers(cfg)
    chunk = traffic["chunk_steps"]
    job = traffic["job_steps"]
    steps = C.run_steps(cfg, traffic, rows, args.seconds)
    cvmdb, physics, numerical = C.write_inputs(work, cfg, src, recv, job)
    built = kernel_build.library_path().exists()
    marks.append(("inputs", time.perf_counter()))

    sim = Simulation.setup(physics, numerical, cvmdb)
    marks.append(("Simulation.setup", time.perf_counter()))
    route, plan = ("multichip", None) if len(devices) > 1 else \
        sim.route("auto")[:2]
    marks.append(("plan", time.perf_counter()))
    if route == "multichip":
        # the program's pipeline on several cards (Simulation.run with
        # ndev > 1, the CLI's --ndev): its path chosen and its stations
        # attached under the "Solver tables" span, then its loop
        def fn(*_, on_chunk, on_samples, on_route, **__):
            sim.src_forces = held
            try:
                return sim._run_multichip(
                    len(devices), devices, device, dtype, chunk, steps,
                    on_chunk, lambda: None, work, (0, None), st.nodes,
                    st.phi, None, None, on_samples, None, None)
            finally:
                on_route(getattr(sim, "solver_path_name", None))

        snapshot = _clone

        def fields(snap):
            return [sim.mc_path.u_global(snap), sim.mc_path.up_global(snap)]
    elif route == "pallas":
        fn = run_pallas_solver

        def snapshot(state):
            return (state[0].clone(), state[1].clone())

        def fields(snap):
            return [pallas_u_global(plan, x, sim.mesh.nnum) for x in snap]
    elif route == "mesh":
        fn = run_mesh_solver

        def snapshot(state):
            return tuple(S[:6].clone() for S in state[0])

        def fields(snap):
            return [mesh_u_global(plan, [S[r:r + 3] for S in snap],
                                  sim.mesh.nnum) for r in (0, 3)]
    else:
        raise RuntimeError(f"the cell takes the {route} route, which no "
                           f"kernel of the port runs")
    if breaker is not None:
        fn = breaker(fn)
    dtype = {"float32": torch.float32, "float64": torch.float64}[
        cfg["precision"]]
    seconds = traffic["trace_seconds"] if args.trace else args.seconds
    win = C.Window(seconds, chunk, args.seed, snapshot,
                   tracer=(lambda: Tracer(work, cards)) if args.trace
                   else None,
                   rate_seconds=traffic["rate_seconds"] if args.trace
                   else 0.0)
    st = sim.stations
    held = C.HeldForces(sim.src_forces)
    taken = []
    try:
        fn(plan, sim.tables, sim.src_ids, held,
           steps, sim.params.delta_t, st_nodes=st.nodes, st_phi=st.phi,
           dtype=dtype, device=device, chunk=chunk, on_chunk=win.on_chunk,
           on_samples=win.on_samples, on_route=taken.append)
    except C.WindowClosed:
        pass
    else:
        raise RuntimeError("the run ended before the window closed")
    setup_s = win.t_setup - T_START
    marks.append(("tables, kernels and the first chunk", win.t_setup))
    print("set-up seconds: " + ", ".join(
        f"{name} {t - t0:.3f}" for (name, t), t0 in
        zip(marks, [T_START] + [t for _, t in marks[:-1]])),
        file=sys.stderr)
    build_s = 0.0 if built or kernel_build.build_seconds is None else \
        kernel_build.build_seconds
    route_name = taken[0]
    # steps a kernel launch advances on the route the program took (its
    # names: cuda_chunk and cuda_bkt_chunk launch once a chunk)
    launch_steps = chunk if route_name.endswith("_chunk") else 1
    peaks = ([torch.cuda.max_memory_allocated(i) for i in cards]
             if device.type == "cuda" else [0])
    memory_peak = max(peaks)
    print(f"memory peak bytes by card: {peaks}", file=sys.stderr)

    kept_start = fields(win.kept[1])
    kept_end = fields(win.kept_end)[0]
    kept = (win.kept[0], kept_start[0], kept_start[1], win.kept_samples,
            kept_end)
    prog_mesh = sim.mesh
    elements = prog_mesh.lenum
    timers = dict(GLOBAL_TIMERS.acc)
    trace = win.trace
    del sim, plan, fn, snapshot, fields, held
    win.kept = win.kept_end = win.candidate = None
    gc.collect()
    if device.type == "cuda":
        for i in cards:
            with torch.cuda.device(i):
                torch.cuda.empty_cache()

    bad = C.forbidden_modules()
    if bad:
        print(f"port_bench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return None

    t_check = time.perf_counter()
    values = check.readings(cfg, chunk, src, recv, job,
                            win.first_samples, kept, prog_mesh, devices)
    print(f"reference seconds: {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)
    correct, lines = check.judge(values, limits)
    control_values = None if control is None else check.readings(
        cfg, chunk, src, recv, job, win.first_samples, kept, prog_mesh,
        devices, run_dtype=control)
    failed = sum(1 for group in (("first_chunk",),
                                 ("window_chunk", "window_field"))
                 if any(not g for n, _, _, g in lines if n in group))

    e2e, per = C.cell_metrics(man, args.workload)
    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": entry["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": win.steps // chunk,
              "failed": failed}
    if not args.trace:
        values_e2e = {"elem_updates_per_s": elements * win.steps
                      / win.elapsed, "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values_e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        kernels = C.load_json(os.path.join(C.HERE, "port_kernels.json"))[
            "kernels"]
        ctx = types.SimpleNamespace(
            timers=timers, trace=trace, steps=win.steps, chunk=chunk,
            untraced=win.untraced, bricks=bricks, ranks=len(devices),
            cards=len(cards), precision=cfg["precision"],
            launch_steps=launch_steps,
            kernel_of=lambda n: next((k for k in kernels if k in n), None))
        for m in per:
            v = C.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["route"] = route_name
    result["kernel_build_s"] = build_s
    if control_values is not None:
        result["control"] = control_values
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in lines}
    return result, lines, win.chunk_seconds()


if __name__ == "__main__":
    sys.exit(main())
