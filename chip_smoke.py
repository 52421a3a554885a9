#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hercules_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  Phases, each printing one
JSON line {"phase": ...}:

1. build   -- compile hercules_tpu_torch/csrc/*.cu with nvcc.
2. k1      -- brick_step (K1) against brick_step_plain on the card: the
              2048-element box, 40 steps in float64 (bound
              2e-13 max|u|) and 20 in float32 (1e-4 max|u|); the
              2^20-element box, 10 steps in float32 (1e-4 max|u|).
3. k5      -- brick_chunk (K5) against the K1 step loop on the
              2048-element box, chunks of 16 steps, 37 steps: states
              bit-identical, samples within 1e-12 (float64) / 1e-5
              (float32) relative; and K5 against brick_chunk_plain at
              2^20 elements, 10 steps in float32 (1e-4 max|u|).
4. main    -- the main path through the CLI, launch counters set to 0
              just before: the 2^20-element box (128 x 128 x 64 at
              7.8125 m), 400 steps, a point source and 5 stations, in
              float32 (route cuda_chunk) and in float64 (cuda_step).
              Stations finite and non-zero, float32 within 1e-2 of
              float64, both kernels launched.
5. accuracy -- 131,072 elements (15.625 m), 200 steps: the float32
              CUDA run's stations within 1e-2 relative of the float64
              plain versions run on the card.
6. timing  -- at 2^20 elements in float32, CUDA events, medians of
              >= 20 steps after warm-up: K1 against its plain version,
              K5 (per step, amortised) against the K1 step loop and
              brick_chunk_plain.

Then the kernel table as one JSON line, the card's name and power
limit (nvidia-smi), and last {"ok": true, "device": {...}}.  Any
failure raises (non-zero exit, no result line); so does a machine
without a CUDA device.  Plain versions run with TF32 matmuls disabled
(torch.backends.cuda.matmul.allow_tf32 = False).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# per-phase JSON lines and the CLI runs' full output
LOG = os.path.join(ROOT, "build", "chip_smoke")


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(os.path.join(LOG, "phases.jsonl"), "a") as f:
        f.write(line + "\n")


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # the JAX package's native meshing helpers cache their build under
    # the checkout too
    os.environ.setdefault("HT_NATIVE_CACHE",
                          os.path.join(ROOT, "build", "native"))
    from hercules_tpu_torch.fixtures import box_stats, write_box_case
    from hercules_tpu_torch.kernels import build
    from hercules_tpu_torch.kernels.brick_chunk import (
        brick_chunk, brick_chunk_plain, sample_stations)
    from hercules_tpu_torch.kernels.brick_step import (brick_step,
                                                       brick_step_plain)
    from hercules_tpu_torch.sim import Simulation
    from hercules_tpu_torch.solver.bricks import build_plan
    from hercules_tpu_torch.solver.fused_brick import (
        PallasBrickTables, run_pallas_solver, source_increments)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(LOG, exist_ok=True)
    open(os.path.join(LOG, "phases.jsonl"), "w").close()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_", dir=os.path.join(ROOT, "build"))
    rng = np.random.default_rng(20261016)
    f32, f64 = torch.float32, torch.float64
    kern = {}

    def box(edge, steps, n_st, name):
        cv, ph, nu = write_box_case(os.path.join(work, name), edge, steps,
                                    n_st)
        sim = Simulation.setup(ph, nu, cv)
        return sim, build_plan(sim.mesh), (cv, ph, nu)

    def tables(sim, plan, dtype):
        st = sim.stations
        return PallasBrickTables(plan, sim.tables, src_ids=sim.src_ids,
                                 st_nodes=st.nodes, st_phi=st.phi,
                                 dtype=dtype, device=dev)

    def random_state(pt):
        """u ~ 1e-3 N(0, 1) on the brick's nodes, u- close to it, zero
        padding."""
        S = np.zeros((8, pt.LEN))
        u = 1e-3 * rng.standard_normal((3, pt.nb))
        S[0:3, :pt.nb] = u
        S[3:6, :pt.nb] = u - 1e-4 * rng.standard_normal((3, pt.nb))
        return torch.as_tensor(S, dtype=pt.dtype, device=dev)

    def k1_loop(pt, S, inc, plain):
        """K1 (or its plain version) step by step with the source adds."""
        S = S.clone()
        spare = torch.empty_like(S)
        for t in range(inc.shape[0]):
            if plain:
                Sn = brick_step_plain(S, pt.K, pt.offs, pt.step.ops)
            else:
                Sn = brick_step(S, pt.K, pt.offs, pt.step.ops, out=spare)
            Sn[0:3].index_add_(1, pt.src_pos, inc[t])
            S, spare = Sn, S
        return S

    def rel(a, b):
        scale = b[0:3].abs().max().item()
        require(scale > 0, "zero reference field")
        err = (a[0:6] - b[0:6]).abs().max().item()
        return err / scale, err

    try:
        # ---- 1. build ------------------------------------------------
        t0 = time.perf_counter()
        so = build.build()
        build.lib()
        log = so.with_suffix(".log").read_text()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "nvcc_seconds": build.build_seconds, "library": so.name,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling entry" in ln]})

        sim_s, plan_s, _ = box(62.5, 40, 5, "small")
        sim_b, plan_b, _ = box(7.8125, 20, 5, "big")
        require(sim_b.mesh.lenum == 1 << 20, f"{sim_b.mesh.lenum} elements")
        dt2_s, dt2_b = sim_s.params.delta_t ** 2, sim_b.params.delta_t ** 2

        # ---- 2. K1 against its plain version ------------------------
        cases = []
        for sim, plan, dtype, steps, bound, dt2 in (
                (sim_s, plan_s, f64, 40, 2e-13, dt2_s),
                (sim_s, plan_s, f32, 20, 1e-4, dt2_s),
                (sim_b, plan_b, f32, 10, 1e-4, dt2_b)):
            pt = tables(sim, plan, dtype)
            S0 = random_state(pt)
            inc = source_increments(pt, sim.src_forces, dt2, 0, steps)
            Sk = k1_loop(pt, S0, inc, plain=False)
            Sp = k1_loop(pt, S0, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            cases.append({"elements": sim.mesh.lenum, "dtype": str(dtype),
                          "steps": steps, "rel_err": r,
                          "max_abs_err": err, "bound": bound})
            require(r <= bound, f"K1 vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any(), "K1 moved the padding")
        kern["brick_step_err"] = cases[-1]["max_abs_err"]
        emit({"phase": "k1", "cases": cases,
              "launches": brick_step.launches})

        # ---- 3. K5 against the K1 step loop and its plain version ----
        cases = []
        for dtype, sbound in ((f64, 1e-12), (f32, 1e-5)):
            pt = tables(sim_s, plan_s, dtype)
            S0 = random_state(pt)
            res = {}
            for route in ("chunk", "step"):
                (u, up), smp = run_pallas_solver(
                    plan_s, sim_s.tables, sim_s.src_ids, sim_s.src_forces,
                    37, sim_s.params.delta_t, st_nodes=sim_s.stations.nodes,
                    st_phi=sim_s.stations.phi, dtype=dtype, device=dev,
                    chunk=16, state=S0, route=route)
                res[route] = (torch.cat([u, up]), smp)
            Sc, Ss = res["chunk"][0], res["step"][0]
            same = torch.equal(Sc, Ss)
            r, err = rel(Sc, Ss)
            sc = np.abs(res["step"][1]).max()
            srel = np.abs(res["chunk"][1] - res["step"][1]).max() / sc
            cases.append({"elements": sim_s.mesh.lenum, "dtype": str(dtype),
                          "steps": 37, "chunk": 16, "bit_identical": same,
                          "rel_err": r, "samples_rel_err": float(srel)})
            require(same or r <= (1e-14 if dtype == f64 else 1e-6),
                    f"K5 vs K1 loop {cases[-1]}")
            require(srel <= sbound, f"K5 samples {cases[-1]}")
        pt = tables(sim_b, plan_b, f32)
        S0 = random_state(pt)
        srcf = source_increments(pt, sim_b.src_forces, dt2_b, 0, 10)
        Sk, smp_k = brick_chunk(S0.clone(), torch.empty_like(S0), pt.K,
                                pt.offs, pt.step.ops, srcf, pt.src_pos,
                                pt.st_pos, pt.st_phi)
        Sp, smp_p = brick_chunk_plain(S0.clone(), pt.K, pt.offs,
                                      pt.step.ops, srcf, pt.src_pos,
                                      pt.st_pos, pt.st_phi)
        torch.cuda.synchronize()
        r, err = rel(Sk, Sp)
        srel = ((smp_k - smp_p).abs().max() / smp_p.abs().max()).item()
        cases.append({"elements": sim_b.mesh.lenum, "dtype": str(f32),
                      "steps": 10, "vs": "brick_chunk_plain",
                      "rel_err": r, "max_abs_err": err,
                      "samples_rel_err": srel, "bound": 1e-4})
        require(r <= 1e-4 and srel <= 1e-4, f"K5 vs plain {cases[-1]}")
        kern["brick_chunk_err"] = err
        emit({"phase": "k5", "cases": cases,
              "launches": brick_chunk.launches})

        # ---- 4. the main path through the CLI ------------------------
        from hercules_tpu_torch import cli
        from hercules_tpu_torch.utils.timers import GLOBAL_TIMERS
        runs = {}
        brick_step.launches = 0
        brick_chunk.launches = 0
        for dname in ("float32", "float64"):
            cv, ph, nu = write_box_case(os.path.join(work, f"main_{dname}"),
                                        7.8125, 400, 5)
            parts = ("Solver", "Solver plan", "Solver tables",
                     "Solver time loop")
            before = {k: GLOBAL_TIMERS.value(k) for k in parts}
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main([f"--dtype={dname}", cv, ph, nu])
            with open(os.path.join(LOG, f"cli_{dname}.log"), "w") as f:
                f.write(out.getvalue())
            require(rc == 0, f"CLI exit code {rc}")
            spent = {k: GLOBAL_TIMERS.value(k) - before[k] for k in parts}
            rundir = os.path.dirname(os.path.dirname(ph))
            with open(os.path.join(rundir, "monitor.txt")) as f:
                path = [ln.split()[2] for ln in f
                        if ln.startswith("solver path:")]
            st = np.stack([np.loadtxt(os.path.join(
                rundir, "stations", f"station.{i}"), skiprows=1)
                for i in range(5)])
            runs[dname] = (path, st, spent)
        main_launches = {"brick_step": brick_step.launches,
                         "brick_chunk": brick_chunk.launches}
        E, N = box_stats(7.8125)
        dt_b = sim_b.params.delta_t
        s32, s64 = runs["float32"][1], runs["float64"][1]
        st_rel = np.abs(s32[..., 1:] - s64[..., 1:]).max() / \
            np.abs(s64[..., 1:]).max()
        emit({"phase": "main", "elements": E, "nodes": N, "steps": 400,
              "stations": 5,
              "runs": {d: {"solver_path": runs[d][0],
                           "seconds": runs[d][2],
                           "steps_per_s": 400 / runs[d][2]["Solver"],
                           "element_updates_per_s":
                               E * 400 / runs[d][2]["Solver"],
                           "wall_s_per_sim_s":
                               runs[d][2]["Solver"] / (400 * dt_b),
                           "loop_element_updates_per_s":
                               E * 400 / runs[d][2]["Solver time loop"]}
                       for d in runs},
              "f32_vs_f64_station_rel": float(st_rel),
              "launches": main_launches})
        require(runs["float32"][0] == ["cuda_chunk"], "f32 route")
        require(runs["float64"][0] == ["cuda_step"], "f64 route")
        for d in runs:
            s = runs[d][1][..., 1:]
            require(np.isfinite(s).all() and np.abs(s).max() > 0,
                    f"{d} stations not finite and non-zero")
        require(st_rel <= 1e-2, f"f32 vs f64 stations {st_rel}")
        require(main_launches["brick_chunk"] > 0
                and main_launches["brick_step"] > 0,
                f"a kernel of the main path never ran: {main_launches}")

        # ---- 5. accuracy: f32 CUDA against f64 plain -----------------
        sim_a, plan_a, _ = box(15.625, 200, 5, "accuracy")
        _, s32 = sim_a.run(device=dev)
        require(sim_a.solver_path_name == "cuda_chunk", "accuracy route")
        pt = tables(sim_a, plan_a, f64)
        srcf = source_increments(pt, sim_a.src_forces,
                                 sim_a.params.delta_t ** 2, 0, 200)
        _, s64 = brick_chunk_plain(torch.zeros((8, pt.LEN), dtype=f64,
                                               device=dev),
                                   pt.K, pt.offs, pt.step.ops, srcf,
                                   pt.src_pos, pt.st_pos, pt.st_phi)
        s64 = s64.cpu().numpy()
        acc = float(np.abs(s32 - s64).max() / np.abs(s64).max())
        emit({"phase": "accuracy", "elements": sim_a.mesh.lenum,
              "steps": 200, "station_rel_err": acc, "bound": 1e-2})
        require(acc <= 1e-2, f"f32 stations vs f64 plain: {acc}")

        # ---- 6. timings at 2^20 elements in float32 -----------------
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        pt = tables(sim_b, plan_b, f32)
        S = random_state(pt)
        spare = torch.empty_like(S)

        def timed(fn, reps, warm):
            """Median milliseconds of fn() over reps calls after warm."""
            for _ in range(warm):
                fn()
            evs = [(torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
                   for _ in range(reps)]
            for a, b in evs:
                a.record()
                fn()
                b.record()
            torch.cuda.synchronize()
            return statistics.median(a.elapsed_time(b) for a, b in evs)

        ops = (pt.K, pt.offs, pt.step.ops)
        CH = 20
        srcf = source_increments(pt, sim_b.src_forces, dt2_b, 0, CH)
        inc0 = srcf[0]
        t_plain = timed(lambda: brick_step_plain(S, *ops), 30, 3)
        t_k1 = timed(lambda: brick_step(S, *ops, out=spare), 30, 5)

        def k1_route_step():
            sample_stations(S, pt.st_pos, pt.st_phi)
            Sn = brick_step(S, *ops, out=spare)
            Sn[0:3].index_add_(1, pt.src_pos, inc0)

        t_loop = timed(k1_route_step, 30, 5)
        t_k5 = timed(lambda: brick_chunk(S, spare, *ops, srcf, pt.src_pos,
                                         pt.st_pos, pt.st_phi), 25, 2) / CH
        t_k5p = timed(lambda: brick_chunk_plain(S, *ops, srcf, pt.src_pos,
                                                pt.st_pos, pt.st_phi),
                      5, 1) / CH
        t_k1_again = timed(lambda: brick_step(S, *ops, out=spare), 30, 5)
        t_plain_again = timed(lambda: brick_step_plain(S, *ops), 30, 3)
        moved = 23 * pt.LEN * 4     # S 8 rows in + 8 out, K 7 rows in
        emit({"phase": "timing", "card": card,
              "elements": sim_b.mesh.lenum, "LEN": pt.LEN,
              "ms_per_step": {
                  "brick_step": [t_k1, t_k1_again],
                  "brick_step_plain": [t_plain, t_plain_again],
                  "k1_route_step": t_loop,
                  "brick_chunk": t_k5,
                  "brick_chunk_plain": t_k5p},
              "brick_step_GBps": moved / (min(t_k1, t_k1_again) * 1e-3)
              / 1e9,
              "element_updates_per_s": {
                  "brick_step": sim_b.mesh.lenum / (min(t_k1, t_k1_again)
                                                    * 1e-3),
                  "brick_chunk": sim_b.mesh.lenum / (t_k5 * 1e-3)}})

        kernels = [
            {"name": "brick_step", "route": "cuda",
             "source": "hercules_tpu_torch/csrc/brick_step.cu",
             "replaces": "hercules_tpu/solver/pallas_brick.py:568",
             "launches": main_launches["brick_step"],
             "max_abs_err": kern["brick_step_err"],
             "ms": min(t_k1, t_k1_again),
             "plain_ms": min(t_plain, t_plain_again)},
            {"name": "brick_chunk", "route": "cuda",
             "source": "hercules_tpu_torch/csrc/brick_chunk.cu",
             "replaces": "hercules_tpu/solver/pallas_brick.py:2924",
             "launches": main_launches["brick_chunk"],
             "max_abs_err": kern["brick_chunk_err"],
             "ms": t_k5, "plain_ms": t_k5p},
        ]
        require("jax" not in sys.modules, "jax was imported")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
