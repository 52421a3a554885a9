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
4. main    -- the elastic main path through the CLI, launch counters
              set to 0 just before and read just after: the
              2^20-element box (128 x 128 x 64 at 7.8125 m), 400 steps,
              a point source and 5 stations, in float32 (route
              cuda_chunk) and in float64 (cuda_step).  Stations finite
              and non-zero, float32 within 1e-2 of float64, both
              kernels launched.
5. accuracy -- 131,072 elements (15.625 m), 200 steps: the float32
              CUDA run's stations within 1e-2 relative of the float64
              plain versions run on the card.
6. k2      -- bkt_step (K2) against bkt_step_plain on the card, from
              random S and memory variables, with the sources: the BKT
              box (shear attenuation only), 40 steps in float64 (S and
              conv within 2e-13 of their max) and 20 in float32 (1e-4);
              the soft box (bulk attenuation on), float64 (2e-13) and
              float32 with bfloat16 conv (1e-3); the 2^20-element BKT
              box, 10 steps in float32 (1e-4).  Padding stays zero.
7. k6      -- bkt_chunk (K6) against the K2 step loop on the BKT box
              and the soft box, chunks of 16, 37 steps, float64 and
              float32: S and conv bit-identical, samples within 1e-12
              / 1e-5 relative; K6 against bkt_chunk_plain at 2^20
              elements, 10 steps in float32 (1e-4).
8. main_bkt -- phase 4 with type_of_damping = bkt: routes
              cuda_bkt_chunk (float32) and cuda_bkt_step (float64),
              both BKT kernels launched.
9. accuracy_bkt -- phase 5 on the BKT box: float32 CUDA stations
              within 1e-2 relative of bkt_chunk_plain in float64.
10. k3     -- the node-tier step (bkt_node_step, K3, then the mixed-
              element epilogue and the sources) against the same route
              on bkt_node_step_plain, from random S, memory variables
              and mixed-element carry: the two-layer box (two Q sets),
              40 steps in float64 (S, conv and conv_mix within 2e-13 of
              their max) and 20 in float32 with bfloat16 memory
              variables (1e-3); its shear-only variant in float32
              (1e-4); the four-layer box at 2^20 elements (four Q sets,
              49,533 mixed elements in 3 runs), 10 steps in float32
              (1e-4 on S).  Padding stays zero.
11. k4     -- bkt_corner_step (K4) against bkt_corner_step_plain: the
              four-layer box at 62.5 m (where the rule picks the corner
              tier), 40 steps in float64 (2e-13) and 20 in float32
              (1e-3); the two-layer box forced to the corner tier,
              float64 (2e-13); the four-layer box at 2^20 forced to the
              corner tier, 10 steps in float32 (1e-4 on S).
12. main_bktq -- phase 4 on the four-layer box at 2^20 elements: both
              types on the node tier (route cuda_bkt_node_step), K3
              launched; then the four-layer box at 62.5 m through the
              CLI: route cuda_bkt_corner_step, K4 launched.
13. accuracy_bktq -- the four-layer box at 15.625 m (131,072 elements),
              200 steps: the float32 CUDA stations within 1e-2 relative
              of the node route on the plain versions in float64.
14. timing -- at 2^20 elements in float32, CUDA events, medians
              of >= 20 steps after warm-up: K1 and K2 against their
              plain versions, the K1 and K2 route steps (sampling +
              step + sources), K5 and K6 (per step, amortised) against
              brick_chunk_plain and bkt_chunk_plain; K2 and K6 again on
              the soft box meshed at 2^20 elements (bfloat16 memory
              variables, bulk attenuation on); on the four-layer box,
              K3, the epilogue alone and the K3 route step against
              bkt_node_step_plain, and K4 (forced) against
              bkt_corner_step_plain.

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
    from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, SOFT_FREQ,
                                             SOFT_LAYERS, TWO_LAYERS,
                                             box_dt, box_stats,
                                             four_q_freq, write_box_case)
    from hercules_tpu_torch.kernels import build
    from hercules_tpu_torch.kernels.bkt_chunk import (bkt_chunk,
                                                      bkt_chunk_plain)
    from hercules_tpu_torch.kernels.bkt_corner_step import (
        bkt_corner_step, bkt_corner_step_plain)
    from hercules_tpu_torch.kernels.bkt_node_step import (
        bkt_node_step, bkt_node_step_plain)
    from hercules_tpu_torch.kernels.bkt_step import (bkt_step,
                                                     bkt_step_plain)
    from hercules_tpu_torch.kernels.brick_chunk import (
        brick_chunk, brick_chunk_plain, sample_stations)
    from hercules_tpu_torch.kernels.brick_step import (brick_step,
                                                       brick_step_plain)
    from hercules_tpu_torch.sim import Simulation
    from hercules_tpu_torch.solver.bricks import build_plan
    from hercules_tpu_torch.solver.fused_brick import (
        PallasBrickTables, run_pallas_solver, source_increments)
    from hercules_tpu_torch.solver.fused_bktq import bkt_mix_epilogue

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

    def box(edge, steps, n_st, name, **case):
        cv, ph, nu = write_box_case(os.path.join(work, name), edge, steps,
                                    n_st, **case)
        sim = Simulation.setup(ph, nu, cv)
        return sim, build_plan(sim.mesh), (cv, ph, nu)

    def tables(sim, plan, dtype, bkt_tier=None):
        st = sim.stations
        return PallasBrickTables(plan, sim.tables, src_ids=sim.src_ids,
                                 st_nodes=st.nodes, st_phi=st.phi,
                                 dtype=dtype, device=dev, bkt_tier=bkt_tier)

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

    def random_bkt_state(pt):
        """random_state's S and memory variables ~ 1e-3 N(0, 1) on the
        brick's nodes, in the storage type."""
        S = random_state(pt)
        cv = np.zeros((pt.step.conv_rows, pt.LEN))
        cv[:, :pt.nb] = 1e-3 * rng.standard_normal((pt.step.conv_rows,
                                                     pt.nb))
        return S, torch.as_tensor(cv, dtype=pt.dtype,
                                  device=dev).to(pt.step.conv_dtype)

    def k2_loop(pt, S, cv, inc, plain):
        """K2 (or its plain version) step by step with the source adds."""
        args = (pt.K, pt.offs, pt.step.fm, pt.step.rec)
        S, cv = S.clone(), cv.clone()
        spare, cspare = torch.empty_like(S), torch.empty_like(cv)
        for t in range(inc.shape[0]):
            if plain:
                Sn, cn = bkt_step_plain(S, cv, *args)
            else:
                Sn, cn = bkt_step(S, cv, *args, out=spare, conv_out=cspare)
            Sn[0:3].index_add_(1, pt.src_pos, inc[t])
            S, spare, cv, cspare = Sn, S, cn, cv
        return S, cv

    def random_bktq_state(pt):
        """random_state's S, then every memory-variable part of the
        tier (conv and the node tier's conv_mix) ~ 1e-3 N(0, 1) on the
        brick's columns, in the storage type."""
        parts = [random_state(pt)]
        for shape, dt in pt.step.state_parts(pt.LEN):
            x = np.zeros(shape)
            if len(shape) == 2:
                x[:, :pt.nb] = 1e-3 * rng.standard_normal((shape[0], pt.nb))
            else:
                x[:] = 1e-3 * rng.standard_normal(shape)
            parts.append(torch.as_tensor(x, dtype=pt.dtype,
                                         device=dev).to(dt))
        return parts

    def node_loop(pt, state, inc, plain):
        """The node route step by step: K3 (or its plain version), the
        mixed-element epilogue, the source adds.  Returns (the final
        state, samples [steps, ns, 3])."""
        st = [x.clone() for x in state]
        spare = [torch.empty_like(st[0]), torch.empty_like(st[1])]
        samples = []
        for t in range(inc.shape[0]):
            samples.append(sample_stations(st[0], pt.st_pos, pt.st_phi))
            if plain:
                Sn, cn = bkt_node_step_plain(st[0], st[1], pt.K, pt.offs,
                                             pt.step.tab)
            else:
                Sn, cn = bkt_node_step(st[0], st[1], pt.K, pt.offs,
                                       pt.step.tab, out=spare[0],
                                       conv_out=spare[1])
            new = [Sn, cn]
            if pt.step.mix_M:
                Sn, cm = bkt_mix_epilogue(pt.step.mix, pt.step.shear_only,
                                          st[0], Sn, st[1], st[2],
                                          runs=pt.step.mix_runs,
                                          offs=pt.offs)
                new.append(cm)
            Sn[0:3].index_add_(1, pt.src_pos, inc[t])
            spare, st = st[:2], new
        return st, torch.stack(samples)

    def k4_loop(pt, S, cv, inc, plain):
        """K4 (or its plain version) step by step with the source adds."""
        args = (pt.K, pt.step.bk, pt.offs, pt.step.fm)
        S, cv = S.clone(), cv.clone()
        spare, cspare = torch.empty_like(S), torch.empty_like(cv)
        for t in range(inc.shape[0]):
            if plain:
                Sn, cn = bkt_corner_step_plain(S, cv, *args)
            else:
                Sn, cn = bkt_corner_step(S, cv, *args, out=spare,
                                         conv_out=cspare)
            Sn[0:3].index_add_(1, pt.src_pos, inc[t])
            S, spare, cv, cspare = Sn, S, cn, cv
        return S, cv

    def crel(a, b):
        """Relative and absolute error of memory variables a against b."""
        b = b.double()
        scale = b.abs().max().item()
        require(scale > 0, "zero reference conv")
        err = (a.double() - b).abs().max().item()
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
        counters = (brick_step, brick_chunk, bkt_step, bkt_chunk,
                    bkt_node_step, bkt_corner_step)

        def main_path(phase, routes, kernels, edge=7.8125, **case):
            """The CLI on the box at ``edge`` (2^20 elements by default),
            400 steps, 5 stations, float32 then float64; every launch
            counter set to 0 just before and read just after.  Returns
            the launches."""
            E, N = box_stats(edge)
            dt_b = box_dt(edge)
            runs = {}
            for c in counters:
                c.launches = 0
            for dname in ("float32", "float64"):
                cv, ph, nu = write_box_case(
                    os.path.join(work, f"{phase}_{dname}"), edge, 400, 5,
                    **case)
                parts = ("Solver", "Solver plan", "Solver tables",
                         "Solver time loop")
                before = {k: GLOBAL_TIMERS.value(k) for k in parts}
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = cli.main([f"--dtype={dname}", cv, ph, nu])
                with open(os.path.join(LOG, f"cli_{phase}_{dname}.log"),
                          "w") as f:
                    f.write(out.getvalue())
                require(rc == 0, f"CLI exit code {rc}")
                spent = {k: GLOBAL_TIMERS.value(k) - before[k]
                         for k in parts}
                rundir = os.path.dirname(os.path.dirname(ph))
                with open(os.path.join(rundir, "monitor.txt")) as f:
                    path = [ln.split()[2] for ln in f
                            if ln.startswith("solver path:")]
                st = np.stack([np.loadtxt(os.path.join(
                    rundir, "stations", f"station.{i}"), skiprows=1)
                    for i in range(5)])
                runs[dname] = (path, st, spent)
            launches = {c.__name__: c.launches for c in counters}
            s32, s64 = runs["float32"][1], runs["float64"][1]
            st_rel = np.abs(s32[..., 1:] - s64[..., 1:]).max() / \
                np.abs(s64[..., 1:]).max()
            emit({"phase": phase, "elements": E, "nodes": N, "steps": 400,
                  "stations": 5, "case": case,
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
                  "launches": launches})
            for d, want in zip(("float32", "float64"), routes):
                require(runs[d][0] == [want], f"{phase} {d} route")
                s_ = runs[d][1][..., 1:]
                require(np.isfinite(s_).all() and np.abs(s_).max() > 0,
                        f"{phase} {d} stations not finite and non-zero")
            require(st_rel <= 1e-2, f"{phase} f32 vs f64 stations {st_rel}")
            require(all(launches[k] > 0 for k in kernels),
                    f"a kernel of the {phase} path never ran: {launches}")
            return launches

        main_launches = main_path("main", ("cuda_chunk", "cuda_step"),
                                  ("brick_step", "brick_chunk"))

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

        # ---- 6. K2 against its plain version ------------------------
        sim_sb, plan_sb, _ = box(62.5, 40, 5, "small_bkt", damping="bkt")
        sim_ss, plan_ss, _ = box(62.5, 40, 5, "soft_bkt", damping="bkt",
                                 layers=SOFT_LAYERS, freq=SOFT_FREQ)
        sim_bb, plan_bb, _ = box(7.8125, 20, 5, "big_bkt", damping="bkt")
        dt2_bb = sim_bb.params.delta_t ** 2
        cases = []
        for label, sim, plan, dtype, steps, bound in (
                ("box", sim_sb, plan_sb, f64, 40, 2e-13),
                ("box", sim_sb, plan_sb, f32, 20, 1e-4),
                ("soft", sim_ss, plan_ss, f64, 40, 2e-13),
                ("soft", sim_ss, plan_ss, f32, 20, 1e-3),
                ("box", sim_bb, plan_bb, f32, 10, 1e-4)):
            pt = tables(sim, plan, dtype)
            S0, cv0 = random_bkt_state(pt)
            inc = source_increments(pt, sim.src_forces,
                                    sim.params.delta_t ** 2, 0, steps)
            Sk, ck = k2_loop(pt, S0, cv0, inc, plain=False)
            Sp, cp = k2_loop(pt, S0, cv0, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            rc_, cerr = crel(ck, cp)
            cases.append({"case": label, "elements": sim.mesh.lenum,
                          "dtype": str(dtype),
                          "conv": str(pt.step.conv_dtype), "steps": steps,
                          "rel_err": r, "max_abs_err": err,
                          "conv_rel_err": rc_, "conv_max_abs_err": cerr,
                          "bound": bound})
            require(r <= bound and rc_ <= bound, f"K2 vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any() and not ck[:, pt.nb:].any(),
                    "K2 moved the padding")
        kern["bkt_step_err"] = cases[-1]["max_abs_err"]
        emit({"phase": "k2", "cases": cases, "launches": bkt_step.launches})

        # ---- 7. K6 against the K2 step loop and its plain version ----
        cases = []
        for label, sim, plan in (("box", sim_sb, plan_sb),
                                 ("soft", sim_ss, plan_ss)):
            for dtype, sbound in ((f64, 1e-12), (f32, 1e-5)):
                pt = tables(sim, plan, dtype)
                S0, cv0 = random_bkt_state(pt)
                res = {}
                for route in ("chunk", "step"):
                    (u, up, c), smp = run_pallas_solver(
                        plan, sim.tables, sim.src_ids, sim.src_forces, 37,
                        sim.params.delta_t, st_nodes=sim.stations.nodes,
                        st_phi=sim.stations.phi, dtype=dtype, device=dev,
                        chunk=16, state=(S0, cv0), route=route)
                    res[route] = (torch.cat([u, up]), c, smp)
                same = (torch.equal(res["chunk"][0], res["step"][0])
                        and torch.equal(res["chunk"][1], res["step"][1]))
                r, _ = rel(res["chunk"][0], res["step"][0])
                rc_, _ = crel(res["chunk"][1], res["step"][1])
                sc = np.abs(res["step"][2]).max()
                srel = np.abs(res["chunk"][2] - res["step"][2]).max() / sc
                cases.append({"case": label, "elements": sim.mesh.lenum,
                              "dtype": str(dtype), "steps": 37, "chunk": 16,
                              "bit_identical": same, "rel_err": r,
                              "conv_rel_err": rc_,
                              "samples_rel_err": float(srel)})
                require(same, f"K6 vs K2 loop {cases[-1]}")
                require(srel <= sbound, f"K6 samples {cases[-1]}")
        pt = tables(sim_bb, plan_bb, f32)
        S0, cv0 = random_bkt_state(pt)
        srcf = source_increments(pt, sim_bb.src_forces, dt2_bb, 0, 10)
        bargs = (pt.K, pt.offs, pt.step.fm, pt.step.rec)
        Sk, ck, smp_k = bkt_chunk(S0.clone(), torch.empty_like(S0),
                                  cv0.clone(), torch.empty_like(cv0), *bargs,
                                  srcf, pt.src_pos, pt.st_pos, pt.st_phi)
        Sp, cp, smp_p = bkt_chunk_plain(S0.clone(), cv0.clone(), *bargs,
                                        srcf, pt.src_pos, pt.st_pos,
                                        pt.st_phi)
        torch.cuda.synchronize()
        r, err = rel(Sk, Sp)
        rc_, _ = crel(ck, cp)
        srel = ((smp_k - smp_p).abs().max() / smp_p.abs().max()).item()
        cases.append({"case": "box", "elements": sim_bb.mesh.lenum,
                      "dtype": str(f32), "steps": 10,
                      "vs": "bkt_chunk_plain", "rel_err": r,
                      "max_abs_err": err, "conv_rel_err": rc_,
                      "samples_rel_err": srel, "bound": 1e-4})
        require(r <= 1e-4 and rc_ <= 1e-4 and srel <= 1e-4,
                f"K6 vs plain {cases[-1]}")
        kern["bkt_chunk_err"] = err
        emit({"phase": "k6", "cases": cases, "launches": bkt_chunk.launches})

        # ---- 8. the BKT main path through the CLI --------------------
        bkt_launches = main_path("main_bkt",
                                 ("cuda_bkt_chunk", "cuda_bkt_step"),
                                 ("bkt_step", "bkt_chunk"), damping="bkt")

        # ---- 9. accuracy: BKT f32 CUDA against f64 plain -------------
        sim_a, plan_a, _ = box(15.625, 200, 5, "accuracy_bkt",
                               damping="bkt")
        _, s32 = sim_a.run(device=dev)
        require(sim_a.solver_path_name == "cuda_bkt_chunk",
                "accuracy_bkt route")
        pt = tables(sim_a, plan_a, f64)
        srcf = source_increments(pt, sim_a.src_forces,
                                 sim_a.params.delta_t ** 2, 0, 200)
        zero = torch.zeros((8, pt.LEN), dtype=f64, device=dev)
        zconv = torch.zeros((pt.step.conv_rows, pt.LEN), dtype=f64,
                            device=dev)
        _, _, s64 = bkt_chunk_plain(zero, zconv, pt.K, pt.offs, pt.step.fm,
                                    pt.step.rec, srcf, pt.src_pos,
                                    pt.st_pos, pt.st_phi)
        s64 = s64.cpu().numpy()
        acc = float(np.abs(s32 - s64).max() / np.abs(s64).max())
        emit({"phase": "accuracy_bkt", "elements": sim_a.mesh.lenum,
              "steps": 200, "station_rel_err": acc, "bound": 1e-2})
        require(acc <= 1e-2, f"BKT f32 stations vs f64 plain: {acc}")

        # ---- 10. K3 (and the epilogue) against the plain route ------
        two = dict(damping="bkt", layers=TWO_LAYERS, freq=SOFT_FREQ)
        four = dict(damping="bkt", layers=FOUR_Q_LAYERS,
                    freq=four_q_freq(62.5))
        four_big = dict(damping="bkt", layers=FOUR_Q_LAYERS,
                        freq=four_q_freq(7.8125))
        sim_2q, plan_2q, _ = box(62.5, 40, 5, "two_q", **two)
        sim_2s, plan_2s, _ = box(62.5, 40, 5, "two_q_shear",
                                 use_infinite_qk=True, **two)
        sim_4q, plan_4q, _ = box(62.5, 40, 5, "four_q", **four)
        sim_4b, plan_4b, _ = box(7.8125, 20, 5, "four_q_big", **four_big)
        require(sim_4b.mesh.lenum == 1 << 20, "four-layer 2^20 box")
        # (case, sim, plan, type, steps, bound on S and samples, bound on
        # the memory variables); at 2^20 elements S alone is bounded
        # tightly: there a memory variable near the max that rounds to
        # the other bfloat16 neighbour differs by 2^-8 of itself, so the
        # memory variables are bounded at 5e-3, just above that
        cases = []
        for label, sim, plan, dtype, steps, bound, mbound in (
                ("two", sim_2q, plan_2q, f64, 40, 2e-13, 2e-13),
                ("two", sim_2q, plan_2q, f32, 20, 1e-3, 1e-3),
                ("two_shear", sim_2s, plan_2s, f32, 20, 1e-4, 1e-4),
                ("four", sim_4b, plan_4b, f32, 10, 1e-4, 5e-3)):
            pt = tables(sim, plan, dtype)
            require(pt.bkt_tier == "node", f"{label} tier {pt.bkt_tier}")
            state = random_bktq_state(pt)
            inc = source_increments(pt, sim.src_forces,
                                    sim.params.delta_t ** 2, 0, steps)
            (Sk, *mk), smp_k = node_loop(pt, state, inc, plain=False)
            (Sp, *mp), smp_p = node_loop(pt, state, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            mem = [crel(a, b) for a, b in zip(mk, mp)]
            srel = ((smp_k - smp_p).abs().max()
                    / smp_p.abs().max()).item()
            cases.append({"case": label, "elements": sim.mesh.lenum,
                          "dtype": str(dtype),
                          "conv": str(pt.step.conv_dtype), "steps": steps,
                          "mixed": pt.step.mix_M,
                          "mix_runs": len(pt.step.mix_runs or ()),
                          "rel_err": r, "max_abs_err": err,
                          "conv_rel_err": mem[0][0],
                          "conv_mix_rel_err": mem[1][0],
                          "samples_rel_err": srel, "bound": bound,
                          "conv_bound": mbound})
            require(r <= bound and srel <= bound
                    and all(m[0] <= mbound for m in mem),
                    f"K3 route vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any() and not mk[0][:, pt.nb:].any(),
                    "K3 moved the padding")
        kern["bkt_node_step_err"] = cases[-1]["max_abs_err"]
        emit({"phase": "k3", "cases": cases,
              "launches": bkt_node_step.launches})

        # ---- 11. K4 against its plain version ------------------------
        cases = []
        for label, sim, plan, dtype, steps, bound, mbound, tier in (
                ("four", sim_4q, plan_4q, f64, 40, 2e-13, 2e-13, None),
                ("four", sim_4q, plan_4q, f32, 20, 1e-3, 1e-3, None),
                ("two", sim_2q, plan_2q, f64, 40, 2e-13, 2e-13, "corner"),
                ("four", sim_4b, plan_4b, f32, 10, 1e-4, 5e-3, "corner")):
            pt = tables(sim, plan, dtype, bkt_tier=tier)
            require(pt.bkt_tier == "corner", f"{label} tier {pt.bkt_tier}")
            S0, cv0 = random_bktq_state(pt)
            inc = source_increments(pt, sim.src_forces,
                                    sim.params.delta_t ** 2, 0, steps)
            Sk, ck = k4_loop(pt, S0, cv0, inc, plain=False)
            Sp, cp = k4_loop(pt, S0, cv0, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            rc_, cerr = crel(ck, cp)
            cases.append({"case": label, "forced": tier,
                          "elements": sim.mesh.lenum, "dtype": str(dtype),
                          "conv": str(pt.step.conv_dtype),
                          "conv_rows": pt.step.conv_rows, "steps": steps,
                          "rel_err": r, "max_abs_err": err,
                          "conv_rel_err": rc_, "conv_max_abs_err": cerr,
                          "bound": bound, "conv_bound": mbound})
            require(r <= bound and rc_ <= mbound, f"K4 vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any() and not ck[:, pt.nb:].any(),
                    "K4 moved the padding")
        kern["bkt_corner_step_err"] = cases[-1]["max_abs_err"]
        emit({"phase": "k4", "cases": cases,
              "launches": bkt_corner_step.launches})

        # ---- 12. the general-Q BKT main path through the CLI ---------
        node_launches = main_path(
            "main_bktq", ("cuda_bkt_node_step", "cuda_bkt_node_step"),
            ("bkt_node_step",), **four_big)
        corner_launches = main_path(
            "main_bktq_corner",
            ("cuda_bkt_corner_step", "cuda_bkt_corner_step"),
            ("bkt_corner_step",), edge=62.5, **four)

        # ---- 13. accuracy: node tier f32 CUDA against f64 plain ------
        sim_a, plan_a, _ = box(15.625, 200, 5, "accuracy_bktq",
                               damping="bkt", layers=FOUR_Q_LAYERS,
                               freq=four_q_freq(15.625))
        _, s32 = sim_a.run(device=dev)
        require(sim_a.solver_path_name == "cuda_bkt_node_step",
                f"accuracy_bktq route {sim_a.solver_path_name}")
        pt = tables(sim_a, plan_a, f64)
        inc = source_increments(pt, sim_a.src_forces,
                                sim_a.params.delta_t ** 2, 0, 200)
        zero = [torch.zeros((8, pt.LEN), dtype=f64, device=dev)] + [
            torch.zeros(shape, dtype=dt, device=dev)
            for shape, dt in pt.step.state_parts(pt.LEN)]
        _, s64 = node_loop(pt, zero, inc, plain=True)
        s64 = s64.cpu().numpy()
        acc = float(np.abs(s32 - s64).max() / np.abs(s64).max())
        emit({"phase": "accuracy_bktq", "elements": sim_a.mesh.lenum,
              "mixed": pt.step.mix_M, "steps": 200,
              "station_rel_err": acc, "bound": 1e-2})
        require(acc <= 1e-2, f"node-tier f32 stations vs f64 plain: {acc}")

        # ---- 14. timings at 2^20 elements in float32 -----------------
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

        # the same for K2 and K6 on the BKT box (float32 conv, 6 rows)
        ptb = tables(sim_bb, plan_bb, f32)
        Sb, cb = random_bkt_state(ptb)
        spb, cspb = torch.empty_like(Sb), torch.empty_like(cb)
        bargs = (ptb.K, ptb.offs, ptb.step.fm, ptb.step.rec)
        srcfb = source_increments(ptb, sim_bb.src_forces, dt2_bb, 0, CH)
        t_k2p = timed(lambda: bkt_step_plain(Sb, cb, *bargs), 30, 3)
        t_k2 = timed(lambda: bkt_step(Sb, cb, *bargs, out=spb,
                                      conv_out=cspb), 30, 5)

        def k2_route_step():
            sample_stations(Sb, ptb.st_pos, ptb.st_phi)
            Sn, _ = bkt_step(Sb, cb, *bargs, out=spb, conv_out=cspb)
            Sn[0:3].index_add_(1, ptb.src_pos, srcfb[0])

        t_k2loop = timed(k2_route_step, 30, 5)
        t_k6 = timed(lambda: bkt_chunk(Sb, spb, cb, cspb, *bargs, srcfb,
                                       ptb.src_pos, ptb.st_pos,
                                       ptb.st_phi), 25, 2) / CH
        t_k6p = timed(lambda: bkt_chunk_plain(Sb, cb, *bargs, srcfb,
                                              ptb.src_pos, ptb.st_pos,
                                              ptb.st_phi), 5, 1) / CH
        t_k2_again = timed(lambda: bkt_step(Sb, cb, *bargs, out=spb,
                                            conv_out=cspb), 30, 5)
        t_k2p_again = timed(lambda: bkt_step_plain(Sb, cb, *bargs), 30, 3)
        # and with the bulk attenuation on: the soft box meshed at 2^20
        # elements, 12 rows of bfloat16 memory variables
        sim_bs, plan_bs, _ = box(7.8125, 20, 5, "big_soft", damping="bkt",
                                 layers=SOFT_LAYERS,
                                 freq=1200.0 / (8 * 7.8125))
        require(sim_bs.mesh.lenum == 1 << 20, "soft 2^20 box")
        pts = tables(sim_bs, plan_bs, f32)
        require(pts.step.conv_dtype == torch.bfloat16, "soft conv type")
        Ss, cs = random_bkt_state(pts)
        sps, csps = torch.empty_like(Ss), torch.empty_like(cs)
        sargs = (pts.K, pts.offs, pts.step.fm, pts.step.rec)
        srcfs = source_increments(pts, sim_bs.src_forces,
                                  sim_bs.params.delta_t ** 2, 0, CH)
        t_k2s = timed(lambda: bkt_step(Ss, cs, *sargs, out=sps,
                                       conv_out=csps), 30, 5)
        t_k6s = timed(lambda: bkt_chunk(Ss, sps, cs, csps, *sargs, srcfs,
                                        pts.src_pos, pts.st_pos,
                                        pts.st_phi), 25, 2) / CH
        t_k2ps = timed(lambda: bkt_step_plain(Ss, cs, *sargs), 30, 3)
        # pass 1: S 6 rows + conv 6 in, conv 6 + dv 3 out; pass 2: S 8
        # + K 5 + dv 3 in, S 8 out (float32, shear-only)
        moved_k2 = 45 * ptb.LEN * 4
        # the general-Q tiers on the four-layer box at 2^20 elements (12
        # rows of bfloat16 memory variables; 49,533 mixed elements)
        ptn = tables(sim_4b, plan_4b, f32)
        Sn0, cn0, cm0 = random_bktq_state(ptn)
        spn, cspn = torch.empty_like(Sn0), torch.empty_like(cn0)
        nargs = (ptn.K, ptn.offs, ptn.step.tab)
        srcfn = source_increments(ptn, sim_4b.src_forces,
                                  sim_4b.params.delta_t ** 2, 0, 1)

        def epilogue(runs=ptn.step.mix_runs):
            bkt_mix_epilogue(ptn.step.mix, ptn.step.shear_only, Sn0, spn,
                             cn0, cm0, runs=runs, offs=ptn.offs)

        def k3_route_step():
            sample_stations(Sn0, ptn.st_pos, ptn.st_phi)
            S1 = ptn.step(Sn0, cn0, cm0, out=spn, conv_out=cspn)[0]
            S1[0:3].index_add_(1, ptn.src_pos, srcfn[0])

        t_k3p = timed(lambda: bkt_node_step_plain(Sn0, cn0, *nargs), 30, 3)
        t_k3 = timed(lambda: bkt_node_step(Sn0, cn0, *nargs, out=spn,
                                           conv_out=cspn), 30, 5)
        t_mix = timed(epilogue, 30, 5)
        # the gather form on the same mixed set, for comparison
        t_mix_gather = timed(lambda: epilogue(None), 30, 5)
        t_k3loop = timed(k3_route_step, 30, 5)
        t_k3_again = timed(lambda: bkt_node_step(Sn0, cn0, *nargs, out=spn,
                                                 conv_out=cspn), 30, 5)
        t_k3p_again = timed(lambda: bkt_node_step_plain(Sn0, cn0, *nargs),
                            30, 3)
        ptc = tables(sim_4b, plan_4b, f32, bkt_tier="corner")
        Sc0, cc0 = random_bktq_state(ptc)
        spc, cspc = torch.empty_like(Sc0), torch.empty_like(cc0)
        cargs = (ptc.K, ptc.step.bk, ptc.offs, ptc.step.fm)
        t_k4p = timed(lambda: bkt_corner_step_plain(Sc0, cc0, *cargs), 10, 2)
        t_k4 = timed(lambda: bkt_corner_step(Sc0, cc0, *cargs, out=spc,
                                             conv_out=cspc), 30, 5)
        t_k4_again = timed(lambda: bkt_corner_step(Sc0, cc0, *cargs, out=spc,
                                                   conv_out=cspc), 30, 5)
        t_k4p_again = timed(lambda: bkt_corner_step_plain(Sc0, cc0, *cargs),
                            10, 2)
        # K3 (float32, bfloat16 kappa): pass 1: S 6 rows, K 1 row, conv
        # 12 bf16 rows in and out, dv 6 rows out; pass 2: S 8, K 6 and
        # dv 6 rows in, S 8 out.  K4: pass 1: S 6 rows, conv 96 bf16
        # rows in and out, bk 20 rows in, F 24 rows out; pass 2: F 24, S
        # 8, K 4 rows in, S 8 out
        moved_k3 = 53 * ptn.LEN * 4
        moved_k4 = 190 * ptc.LEN * 4
        emit({"phase": "timing", "card": card,
              "elements": sim_b.mesh.lenum, "LEN": pt.LEN,
              "ms_per_step": {
                  "brick_step": [t_k1, t_k1_again],
                  "brick_step_plain": [t_plain, t_plain_again],
                  "k1_route_step": t_loop,
                  "brick_chunk": t_k5,
                  "brick_chunk_plain": t_k5p,
                  "bkt_step": [t_k2, t_k2_again],
                  "bkt_step_plain": [t_k2p, t_k2p_again],
                  "k2_route_step": t_k2loop,
                  "bkt_chunk": t_k6,
                  "bkt_chunk_plain": t_k6p,
                  "bkt_step_bf16_kappa": t_k2s,
                  "bkt_step_plain_bf16_kappa": t_k2ps,
                  "bkt_chunk_bf16_kappa": t_k6s,
                  "bkt_node_step": [t_k3, t_k3_again],
                  "bkt_node_step_plain": [t_k3p, t_k3p_again],
                  "bkt_mix_epilogue": t_mix,
                  "bkt_mix_epilogue_gather_form": t_mix_gather,
                  "k3_route_step": t_k3loop,
                  "bkt_corner_step": [t_k4, t_k4_again],
                  "bkt_corner_step_plain": [t_k4p, t_k4p_again]},
              "mixed_elements": ptn.step.mix_M,
              "bytes_per_step": {"brick_step": moved, "bkt_step": moved_k2,
                                 "bkt_node_step": moved_k3,
                                 "bkt_corner_step": moved_k4},
              "brick_step_GBps": moved / (min(t_k1, t_k1_again) * 1e-3)
              / 1e9,
              "bkt_step_GBps": moved_k2 / (min(t_k2, t_k2_again) * 1e-3)
              / 1e9,
              "bkt_node_step_GBps": moved_k3 / (min(t_k3, t_k3_again)
                                                * 1e-3) / 1e9,
              "bkt_corner_step_GBps": moved_k4 / (min(t_k4, t_k4_again)
                                                  * 1e-3) / 1e9,
              "element_updates_per_s": {
                  "brick_step": sim_b.mesh.lenum / (min(t_k1, t_k1_again)
                                                    * 1e-3),
                  "brick_chunk": sim_b.mesh.lenum / (t_k5 * 1e-3),
                  "bkt_step": sim_bb.mesh.lenum / (min(t_k2, t_k2_again)
                                                   * 1e-3),
                  "bkt_chunk": sim_bb.mesh.lenum / (t_k6 * 1e-3),
                  "k3_route_step": sim_4b.mesh.lenum / (t_k3loop * 1e-3),
                  "bkt_corner_step": sim_4b.mesh.lenum
                  / (min(t_k4, t_k4_again) * 1e-3)}})

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
            {"name": "bkt_step", "route": "cuda",
             "source": "hercules_tpu_torch/csrc/bkt_step.cu",
             "replaces": "hercules_tpu/solver/pallas_brick.py:1389",
             "launches": bkt_launches["bkt_step"],
             "max_abs_err": kern["bkt_step_err"],
             "ms": min(t_k2, t_k2_again),
             "plain_ms": min(t_k2p, t_k2p_again)},
            {"name": "bkt_chunk", "route": "cuda",
             "source": "hercules_tpu_torch/csrc/bkt_chunk.cu",
             "replaces": "hercules_tpu/solver/pallas_brick.py:1789",
             "launches": bkt_launches["bkt_chunk"],
             "max_abs_err": kern["bkt_chunk_err"],
             "ms": t_k6, "plain_ms": t_k6p},
            {"name": "bkt_node_step", "route": "cuda",
             "source": "hercules_tpu_torch/csrc/bkt_node.cu",
             "replaces": "hercules_tpu/solver/pallas_brick.py:2153",
             "launches": node_launches["bkt_node_step"],
             "max_abs_err": kern["bkt_node_step_err"],
             "ms": min(t_k3, t_k3_again),
             "plain_ms": min(t_k3p, t_k3p_again)},
            {"name": "bkt_corner_step", "route": "cuda",
             "source": "hercules_tpu_torch/csrc/bkt_corner.cu",
             "replaces": "hercules_tpu/solver/pallas_brick.py:1216",
             "launches": corner_launches["bkt_corner_step"],
             "max_abs_err": kern["bkt_corner_step_err"],
             "ms": min(t_k4, t_k4_again),
             "plain_ms": min(t_k4p, t_k4p_again)},
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
