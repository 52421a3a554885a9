"""Back-to-back A/B timing of environment configs in one process:

  python -m hercules_tpu_torch.tools.perf_ab <damping> <steps> \
      KEY=V[,KEY=V...] [...] [--elems=N] [--device=cpu]

e.g. ``perf_ab rayleigh 100 "" HT_BKT_UNIFORM=0``.

Counterpart of ``hercules_tpu/tools/perf_ab.py``, with its command
line.  The box is fixture (a) (``resident_bench.build``: at the edge the
root bench.build picks for ``--elems``, default 1,000,000 -> 2^20
elements), built once with ``damping`` (``elastic`` is Rayleigh, as
there).  Then, for two rounds and each config, the config's variables
are set while the box's float32 ``PallasBrickTables`` and its step are
built, and restored afterwards; the per-step route
(``fused_brick.step_advance``: K1 for elastic and Rayleigh; K2, K3 or
K4 by the BKT tier for ``bkt``) runs ``steps`` steps once to warm, then
once timed, from a seeded state (``resident_bench.seeded_state``).
Each config's line gives microseconds per step and element updates per
second beside the route's name (``fused_brick.route_name``), its BKT
tier and the card's name and power limit, so that a config the port
does not read shows as such: the port keeps none of the JAX package's
layout knobs on this route.  It ends with the best of the two rounds.
On ``--device=cpu`` it runs the plain versions, and its times are the
CPU's.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .resident_bench import (build, device_label, parse_args,
                             seeded_state)


def _set_env(cfg):
    """Set a config's KEY=V pairs; returns the values they replaced."""
    saved = {}
    for kv in [kv for kv in cfg.split(",") if kv]:
        k, v = kv.split("=", 1)
        saved.setdefault(k, os.environ.get(k))
        os.environ[k] = v
    return saved


def _restore_env(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def run(damping, steps, configs, elems=1_000_000, device="cuda",
        problem=None, out=None):
    """The A/B; prints the tool's lines to ``out`` and returns {cfg:
    {"route", "tier", "eups": [per round], "us_per_step": [per round],
    "S0": the seeded start state, "S": the last round's state after its
    2 ``steps`` steps}}."""
    from ..solver.bricks import build_plan
    from ..solver.fused_brick import (PallasBrickTables,
                                      init_packed_state, route_name,
                                      solver_device, step_advance)

    out = out or sys.stdout
    device = solver_device(device)
    want = "rayleigh" if damping == "elastic" else damping
    p, mesh, tables, t_mesh, t_asm = problem or build(elems, want)
    if tables.damping != want:
        raise ValueError(f"the box was built with {tables.damping} "
                         f"damping, not {want}")
    plan = build_plan(mesh)
    card = device_label(device)
    print(f"# problem built: {mesh.lenum} elems "
          f"(mesh {t_mesh:.1f}s asm {t_asm:.1f}s) ({card})", file=out,
          flush=True)
    E = mesh.lenum
    forces = np.zeros((steps, 0, 3))
    results = {}
    for rep in range(2):
        for cfg in configs:
            saved = _set_env(cfg)
            try:
                pt = PallasBrickTables(plan, tables, dtype=torch.float32,
                                       device=device)
                advance = step_advance(pt, forces, p.delta_t ** 2)
            finally:
                _restore_env(saved)
            S0 = seeded_state(pt)
            state = (S0.clone(),) + init_packed_state(pt)[1:]
            state, _ = advance(state, 0, steps)         # warm
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, _ = advance(state, 0, steps)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            us, eups = dt / steps * 1e6, E * steps / dt
            route = route_name(pt, "step")
            r = results.setdefault(cfg, {"route": route,
                                         "tier": pt.bkt_tier, "eups": [],
                                         "us_per_step": []})
            r["eups"].append(eups)
            r["us_per_step"].append(us)
            r["S0"], r["S"] = S0, state
            print(f"[{rep}] {cfg or '(default)'}: {us:.0f} us/step  "
                  f"{eups:.3e} eups  route {route} tier "
                  f"{pt.bkt_tier or '-'} ({card})", file=out, flush=True)
    print("# best-of-2:", file=out)
    for cfg, r in results.items():
        print(f"#   {cfg or '(default)'}: {max(r['eups']):.3e} eups "
              f"({card})", file=out, flush=True)
    return results


def main(argv=None):
    pos, opts = parse_args(list(sys.argv[1:] if argv is None else argv))
    if len(pos) < 2:
        print(__doc__)
        return 2
    run(pos[0], int(pos[1]), pos[2:] or [""],
        elems=int(float(opts.get("elems", 1_000_000))),
        device=opts.get("device", "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
