"""Readings for the limits of ``correct``: on each seed, one short run
of a cell (its own sizes and load), the program's numbers and those of
the control, the reference computed in the nearest type below the
configuration's and put in the program's place (bfloat16 for float32).

    python3 -m port_bench.control --workload <cell> --seconds <s> \
        --seeds <n>,<n>,... [--control bfloat16]

One JSON line per seed on standard output.  The benchmark's runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import types


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="bfloat16")
    a = ap.parse_args(argv)
    from port_bench import run as R
    R.caches(R.ROOT)
    import torch
    from port_bench import cell as C
    man = C.manifest(R.ROOT)
    entry, cfg, traffic, limits = C.find(man, a.workload)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in a.seeds.split(",")):
        args = types.SimpleNamespace(workload=a.workload, seed=seed,
                                     seconds=a.seconds, trace=0)
        with tempfile.TemporaryDirectory(prefix="port_bench_") as work:
            result, _, _ = R.run(
                args, man, entry, cfg, traffic, limits, work,
                [torch.device("cuda", i) for i in range(entry["chips"])],
                control=getattr(torch, a.control))
        print(json.dumps({"seed": seed, "program": {
            k: v["value"] for k, v in result["checks"].items()},
            "control": result["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
