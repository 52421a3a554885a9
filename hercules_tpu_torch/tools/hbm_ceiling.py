"""Device-memory streaming ceiling of the CUDA card, at the solver's
state shape.

The port's counterpart of ``hercules_tpu/tools/hbm_ceiling.py``.  The
solver's kernels stream their state through device memory, so the rate
a plain streaming pass reaches is the yardstick of their bandwidth.
This probe measures it with the JAX tool's dataflow and sizes: an
[8, LEN] float32 state S and a constant C of the same shape, LEN = 33 x
32768 columns, and S' = S + C repeated 50 times per run:

  1. torch.add(S, C, out=S): PyTorch's own elementwise kernel (the
     counterpart of the JAX tool's scan-carried add; the library call
     beside K7)
  2. stream_add (K7, csrc/stream_add.cu) out of place, two buffers in
     turn
  3. stream_add aliased: out is S (the counterpart of
     input_output_aliases={0: 0})
  4. torch.add again, so that the library call's two legs bracket K7's
     (the legs run in turns in one process: torch.add, K7, K7 aliased,
     torch.add)

Each iteration moves 2 reads + 1 write of the array; GB/s = those bytes
/ time.  Each run is timed with CUDA events after a warm-up run, best of
3.  Every leg prints beside the card's name and power limit.

Each array is 34.6 MB and the H100 has 50 MB of L2 cache.  C is read
unchanged every iteration, so part of the stream can be served from L2
and a leg can read above the published 3.35 TB/s; such a reading is
flagged: it is an L2 effect at this size, not a ceiling.

Usage: python -m hercules_tpu_torch.tools.hbm_ceiling   (needs a CUDA
device; exits non-zero without one)
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.stream_add import stream_add
from ..utils.roofline import PEAK_BYTES_PER_S, card

B = 32768
T = 33
LEN = T * B
N = 50
BYTES_PER_ITERATION = 3 * 8 * LEN * 4      # 2 reads + 1 write


def _best(fn, n=3):
    """Best seconds of fn() over n runs, each timed with CUDA events."""
    best = np.inf
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) * 1e-3)
    return best


def main():
    """Run the four legs; returns {"card", "bytes_per_iteration",
    "iterations", "legs": {label: {"ms_per_iteration", "GBps",
    "above_peak"}}}."""
    if not torch.cuda.is_available():
        raise SystemExit("hbm_ceiling: no CUDA device is available; the "
                         "probe measures the card and has no CPU form")
    dev = torch.device("cuda", torch.cuda.current_device())
    name = card()
    S = torch.ones((8, LEN), dtype=torch.float32, device=dev)
    S2 = torch.empty_like(S)
    C = torch.ones_like(S)

    def torch_add():
        for _ in range(N):
            torch.add(S, C, out=S)

    def out_of_place():
        x, y = S, S2
        for _ in range(N):
            stream_add(x, C, out=y)
            x, y = y, x

    def aliased():
        for _ in range(N):
            stream_add(S, C, out=S)

    legs = {}
    for label, fn in (("torch.add", torch_add),
                      ("stream_add", out_of_place),
                      ("stream_add aliased", aliased),
                      ("torch.add again", torch_add)):
        fn()
        torch.cuda.synchronize()
        dt = _best(fn)
        gbs = BYTES_PER_ITERATION * N / dt / 1e9
        above = gbs * 1e9 > PEAK_BYTES_PER_S
        legs[label] = {"ms_per_iteration": dt / N * 1e3, "GBps": gbs,
                       "above_peak": above}
        print(f"[{label:18s}] {dt / N * 1e3:.4f} ms/it  {gbs:.0f} GB/s  "
              f"({name})"
              + ("  above the 3350 GB/s peak: served in part from L2"
                 if above else ""), flush=True)
    return {"card": name, "bytes_per_iteration": BYTES_PER_ITERATION,
            "iterations": N, "legs": legs}


if __name__ == "__main__":
    main()
