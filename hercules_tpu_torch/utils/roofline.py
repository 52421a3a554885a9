"""Roofline of the port's kernels: bytes and operations per step,
counted from the shapes, and the least time an H100 could take for them.

The port's counterpart of the roofline section of the JAX bench
(``bench.py:751-817``), which divides each route's HBM bytes per step
by the measured streaming ceiling (``tools/hbm_ceiling.py``).  Here
every kernel K1-K7 gets two byte counts and one operation count per
step:

- ``bytes``: what the function must move -- each input row that holds
  data read once, each output row that holds data written once (the
  zero padding rows S[6:8] and K's unused rows are not counted, nor the
  operator constants of a few kB).  The bound uses this count.
- ``moved``: what the port's kernel itself streams per step, with its
  passes' intermediates (K2's and K3's dv, K4's element force F) and
  the state and constants it reads again every step.  Achieved
  bandwidth uses this count.
- ``flop``: the algebra each element and node needs, counted once, in
  the spectral form the TPU kernels use (``physics/kmats.py``: 8-point
  Hadamard butterflies around a multiply-add per nonzero of the sparse
  spectral factors, about 330-430 operations per element instead of a
  dense [24, 48] product's 2,304), not the kernels' repeated per-node
  work.

The chunk kernels (K5, K6) take ``chunk`` steps in one launch and read
their state and constants once per launch, so their ``bytes`` is the
step kernel's divided by ``chunk``; their ``flop`` and ``moved`` are
per step.  Their sources and samples (at most 128 columns each) are
left out.

The bound is max(bytes / 3.35 TB/s, flop / peak), the peak being the
H100 SXM data sheet's non-tensor rate for the arithmetic type (67
TFLOP/s float32, 34 TFLOP/s float64) at its 700 W power limit;
``bound_by`` says which term sets it.
"""

from __future__ import annotations

import functools
import subprocess
from dataclasses import dataclass

import torch

from ..physics.kmats import spectral_bkt_factors, spectral_factors

# H100 SXM data sheet (700 W): HBM3 rate, non-tensor arithmetic rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# one 8-point Hadamard over the corners of a 24-vector: 3 butterfly
# stages of 8 adds or subtractions, for each of 3 components
BUTTERFLY_FLOP = 3 * 8 * 3
# per node: u+ = u + (force + mm (u - u-)) inv_mass, 3 components
UPDATE_FLOP = 3 * 5
# per node component and memory-variable pair: s0', s1' (5 each), dv (6)
PAIR_FLOP = 16


@functools.cache
def element_flop(bkt: bool) -> int:
    """Operations of one element's force in the spectral form: the
    forward Hadamard of each input field (the elastic W; BKT's dvs and
    dvk), a multiply-add per nonzero of the two sparse factors (M1, M2
    or KMU, KKAPPA), the inverse Hadamard, the 48 products that scale
    the two operators' inputs (c1, c2) or outputs (mu_f, kappa_f) and
    the 24 scatter adds: 330 elastic, 426 BKT."""
    factors = spectral_bkt_factors() if bkt else spectral_factors()
    fields = 2 if bkt else 1
    return ((fields + 1) * BUTTERFLY_FLOP
            + 2 * sum(len(f) for f in factors) + 48 + 24)


@dataclass(frozen=True)
class KernelCost:
    """One kernel's bytes and operations per step (module docstring)."""

    name: str
    bytes: float
    moved: float
    flop: float
    dtype: torch.dtype = torch.float32

    @property
    def bound_ms(self) -> float:
        """The least time the card could take, in ms per step."""
        return 1e3 * max(self.bytes / PEAK_BYTES_PER_S,
                         self.flop / PEAK_FLOP_PER_S[self.dtype])

    @property
    def bound_by(self) -> str:
        """"bytes" or "operations": the term that sets the bound."""
        return ("bytes" if self.bytes / PEAK_BYTES_PER_S
                >= self.flop / PEAK_FLOP_PER_S[self.dtype] else "operations")


def kernel_cost(name, LEN, elements, dtype=torch.float32, conv_rows=0,
                conv_dtype=None, bk_rows=0, chunk=1) -> KernelCost:
    """Cost per step of kernel ``name`` (a wrapper's name: brick_step,
    brick_chunk, bkt_step, bkt_chunk, bkt_node_step, bkt_corner_step,
    stream_add) on [*, LEN] arrays in ``dtype`` with ``elements`` mesh
    elements; BKT kernels take their memory variables' rows and storage
    type (``conv_rows``, ``conv_dtype``), K4 its coefficient rows
    (``bk_rows``), the chunk kernels the steps per launch (``chunk``)."""
    w = torch.empty((), dtype=dtype).element_size()
    L, E = int(LEN), int(elements)
    if name == "stream_add":
        nbytes = 3 * 8 * L * 4          # a and b read, out written
        return KernelCost(name, nbytes, nbytes, 8 * L, torch.float32)
    c = torch.empty((), dtype=conv_dtype or dtype).element_size()
    conv = 2 * conv_rows * L * c        # memory variables in and out
    # memory-variable pairs: 1 shear-only, 2 with kappa (6 | 12 rows per
    # node, or 48 | 96 per element in K4's corner basis)
    pairs = conv_rows // (48 if name == "bkt_corner_step" else 6)
    D = 3 * pairs                       # rows of dv (K2, K3)
    rec = L * 3 * (1 + PAIR_FLOP * pairs)   # du once, then the pairs
    el, bkt = element_flop(False), element_flop(True)
    step = {
        # S (u, u-) 6 rows in, K 7 rows in, S' 6 rows out; the kernel
        # streams S 8 rows in and out and K 7 rows; W = u + beta (u - u-)
        # at the 8 corners
        "brick_step": (19 * L * w, 23 * L * w,
                       E * (el + 24 * 3) + L * UPDATE_FLOP),
        # S 6, K 5 (mm, inv_mass, element valid), S' 6; pass 1 reads S
        # 6 rows and writes dv, pass 2 reads S 8, K 5, dv, writes S' 8
        "bkt_step": (17 * L * w + conv, (27 + 2 * D) * L * w + conv,
                     E * bkt + rec + L * UPDATE_FLOP),
        # S 6, K 7 (mm, inv_mass, mu_f, kappa_f, set index), S' 6; pass
        # 1 reads S 6, the set index, writes dv; pass 2 reads S 8, K 6,
        # dv, writes S' 8
        "bkt_node_step": (19 * L * w + conv, (29 + 2 * D) * L * w + conv,
                          E * (bkt + 24) + rec
                          + L * UPDATE_FLOP),
        # S 6, K 4, bk rows, S' 6; pass 1 reads S 6, bk, writes F 24
        # rows; pass 2 reads F, S 8, K 4, writes S' 8; the recursion
        # runs on each element's 8 corners (24 rows per pair) after
        # forming du and u- there (48)
        "bkt_corner_step": ((16 + bk_rows) * L * w + conv,
                            (74 + bk_rows) * L * w + conv,
                            E * (bkt + 48 + 24 * PAIR_FLOP * pairs)
                            + L * UPDATE_FLOP),
    }
    chunked = {"brick_chunk": "brick_step", "bkt_chunk": "bkt_step"}
    if name in chunked:
        nbytes, moved, flop = step[chunked[name]]
        return KernelCost(name, nbytes / chunk, moved, flop, dtype)
    if name not in step:
        raise ValueError(f"no cost model for kernel {name!r}")
    return KernelCost(name, *step[name], dtype)


def route_costs(pt, elements, chunk=1) -> dict:
    """{name: KernelCost} of the kernels that run the routes of a
    ``PallasBrickTables``: its step kernel, and its chunk kernel (per
    step, at ``chunk`` steps per launch) where the tier has one."""
    step = pt.step
    kw = dict(LEN=pt.LEN, elements=elements, dtype=pt.dtype)
    if pt.bkt_tier is None:
        names = ("brick_step", "brick_chunk")
    else:
        kw.update(conv_rows=step.conv_rows, conv_dtype=step.conv_dtype)
        names = {"uniform": ("bkt_step", "bkt_chunk"),
                 "node": ("bkt_node_step",),
                 "corner": ("bkt_corner_step",)}[pt.bkt_tier]
        if pt.bkt_tier == "corner":
            kw["bk_rows"] = step.bk.shape[0]
    return {n: kernel_cost(n, chunk=chunk, **kw) for n in names}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W")."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
