"""Uniform-Q BKT attenuation on one brick: the host tables, the step
operator and its node-basis memory variables.

Counterpart of the uniform-Q tier of
``hercules_tpu/solver/pallas_brick.py`` (``_make_bkt_uniform_kernel``
and its host side); the JAX names are kept (``BK_ROWS``,
``bk_row_names``, ``bkt_kappa_zero``, ``bkt_conv_dtype``,
``detect_bkt_uniform``).

BKT (constant-Q viscoelasticity, the reference's ``damping.c``) keeps
memory variables that a recursion drives from the node displacement.
When every valid element shares one coefficient set, the variable of
(element, corner) depends only on the corner's node, so the state is a
node field: conv [6, LEN] (s0, s1 x 3 components) when the bulk (kappa)
attenuation is off, [12, LEN] (s0, s1, k0, k1) when it is on.  The
port's conv has no padding rows (the JAX package pads to 8 or 16).

Layout (column n = node n of the brick, as in ``fused_brick.py``):

- S [8, LEN]: u, u-, 0, 0.
- K [8, LEN]: rows 0:3 = mass_minusaM, 3 = inv_mass, 4 = element
  valid (1.0 for the element whose lowest corner is column n), 5:8 = 0.
- scales = (mu_f, kappa_f) in float64, the operator's one source: the
  plain version's element force is fm @ [dvs at the 8 corners; dvk at
  the 8 corners] with fm = [mu_f Kmu | kappa_f Kkappa] [24, 48]
  (``kernels.bkt_step.bkt_operator``: folded in float64, then cast);
  the kernels take the scales rounded to the working type and the
  operators in their spectral form.
- rec: the 9 shear recursion scalars (c1 c2 c3 c4 e0 e1 a0 a1 coef),
  then the 9 kappa ones when kappa is active, in the working type.

A brick with more than one coefficient set takes the node or the
corner tier (``fused_bktq.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels.bkt_chunk import bkt_chunk
from ..kernels.bkt_step import bkt_operator, bkt_step

# row order of the BKT coefficient table (pallas_brick.py:52-56)
BK_ROWS = ("shear_c1", "shear_c2", "shear_c3", "shear_c4",
           "shear_e0", "shear_e1", "a0_shear", "a1_shear", "shear_coef",
           "kappa_c1", "kappa_c2", "kappa_c3", "kappa_c4",
           "kappa_e0", "kappa_e1", "a0_kappa", "a1_kappa", "kappa_coef",
           "mu_f", "kappa_f")
# shear-only runs never read the 9 kappa recursion rows
BK_ROWS_SHEAR = BK_ROWS[:9] + BK_ROWS[18:]


def bk_row_names(shear_only: bool):
    return BK_ROWS_SHEAR if shear_only else BK_ROWS


def bkt_kappa_zero(bkt) -> bool:
    """True when the bulk (kappa) attenuation is off: the kappa memory
    variables are multiplied by zero everywhere, so dv_kappa == u and
    the state drops them."""
    return (not np.asarray(bkt["a0_kappa"]).any()
            and not np.asarray(bkt["a1_kappa"]).any()
            and not np.asarray(bkt["kappa_coef"]).any())


def bkt_conv_dtype(dtype, shear_only=False):
    """Storage type of the node memory variables: bfloat16 for float32
    runs with kappa active (they enter the force only through a0/a1 ~
    0.01 weights), else the working type."""
    if dtype == torch.float32 and not shear_only:
        return torch.bfloat16
    return dtype


def detect_bkt_uniform(bkt_tables, eidx, evalid, shear_only):
    """One coefficient set across the valid elements -> {row name:
    float}, else None (also None when no element is valid)."""
    if not np.any(evalid):
        return None
    scal = {}
    for k in bk_row_names(shear_only):
        v = np.asarray(bkt_tables[k])[eidx][evalid]
        if v.size and np.all(v == v[0]):
            scal[k] = float(v[0])
        else:
            return None
    return scal


def recursion_scalars(scal, shear_only):
    """The 9 (shear-only) or 18 recursion scalars in BK_ROWS order."""
    return tuple(scal[k] for k in bk_row_names(shear_only)[:-2])


def pack_bkt_constants(plan, tables, LEN):
    """K [8, LEN] in float64 (see the module docstring)."""
    g = plan.gnid_cat
    nb = len(g)
    K = np.zeros((8, LEN))
    K[0:3, :nb] = tables.mass_minusaM[g].T
    K[3, :nb] = tables.inv_mass[g]
    K[4, :len(plan.evalid_cat)] = plan.evalid_cat
    return K


class BktStep(nn.Module):
    """The brick's uniform-Q BKT step operator: buffer K [8, LEN];
    ``scales`` (mu_f, kappa_f) in float64 and ``rec`` the recursion
    scalars rounded to the working type; conv rows and storage type
    fixed by ``shear_only``."""

    tier = "uniform"

    def __init__(self, K, offs, scales, rec, shear_only):
        super().__init__()
        self.offs = tuple(int(o) for o in offs)
        self.register_buffer("K", K)
        np_dt = np.float32 if K.dtype == torch.float32 else np.float64
        self.scales = tuple(float(v) for v in scales)
        self.rec = tuple(float(np_dt(v)) for v in rec)
        self.shear_only = shear_only
        self.conv_rows = 6 if shear_only else 12
        self.conv_dtype = bkt_conv_dtype(K.dtype, shear_only)

    @property
    def fm(self):
        """The plain version's [24, 48] operator in the working type."""
        return bkt_operator(self.scales, self.K.dtype, self.K.device)

    def state_parts(self, LEN):
        """(shape, dtype) of the state after S: conv [R, LEN]."""
        return [((self.conv_rows, LEN), self.conv_dtype)]

    def forward(self, S, conv, out=None, conv_out=None):
        """One step (K2): (S', conv')."""
        return bkt_step(S, conv, self.K, self.offs, self.scales, self.rec,
                        out=out, conv_out=conv_out)

    def chunk(self, S, conv, srcf, src_pos=None, st_pos=None,
              st_phi=None):
        """srcf.shape[0] steps in one launch (K6); see bkt_chunk.
        Returns (S', conv', samples)."""
        return bkt_chunk(S, torch.empty_like(S), conv,
                         torch.empty_like(conv), self.K, self.offs,
                         self.scales, self.rec, srcf, src_pos, st_pos,
                         st_phi)


def uniform_step_module(plan, tables, LEN, offs, dtype, device):
    """(BktStep, K) of a uniform-Q BKT brick, or None when the brick has
    more than one coefficient set."""
    shear_only = bkt_kappa_zero(tables.bkt)
    scal = detect_bkt_uniform(tables.bkt, plan.eidx_cat, plan.evalid_cat,
                              shear_only)
    if scal is None:
        return None
    K = pack_bkt_constants(plan, tables, LEN)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return BktStep(as_t(K), offs, (scal["mu_f"], scal["kappa_f"]),
                   recursion_scalars(scal, shear_only), shear_only), K
