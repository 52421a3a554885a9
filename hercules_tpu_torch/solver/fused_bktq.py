"""General-Q BKT attenuation on one brick: the node tier (K3, the mixed
elements included), the corner tier (K4), and the choice between them
and the uniform tier (``fused_bkt.py``).

Counterpart of the general-Q host side of
``hercules_tpu/solver/pallas_brick.py``; the JAX names are kept
(``BKN_COEF``, ``bkn_coef_keys``, ``assign_bkt_node_coeffs``,
``bkt_nodeq_tables``).  The JAX package's mixed-element epilogue
(``bkt_mix_epilogue``) has no counterpart here: K3 forms the mixed
elements' force itself (``kernels/bkt_node_step.py``).

A real velocity model's Qs(Vs) fit gives one BKT coefficient set per
QTABLE bin, so a layered brick carries several.  The tiers, tried in
this order (``PallasBrickTables``, pallas_brick.py:2688-2720):

1. uniform: one set (``fused_bkt.BktStep``, K2/K6).
2. node: memory variables per node, as the uniform tier keeps them.
   Every node takes the set of one adjacent element (the last corner
   writer), so the elements whose 8 corners all carry their own set are
   exact; the "mixed" ones -- one element plane per interface in a
   layered model -- carry their own corner-basis state conv_mix [R, 8, M]
   and K3 forms their force from it (the direct form of the JAX
   package's epilogue, FM (mu_f (dvs_e - dvs_n)) and the kappa term
   added to the node-basis force).  Declined when the
   true mixed set exceeds NODEQ_MAX_MIXED of the valid elements, there
   are more than NODEQ_MAX_SETS sets, or an uncoalesced mixed set
   exceeds NODEQ_MAX_MIXED_ABS elements.
3. corner: memory variables per (element, corner), conv [48 | 96, LEN]
   (K4); holds any brick.

Layout (column n = node n, as in ``fused_brick.py``):

- node tier: K [8, LEN] = mass_minusaM x 3, inv_mass, mu_f, kappa_f
  (at the element columns), set index (a float; nsets for a node with no
  adjacent element), 0 -- pallas_brick.py:2103-2108.  conv [6 | 12,
  LEN] as the uniform tier's; the set index is not copied into a conv
  row as the JAX package does (its conv has padding rows to spare).
  tab: fm [24, 48] = [Kmu | Kkappa] and the sets (kernels/bkt_node_step).
- corner tier: K [8, LEN] = mass_minusaM x 3, inv_mass, then at the
  element columns mu_f, kappa_f, the shear set index and the kappa set
  index (floats); tab (kernels/bkt_corner_step.corner_tab): fm [24, 48]
  = [Kmu | Kkappa] and each channel's distinct coefficient rows.  The
  JAX package keeps the element rows themselves (bk [11 | 20, LEN],
  ``bk_row_names``): ``corner_rows`` gives them back.  conv [48 | 96,
  LEN], row 24 v + 3 j + c, bfloat16 in every float32 run (shear-only
  too, as the JAX corner tier stores it) and float64 in float64 runs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..physics.kmats import bkt_matrices_24

from ..kernels.bkt_corner_step import bkt_corner_step, corner_tab
from ..kernels.bkt_node_step import bkt_node_step, node_mix, node_tab
from .fused_bkt import (bk_row_names, bkt_conv_dtype, bkt_kappa_zero,
                        pack_bkt_constants, uniform_step_module)

BKT_TIERS = ("uniform", "node", "corner")

# the node tier's decline rule at the JAX package's defaults
# (pallas_brick.py:2045-2053 and :2093-2097), so that both packages take
# the same tier on the same mesh: the share of valid elements in the
# true mixed set, the number of coefficient sets (len(QTABLE); also the
# size of K3's table), and the size of a mixed set that does not
# coalesce into runs (a bound the JAX package sets for its scattered
# epilogue)
NODEQ_MAX_MIXED = 0.25
NODEQ_MAX_SETS = 18
NODEQ_MAX_MIXED_ABS = 8192
# run coalescing of the mixed set (pallas_brick.py:2069-2070): gaps of
# up to MIX_GAP columns are bridged, at most MIX_MAX_RUNS runs
MIX_GAP = 512
MIX_MAX_RUNS = 64

# per-channel recursion/combine coefficient row order of the node table
BKN_COEF = ("c1", "c2", "c3", "c4", "e0", "e1", "a0", "a1", "coef")


def bkn_coef_keys(shear_only: bool):
    """bkt-table keys of the per-element recursion rows, channel-major
    in BKN_COEF order (mu_f/kappa_f live in the K rows instead)."""
    def chan(name):
        return [f"{name}_c1", f"{name}_c2", f"{name}_c3", f"{name}_c4",
                f"{name}_e0", f"{name}_e1", f"a0_{name}", f"a1_{name}",
                f"{name}_coef"]
    return chan("shear") + ([] if shear_only else chan("kappa"))


def _unique_rows(rows):
    """np.unique(rows, axis=0, return_inverse=True) for [n, k] float rows
    of which few are distinct.  np.unique sorts the n rows as records
    (seconds at 2^20 rows); here the rows are grouped by a float key
    (rows @ w, the same for equal rows), the grouping is checked against
    the rows themselves, and only the distinct rows are sorted.  Falls
    back to np.unique if two different rows share a key."""
    w = np.random.default_rng(0).uniform(1.0, 2.0, rows.shape[1])
    _, first, inv = np.unique(rows @ w, return_index=True,
                              return_inverse=True)
    reps = rows[first]
    if not np.array_equal(reps[inv], rows):
        sets, inv = np.unique(rows, axis=0, return_inverse=True)
        return sets, inv.ravel()
    sets, order = np.unique(reps, axis=0, return_inverse=True)
    return sets, order.ravel()[inv]


def assign_bkt_node_coeffs(coef_e, evalid, offs):
    """Node coefficient assignment of the node tier.

    coef_e: [RC, LEN] per-element recursion rows (zero at invalid
    columns).  Every node column gets the rows of one adjacent valid
    element (the last corner writer in ascending-j order -- on the
    z-major brick layout the element ABOVE an interface, so exactly one
    element plane per interface ends up mixed).  Returns (node_rows
    [RC, LEN], node_src [LEN] int64 source element column or -1,
    mixed_cols [M] element columns whose corners carry a foreign set,
    sets [nsets, RC] distinct coefficient sets, node_bin [LEN] set index
    per node with nsets = "no adjacent element")."""
    LEN = coef_e.shape[1]
    ecols = np.flatnonzero(np.asarray(evalid))
    node_src = np.full(LEN, -1, np.int64)
    for o in offs:
        node_src[ecols + o] = ecols
    # coefficient-set ids (identical values from different elements
    # dedupe, so a Q-uniform region never counts as mixed)
    sets, cid_e = _unique_rows(coef_e[:, ecols].T)
    cid = np.full(LEN, -1, np.int64)
    cid[ecols] = cid_e
    ns = np.maximum(node_src, 0)
    node_rows = np.where(node_src >= 0, coef_e[:, ns], 0.0)
    node_cid = np.where(node_src >= 0, cid[ns], -1)
    mixed = np.zeros(len(ecols), bool)
    for o in offs:
        mixed |= node_cid[ecols + o] != cid[ecols]
    node_bin = np.where(node_cid >= 0, node_cid, len(sets))
    return node_rows, node_src, ecols[mixed], sets, node_bin


def _coalesce(mixed):
    """(dense mixed columns, runs [(column, carry offset, length)]) when
    the mixed set coalesces into a few dense runs, else (mixed, None)
    (pallas_brick.py:2066-2092).  Bridged columns need no masking:
    invalid columns carry zero coefficients, and a valid un-mixed
    element's carried state recurses exactly as its corners' node
    recursion does, so its correction is identically zero."""
    brk = np.flatnonzero(np.diff(mixed) > MIX_GAP)
    rstarts = np.concatenate([[0], brk + 1])
    rends = np.concatenate([brk + 1, [len(mixed)]])
    spans = [(int(mixed[s]), int(mixed[e - 1]) + 1)
             for s, e in zip(rstarts, rends)]
    width = sum(e - s for s, e in spans)
    if len(spans) > MIX_MAX_RUNS or width > 2 * len(mixed) + 64 * len(spans):
        return mixed, None
    runs, q = [], 0
    for s, e in spans:
        runs.append((s, q, e - s))
        q += e - s
    return np.concatenate([np.arange(s, e) for s, e in spans]), runs


def bkt_nodeq_tables(coef_e, muf, kaf, mm, invm, evalid, offs, shear_only,
                     force=False):
    """Host tables of the node tier (float64 / int64 numpy) from padded
    per-element arrays: coef_e [RC, LEN] (bkn_coef_keys order), muf, kaf,
    invm [LEN], mm [3, LEN], evalid [LEN] bool.

    Returns a dict with the node assignment (always: node_src,
    mixed_cols -- the dense coalesced set when it coalesces -- M, sets,
    node_bin), "declined", and when accepted "mix_runs", K [8, LEN] and
    the JAX package's mixed-element epilogue tables mix_idx [8, M],
    mix_ce [RC, 1, M], mix_cn [RC, 8, M], mix_invm [8, M], mix_muf,
    mix_kaf [M], mix_fm [24, 24 | 48] (K3 takes mixed_cols and mix_ce;
    the tests hold the rest against the JAX package's).  ``force`` lifts the mixed-share and scattered-size
    rules (not the set count, which K3's table bounds)."""
    LEN = coef_e.shape[1]
    node_rows, node_src, mixed, sets, node_bin = \
        assign_bkt_node_coeffs(coef_e, evalid, offs)
    out = {"node_src": node_src, "sets": sets,
           "node_bin": node_bin.astype(np.float64), "declined": True}
    n_valid = max(int(np.asarray(evalid).sum()), 1)
    n_mixed_true = len(mixed)
    mix_runs = None
    if len(mixed):
        mixed, mix_runs = _coalesce(mixed)
    out["mixed_cols"] = mixed
    out["M"] = M = len(mixed)
    if len(sets) > NODEQ_MAX_SETS or not force and (
            n_mixed_true > NODEQ_MAX_MIXED * n_valid
            or (mix_runs is None and M > NODEQ_MAX_MIXED_ABS)):
        return out
    out["declined"] = False
    out["mix_runs"] = mix_runs
    K = np.zeros((8, LEN))
    K[0:3] = mm
    K[3] = invm
    K[4] = muf
    K[5] = kaf
    K[6] = out["node_bin"]
    out["K"] = K
    if M:
        idx24 = np.asarray(offs, np.int64)[:, None] + mixed[None, :]
        out["mix_idx"] = idx24                            # [8, M]
        out["mix_ce"] = coef_e[:, mixed][:, None, :]      # [RC, 1, M]
        out["mix_cn"] = node_rows[:, idx24]               # [RC, 8, M]
        out["mix_invm"] = invm[idx24]                     # [8, M]
        out["mix_muf"] = muf[mixed]                       # [M]
        out["mix_kaf"] = kaf[mixed]
        kmu, kk = bkt_matrices_24()
        out["mix_fm"] = kmu if shear_only else np.concatenate([kmu, kk], 1)
    return out


class BktNodeStep(nn.Module):
    """The brick's node-tier step operator: buffers K [8, LEN] and tab
    (kernels/bkt_node_step.node_tab); ``mix`` the mixed-element tables
    (kernels/bkt_node_step.node_mix), None without mixed elements."""

    tier = "node"

    def __init__(self, K, offs, tab, shear_only, mix):
        super().__init__()
        self.offs = tuple(int(o) for o in offs)
        self.register_buffer("K", K)
        self.register_buffer("tab", tab)
        self.shear_only = shear_only
        self.conv_rows = 6 if shear_only else 12
        self.conv_dtype = bkt_conv_dtype(K.dtype, shear_only)
        self.mix = mix
        self.mix_M = 0 if mix is None else int(mix["cols"].shape[0])

    def state_parts(self, LEN):
        """(shape, dtype) of the state after S: conv [R, LEN] and, with
        mixed elements, conv_mix [R, 8, M] in the same storage type."""
        parts = [((self.conv_rows, LEN), self.conv_dtype)]
        if self.mix_M:
            parts.append(((self.conv_rows, 8, self.mix_M), self.conv_dtype))
        return parts

    def forward(self, S, conv, conv_mix=None, out=None, conv_out=None,
                conv_mix_out=None):
        """One step (K3, the mixed elements included): (S', conv'[,
        conv_mix'])."""
        return bkt_node_step(S, conv, self.K, self.offs, self.tab,
                             mix=self.mix, conv_mix=conv_mix, out=out,
                             conv_out=conv_out, conv_mix_out=conv_mix_out)


class BktCornerStep(nn.Module):
    """The brick's corner-tier step operator: buffers K [8, LEN] and tab
    (kernels/bkt_corner_step.corner_tab)."""

    tier = "corner"

    def __init__(self, K, tab, offs, shear_only):
        super().__init__()
        self.offs = tuple(int(o) for o in offs)
        self.register_buffer("K", K)
        self.register_buffer("tab", tab)
        self.shear_only = shear_only
        self.conv_rows = 48 if shear_only else 96
        # bkt_conv_dtype without the shear-only clause: the JAX corner
        # tier stores bfloat16 in every float32 run (pallas_brick.py:2695)
        self.conv_dtype = bkt_conv_dtype(K.dtype)

    def state_parts(self, LEN):
        return [((self.conv_rows, LEN), self.conv_dtype)]

    def forward(self, S, conv, out=None, conv_out=None):
        """One step (K4): (S', conv')."""
        return bkt_corner_step(S, conv, self.K, self.offs, self.tab,
                               out=out, conv_out=conv_out)


def _element_rows(plan, tables, keys, LEN):
    """Per-element BKT rows [len(keys), LEN] at the element columns
    (zero at invalid and padding columns), float64."""
    out = np.zeros((len(keys), LEN))
    n = len(plan.eidx_cat)
    for r, k in enumerate(keys):
        out[r, :n] = np.where(plan.evalid_cat,
                              np.asarray(tables.bkt[k])[plan.eidx_cat], 0.0)
    return out


def bkt_fm():
    """[Kmu | Kkappa], [24, 48] float64."""
    return np.concatenate(bkt_matrices_24(), axis=1)


def nodeq_inputs(plan, tables, LEN):
    """The padded per-element arguments (coef_e, muf, kaf, mm, invm,
    evalid) of bkt_nodeq_tables for a brick."""
    K = pack_bkt_constants(plan, tables, LEN)
    keys = bkn_coef_keys(bkt_kappa_zero(tables.bkt))
    coef_e = _element_rows(plan, tables, keys, LEN)
    muf, kaf = _element_rows(plan, tables, ("mu_f", "kappa_f"), LEN)
    return coef_e, muf, kaf, K[0:3], K[3], K[4] != 0


def node_tables(plan, tables, LEN, offs, force=False):
    """bkt_nodeq_tables of a brick (see there)."""
    return bkt_nodeq_tables(*nodeq_inputs(plan, tables, LEN), offs,
                            bkt_kappa_zero(tables.bkt), force=force)


def node_step_module(nq, offs, shear_only, dtype, device):
    """The BktNodeStep of accepted node tables ``nq``: the mixed set
    (mixed_cols, coalesced or not) and its recursion rows mix_ce."""
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    mix = None
    if nq["M"]:
        mix = node_mix(nq["mixed_cols"], nq["mix_ce"][:, 0, :],
                       nq["K"].shape[1], dtype, device)
    tab = node_tab(as_t(bkt_fm()), as_t(nq["sets"]))
    return BktNodeStep(as_t(nq["K"]), offs, tab, shear_only, mix)


def corner_tables(plan, tables, LEN):
    """(K [8, LEN], shear sets [ns, 9], kappa sets [nk, 9] or None when
    shear-only) of the corner tier, float64 numpy: each channel's
    distinct coefficient rows over all columns (the zero row of the
    padding and invalid elements among them) and every element column's
    index into them."""
    shear_only = bkt_kappa_zero(tables.bkt)
    K = pack_bkt_constants(plan, tables, LEN)
    rows = _element_rows(plan, tables, bk_row_names(shear_only), LEN)
    K[4:6] = rows[-2:]
    sets = []
    for ch in range(1 if shear_only else 2):
        s_, inv = _unique_rows(rows[9 * ch:9 * ch + 9].T)
        K[6 + ch] = inv
        sets.append(s_)
    return K, sets[0], None if shear_only else sets[1]


def corner_step_module(plan, tables, LEN, offs, dtype, device):
    """(BktCornerStep, K) of any BKT brick."""
    K, shear_sets, kappa_sets = corner_tables(plan, tables, LEN)
    as_t = lambda x: None if x is None else torch.as_tensor(
        x, dtype=dtype, device=device)
    tab = corner_tab(as_t(bkt_fm()), as_t(shear_sets), as_t(kappa_sets))
    return BktCornerStep(as_t(K), tab, offs, kappa_sets is None), K


def bkt_step_module(plan, tables, LEN, offs, dtype, device, tier=None):
    """(step module, K float64 numpy) of a BKT brick.  tier None picks
    the first that holds the brick: uniform (one coefficient set), node
    (unless bkt_nodeq_tables declines), corner.  A tier named in
    ``tier`` is taken, or ValueError raised if it cannot hold the brick
    (uniform: more than one set; node: more than NODEQ_MAX_SETS sets);
    a forced node tier ignores the mixed-share and size rules.

    The module also keeps what a restart's basis conversions read
    (``solver/restart.py``): ``evalid`` [LEN] bool, and ``node_src``
    and ``mixed_cols``, the node assignment, where the node tables were
    built (the node tier, and the corner tier the rule fell back to);
    None elsewhere."""
    if tier not in (None, *BKT_TIERS):
        raise ValueError(f"bkt_tier must be one of {BKT_TIERS}, got {tier!r}")
    mod = nq = None
    if tier in (None, "uniform"):
        mod = uniform_step_module(plan, tables, LEN, offs, dtype, device)
        if mod is None and tier == "uniform":
            raise ValueError("bkt_tier='uniform': the brick has more than "
                             "one BKT coefficient set")
    if mod is None and tier in (None, "node"):
        nq = node_tables(plan, tables, LEN, offs, force=tier == "node")
        if not nq["declined"]:
            mod = (node_step_module(nq, offs, bkt_kappa_zero(tables.bkt),
                                    dtype, device), nq["K"])
        elif tier == "node":
            raise ValueError(f"bkt_tier='node': {len(nq['sets'])} "
                             f"coefficient sets (at most {NODEQ_MAX_SETS})")
    if mod is None:
        mod = corner_step_module(plan, tables, LEN, offs, dtype, device)
    step = mod[0]
    step.evalid = np.zeros(LEN, bool)
    step.evalid[:len(plan.evalid_cat)] = plan.evalid_cat
    step.node_src = None if nq is None else nq["node_src"]
    step.mixed_cols = None if nq is None else nq["mixed_cols"]
    return mod
