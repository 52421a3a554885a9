"""K3: one step of a general-Q BKT brick (node-basis memory variables,
one coefficient set per node), the mixed elements' force included.

``bkt_node_step`` launches the CUDA kernel of ``csrc/bkt_node.cu`` on
CUDA tensors and runs ``bkt_node_step_plain``, the same step in plain
PyTorch, on CPU tensors.  It counts its launches in
``bkt_node_step.launches`` (one per step).

Layout (see ``solver/fused_bktq.py``): S [8, LEN] = (u, u-, 0, 0),
conv [6 | 12, LEN] = (s0, s1[, k0, k1]) x 3 components in the storage
type, K [8, LEN] = (mass_minusaM x 3, inv_mass, mu_f, kappa_f, set index,
0), tab = ``node_tab(fm, sets)``: fm [24, 48] = [Kmu | Kkappa] and the
coefficient sets [MAX_SETS + 1, 18], flattened into one tensor.

The mixed elements (those whose corners carry a foreign set) are given
by ``mix = node_mix(...)``: "cols" [M] their element columns, "slot"
[LEN] int32 (m at column cols[m], else -1), "ce" [9 | 18, M] their own
recursion rows; their corner-basis state is conv_mix [R, 8, M] (row r,
corner i, slot m).  For them the step runs the recursion on conv_mix
with their own rows and forms the force from those damping vectors (the
direct form); in exact arithmetic that is the JAX package's node-basis
force plus its mixed-element epilogue (pallas_brick.py:_bkt_mix_one).
"""

from __future__ import annotations

import torch

from . import build
from .bkt_step import CONV_TYPES, bkt_recursion_plain, check_layout
from .tiles import brick_strides

# the most coefficient sets a brick may have (len(QTABLE)); the table
# holds one more row, zero, for nodes with no adjacent element
MAX_SETS = 18
SET_ROW = 18                   # coefficients per set: 9 shear, 9 kappa
FM_SIZE = 24 * 48
TAB_SIZE = FM_SIZE + (MAX_SETS + 1) * SET_ROW


def node_tab(fm, sets):
    """fm [24, 48] and sets [nsets, 9 | 18] as the one tensor the kernel
    uploads: fm, then the sets in rows of 18 (zero-padded), then zero
    rows up to MAX_SETS + 1."""
    nsets, rc = sets.shape
    if nsets > MAX_SETS or rc not in (9, 18):
        raise ValueError(f"{nsets} coefficient sets of {rc} values (at "
                         f"most {MAX_SETS} of 9 or 18)")
    tab = fm.new_zeros(TAB_SIZE)
    tab[:FM_SIZE] = fm.reshape(-1)
    tab[FM_SIZE:].view(MAX_SETS + 1, SET_ROW)[:nsets, :rc] = sets
    return tab


def unpack_tab(tab, rc):
    """(fm [24, 48], the sets table [MAX_SETS + 1, rc]) views of tab."""
    return (tab[:FM_SIZE].view(24, 48),
            tab[FM_SIZE:].view(MAX_SETS + 1, SET_ROW)[:, :rc])


def node_mix(cols, ce, LEN, dtype, device):
    """The mixed-element tables of the step from the mixed element
    columns ``cols`` [M] and their recursion rows ``ce`` [9 | 18, M]."""
    cols = torch.as_tensor(cols, dtype=torch.int64, device=device)
    slot = torch.full((LEN,), -1, dtype=torch.int32, device=device)
    slot[cols] = torch.arange(len(cols), dtype=torch.int32, device=device)
    return {"cols": cols, "slot": slot,
            "ce": torch.as_tensor(ce, dtype=dtype,
                                  device=device).contiguous()}


def _mix_count(mix):
    return 0 if mix is None else int(mix["cols"].shape[0])


def bkt_node_step_plain(S, conv, K, offs, tab, mix=None, conv_mix=None):
    """The step as a gather of each node's coefficient set, K2's node
    recursion, 8 shifted slices (at the mixed elements, the damping
    vectors of their own recursion on conv_mix), two [24, 24] @ [24, E]
    products scaled by each element's mu_f and kappa_f, and 24 shifted
    adds.  conv' and conv_mix' round to the storage type once, on
    return.  Returns (S', conv'[, conv_mix'])."""
    LEN = S.shape[1]
    E = LEN - offs[7]                  # element columns whose corners fit
    u, up = S[0:3], S[3:6]
    rc = 9 if conv.shape[0] == 6 else 18
    fm, sets = unpack_tab(tab, rc)
    cf = sets[K[6].long()].T                            # [rc, LEN]
    cn, dvs, dvk = bkt_recursion_plain(S, conv, cf)
    Xs = torch.cat([dvs[:, o:o + E] for o in offs])     # [24, E]
    Xk = torch.cat([dvk[:, o:o + E] for o in offs])
    M = _mix_count(mix)
    if M:
        cols = mix["cols"]
        idx = cols[None, :] + torch.as_tensor(offs, device=S.device)[:, None]
        # [6, 8, M] state at the corners, the element's own rows [rc, 1, M]
        cmn, dvs_e, dvk_e = bkt_recursion_plain(
            S[0:6][:, idx], conv_mix, mix["ce"][:, None, :])
        # [3, 8, M] component-major -> row 3 i + c
        Xs[:, cols] = dvs_e.transpose(0, 1).reshape(24, M)
        Xk[:, cols] = dvk_e.transpose(0, 1).reshape(24, M)
    F = (torch.matmul(fm[:, :24], Xs) * K[4:5, :E]
         + torch.matmul(fm[:, 24:], Xk) * K[5:6, :E])   # [24, E]
    force = torch.zeros_like(u)
    for j, o in enumerate(offs):
        force[:, o:o + E] += F[3 * j:3 * j + 3]
    un = u + (force + K[0:3] * (u - up)) * K[3:4]
    Sn = torch.cat([un, u, S[6:8]])
    if M:
        return Sn, cn.to(conv.dtype), cmn.to(conv_mix.dtype)
    return Sn, cn.to(conv.dtype)


def check_args(S, conv, K, offs, tab, out, conv_out, slot, ce, conv_mix,
               conv_mix_out):
    """Raise unless the tensors are what the kernel takes; returns (C
    entry, its constant arguments, the constant bank's setter)."""
    name = "bkt_node_step"
    dev, dt = S.device, S.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    sfx = CONV_TYPES.get((dt, conv.dtype))
    if sfx is None:
        raise TypeError(f"{name}: working type {dt} with conv {conv.dtype} "
                        f"(one of {list(CONV_TYPES)})")
    LEN = S.shape[1] if S.dim() == 2 else -1
    R = conv.shape[0] if conv.dim() == 2 else -1
    if R not in (6, 12):
        raise ValueError(f"{name}: conv has {R} rows (6 or 12)")
    specs = [("S", S, (8, LEN), dt), ("K", K, (8, LEN), dt),
             ("tab", tab, (TAB_SIZE,), dt), ("out", out, (8, LEN), dt),
             ("conv", conv, (R, LEN), conv.dtype),
             ("conv_out", conv_out, (R, LEN), conv.dtype)]
    outputs = [(out, S), (conv_out, conv)]
    M = 0 if ce is None else ce.shape[-1]
    if M:
        specs += [("slot", slot, (LEN,), torch.int32),
                  ("ce", ce, (3 * R // 2, M), dt),
                  ("conv_mix", conv_mix, (R, 8, M), conv.dtype),
                  ("conv_mix_out", conv_mix_out, (R, 8, M), conv.dtype)]
        outputs.append((conv_mix_out, conv_mix))
        if R * 8 * M >= 2 ** 31:
            raise ValueError(f"{name}: {M} mixed elements exceed 32-bit "
                             f"indexing")
    check_layout(name, specs, outputs, offs, LEN, 12)
    brick_strides(offs)
    return (build.entry(f"ht_bkt_node_step_{sfx}"), M, LEN,
            build.offsets_arg(offs), int(R == 12), dev.index,
            f"ht_bkt_node_set_tab_{sfx[:3]}")


_CHECKS = build.CheckCache(check_args)


def bkt_node_step(S, conv, K, offs, tab, mix=None, conv_mix=None, out=None,
                  conv_out=None, conv_mix_out=None):
    """One step (S, conv[, conv_mix]) -> (out, conv_out[, conv_mix_out])
    (new tensors unless given); conv_mix with ``mix`` of M > 0 mixed
    elements.  CUDA tensors run the K3 kernel; CPU tensors run
    bkt_node_step_plain."""
    M = _mix_count(mix)
    if M and conv_mix is None:
        raise ValueError("bkt_node_step: mixed elements need conv_mix")
    if S.device.type == "cpu":
        res = bkt_node_step_plain(S, conv, K, offs, tab, mix, conv_mix)
        given = (out, conv_out, conv_mix_out)
        return tuple(r if g is None else g.copy_(r)
                     for r, g in zip(res, given))
    if out is None:
        out = torch.empty_like(S)
    if conv_out is None:
        conv_out = torch.empty_like(conv)
    slot = ce = cm = None
    if M:
        slot, ce, cm = mix["slot"], mix["ce"], conv_mix
        if conv_mix_out is None:
            conv_mix_out = torch.empty_like(conv_mix)
    else:
        conv_mix_out = None
    fn, M, LEN, offs_arg, kappa, dev, setter = _CHECKS(
        S, conv, K, offs, tab, out, conv_out, slot, ce, cm, conv_mix_out)
    stream = build.stream(S)
    build.ensure_ops(setter, tab, stream)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(S.data_ptr(), conv.data_ptr(), K.data_ptr(), out.data_ptr(),
            conv_out.data_ptr(), ptr(slot), ptr(ce), ptr(cm),
            ptr(conv_mix_out), M, LEN, offs_arg, kappa, dev, stream)
    build.check(rc, "bkt_node_step launch")
    bkt_node_step.launches += 1
    if M:
        return out, conv_out, conv_mix_out
    return out, conv_out


bkt_node_step.launches = 0
