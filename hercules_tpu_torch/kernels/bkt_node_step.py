"""K3: one step of a general-Q BKT brick (node-basis memory variables,
one coefficient set per node).

``bkt_node_step`` launches the CUDA kernels of ``csrc/bkt_node.cu`` on
CUDA tensors and runs ``bkt_node_step_plain``, the same step in plain
PyTorch, on CPU tensors.  It counts its launches in
``bkt_node_step.launches`` (one per step: the recursion pass and the
force pass go out together).  The mixed-element epilogue that follows
each step is torch code (``solver/fused_bktq.bkt_mix_epilogue``).

Layout (see ``solver/fused_bktq.py``): S [8, LEN] = (u, u-, 0, 0),
conv [6 | 12, LEN] = (s0, s1[, k0, k1]) x 3 components in the storage
type, K [8, LEN] = (mass_minusaM x 3, inv_mass, mu_f, kappa_f, set index,
0), tab = ``node_tab(fm, sets)``: fm [24, 48] = [Kmu | Kkappa] and the
coefficient sets [MAX_SETS + 1, 18], flattened into one tensor.
"""

from __future__ import annotations

import torch

from . import build
from .bkt_step import CONV_TYPES, bkt_recursion_plain, check_layout

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


def bkt_node_step_plain(S, conv, K, offs, tab):
    """The step as a gather of each node's coefficient set, K2's node
    recursion, 8 shifted slices, two [24, 24] @ [24, E] products scaled
    by each element's mu_f and kappa_f, and 24 shifted adds.  conv'
    rounds to the storage type once, on return.  Returns (S', conv')."""
    LEN = S.shape[1]
    E = LEN - offs[7]                  # element columns whose corners fit
    u, up = S[0:3], S[3:6]
    rc = 9 if conv.shape[0] == 6 else 18
    fm, sets = unpack_tab(tab, rc)
    cf = sets[K[6].long()].T                            # [rc, LEN]
    cn, dvs, dvk = bkt_recursion_plain(S, conv, cf)
    Xs = torch.cat([dvs[:, o:o + E] for o in offs])     # [24, E]
    Xk = torch.cat([dvk[:, o:o + E] for o in offs])
    F = (torch.matmul(fm[:, :24], Xs) * K[4:5, :E]
         + torch.matmul(fm[:, 24:], Xk) * K[5:6, :E])   # [24, E]
    force = torch.zeros_like(u)
    for j, o in enumerate(offs):
        force[:, o:o + E] += F[3 * j:3 * j + 3]
    un = u + (force + K[0:3] * (u - up)) * K[3:4]
    return torch.cat([un, u, S[6:8]]), cn.to(conv.dtype)


def check_args(name, S, conv, K, offs, tab, out, conv_out):
    """Raise unless the tensors are what the kernels take; returns the
    C entry suffix."""
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
    check_layout(name, (("S", S, (8, LEN), dt), ("K", K, (8, LEN), dt),
                        ("tab", tab, (TAB_SIZE,), dt),
                        ("out", out, (8, LEN), dt),
                        ("conv", conv, (R, LEN), conv.dtype),
                        ("conv_out", conv_out, (R, LEN), conv.dtype)),
                 ((out, S), (conv_out, conv)), offs, LEN, 12)
    return sfx


def bkt_node_step(S, conv, K, offs, tab, out=None, conv_out=None):
    """One step (S, conv) -> (out, conv_out) (new tensors unless given).
    CUDA tensors run the K3 kernels; CPU tensors run
    bkt_node_step_plain."""
    if S.device.type == "cpu":
        Sn, cn = bkt_node_step_plain(S, conv, K, offs, tab)
        if out is not None:
            Sn = out.copy_(Sn)
        if conv_out is not None:
            cn = conv_out.copy_(cn)
        return Sn, cn
    if out is None:
        out = torch.empty_like(S)
    if conv_out is None:
        conv_out = torch.empty_like(conv)
    sfx = check_args("bkt_node_step", S, conv, K, offs, tab, out, conv_out)
    kappa = conv.shape[0] == 12
    dv = S.new_empty((6 if kappa else 3, S.shape[1]))
    stream = torch.cuda.current_stream(S.device).cuda_stream
    build.ensure_ops(f"ht_bkt_node_set_tab_{sfx[:3]}", tab, stream)
    rc = getattr(build.lib(), f"ht_bkt_node_step_{sfx}")(
        S.data_ptr(), conv.data_ptr(), K.data_ptr(), out.data_ptr(),
        conv_out.data_ptr(), dv.data_ptr(), S.shape[1],
        build.offsets_arg(offs), int(kappa), S.device.index, stream)
    build.check(rc, "bkt_node_step launch")
    bkt_node_step.launches += 1
    return out, conv_out


bkt_node_step.launches = 0
