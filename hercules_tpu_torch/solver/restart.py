"""Restart of a BKT brick from checkpointed memory variables: the basis
conversions and the fitters of each tier.

Counterpart of the restart half of ``hercules_tpu/solver/pallas_brick.py``
(``conv_corner_to_node`` and its siblings, :2562-2649; ``_fit_conv_node``,
``_fit_conv_corner`` and ``_fit_conv_nodeq``, :3530-3625), fitted to the
port's layouts (``fused_bkt.py``, ``fused_bktq.py``):

- node basis: conv [6 | 12, LEN] (s0, s1[, k0, k1] x 3 components) on
  the uniform and the node tier; the JAX package keeps [8 | 16, LEN]
  with padding rows (on its node tier the set index in row 6 | 12), so
  a checkpoint's node array of 8 or 16 rows is read as 6 or 12;
- corner basis: conv [48 | 96, LEN], row 24 v + 3 j + c (variable v,
  corner j, component c), on the corner tier;
- the node tier's mixed elements: conv_mix [6 | 12, 8, M].

Every conversion only moves values (float64 numpy), so a state
restarted in its own basis and type is bit-exact, bfloat16 memory
variables included (they are written widened to float32, exactly).
Columns past the brick's nodes are zero in both packages; a checkpoint
array wider or narrower than LEN is cut or zero-padded.  A layout no
fitter reads raises RuntimeError in the JAX package's words; it never
starts from zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NODE_ROWS = (6, 8, 12, 16)
CORNER_ROWS = (48, 96)
LAYOUT_ERROR = ("checkpointed BKT conv state has an unsupported layout "
                "for the fused kernel; restart with the solver path that "
                "wrote the checkpoint")


class Checkpoint(NamedTuple):
    """A state as ``io.checkpoint.checkpoint_read`` gives it: the fields
    u and u- (canonical global [N, 3], or component-major [3, X] in
    the brick's column order with any padding), the flat memory
    variables (see ``fused_brick.restore_packed_state`` and
    ``fused_mesh.restore_mesh_state`` for their order), and the
    checkpoint's extra entries (``mc_path`` and ``mc_ndev`` name the
    multi-chip path and rank count a carry tail is shaped for)."""
    u_now: np.ndarray
    u_prev: np.ndarray
    conv: tuple = ()
    extras: dict = {}


def conv_corner_to_node(offs, evalid, conv_corner):
    """Corner-basis conv [R, LEN] -> node-basis [R2, LEN] (uniform Q).

    Under one coefficient set the (element, corner-j) variable equals
    the node field at column e + offs[j]; all corners of all valid
    elements agree, so any one determines the node value."""
    conv_corner = np.asarray(conv_corner, np.float64)
    R, LEN = conv_corner.shape
    nvar = R // 24
    out = np.zeros((3 * nvar, LEN))
    seen = np.zeros(LEN, bool)
    e = np.flatnonzero(np.asarray(evalid))
    for j, o in enumerate(offs):
        cols = e + o
        take = ~seen[cols]
        for v in range(nvar):
            out[3 * v:3 * v + 3, cols[take]] = \
                conv_corner[24 * v + 3 * j:24 * v + 3 * j + 3, e[take]]
        seen[cols[take]] = True
    return out


def conv_node_to_corner(offs, evalid, conv_node, R):
    """Node-basis conv [>=R2, LEN] -> corner basis [R, LEN]."""
    conv_node = np.asarray(conv_node, np.float64)
    LEN = conv_node.shape[1]
    nvar = R // 24
    out = np.zeros((R, LEN))
    e = np.flatnonzero(np.asarray(evalid))
    for j, o in enumerate(offs):
        for v in range(nvar):
            out[24 * v + 3 * j:24 * v + 3 * j + 3, e] = \
                conv_node[3 * v:3 * v + 3, e + o]
    return out


def conv_corner_to_nodeq(offs, node_src, conv_corner):
    """Corner-basis conv [R, LEN] -> the node tier's node basis
    [R2, LEN]: node n takes the variable of its assigned element
    node_src[n] at the corner j with n = node_src[n] + offs[j] -- the
    one the node-basis recursion would have produced (exact, unlike
    the any-corner pick of conv_corner_to_node under several Q sets)."""
    conv_corner = np.asarray(conv_corner, np.float64)
    R, LEN = conv_corner.shape
    nvar = R // 24
    out = np.zeros((3 * nvar, LEN))
    node_src = np.asarray(node_src)
    n_all = np.flatnonzero(node_src >= 0)
    for j, o in enumerate(offs):
        n = n_all[node_src[n_all] == n_all - o]
        for v in range(nvar):
            out[3 * v:3 * v + 3, n] = \
                conv_corner[24 * v + 3 * j:24 * v + 3 * j + 3, n - o]
    return out


def conv_mix_of_corner(offs, mixed_cols, conv_corner):
    """Corner-basis conv -> the mixed elements' state [R2, 8, M]."""
    conv_corner = np.asarray(conv_corner, np.float64)
    nvar = conv_corner.shape[0] // 24
    out = np.zeros((3 * nvar, 8, len(mixed_cols)))
    for j in range(8):
        for v in range(nvar):
            out[3 * v:3 * v + 3, j, :] = \
                conv_corner[24 * v + 3 * j:24 * v + 3 * j + 3, mixed_cols]
    return out


def conv_nodeq_to_corner(offs, evalid, mixed_cols, conv_node, conv_mix, R):
    """(node-basis conv, mixed elements' state) -> corner basis [R, LEN]
    (exact: the corners of unmixed elements read the node field, the
    mixed elements their own state)."""
    out = conv_node_to_corner(offs, evalid, conv_node, R)
    if conv_mix is not None and len(mixed_cols):
        cm = np.asarray(conv_mix, np.float64)
        nvar = R // 24
        for j in range(8):
            for v in range(nvar):
                out[24 * v + 3 * j:24 * v + 3 * j + 3, mixed_cols] = \
                    cm[3 * v:3 * v + 3, j, :]
    return out


def conv_array(cv, LEN, nb=None):
    """A conv array of a checkpoint or of the JAX package as float64
    [rows, LEN]: a node-basis array of 8 or 16 rows read as 6 or 12
    (the JAX package's padding rows, on its node tier the set index,
    dropped), a corner-basis one as it is; its first ``nb`` columns
    (all when None) kept, cut or zero-padded to LEN.  RuntimeError if
    no basis has its rows."""
    a = np.asarray(cv)
    if a.ndim != 2 or a.shape[0] not in NODE_ROWS + CORNER_ROWS:
        raise RuntimeError(LAYOUT_ERROR)
    R = {8: 6, 16: 12}.get(a.shape[0], a.shape[0])
    w = min(LEN, a.shape[1], LEN if nb is None else nb)
    out = np.zeros((R, LEN))
    out[:, :w] = a[:R, :w]
    return out


def _rows(a, R):
    """The first R rows of a [rows, LEN] array; missing rows zero."""
    out = np.zeros((R, a.shape[1]))
    r = min(R, a.shape[0])
    out[:r] = a[:r]
    return out


def fit_conv_node(step, LEN, cv):
    """The uniform tier's conv [R2, LEN] (float64) from a checkpoint's
    node-basis array, or a corner-basis one (conv_corner_to_node)."""
    if cv is None:
        return np.zeros((step.conv_rows, LEN))
    a = conv_array(cv, LEN)
    if a.shape[0] in CORNER_ROWS:
        a = conv_corner_to_node(step.offs, step.evalid, a)
    return _rows(a, step.conv_rows)


def fit_conv_corner(step, LEN, cv, mix=None):
    """The corner tier's conv [48 | 96, LEN] (float64) from a
    checkpoint's corner-basis array, or a node-basis one
    (conv_nodeq_to_corner: the mixed elements of the brick's node
    assignment read from ``mix``, the node tier's state, when given)."""
    if cv is None:
        return np.zeros((step.conv_rows, LEN))
    a = conv_array(cv, LEN)
    if a.shape[0] in CORNER_ROWS:
        return _rows(a, step.conv_rows)
    mixed = step.mixed_cols
    if mixed is None:
        mixed = np.zeros(0, np.int64)
    if mix is not None:
        mix = np.asarray(mix, np.float64)
        if mix.shape[-1] != len(mixed):
            raise RuntimeError("checkpointed BKT mixed-element state does "
                               "not match this mesh's mixed set")
    return conv_nodeq_to_corner(step.offs, step.evalid, mixed,
                                _rows(a, step.conv_rows // 8), mix,
                                step.conv_rows)


def fit_conv_nodeq(step, LEN, parts):
    """The node tier's (conv [R2, LEN], conv_mix [R2, 8, M] when the
    brick has mixed elements), float64, from a checkpoint's parts: this
    tier's own (node, mix) pair; a corner-basis array (the exact split
    by the node assignment); or a bare node-basis array (conv_mix filled
    from the node field at the mixed corners -- exact only where the
    coefficient sets agree)."""
    R2, M = step.conv_rows, step.mix_M
    mix = np.zeros((R2, 8, M)) if M else None
    if not parts or parts[0] is None:
        node = np.zeros((R2, LEN))
    else:
        a = conv_array(parts[0], LEN)
        if a.shape[0] in CORNER_ROWS:
            node = _rows(conv_corner_to_nodeq(step.offs, step.node_src, a),
                         R2)
            if M:
                mix = _rows(conv_mix_of_corner(
                    step.offs, step.mixed_cols, a).reshape(-1, 8 * M),
                    R2).reshape(R2, 8, M)
        else:
            node = _rows(a, R2)
            if M and len(parts) > 1 and parts[1] is not None:
                mix = np.asarray(parts[1], np.float64)
                if mix.shape != (R2, 8, M):
                    raise RuntimeError(
                        "checkpointed BKT mixed-element state does not "
                        "match this mesh's mixed set")
            elif M:
                mix = np.stack([node[:, step.mixed_cols + o]
                                for o in step.offs], axis=1)
    return (node,) + ((mix,) if M else ())


def fit_conv(step, LEN, parts):
    """The memory variables of a BKT step module's tier (float64 numpy,
    in ``step.state_parts`` order) from a checkpoint's parts: conv
    first, then the node tier's conv_mix."""
    parts = tuple(parts)
    if step.tier == "node":
        return fit_conv_nodeq(step, LEN, parts)
    if len(parts) > 2:
        raise RuntimeError(LAYOUT_ERROR)
    cv = parts[0] if parts else None
    if step.tier == "corner":
        return (fit_conv_corner(step, LEN, cv,
                                parts[1] if len(parts) > 1 else None),)
    return (fit_conv_node(step, LEN, cv),)
