"""Numerical health checks: NaN scanning and overflow monitoring.

Replaces the reference's DEBUG-guarded nets: solver_check_nan
(psolve.c:3770), solver_debug_overflow (:3674) and the hu_*_nan
scanners (util.c:60-217).

Counterpart of ``hercules_tpu/utils/debug.py``, with its messages and
exception type.  ``state[0]`` is whatever the route carries: the
global [N, 3] field, a brick's component-major [3, LEN] rows (or the
packed [8, LEN] state), or a list or tuple of such tensors (per brick,
per rank).  The node a message names does not depend on the layout: the
index along the first axis of an [N, ...] field, as the JAX tool reads
its [N, 3] field, and the column of a component-major one.  The check
is one reduction on the tensor's device, and only a scalar crosses to
the host; the offending indices are found only on failure.
"""

from __future__ import annotations

import torch


def _tensors(x):
    """The tensors of ``x``: a tensor or array, or nested lists and
    tuples of them (None entries skipped)."""
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [t for part in x for t in _tensors(part)]
    return [torch.as_tensor(x)]


def _bad_nodes(u):
    """Indices of the nodes holding a non-finite value: the columns of
    a component-major [3 | 6 | 8, X] field, else along the first axis."""
    fin = torch.isfinite(u)
    if u.ndim == 0:
        rows = fin.reshape(1)
    elif u.ndim == 2 and u.shape[0] in (3, 6, 8) and u.shape[1] > 8:
        rows = fin.all(dim=0)
    else:
        rows = fin.reshape(u.shape[0], -1).all(dim=1)
    return torch.nonzero(~rows).flatten()[:10].cpu().tolist()


def check_state(state, where="", max_disp=None):
    """Raise if the displacement field contains NaN/Inf (or exceeds
    max_disp, the solver_debug_overflow equivalent)."""
    parts = _tensors(state[0])
    for u in parts:
        if not bool(torch.isfinite(u).all()):
            raise FloatingPointError(
                f"non-finite displacement {where} at nodes {_bad_nodes(u)}")
    if max_disp is not None:
        peak = max((float(u.abs().amax()) for u in parts if u.numel()),
                   default=0.0)
        if peak > max_disp:
            raise FloatingPointError(
                f"displacement overflow {where}: |u|={peak:.3e} > "
                f"{max_disp:.3e}")
    return True


def make_chunk_checker(every=1, max_disp=None, inner=None):
    """on_chunk hook running check_state every `every` chunks."""
    n = {"i": 0}

    def hook(done, state):
        n["i"] += 1
        if n["i"] % every == 0:
            check_state(state, where=f"after step {done}",
                        max_disp=max_disp)
        if inner is not None:
            inner(done, state)

    return hook
