"""Point-in-mesh search (search_point, psolve.c:6354-6370) and element
local coordinates (compute_csi_eta_dzeta, psolve.c:6378-6445).

The port's copy of ``hercules_tpu/mesh/locate.py``, kept equal to it
(tests/test_torch_host.py)."""

from __future__ import annotations

import numpy as np

from ..etree import morton
from ..etree.reader import floor_indices
from .extract import MeshArrays
from .octree import PIXELLEVEL


def locate_points(mesh: MeshArrays, x_m, y_m, z_m):
    """Find the element containing each physical point.

    Returns (found[n] bool, eindex[n] int64).  Points exactly on the far
    domain boundary are not found (octor search semantics)."""
    ts = mesh.ticksize
    xt = (np.asarray(x_m, np.float64) / ts).astype(np.int64)
    yt = (np.asarray(y_m, np.float64) / ts).astype(np.int64)
    zt = (np.asarray(z_m, np.float64) / ts).astype(np.int64)
    inb = ((xt >= 0) & (yt >= 0) & (zt >= 0)
           & (xt < mesh.farendp[0]) & (yt < mesh.farendp[1])
           & (zt < mesh.farendp[2]))
    ehi, elo = morton.interleave3(
        mesh.elem_x.astype(np.uint64), mesh.elem_y.astype(np.uint64),
        mesh.elem_z.astype(np.uint64))
    qhi, qlo = morton.interleave3(
        xt.astype(np.uint64), yt.astype(np.uint64), zt.astype(np.uint64))
    idx = floor_indices(ehi, elo, qhi, qlo)
    ok = idx >= 0
    safe = np.maximum(idx, 0)
    # ancestor check at octor granularity: element level L occupies
    # 2**(30-L) ticks; in 31-bit morton space the shared prefix is
    # 3*(L+1) bits of 3*31
    anc = morton.is_ancestor(
        ehi[safe], elo[safe], mesh.elem_level[safe].astype(np.int64),
        qhi, qlo, np.full(qhi.shape, 30, np.int64), bits=31)
    return inb & ok & anc, safe


def local_coords(mesh: MeshArrays, eindex, x_m, y_m, z_m):
    """csi/eta/dzeta in [-1,1] relative to the element center
    (compute_csi_eta_dzeta)."""
    ts = mesh.ticksize
    e = (np.int64(1) << (PIXELLEVEL
                         - mesh.elem_level[eindex].astype(np.int64)))
    h = ts * e.astype(np.float64)
    cx = ts * (mesh.elem_x[eindex].astype(np.float64) + e / 2.0)
    cy = ts * (mesh.elem_y[eindex].astype(np.float64) + e / 2.0)
    cz = ts * (mesh.elem_z[eindex].astype(np.float64) + e / 2.0)
    return (2 * (np.asarray(x_m) - cx) / h,
            2 * (np.asarray(y_m) - cy) / h,
            2 * (np.asarray(z_m) - cz) / h)
