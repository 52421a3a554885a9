"""MATLAB mesh export (meshformatlab.c:30-250): binary files
``mesh_coordinates.0`` (8 corner tick coords int32 x/y/z per element)
and ``mesh_data.0`` (float32 Vs, Vp, rho per element) for elements
whose low corner lies in the requested bounding box, consumable by
matlab-utils/scripts/plotmesh.m.

The port's copy of ``hercules_tpu/io/matlab.py``, kept equal to it
(tests/test_torch_host.py)."""

from __future__ import annotations

import os

import numpy as np


def write_matlab_mesh(outdir, mesh, params, bbox=None):
    """bbox: (xmin, xmax, ymin, ymax, zmin, zmax) in meters; defaults
    to the whole domain."""
    os.makedirs(outdir, exist_ok=True)
    ts = mesh.ticksize
    x = mesh.elem_x.astype(np.float64) * ts
    y = mesh.elem_y.astype(np.float64) * ts
    z = mesh.elem_z.astype(np.float64) * ts
    if bbox is None:
        sel = np.ones(mesh.lenum, dtype=bool)
    else:
        xmin, xmax, ymin, ymax, zmin, zmax = bbox
        sel = ((x >= xmin) & (x < xmax) & (y >= ymin) & (y < ymax)
               & (z >= zmin) & (z < zmax))
    idx = np.flatnonzero(sel)
    if len(idx) == 0:
        return 0

    lnid = mesh.elem_lnid[idx]                       # [e, 8]
    coords = np.stack([mesh.node_x[lnid], mesh.node_y[lnid],
                       mesh.node_z[lnid]], axis=2).astype("<i4")
    coords.tofile(os.path.join(outdir, "mesh_coordinates.0"))

    mat = np.stack([mesh.props["Vs"][idx], mesh.props["Vp"][idx],
                    mesh.props["rho"][idx]], axis=1).astype("<f4")
    mat.tofile(os.path.join(outdir, "mesh_data.0"))
    return len(idx)
