"""mesh.e database writer (mesh_output, psolve.c:2362-2497): elements
keyed by their low-corner address at the element level, payload
mdata_t = 8 int64 gnids + float32 edgesize, Vp, Vs, rho.

The port's copy of ``hercules_tpu/io/meshout.py``, kept equal to it
(tests/test_torch_host.py)."""

from __future__ import annotations

import numpy as np

from ..etree.writer import EtreeWriter


def write_mesh_etree(path, mesh):
    E = mesh.lenum
    payload = np.zeros((E, 80), np.uint8)
    payload[:, :64] = (mesh.elem_lnid.astype("<i8")
                       .view(np.uint8).reshape(E, 64))
    mat = np.stack([
        mesh.edge_m, mesh.props["Vp"], mesh.props["Vs"],
        mesh.props["rho"]], axis=1).astype("<f4")
    payload[:, 64:80] = mat.view(np.uint8).reshape(E, 16)
    w = EtreeWriter(path, 80)
    return w.write(mesh.elem_x.astype(np.uint32),
                   mesh.elem_y.astype(np.uint32),
                   mesh.elem_z.astype(np.uint32),
                   mesh.elem_level.astype(np.uint8), payload)
