"""Point time-series queries of the 4-D output + mesh database.

Tools (q4.c:30-160, q4node.c:37-60, single_query.c:32,
q4showmeta.c:46):

  python -m hercules_tpu_torch.tools.q4 single_query <mesh.e> <out.h4d> x y z
  python -m hercules_tpu_torch.tools.q4 q4node <mesh.e> <out.h4d> <gnid>
  python -m hercules_tpu_torch.tools.q4 showmeta <out.h4d>

The port's copy of ``hercules_tpu/tools/q4.py``, on the port's own
host modules: its output equals the JAX tool's on the same files
(tests/test_torch_tools.py).
"""

from __future__ import annotations

import sys

import numpy as np

from ..etree.reader import EtreeReader
from ..io.output4d import HDR_DTYPE


def open_mesh(path):
    db = EtreeReader(path)
    rec = db.payload.reshape(db.n, -1)
    nid = rec[:, :64].copy().view("<i8").reshape(db.n, 8)
    mat = rec[:, 64:80].copy().view("<f4").reshape(db.n, 4)
    return db, nid, mat


def q4_point(x, y, z, mesh_path, h4d_path):
    """Interpolated displacement time series at a point (q4.c:30-160).

    Returns (times_idx, values [S, 3])."""
    db, nid, mat = open_mesh(mesh_path)
    with open(h4d_path, "rb") as f:
        hdr = np.frombuffer(f.read(136), HDR_DTYPE)[0]
        ticksize = float(hdr["mesh_ticksize"])
        xt = np.array([int(x / ticksize)], np.uint32)
        yt = np.array([int(y / ticksize)], np.uint32)
        zt = np.array([int(z / ticksize)], np.uint32)
        ok, idx = db.search_points(xt, yt, zt)
        if not ok[0]:
            raise LookupError(f"point ({x},{y},{z}) not in mesh")
        e = int(idx[0])
        from ..etree import morton
        ex, ey, ez = morton.deinterleave3(db.hi[e : e + 1],
                                          db.lo[e : e + 1])
        edgesize = float(mat[e, 0])
        ldb = np.array([ex[0], ey[0], ez[0]], np.float64) * ticksize
        center = ldb + edgesize / 2
        d = (np.array([x, y, z]) - center) * 2 / edgesize
        xi = np.array([
            [-1, 1, -1, 1, -1, 1, -1, 1],
            [-1, -1, 1, 1, -1, -1, 1, 1],
            [-1, -1, -1, -1, 1, 1, 1, 1],
        ], np.float64)
        phi = ((1 + xi[0] * d[0]) * (1 + xi[1] * d[1])
               * (1 + xi[2] * d[2]) / 8)

        S = int(hdr["output_steps"])
        N = int(hdr["total_nodes"])
        stride = N * 24
        out = np.zeros((S, 3))
        for s in range(S):
            vals = np.zeros((8, 3))
            for w in range(8):
                f.seek(136 + s * stride + int(nid[e, w]) * 24)
                vals[w] = np.frombuffer(f.read(24), "<f8")
            out[s] = phi @ vals
    return hdr, out


def q4_node(gnid, h4d_path):
    """Raw node time series (q4node.c:37-60)."""
    with open(h4d_path, "rb") as f:
        hdr = np.frombuffer(f.read(136), HDR_DTYPE)[0]
        S = int(hdr["output_steps"])
        N = int(hdr["total_nodes"])
        out = np.zeros((S, 3))
        for s in range(S):
            f.seek(136 + s * N * 24 + gnid * 24)
            out[s] = np.frombuffer(f.read(24), "<f8")
    return hdr, out


def show_meta(h4d_path, out=sys.stdout):
    with open(h4d_path, "rb") as f:
        hdr = np.frombuffer(f.read(136), HDR_DTYPE)[0]
    for name in HDR_DTYPE.names:
        v = hdr[name]
        if name == "file_type_str":
            v = bytes(v).decode(errors="replace")
        elif name == "ufid":
            v = bytes(v).hex()
        out.write(f"{name:18s} = {v}\n")
    return hdr


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 2
    cmd = argv[0]
    if cmd == "showmeta":
        show_meta(argv[1])
    elif cmd == "single_query":
        mesh, h4d, x, y, z = argv[1:6]
        hdr, out = q4_point(float(x), float(y), float(z), mesh, h4d)
        dt = float(hdr["delta_t"]) * int(hdr["output_rate"])
        for s in range(out.shape[0]):
            print("%f %e %e %e" % (s * dt, out[s, 0], out[s, 1],
                                   out[s, 2]))
    elif cmd == "q4node":
        mesh, h4d, gnid = argv[1:4]
        hdr, out = q4_node(int(gnid), h4d)
        dt = float(hdr["delta_t"]) * int(hdr["output_rate"])
        for s in range(out.shape[0]):
            print("%f %e %e %e" % (s * dt, out[s, 0], out[s, 1],
                                   out[s, 2]))
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
