"""3-D mesh plot from the MATLAB-export dump — the plotmesh.m
equivalent (matlab-utils/scripts/plotmesh.m, plot3d_Hercules_v2).

Reads the binary ``mesh_coordinates.N`` (24 int32 corner ticks per
element) and ``mesh_data.N`` (3 float32 Vs/Vp/rho per element) files
written by io.matlab.write_matlab_mesh (meshformatlab.c:30-250 layout)
for any number of PE-suffixed parts, selects a bounding box, and
renders the element faces colored by Vs, Vp, rho, or writing PE —
saved to a PNG instead of an interactive MATLAB figure.

CLI (same 14-line parameter file as the reference, ``key : value``):

    python -m hercules_tpu_torch.tools.plotmesh parameters_for_matlab.in \
        [out.png]

The port's copy of ``hercules_tpu/tools/plotmesh.py``, on the port's own
host modules: its output equals the JAX tool's on the same files
(tests/test_torch_tools.py).
"""

from __future__ import annotations

import os
import sys

import numpy as np

# the 6 faces of a hex element in the dump's corner order (x fastest,
# then y, then z — same bit order as plotmesh.m's faces_matrix)
_FACES = np.array([
    [0, 2, 3, 1],
    [4, 6, 7, 5],
    [6, 7, 3, 2],
    [4, 5, 1, 0],
    [5, 7, 3, 1],
    [4, 6, 2, 0],
])


def read_matlab_mesh(directory, n_parts=None, data_dir=None):
    """Load all ``mesh_coordinates.N``/``mesh_data.N`` parts.

    Returns (coords [E,8,3] int32 ticks, data [E,3] f32 Vs/Vp/rho,
    part_id [E] int32).  n_parts=None scans suffixes until a gap.
    """
    data_dir = data_dir or directory
    coords, data, part = [], [], []
    i = 0
    while True:
        cpath = os.path.join(directory, f"mesh_coordinates.{i}")
        if not os.path.exists(cpath):
            if n_parts is None or i >= n_parts:
                break
            i += 1
            continue
        c = np.fromfile(cpath, "<i4").reshape(-1, 8, 3)
        coords.append(c)
        dpath = os.path.join(data_dir, f"mesh_data.{i}")
        if os.path.exists(dpath):
            data.append(np.fromfile(dpath, "<f4").reshape(-1, 3))
        else:
            data.append(np.zeros((len(c), 3), np.float32))
        part.append(np.full(len(c), i, np.int32))
        i += 1
        if n_parts is not None and i >= n_parts:
            break
    if not coords:
        raise FileNotFoundError(
            f"no mesh_coordinates.N files under {directory}")
    return (np.concatenate(coords), np.concatenate(data),
            np.concatenate(part))


def ticks_to_meters(coords, dims):
    """Tick -> meter conversion exactly as plotmesh.m: the etree
    domain is the 2^30-tick cube scaled by the LARGEST dimension."""
    dims = np.asarray(dims, np.float64)
    return coords.astype(np.float64) * (dims.max() / 2 ** 30)


def plot_mesh(coords_m, values, out_path, label="Vs (m/s)",
              bbox=None, elev=22.0, azim=-60.0, lw=0.2):
    """Render hex elements as face collections colored by `values`.

    coords_m: [E, 8, 3] corner coordinates in meters (z positive
    down, as in the solver; plotted with z inverted so depth points
    down).  values: [E] scalar per element.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if bbox is not None:
        xmin, xmax, ymin, ymax, zmin, zmax = bbox
        lo = coords_m.min(axis=1)
        sel = ((lo[:, 0] >= xmin) & (lo[:, 0] < xmax)
               & (lo[:, 1] >= ymin) & (lo[:, 1] < ymax)
               & (lo[:, 2] >= zmin) & (lo[:, 2] < zmax))
        coords_m, values = coords_m[sel], values[sel]
    if len(coords_m) == 0:
        raise ValueError("bounding box selects no elements")

    quads = coords_m[:, _FACES, :]            # [E, 6, 4, 3]
    quads = quads.reshape(-1, 4, 3)
    vals = np.repeat(np.asarray(values, np.float64), 6)

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    norm = plt.Normalize(vals.min(), vals.max() or 1.0)
    cmap = plt.get_cmap("viridis")
    pc = Poly3DCollection(quads, facecolors=cmap(norm(vals)),
                          edgecolor="k", linewidths=lw)
    ax.add_collection3d(pc)
    for k, name in ((0, "east (m)"), (1, "north (m)"), (2, "depth (m)")):
        lo, hi = quads[..., k].min(), quads[..., k].max()
        pad = 0.02 * max(hi - lo, 1.0)
        (ax.set_xlim, ax.set_ylim, ax.set_zlim)[k](lo - pad, hi + pad)
        (ax.set_xlabel, ax.set_ylabel, ax.set_zlabel)[k](name)
    ax.invert_zaxis()                          # depth increases down
    ax.view_init(elev=elev, azim=azim)
    sm = plt.cm.ScalarMappable(norm=norm, cmap=cmap)
    fig.colorbar(sm, ax=ax, shrink=0.7, label=label)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def parse_parameters(path):
    """The reference's 14-line ``parameters_for_matlab.in``: numeric
    lines 1-11, paths 12-13, 'p'/'d' mode line 14 (plotmesh.m:41-85;
    names before the colon are free-form)."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals.append(line.split(":", 1)[1].strip())
    if len(vals) < 14:
        raise ValueError(f"{path}: expected 14 'name : value' lines, "
                         f"got {len(vals)}")
    num = [float(v) for v in vals[:11]]
    return {
        "dims": (num[0], num[1], num[2]),
        "bbox": (num[3], num[4], num[5], num[6], num[7], num[8]),
        "fourth_dim": int(num[9]),             # 1 Vs, 2 Vp, 3 rho
        "n_parts": int(num[10]),
        "coord_dir": vals[11],
        "data_dir": vals[12],
        "mode": vals[13],                      # 'p' or 'd'
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cfg = parse_parameters(argv[0])
    out = argv[1] if len(argv) > 1 else "plotmesh.png"
    coords, data, part = read_matlab_mesh(
        cfg["coord_dir"], n_parts=cfg["n_parts"],
        data_dir=cfg["data_dir"])
    coords_m = ticks_to_meters(coords, cfg["dims"])
    if cfg["mode"].startswith("p"):
        values, label = part, "writing PE"
    else:
        k = cfg["fourth_dim"] - 1
        values = data[:, k]
        label = ("Vs (m/s)", "Vp (m/s)", "rho (kg/m^3)")[k]
    plot_mesh(coords_m, values, out, label=label, bbox=cfg["bbox"])
    print(f"wrote {out} ({len(coords)} elements)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
