"""Surface/fault plane output (io_planes.c): regular strike/dip grids
of sample points, trilinear-interpolated each print step.

Per plane N: ``planedisplacements.N`` holds raw little-endian float64
records [print_steps, n_strike, n_downdip, 3] in the reference's grid
order (strike outer, down-dip inner, io_planes.c:497-545);
``planecoords.N`` lists the grid point domain coordinates.

Out-of-mesh points: the reference fwrites the FULL rectangular
nstrike x ndip x 3 buffer every print step
(Old_print_plane_displacements, io_planes.c:253-268) with only the
in-mesh "strips" memcpy'd into their offsets (io_planes.c:214-236),
so out-of-mesh slots hold uninitialized malloc memory
(io_planes.c:457).  This writer keeps the identical rectangular
record layout and defines those slots as exact zeros — a strict
superset of the reference's undefined bytes.

The reference's two MPI paths (PE0-collect and dedicated IO-pool
server PEs, io_planes.c:151,1145) collapse to device-side batched
interpolation + an async host writer thread.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from ..mesh.locate import locate_points, local_coords
from ..source.model import compute_domain_coords_linearinterp
from ..source.extended import plane_rotation

XI = np.array([
    [-1, 1, -1, 1, -1, 1, -1, 1],
    [-1, -1, 1, 1, -1, -1, 1, 1],
    [-1, -1, -1, -1, 1, 1, 1, 1],
], dtype=np.float64)


class PlaneSet:
    """All output planes: sample-point interpolation tables."""

    def __init__(self, mesh, params, outdir, surface_shift=0.0):
        self.outdir = outdir
        self.print_rate = params.planes_print_rate
        os.makedirs(outdir, exist_ok=True)
        self.planes = []
        corners = params.domain_surface_corners
        for ip in range(params.number_output_planes):
            (lat, lon, depth, dstrike, nstrike, ddip, ndip, strike,
             dip) = params.planes[ip]
            nstrike = int(nstrike)
            ndip = int(ndip)
            x0, y0 = compute_domain_coords_linearinterp(
                lon, lat, corners[:, 0], corners[:, 1],
                params.region_length_east_m, params.region_length_north_m)
            origin = np.array([float(np.asarray(x0).ravel()[0]),
                               float(np.asarray(y0).ravel()[0]),
                               depth + surface_shift])
            ii = np.arange(nstrike)
            jj = np.arange(ndip)
            xl = np.repeat(ii * dstrike, ndip)      # strike outer
            yl = np.tile(jj * ddip, nstrike)        # down-dip inner
            R = plane_rotation(dip, 0.0, strike)
            local = np.stack([xl, yl, np.zeros_like(xl)])
            g = R @ local + origin[:, None]
            found, eidx = locate_points(mesh, g[0], g[1], g[2])
            cx, cy, cz = local_coords(mesh, eidx, g[0], g[1], g[2])
            phi = ((1 + XI[0][None] * cx[:, None])
                   * (1 + XI[1][None] * cy[:, None])
                   * (1 + XI[2][None] * cz[:, None]) / 8.0)
            phi = np.where(found[:, None], phi, 0.0)
            nodes = np.where(found[:, None], mesh.elem_lnid[eidx], 0)
            self.planes.append({
                "nodes": nodes.astype(np.int32), "phi": phi,
                "coords": g.T, "found": found,
                "shape": (nstrike, ndip),
                "fp": open(os.path.join(outdir,
                                        f"planedisplacements.{ip}"), "wb"),
            })
            with open(os.path.join(outdir, f"planecoords.{ip}"),
                      "w") as f:
                for r in range(g.shape[1]):
                    f.write(f"\n {g[0, r]:f} {g[1, r]:f} {g[2, r]:f}")
        # concatenated interpolation tables for one device pass
        self.all_nodes = np.concatenate([p["nodes"] for p in self.planes])
        self.all_phi = np.concatenate([p["phi"] for p in self.planes])
        self._sizes = [p["phi"].shape[0] for p in self.planes]
        self._q = queue.Queue(maxsize=4)
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            vals = item
            o = 0
            for p, n in zip(self.planes, self._sizes):
                p["fp"].write(vals[o : o + n].astype("<f8").tobytes())
                o += n

    def maybe_write(self, step, sampler):
        """sampler(nodes [M,8], phi [M,8]) -> [M,3] displacements."""
        if step % self.print_rate:
            return False
        vals = np.asarray(sampler(self.all_nodes, self.all_phi))
        self._q.put(vals)
        return True

    def close(self):
        self._q.put(None)
        self._thread.join()
        for p in self.planes:
            p["fp"].close()


def read_plane(path, nstrike, ndip):
    data = np.fromfile(path, "<f8")
    steps = len(data) // (nstrike * ndip * 3)
    return data.reshape(steps, nstrike, ndip, 3)
