"""Kinematic earthquake sources: geometry, moment-tensor nodal forces,
and the per-node force time series the solver streams each step.

Replaces quakesource.c's force machinery: instead of per-PE force files
on disk, the result is an in-memory (node_ids [L], forces [T, L, 3])
pair (with an optional reference-format force-file writer for parity
tooling).  Citations:

- source_initnodalforce (quakesource.c:420-475): double-couple from
  strike/dip/rake via shape-function gradients
- compute_domain_coords_linearinterp (geometrics.c:176-244): Newton
  solve of the bilinear corner interpolation
- compute_myForces_srfh / _point (quakesource.c:3157,3286-3460)
- update_point_source_srfh (quakesource.c:1357-1383)
- compute_point_source_strike_srfh (quakesource.c:1297-1352)

The port's copy of ``hercules_tpu/source/model.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import ConfigFile
from ..mesh.locate import locate_points
from ..mesh.octree import PIXELLEVEL
from .filter import butterworth_filter_signal
from .slip import compute_source_function

PI = np.pi


class DiskForceStream:
    """Disk-backed [T, L, 3] force series with ndarray-slice semantics.

    The TPU-era equivalent of the reference's out-of-core force files
    (force_process.<pe> cycled by theForcesBufferSize,
    quakesource.c:2478-3031): the solver's chunked scan slices steps
    [s, s+k) on demand, so host RAM stays bounded by one scan chunk
    regardless of fault size x duration."""

    def __init__(self, path):
        self.path = path
        self._mm = np.load(path, mmap_mode="r")
        self.shape = self._mm.shape
        self.dtype = self._mm.dtype

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        return np.array(self._mm[idx])


def compute_domain_coords_linearinterp(lon, lat, corners_long,
                                       corners_lat, len_east, len_north):
    """Vectorized Newton solve (geometrics.c:176-244).  Returns
    (x_north, y_east) domain coordinates."""
    X = np.atleast_1d(np.asarray(lat, np.float64))
    Y = np.atleast_1d(np.asarray(lon, np.float64))
    Xi = np.asarray(corners_lat, np.float64)
    Yi = np.asarray(corners_long, np.float64)

    Ax = 4 * X - Xi.sum()
    Ay = 4 * Y - Yi.sum()
    Bx = -Xi[0] + Xi[1] + Xi[2] - Xi[3]
    By = -Yi[0] + Yi[1] + Yi[2] - Yi[3]
    Cx = -Xi[0] - Xi[1] + Xi[2] + Xi[3]
    Cy = -Yi[0] - Yi[1] + Yi[2] + Yi[3]
    Dx = Xi[0] - Xi[1] + Xi[2] - Xi[3]
    Dy = Yi[0] - Yi[1] + Yi[2] - Yi[3]

    c = np.zeros_like(X)   # csi
    e = np.zeros_like(X)   # etha
    res = np.full_like(X, np.inf)
    for _ in range(200):
        live = res > 1e-6
        if not live.any():
            break
        M00 = Bx + Dx * e
        M01 = Cx + Dx * c
        M10 = By + Dy * e
        M11 = Cy + Dy * c
        F0 = -Ax + Bx * c + Cx * e + Dx * c * e
        F1 = -Ay + By * c + Cy * e + Dy * c * e
        det = M00 * M11 - M10 * M01
        dc = -(F0 * M11 - F1 * M01) / det
        de = -(F1 * M00 - F0 * M10) / det
        res = np.abs(F0) + np.abs(F1)
        c = np.where(live, c + dc, c)
        e = np.where(live, e + de, e)
    return (0.5 * (c + 1) * len_north, 0.5 * (e + 1) * len_east)


def source_initnodalforce(strike, dip, rake, x, y, z, h):
    """Equivalent nodal force weights [8, 3] for a double couple at
    local offset (x, y, z) from the element center
    (source_initnodalforce, quakesource.c:420-475)."""
    s = strike / 180.0 * PI
    d = dip / 180.0 * PI
    r = rake / 180.0 * PI
    hcube = h ** 3

    n = np.array([-np.sin(s) * np.sin(d),
                  np.cos(s) * np.sin(d),
                  -np.cos(d)])
    t = np.array([np.cos(r) * np.sin(PI / 2 - s)
                  + np.sin(r) * np.sin(s) * np.cos(d),
                  np.cos(r) * np.sin(s) - np.sin(r) * np.cos(s) * np.cos(d),
                  -np.sin(r) * np.sin(d)])
    v = np.outer(n, t) + np.outer(t, n)

    xi = np.array([
        [-1, 1, -1, 1, -1, 1, -1, 1],
        [-1, -1, 1, 1, -1, -1, 1, 1],
        [-1, -1, -1, -1, 1, 1, 1, 1],
    ], dtype=np.float64)

    force = np.zeros((8, 3))
    for j in range(8):
        dx = (2 * xi[0][j]) * (h + 2 * xi[1][j] * y) * (h + 2 * xi[2][j] * z) \
            / (8 * hcube)
        dy = (2 * xi[1][j]) * (h + 2 * xi[2][j] * z) * (h + 2 * xi[0][j] * x) \
            / (8 * hcube)
        dz = (2 * xi[2][j]) * (h + 2 * xi[0][j] * x) * (h + 2 * xi[1][j] * y) \
            / (8 * hcube)
        grad = np.array([dx, dy, dz])
        force[j] = v @ grad
    return force


@dataclass
class SourceModel:
    """Parsed source description + force computation."""

    type_of_source: str = "point"
    source_function_type: str = "ramp"
    is_filtered: int = 0
    threshold_frequency: float = 0.0
    number_of_poles: int = 0
    average_risetime: float = 0.0
    ricker_ts: float = 0.0
    ricker_tp: float = 0.0
    corners_long: Optional[np.ndarray] = None
    corners_lat: Optional[np.ndarray] = None
    # point source
    moment_magnitude: float = 0.0
    moment_amplitude: float = 0.0
    lonlat_or_cartesian: int = 0
    hypo_lat: float = 0.0
    hypo_lon: float = 0.0
    hypo_depth: float = 0.0
    strike: float = 0.0
    dip: float = 0.0
    rake: float = 0.0
    # srfh arrays
    src_lon: Optional[np.ndarray] = None
    src_lat: Optional[np.ndarray] = None
    src_depth: Optional[np.ndarray] = None
    src_area: Optional[np.ndarray] = None
    src_strike: Optional[np.ndarray] = None
    src_dip: Optional[np.ndarray] = None
    src_rake: Optional[np.ndarray] = None
    src_slip: Optional[np.ndarray] = None
    src_tinit: Optional[np.ndarray] = None
    src_dtfn: Optional[np.ndarray] = None
    src_slipfn: list = field(default_factory=list)
    # plane sources
    plane: dict = field(default_factory=dict)
    # bookkeeping
    total_m0: float = 0.0

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, params, global_delay_t=0.0, surface_shift=0.0):
        """source_init_parameters (quakesource.c:3879-4003)."""
        sm = cls()
        srcdir = params.source_directory
        if not os.path.isabs(srcdir):
            srcdir = os.path.join(
                os.path.dirname(os.path.dirname(params.physics_path)) or ".",
                srcdir)
            # reference resolves relative to the run cwd; prefer that if
            # the physics-relative guess is missing
            if not os.path.exists(os.path.join(srcdir, "source.in")) \
                    and os.path.exists(os.path.join(params.source_directory,
                                                    "source.in")):
                srcdir = params.source_directory
        sm.srcdir = srcdir
        src = ConfigFile(os.path.join(srcdir, "source.in"))

        sm.is_filtered = src.get_int("source_is_filtered", 0)
        if sm.is_filtered:
            sm.threshold_frequency = src.get_double("threshold_frequency",
                                                    required=True)
            sm.number_of_poles = src.get_int("number_of_poles",
                                             required=True)
        sm.type_of_source = src.get_string("type_of_source",
                                           required=True).lower()
        sm.source_function_type = src.get_string("source_function_type",
                                                 required=True).lower()
        if sm.source_function_type in ("ramp", "sine", "quadratic",
                                       "exponential"):
            sm.average_risetime = src.get_double("average_risetime_sec",
                                                 required=True)
        if sm.source_function_type == "ricker":
            sm.ricker_ts = src.get_double("ricker_Ts", required=True)
            sm.ricker_tp = src.get_double("ricker_Tp", required=True)

        corners = src.get_table("domain_surface_corners", 4, 2)
        if corners is not None:
            sm.corners_long = corners[:, 0]
            sm.corners_lat = corners[:, 1]

        if sm.type_of_source == "point":
            sm.moment_magnitude = src.get_double("moment_magnitude", 0.0)
            sm.moment_amplitude = src.get_double("moment_amplitude", 0.0)
            sm.lonlat_or_cartesian = src.get_int("lonlat_or_cartesian", 0)
            if sm.lonlat_or_cartesian == 0:
                sm.hypo_lat = src.get_double("hypocenter_lat_deg",
                                             required=True)
                sm.hypo_lon = src.get_double("hypocenter_long_deg",
                                             required=True)
            else:
                sm.hypo_lat = src.get_double("hypocenter_x", required=True)
                sm.hypo_lon = src.get_double("hypocenter_y", required=True)
            sm.hypo_depth = src.get_double("hypocenter_depth_m",
                                           required=True)
            sm.strike = src.get_double("source_strike_deg", required=True)
            sm.dip = src.get_double("source_dip_deg", required=True)
            sm.rake = src.get_double("source_rake_deg", required=True)
        elif sm.type_of_source == "srfh":
            nsrc = src.get_int("number_of_point_sources", required=True)
            vals = _read_numbers(os.path.join(srcdir, "coords.in"))
            coords = vals.reshape(nsrc, 3)
            sm.src_lon = coords[:, 0]
            sm.src_lat = coords[:, 1]
            sm.src_depth = coords[:, 2] + surface_shift
            sm.src_area = _read_numbers(
                os.path.join(srcdir, "area.in"))[:nsrc]
            sm.src_strike = _read_numbers(
                os.path.join(srcdir, "strike.in"))[:nsrc]
            sm.src_dip = _read_numbers(os.path.join(srcdir, "dip.in"))[:nsrc]
            sm.src_rake = _read_numbers(
                os.path.join(srcdir, "rake.in"))[:nsrc]
            sm.src_slip = _read_numbers(
                os.path.join(srcdir, "slip.in"))[:nsrc]
            # slipfunction.in: per source nt1, tinit, dt, then nt1 values
            sf = _read_numbers(os.path.join(srcdir, "slipfunction.in"))
            pos = 0
            tinit = np.zeros(nsrc)
            dtfn = np.zeros(nsrc)
            for i in range(nsrc):
                nt1 = int(sf[pos])
                tinit[i] = sf[pos + 1]
                dtfn[i] = sf[pos + 2]
                sm.src_slipfn.append(sf[pos + 3 : pos + 3 + nt1].copy())
                pos += 3 + nt1
            sm.src_tinit = tinit + global_delay_t
            sm.src_dtfn = dtfn
        elif sm.type_of_source in ("plane", "planewithkinks"):
            sm._parse_plane(src, srcdir)
        else:
            raise ValueError(f"unknown source type {sm.type_of_source!r}")
        return sm

    def _parse_plane(self, src, srcdir):
        """read_plane_source / read_planewithkinks
        (quakesource.c:2130-2289)."""
        pl = {}
        nw = src.get_int("number_of_time_windows", required=True)
        pl["time_windows"] = src.get_array("time_windows", nw)
        pl["cell_size_down_dip_m"] = src.get_double(
            "extended_cell_size_down_dip_m", required=True)
        pl["isminimumedgeautomatic"] = src.get_int(
            "extended_isminimumedgeautomatic", 0)
        pl["depth_m"] = src.get_double("extended_depth_m", required=True)
        pl["cells_along_strike"] = src.get_int(
            "extended_cells_along_strike", required=True)
        pl["cells_down_dip"] = src.get_int(
            "extended_cells_down_dip", required=True)
        pl["hypocenter_along_strike_m"] = src.get_double(
            "extended_hypocenter_along_strike_m", required=True)
        pl["hypocenter_down_dip_m"] = src.get_double(
            "extended_hypocenter_down_dip_m", required=True)
        pl["average_rupture_velocity"] = src.get_double(
            "extended_average_rupture_velocity", required=True)
        if self.type_of_source == "plane":
            pl["cell_size_along_strike_m"] = src.get_double(
                "extended_cell_size_along_strike_m", required=True)
            pl["lat_deg"] = src.get_double("extended_lat_deg",
                                           required=True)
            pl["long_deg"] = src.get_double("extended_long_deg",
                                            required=True)
            pl["strike_deg"] = src.get_double("extended_strike_deg",
                                              required=True)
            pl["dip_deg"] = src.get_double("extended_dip_deg",
                                           required=True)
        else:
            pl["dip_deg"] = src.get_double("extended_dip_deg", 90.0)
            nk = src.get_int("extended_number_of_kinks", required=True)
            kinks = src.get_table("extended_kinks", nk, 2)
            pl["kink_lon"] = kinks[:, 0]
            pl["kink_lat"] = kinks[:, 1]
        if not pl["isminimumedgeautomatic"]:
            pl["minimum_edge_m"] = src.get_double(
                "extended_minimum_edge_m", required=True)
        else:
            pl["minimum_edge_m"] = 0.0

        rows, cols = pl["cells_down_dip"], pl["cells_along_strike"]
        slip_vals = _read_numbers(os.path.join(srcdir, "slip.in"))
        rake_vals = _read_numbers(os.path.join(srcdir, "rake.in"))
        need = int(len(pl["time_windows"])) * rows * cols
        if len(slip_vals) < need or len(rake_vals) < need:
            raise ValueError(
                f"slip.in/rake.in too short: need {need} values")
        pl["slip"] = slip_vals[:need].reshape(-1, rows, cols)
        pl["rake"] = rake_vals[:need].reshape(-1, rows, cols)
        self.plane = pl

    # ------------------------------------------------------------------
    def _adjusted_strike(self, strike, lon, lat, len_east, len_north):
        """compute_point_source_strike_srfh (quakesource.c:1297-1352):
        lonlat mode corrects strike by the local grid-north rotation."""
        if self.lonlat_or_cartesian == 1:
            return strike
        px, py = compute_domain_coords_linearinterp(
            lon, lat, self.corners_long, self.corners_lat,
            len_east, len_north)
        nx, ny = compute_domain_coords_linearinterp(
            lon, np.asarray(lat) + 0.1, self.corners_long,
            self.corners_lat, len_east, len_north)
        ux = nx - px
        uy = ny - py
        norm = np.hypot(ux, uy)
        ux, uy = ux / norm, uy / norm
        with np.errstate(divide="ignore"):
            fi = np.arctan(ux / uy)
        fi = np.where(uy < 0, fi + PI, fi)
        return 90.0 + strike - 180.0 * fi / PI

    # ------------------------------------------------------------------
    def compute_forces(self, mesh, params, props=None, partial=False):
        """Compute (node_ids [L], forces [T, L, 3]).

        The moment scale is mu*area*slip per point source, with mu from
        the containing element's material (quakesource.c:1180-1202).

        partial=True: `mesh` may be a MeshShard covering only part of
        the domain — sources outside it are silently dropped instead
        of raising (the caller merges rank results; the count of
        locally located points is left in ``self.located_points``).
        locate_points' ancestor check guarantees a point is claimed by
        exactly one shard.
        """
        T = params.total_steps
        dt = params.delta_t
        props = props if props is not None else mesh.props

        if self.type_of_source in ("plane", "planewithkinks"):
            return self._forces_extended(mesh, params, props,
                                         partial=partial)

        if self.type_of_source == "point":
            lon = np.array([self.hypo_lon])
            lat = np.array([self.hypo_lat])
            depth = np.array([self.hypo_depth])
            strike = np.array([self.strike], np.float64)
            dip = np.array([self.dip], np.float64)
            rake = np.array([self.rake], np.float64)
            area = np.array([0.0])
            slip = np.array([1.0])
            tinit = np.array([0.0])
            nsrc = 1
        elif self.type_of_source == "srfh":
            lon, lat, depth = self.src_lon, self.src_lat, self.src_depth
            strike, dip, rake = self.src_strike, self.src_dip, self.src_rake
            area, slip, tinit = self.src_area, self.src_slip, self.src_tinit
            nsrc = len(lon)
        else:
            raise NotImplementedError(self.type_of_source)
        src_dtfn, src_slipfn = self.src_dtfn, self.src_slipfn

        if self.lonlat_or_cartesian == 1 and self.type_of_source == "point":
            dx, dy = np.asarray(lat, np.float64), np.asarray(lon, np.float64)
        else:
            dx, dy = compute_domain_coords_linearinterp(
                lon, lat, self.corners_long, self.corners_lat,
                params.region_length_east_m, params.region_length_north_m)
        strike = self._adjusted_strike(strike, lon, lat,
                                       params.region_length_east_m,
                                       params.region_length_north_m)

        found, eidx = locate_points(mesh, dx, dy, depth)
        if partial:
            keep = np.flatnonzero(found)
            self.located_points = len(keep)
            dx, dy, depth = dx[keep], dy[keep], depth[keep]
            strike, dip, rake = strike[keep], dip[keep], rake[keep]
            area, slip, tinit = area[keep], slip[keep], tinit[keep]
            eidx = eidx[keep]
            nsrc = len(keep)
            if self.type_of_source == "srfh":
                if src_dtfn is not None:
                    src_dtfn = [src_dtfn[i] for i in keep]
                if src_slipfn:
                    src_slipfn = [src_slipfn[i] for i in keep]
            if nsrc == 0:
                return (np.zeros(0, np.int32), np.zeros((T, 0, 3)))
        elif not found.all():
            missing = np.flatnonzero(~found)
            raise RuntimeError(f"point sources outside mesh: {missing[:5]}")

        ts = mesh.ticksize
        e = (np.int64(1) << (PIXELLEVEL
                             - mesh.elem_level[eidx].astype(np.int64)))
        h = ts * e.astype(np.float64)
        cx = ts * (mesh.elem_x[eidx] + e / 2.0)
        cy = ts * (mesh.elem_y[eidx] + e / 2.0)
        cz = ts * (mesh.elem_z[eidx] + e / 2.0)
        lx = dx - cx
        ly = dy - cy
        lz = depth - cz

        mu = (props["rho"][eidx] * props["Vs"][eidx] ** 2)

        # accumulate forces per node
        times = dt * np.arange(T)
        node_force = {}
        self.total_m0 = 0.0
        for i in range(nsrc):
            if self.type_of_source == "point":
                m0 = self.moment_amplitude
                if m0 == 0:
                    m0 = 10 ** (1.5 * self.moment_magnitude + 9.1)
                mu_area = m0
                max_slip = 1.0
                self.total_m0 += m0
            else:
                mu_area = mu[i] * area[i]
                max_slip = slip[i]
                self.total_m0 += abs(mu_area * max_slip)

            decay = compute_source_function(
                self.source_function_type, times,
                T0=self.average_risetime, Ts=self.ricker_ts,
                Tp=self.ricker_tp, delay=float(tinit[i]),
                dt_discrete=(src_dtfn[i]
                             if src_dtfn is not None else None),
                discrete=(src_slipfn[i] if src_slipfn else None))
            displacement = decay * max_slip

            nodal = source_initnodalforce(
                float(strike[i]), float(dip[i]), float(rake[i]),
                float(lx[i]), float(ly[i]), float(lz[i]), float(h[i]))

            lnids = mesh.elem_lnid[eidx[i]]
            for j in range(8):
                contrib = np.outer(displacement,
                                   nodal[j] * mu_area)  # [T,3]
                nid = int(lnids[j])
                if nid in node_force:
                    node_force[nid] += contrib
                else:
                    node_force[nid] = contrib

        node_ids = np.array(sorted(node_force.keys()), np.int32)
        forces = np.stack([node_force[int(n)] for n in node_ids],
                          axis=1)  # [T, L, 3]

        if self.is_filtered:
            forces = np.moveaxis(butterworth_filter_signal(
                np.moveaxis(forces, 0, -1), 1.0 / dt,
                self.threshold_frequency, self.number_of_poles), -1, 0)
        return node_ids, forces

    # ------------------------------------------------------------------
    def _forces_extended(self, mesh, params, props, partial=False):
        """Vectorized extended-fault force generation
        (compute_myForces_planes, quakesource.c:2632-3031)."""
        from .extended import extended_fault_points, batched_nodal_forces
        from ..mesh.octree import PIXELLEVEL

        T = params.total_steps
        dt = params.delta_t
        pts = extended_fault_points(self, params)
        found, eidx = locate_points(mesh, pts["x"], pts["y"], pts["z"])
        keep = np.flatnonzero(found)
        if partial:
            self.located_points = len(keep)
            if len(keep) == 0:
                return (np.zeros(0, np.int32), np.zeros((T, 0, 3)))
        elif len(keep) == 0:
            raise RuntimeError("extended fault entirely outside mesh")
        eidx = eidx[keep]

        ts = mesh.ticksize
        e = (np.int64(1) << (PIXELLEVEL
                             - mesh.elem_level[eidx].astype(np.int64)))
        h = ts * e.astype(np.float64)
        lx = pts["x"][keep] - ts * (mesh.elem_x[eidx] + e / 2.0)
        ly = pts["y"][keep] - ts * (mesh.elem_y[eidx] + e / 2.0)
        lz = pts["z"][keep] - ts * (mesh.elem_z[eidx] + e / 2.0)
        mu = props["rho"][eidx] * props["Vs"][eidx] ** 2
        mu_area = mu * pts["area"][keep]

        pl = self.plane
        nW = len(pts["time_windows"])
        ci = pts["cell_i"][keep]
        cj = pts["cell_j"][keep]
        # rake of the LAST window drives the force direction
        rake_last = pl["rake"][nW - 1][ci, cj]
        nodal = batched_nodal_forces(pts["strike"][keep],
                                     pts["dip"][keep], rake_last,
                                     lx, ly, lz, h)     # [P, 8, 3]

        n_use = min(pts["num_steps"], T)
        P = len(keep)
        slip_w = [pl["slip"][w][ci, cj] for w in range(nW)]
        delay_w = [pts["delay"][keep] + pts["time_windows"][w]
                   for w in range(nW)]
        self.total_m0 = float(np.abs(mu_area * sum(slip_w)).sum())

        # per-node force series = sparse [L, P] node-weight matrix
        # applied to the [P, T'] displacement table
        from scipy.sparse import csr_matrix
        from .slip import compute_source_function
        lnids = mesh.elem_lnid[eidx]                    # [P, 8]
        node_ids, inv = np.unique(lnids, return_inverse=True)
        inv = inv.reshape(P, 8)
        L = len(node_ids)
        w8 = nodal * mu_area[:, None, None]             # [P, 8, 3]
        rows = inv.ravel()                              # [P*8]
        cols = np.repeat(np.arange(P), 8).reshape(P, 8).ravel()
        M = [csr_matrix((w8[:, :, c].ravel(), (rows, cols)),
                        shape=(L, P)) for c in range(3)]

        def gen_chunk(out, s):
            """Fill out[k, L, 3] with forces for steps [s, s+k)."""
            k = out.shape[0]
            kk = max(0, min(n_use - s, k))
            if kk < k:
                out[kk:] = 0.0
            if kk <= 0:
                return
            t = dt * (s + np.arange(kk))
            disp = np.zeros((P, kk))
            for w in range(nW):
                decay = compute_source_function(
                    self.source_function_type, t[None, :],
                    T0=self.average_risetime, Ts=self.ricker_ts,
                    Tp=self.ricker_tp, delay=delay_w[w][:, None])
                disp += decay * slip_w[w][:, None]
            for c in range(3):
                out[:kk, :, c] = (M[c] @ disp).T

        node_ids = node_ids.astype(np.int32)
        need = T * L * 3 * 8 + P * n_use * 8
        bufsz = int(getattr(params, "forces_buffer_size", 0)
                    or 100_000_000)
        if need <= bufsz:
            # in-memory fast path
            forces = np.empty((T, L, 3))
            gen_chunk(forces, 0)
            if self.is_filtered:
                forces = np.moveaxis(butterworth_filter_signal(
                    np.moveaxis(forces, 0, -1), 1.0 / dt,
                    self.threshold_frequency, self.number_of_poles),
                    -1, 0)
            return node_ids, forces

        # ---- out-of-core path (theForcesBufferSize cycling,
        # quakesource.c:2478-3031): generate in bounded time-chunks
        # into a disk-backed array (the reference's force_process files
        # become one memmap the solver slices per scan chunk) ---------
        import tempfile
        srcdir = getattr(params, "source_directory_output", "") or ""
        if srcdir:
            os.makedirs(srcdir, exist_ok=True)
            path = os.path.join(srcdir, "force_stream.npy")
        else:
            fd, path = tempfile.mkstemp(suffix=".npy",
                                        prefix="ht_forces_")
            os.close(fd)
        mm = np.lib.format.open_memmap(path, mode="w+",
                                       dtype=np.float64,
                                       shape=(T, L, 3))
        Tb = max(1, bufsz // (L * 3 * 8 + P * 8))
        for s in range(0, T, Tb):
            gen_chunk(mm[s:min(s + Tb, T)], s)
        if self.is_filtered:
            # filter along T per node-block (FilterSignal is global in
            # time, local per node)
            Lb = max(1, bufsz // (T * 3 * 8 * 4))
            for l0 in range(0, L, Lb):
                blk = np.moveaxis(np.array(mm[:, l0:l0 + Lb]), 0, -1)
                blk = butterworth_filter_signal(
                    blk, 1.0 / dt, self.threshold_frequency,
                    self.number_of_poles)
                mm[:, l0:l0 + Lb] = np.moveaxis(blk, -1, 0)
        mm.flush()
        del mm
        return node_ids, DiskForceStream(path)

    # ------------------------------------------------------------------
    def write_force_file(self, path, node_ids, forces):
        """Reference force_process.<pe> layout (print_header_myForces,
        quakesource.c:2453-2471): int32 count, int32 node ids, then
        per-step [L,3] float64."""
        with open(path, "wb") as f:
            np.array([len(node_ids)], "<i4").tofile(f)
            np.asarray(node_ids, "<i4").tofile(f)
            np.asarray(forces, "<f8").tofile(f)


def _read_numbers(path):
    """Whitespace-separated doubles from an aux source file."""
    with open(path) as f:
        return np.array([float(t) for t in f.read().split()])
