"""Extended-fault kinematic sources: PLANE and PLANEWITHKINKS.

Re-implements compute_myForces_planes (quakesource.c:2632-3031) and the
kinked-trace mapping (init_planewithkinks_mapping :1393,
compute_global_coords_mapping :1495, compute_strike_planewithkinks
:1567), plus the fault-plane geometry of geometrics.c:33-130, as
vectorized passes over all subcell point sources.

Reference quirks preserved deliberately:
- the nodal force direction uses the LAST time window's rake (the
  displacement time series accumulates all windows, but
  source_initnodalforce runs once after the window loop)
- the slip time series is truncated after numStepsNecessary =
  1.1 * (sum of window delays + max corner rupture delay) / dt
  (quakesource.c:2762-2781)

The port's copy of ``hercules_tpu/source/extended.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np

from .slip import compute_source_function
from .model import compute_domain_coords_linearinterp

PI = np.pi


def compute_1d_grid(cell_size, n_cells, pts_in_cell, min_edge):
    """Subcell grid along one fault axis (geometrics.c:110-126)."""
    k = n_cells * pts_in_cell + 1
    g = np.empty(k)
    idx = 0
    for i in range(n_cells):
        for j in range(pts_in_cell):
            g[idx] = i * cell_size + j * min_edge
            idx += 1
    g[idx] = n_cells * cell_size
    return g


def plane_rotation(dip_deg, rake_deg, strike_deg):
    """Local fault coords -> global rotation matrix
    (compute_global_coords, geometrics.c:33-70)."""
    d = dip_deg * PI / 180
    l = rake_deg * PI / 180
    p = strike_deg * PI / 180
    return np.array([
        [np.cos(p) * np.cos(l) + np.sin(p) * np.cos(d) * np.sin(l),
         -(-np.cos(p) * np.sin(l) + np.sin(p) * np.cos(d) * np.cos(l)),
         np.sin(p) * np.sin(d)],
        [np.sin(p) * np.cos(l) - np.cos(p) * np.cos(d) * np.sin(l),
         -(-np.sin(p) * np.sin(l) - np.cos(p) * np.cos(d) * np.cos(l)),
         -np.cos(p) * np.sin(d)],
        [-np.sin(d) * np.sin(l), np.sin(d) * np.cos(l), np.cos(d)],
    ])


class KinkedTrace:
    """Fault trace through kink points, arc-length parameterized."""

    def __init__(self, kink_lon, kink_lat, corners_long, corners_lat,
                 len_east, len_north, depth_m):
        x, y = compute_domain_coords_linearinterp(
            kink_lon, kink_lat, corners_long, corners_lat,
            len_east, len_north)
        self.px = np.asarray(x)
        self.py = np.asarray(y)
        self.depth = depth_m
        seg = np.hypot(np.diff(self.px), np.diff(self.py))
        acc = np.concatenate([[0.0], np.cumsum(seg)])
        self.total_length = acc[-1]
        self.acc_norm = acc / self.total_length
        self.vx = np.diff(self.px) / seg
        self.vy = np.diff(self.py) / seg

    def _segment(self, s_along):
        ns = s_along / self.total_length
        i = np.clip(np.searchsorted(self.acc_norm, ns, side="right") - 1,
                    0, len(self.vx) - 1)
        return i, ns

    def map_points(self, s_along, d_down):
        """(along-strike, down-dip) -> domain coords (x, y, z)."""
        i, ns = self._segment(s_along)
        rem = s_along - self.acc_norm[i] * self.total_length
        return (self.px[i] + rem * self.vx[i],
                self.py[i] + rem * self.vy[i],
                np.asarray(d_down) + self.depth)

    def strike_at(self, s_along):
        """Strike in degrees (compute_strike_planewithkinks,
        quakesource.c:1567-1620)."""
        i, _ = self._segment(s_along)
        vx, vy = self.vx[i], self.vy[i]
        ac = np.arccos(np.clip(vx, -1.0, 1.0))
        strike = np.where(
            vy >= 0, ac,
            np.where(vx < 0, 1.5 * PI - ac, ac + 1.5 * PI))
        return 180.0 * strike / PI


def extended_fault_points(sm, params):
    """Enumerate all subcell point sources of an extended fault.

    Returns dict of arrays over the P subcells: domain coords (x,y,z),
    strike/dip/rake per window, slip per window, rupture delay, area,
    local fault coords.
    """
    pl = sm.plane
    strk_cells = pl["cells_along_strike"]
    dp_cells = pl["cells_down_dip"]

    if sm.type_of_source == "planewithkinks":
        trace = KinkedTrace(pl["kink_lon"], pl["kink_lat"],
                            sm.corners_long, sm.corners_lat,
                            params.region_length_east_m,
                            params.region_length_north_m,
                            pl["depth_m"])
        cell_strike = trace.total_length / strk_cells
        dip = 90.0
    else:
        trace = None
        cell_strike = pl["cell_size_along_strike_m"]
        dip = pl["dip_deg"]

    cell_dip = pl["cell_size_down_dip_m"]
    min_edge = pl["minimum_edge_m"]
    if pl.get("isminimumedgeautomatic", 0):
        min_edge = min(cell_strike, cell_dip)

    me = min(min_edge, cell_strike)
    pts_strk = max(1, int(cell_strike / me))
    edge_strk = cell_strike / pts_strk
    me = min(me, cell_dip)
    pts_dip = max(1, int(cell_dip / me))
    edge_dip = cell_dip / pts_dip

    grd_strk = compute_1d_grid(cell_strike, strk_cells, pts_strk,
                               edge_strk)
    grd_dip = compute_1d_grid(cell_dip, dp_cells, pts_dip, edge_dip)
    ns, nd = len(grd_strk), len(grd_dip)

    # rectangle subcells: center coords + area
    j = np.arange(ns - 1)
    i = np.arange(nd - 1)
    jj, ii = np.meshgrid(j, i)          # [nd-1, ns-1]
    jj = jj.ravel()
    ii = ii.ravel()
    s0 = grd_strk[jj]
    s1 = grd_strk[jj + 1]
    d0 = grd_dip[ii]
    d1 = grd_dip[ii + 1]
    s_mid = 0.5 * (s0 + s1)
    d_mid = 0.5 * (d0 + d1)
    area = np.abs((s1 - s0) * (d1 - d0))
    cell_i = ii // pts_dip              # down-dip cell
    cell_j = jj // pts_strk             # along-strike cell

    if sm.type_of_source == "planewithkinks":
        dx, dy, dz = trace.map_points(s_mid, d_mid)
        strike = trace.strike_at(s_mid)
    else:
        from ..cvm import DIST1LAT, DIST1LON
        ox = (pl["lat_deg"] - params.region_origin_latitude_deg) * DIST1LAT
        oy = (pl["long_deg"]
              - params.region_origin_longitude_deg) * DIST1LON
        oz = pl["depth_m"] - params.region_depth_shallow_m
        R = plane_rotation(dip, 0.0, pl["strike_deg"])
        local = np.stack([s_mid, d_mid, np.zeros_like(s_mid)])
        g = R @ local
        dx = g[0] + ox
        dy = g[1] + oy
        dz = g[2] + oz
        az = params.region_azimuth_leftface_deg
        if az != 0.0:
            a = az * PI / 180
            rx = np.cos(a) * dx + np.sin(a) * dy
            ry = -np.sin(a) * dx + np.cos(a) * dy
            dx, dy = rx, ry
            strike = np.full(len(s_mid), pl["strike_deg"] - az)
        else:
            strike = np.full(len(s_mid), pl["strike_deg"])

    # rupture initiation delay (compute_initial_time)
    hyp = np.array([pl["hypocenter_along_strike_m"],
                    pl["hypocenter_down_dip_m"], 0.0])
    dist = np.sqrt((s_mid - hyp[0]) ** 2 + (d_mid - hyp[1]) ** 2)
    delay = dist / pl["average_rupture_velocity"]

    # numStepsNecessary (quakesource.c:2762-2781)
    time_windows = np.asarray(pl["time_windows"])
    t_win = time_windows.sum()
    corners_s = np.array([grd_strk[0], grd_strk[-1]])
    corners_d = np.array([grd_dip[0], grd_dip[-1]])
    t_size = 0.0
    for cs in corners_s:
        for cd in corners_d:
            t_size = max(t_size, np.hypot(cs - hyp[0], cd - hyp[1])
                         / pl["average_rupture_velocity"])
    num_steps = int(1.1 * (t_win + t_size) / params.delta_t)

    return {
        "x": dx, "y": dy, "z": dz,
        "strike": strike, "dip": np.full(len(s_mid), dip),
        "area": area, "delay": delay,
        "cell_i": cell_i, "cell_j": cell_j,
        "s_mid": s_mid, "d_mid": d_mid,
        "num_steps": num_steps,
        "time_windows": time_windows,
    }


def batched_nodal_forces(strike, dip, rake, x, y, z, h):
    """Vectorized source_initnodalforce (quakesource.c:420-475) over P
    point sources.  Returns [P, 8, 3] nodal weight vectors."""
    s = np.asarray(strike) / 180.0 * PI
    d = np.asarray(dip) / 180.0 * PI
    r = np.asarray(rake) / 180.0 * PI
    P = len(s)
    hcube = h ** 3

    n = np.stack([-np.sin(s) * np.sin(d),
                  np.cos(s) * np.sin(d),
                  -np.cos(d)], axis=1)                  # [P, 3]
    t = np.stack([np.cos(r) * np.sin(PI / 2 - s)
                  + np.sin(r) * np.sin(s) * np.cos(d),
                  np.cos(r) * np.sin(s)
                  - np.sin(r) * np.cos(s) * np.cos(d),
                  -np.sin(r) * np.sin(d)], axis=1)
    v = n[:, :, None] * t[:, None, :] + t[:, :, None] * n[:, None, :]

    xi = np.array([
        [-1, 1, -1, 1, -1, 1, -1, 1],
        [-1, -1, 1, 1, -1, -1, 1, 1],
        [-1, -1, -1, -1, 1, 1, 1, 1],
    ], dtype=np.float64)

    grads = np.empty((P, 8, 3))
    for j in range(8):
        dx = (2 * xi[0][j]) * (h + 2 * xi[1][j] * y) \
            * (h + 2 * xi[2][j] * z) / (8 * hcube)
        dy = (2 * xi[1][j]) * (h + 2 * xi[2][j] * z) \
            * (h + 2 * xi[0][j] * x) / (8 * hcube)
        dz = (2 * xi[2][j]) * (h + 2 * xi[0][j] * x) \
            * (h + 2 * xi[1][j] * y) / (8 * hcube)
        grads[:, j, 0] = dx
        grads[:, j, 1] = dy
        grads[:, j, 2] = dz
    return np.einsum("pkc,pjc->pjk", v, grads)


def accumulate_plane_displacement(sm, params, pts, idx):
    """Slip time series for subcell ``idx``: window-accumulated source
    functions (update_point_source, quakesource.c:1259-1296),
    truncated after num_steps.  Returns (disp [T], rake_last,
    slip_total)."""
    pl = sm.plane
    T = params.total_steps
    n_use = min(pts["num_steps"], T)
    t = params.delta_t * np.arange(n_use)
    disp = np.zeros(T)
    ci, cj = pts["cell_i"][idx], pts["cell_j"][idx]
    rake = 0.0
    slip_total = 0.0
    acc = np.zeros(n_use)
    for w in range(len(pts["time_windows"])):
        rake = pl["rake"][w][ci, cj]
        slip = pl["slip"][w][ci, cj]
        slip_total += slip
        delay = pts["delay"][idx] + _window_delay(pts["time_windows"], w)
        decay = compute_source_function(
            sm.source_function_type, t, T0=sm.average_risetime,
            Ts=sm.ricker_ts, Tp=sm.ricker_tp, delay=delay)
        acc += decay * slip
    disp[:n_use] = acc
    return disp, rake, slip_total


def _window_delay(time_windows, w):
    """theWindowDelay[iWindow] added per window (quakesource.c:1283)."""
    return time_windows[w]
