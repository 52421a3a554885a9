"""Material assignment: refinement-time setrec, the Vs rule, and the
post-partition property correction (incl. BKT attenuation coefficients).

Mirrors setrec (psolve.c:1307-1397), vsrule (quake_util.c:215-226),
mesh_correct_properties (psolve.c:7104-7331), the 26x6 quality-factor
table (psolve.c:5575-5616) and Search_Quality_Table
(quake_util.c:128-168), all vectorized over elements.

The port's copy of ``hercules_tpu/material.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mesh.octree import PIXELLEVEL
from .cvm import CVM, DIST1LAT, DIST1LON

# Quality-factor table (psolve.c:5578-5604): rows of
# [Q, a0, a1, g0, g1, b].  Only the first 18 rows are installed by
# constract_Quality_Factor_Table (psolve.c:5605-5612).
QTABLE = np.array([
    [5., 0.211111102, 0.236842104, 0.032142857, 0.271428571, 0.14],
    [6.25, 0.188888889, 0.184210526, 0.039893617, 0.336879433, 0.10152],
    [8.33, 0.157777778, 0.139473684, 0.045, 0.38, 0.07],
    [10., 0.137777765, 0.12105263, 0.032942899, 0.27818448, 0.0683],
    [15., 0.097777765, 0.08105263, 0.032942899, 0.27818448, 0.045],
    [20., 0.078139527, 0.060526314, 0.031409788, 0.277574872, 0.034225],
    [25., 0.064285708, 0.049999999, 0.031578947, 0.285714286, 0.0266],
    [30., 0.053658537, 0.044736842, 0.026640676, 0.24691358, 0.023085],
    [35., 0.046341463, 0.038157895, 0.02709848, 0.251156642, 0.019669],
    [40., 0.040487805, 0.034210526, 0.025949367, 0.240506329, 0.01738],
    [45., 0.036585366, 0.028947368, 0.031393568, 0.290964778, 0.014366],
    [50., 0.032926829, 0.026315789, 0.032488114, 0.30110935, 0.01262],
    [60., 0.0279, 0.0223, 0.0275, 0.2545, 0.0114],
    [70., 0.024, 0.019, 0.032488114, 0.30110935, 0.0083],
    [80., 0.0207, 0.0174, 0.0251, 0.2326, 0.0088],
    [90., 0.0187, 0.0154, 0.0244, 0.2256, 0.0079],
    [100., 0.017, 0.014, 0.028021016, 0.288966725, 0.006281],
    [120., 0.0142, 0.0115, 0.0280, 0.2700, 0.0052],
])


@dataclass
class MeshOrigin:
    """Offset of the mesh coordinate system inside the CVM etree domain
    (psolve.c:1107-1111)."""

    x: float = 0.0   # south-north
    y: float = 0.0   # east-west
    z: float = 0.0

    @classmethod
    def from_params(cls, params, ctl):
        return cls(
            x=(params.region_origin_latitude_deg
               - ctl.region_origin_latitude_deg) * DIST1LAT,
            y=(params.region_origin_longitude_deg
               - ctl.region_origin_longitude_deg) * DIST1LON,
            z=(params.region_depth_shallow_m - ctl.region_depth_shallow_m),
        )


def make_setrec(cvm: CVM, params, origin: MeshOrigin, buildings=None):
    """Vectorized setrec: min Vs over a 3x3x3 sample grid inside each
    leaf, VsCut clamp, out-of-bound force-split (psolve.c:1307-1397);
    with buildings: property overrides + air + z-shifted CVM queries
    (psolve.c:1328-1330,1355-1357)."""
    points = np.array([0.01, 1.0, 1.99])
    zshift = buildings.surface_shift if buildings is not None else 0.0

    def setrec(tree, hi, lo, lv):
        from .etree import morton
        x, y, z = morton.deinterleave3(hi, lo)
        x = x.astype(np.float64)
        y = y.astype(np.float64)
        z = z.astype(np.float64)
        half = (np.int64(1) << (PIXELLEVEL - lv.astype(np.int64) - 1)
                ).astype(np.float64)
        ts = tree.ticksize
        n = len(x)
        fast = _fast_sample27(cvm, x, y, z, half, ts, origin, zshift,
                              points, mode=0)
        if fast is not None:
            vp_min, vs_min, rho_min, any_ok = fast
        else:
            vs_min = np.full(n, np.inf)
            vp_min = np.full(n, np.nan)
            rho_min = np.full(n, np.nan)
            any_ok = np.zeros(n, dtype=bool)
            for px in points:
                x_m = origin.x + (x + px * half) * ts
                for py in points:
                    y_m = origin.y + (y + py * half) * ts
                    for pz in points:
                        z_m = origin.z + (z + pz * half) * ts - zshift
                        ok, vp, vs, rho = cvm.query(y_m, x_m, z_m)
                        upd = ok & (vs < vs_min)
                        vs_min = np.where(upd, vs, vs_min)
                        vp_min = np.where(upd, vp, vp_min)
                        rho_min = np.where(upd, rho, rho_min)
                        any_ok |= ok
        edgesize = 2.0 * half * ts
        # all queries failed: force a split by synthesizing a tiny Vs
        # (psolve.c:1386-1389)
        vs_min = np.where(any_ok, vs_min, params.factor * edgesize / 2)
        # VsCut clamp (psolve.c:1390-1395)
        cut = any_ok & (vs_min <= params.vscut)
        ratio = np.where(cut, vp_min / vs_min, 1.0)
        vp_min = np.where(cut, params.vscut * ratio, vp_min)
        vs_min = np.where(cut, params.vscut, vs_min)
        rec = {"Vp": vp_min, "Vs": vs_min, "rho": rho_min,
               "edgesize": edgesize}
        if buildings is not None:
            buildings.setrec_override(x * ts, y * ts, z * ts, edgesize,
                                      rec, cvm, origin, ts)
        return rec

    return setrec


def _fast_sample27(cvm, X, Y, Z, half_or_edge, ts, origin, zshift,
                   points, mode):
    """Native fused 27-point sampling when the CVM is an in-memory
    etree with a dense lookup (reader._dense_lut): bit-identical to
    the numpy loop (same float sequences, same reduction order), one
    C pass instead of 27 vectorized query passes.  Returns
    (vp, vs, rho, ok) or None (fall back to the numpy loop)."""
    from . import native
    from .cvm import CVM as _CVM

    if not isinstance(cvm, _CVM) or cvm.db.out_of_core:
        return None
    dense, sh = cvm.db._dense_lut()
    if dense is None:
        return None
    cols = cvm._field_arrays()
    if cols is None:
        return None
    r = native.cvm_sample27(
        X, Y, Z, half_or_edge, ts, (origin.x, origin.y, origin.z),
        zshift, points, cvm.ticksize,
        (cvm.ctl.domain_endpoint_x, cvm.ctl.domain_endpoint_y,
         cvm.ctl.domain_endpoint_z), dense, sh, cols, mode)
    if r is None:
        return None
    ovp, ovs, orho, ook = r
    if mode == 0:
        ok = ook != 0
        nan = np.where(ok, 1.0, np.nan)
        return ovp * nan, np.where(ok, ovs, np.inf), orho * nan, ok
    return ovp, ovs, orho, ook


def make_toexpand(params, buildings=None):
    """vsrule (quake_util.c:215-226): split while edge > Vs/factor;
    buildings tri-state takes precedence (psolve.c toexpand
    :2184-2210)."""

    def toexpand(tree, hi, lo, lv, rec):
        vs_split = rec["edgesize"] > rec["Vs"] / params.factor
        if buildings is None:
            return vs_split
        from .etree import morton
        x, y, z = morton.deinterleave3(hi, lo)
        ts = tree.ticksize
        res = buildings.toexpand(x * ts, y * ts, z * ts,
                                 rec["edgesize"], rec["Vs"],
                                 params.factor)
        return np.where(res >= 0, res == 1, vs_split)

    return toexpand


def search_quality_table(q: np.ndarray) -> np.ndarray:
    """Vectorized Search_Quality_Table (quake_util.c:128-168): nearest
    table row by |Q - row| (earlier row wins ties); Q > 500 -> -1,
    meaning no attenuation (zero coefficients)."""
    qs = QTABLE[:, 0]
    mids = (qs[:-1] + qs[1:]) / 2.0
    idx = np.searchsorted(mids, q, side="left")
    return np.where(q > 500.0, -1, idx)


def bkt_attenuation(vp, vs, params):
    """BKT attenuation coefficients + Q-based velocity dispersion
    correction for element arrays (vp, vs) — the damping block of
    mesh_correct_properties (psolve.c:7240-7331), factored out so the
    physics validation suite can drive it directly.

    Returns (props_update, vp_new, vs_new): props_update maps
    '{a0,a1,g0,g1,b}_{shear,kappa}' to per-element arrays; vp_new/vs_new
    carry the dispersion correction (identical to the inputs when
    params.freq_vel == 0)."""
    E = len(vp)
    props = {}
    vksq = vp * vp - 4.0 / 3.0 * vs * vs
    vs_vp = vs / vp
    vskm = vs * 0.001
    L = 4.0 / 3.0 * vs_vp * vs_vp
    # Brocher (2008) fit (psolve.c:7258)
    qs = 10.5 + vskm * (-16. + vskm * (153. + vskm * (-103. + vskm * (
        34.7 + vskm * (-5.29 + vskm * 0.31)))))
    qp = 2.0 * qs
    if params.use_infinite_qk:
        qk = np.full(E, 1000.0)
    else:
        qk = (1.0 - L) / (1.0 / qp - L / qs)

    for name, q in (("shear", qs), ("kappa", qk)):
        idx = search_quality_table(q)
        none = idx < 0
        safe = np.maximum(idx, 0)
        for ci, coef in enumerate(("a0", "a1", "g0", "g1", "b")):
            col = QTABLE[safe, ci + 1]
            props[f"{coef}_{name}"] = np.where(none, 0.0, col)

    # Q-based velocity dispersion correction (psolve.c:7313-7328)
    if params.freq_vel != 0.0:
        w = params.freq_vel / params.freq
        a0s, a1s = props["a0_shear"], props["a1_shear"]
        g0s, g1s = props["g0_shear"], props["g1_shear"]
        active = (a0s != 0) & (a1s != 0)
        corr = np.sqrt(np.maximum(0.0, 1.0 - (
            a0s * g0s * g0s / (g0s * g0s + w * w)
            + a1s * g1s * g1s / (g1s * g1s + w * w))))
        vs = np.where(active, corr * vs, vs)
        a0k, a1k = props["a0_kappa"], props["a1_kappa"]
        g0k, g1k = props["g0_kappa"], props["g1_kappa"]
        activek = (a0k != 0)  # reference checks a0 twice (:7322)
        corrk = np.sqrt(np.maximum(0.0, 1.0 - (
            a0k * g0k * g0k / (g0k * g0k + w * w)
            + a1k * g1k * g1k / (g1k * g1k + w * w))))
        vp = np.where(
            activek,
            np.sqrt(corrk * corrk * vksq + 4.0 / 3.0 * vs * vs), vp)
    return props, vp, vs


def correct_properties(mesh, cvm: CVM, params, origin: MeshOrigin,
                       buildings=None):
    """mesh_correct_properties (psolve.c:7104-7331): re-query the CVM at
    27 points per element, average, apply softening + VsCut, compute BKT
    coefficients and Q-based velocity dispersion correction.

    Fills mesh.props with Vp, Vs, rho (+ BKT coefficient arrays).
    """
    pts = np.array([0.005, 0.5, 0.995])
    ts = mesh.ticksize
    ex = mesh.elem_x.astype(np.float64)
    ey = mesh.elem_y.astype(np.float64)
    ez = mesh.elem_z.astype(np.float64)
    edge = mesh.edge_m
    E = mesh.lenum
    zshift = buildings.surface_shift if buildings is not None else 0.0

    # building/foundation elements keep their table properties
    # (bldgs_correctproperties, psolve.c:7137-7141)
    skip = np.zeros(E, dtype=bool)

    fast = None
    if buildings is None:
        fast = _fast_sample27(cvm, ex, ey, ez, edge, ts, origin,
                              zshift, pts, mode=1)
    if fast is not None:
        vp, vs, rho, nok = fast
        if not (nok == 27).all():
            bad = np.flatnonzero(nok != 27)[:5]
            raise RuntimeError(
                f"mesh_correct_properties: CVM query failed for "
                f"elements {bad}")
    else:
        vp = np.zeros(E)
        vs = np.zeros(E)
        rho = np.zeros(E)
        for pn in pts:
            north_m = ts * ex + edge * pn + origin.x
            for pe in pts:
                east_m = ts * ey + edge * pe + origin.y
                for pd in pts:
                    depth_m = ts * ez + edge * pd + origin.z - zshift
                    ok, qvp, qvs, qrho = cvm.query(east_m, north_m,
                                                   depth_m)
                    if buildings is not None:
                        # above-surface sample points belong to
                        # buildings
                        ok = ok | (depth_m < 0)
                        qvp = np.where(np.isnan(qvp), 0.0, qvp)
                        qvs = np.where(np.isnan(qvs), 0.0, qvs)
                        qrho = np.where(np.isnan(qrho), 0.0, qrho)
                    if not ok.all():
                        bad = np.flatnonzero(~ok)[:5]
                        raise RuntimeError(
                            f"mesh_correct_properties: CVM query "
                            f"failed for elements {bad}")
                    vp += qvp
                    vs += qvs
                    rho += qrho
    vp /= 27.0
    vs /= 27.0
    rho /= 27.0

    with np.errstate(invalid="ignore", divide="ignore"):
        vpvs = vp / vs
        rhovp = rho / vp

    # softening (psolve.c:7211-7228)
    if params.softening_factor > 0:
        ideal = edge * params.factor
        factored = ideal * params.softening_factor
        m = vs > factored
        vs = np.where(m, factored, vs)
        vp = np.where(m, factored * vpvs, vp)
        rho = np.where(m, vp * rhovp, rho)

    # VsCut (psolve.c:7230-7236); rho deliberately not adjusted
    m = vs < params.vscut
    vs = np.where(m, params.vscut, vs)
    vp = np.where(m, params.vscut * vpvs, vp)

    props = {"Vp": vp, "Vs": vs, "rho": rho}

    if params.type_of_damping == "bkt":
        upd, vp, vs = bkt_attenuation(vp, vs, params)
        props.update(upd)
        props["Vp"] = vp
        props["Vs"] = vs
    else:
        zeros = np.zeros(E)
        for name in ("shear", "kappa"):
            for coef in ("a0", "a1", "g0", "g1", "b"):
                props[f"{coef}_{name}"] = zeros

    if buildings is not None:
        # building/foundation elements bypass softening/VsCut/BKT
        # entirely (the reference 'continue's before them,
        # psolve.c:7137-7141); re-impose table properties and zero
        # their attenuation coefficients
        skip = buildings.correct_properties(mesh, props)
        if skip.any():
            for name in ("shear", "kappa"):
                for coef in ("a0", "a1", "g0", "g1", "b"):
                    props[f"{coef}_{name}"] = np.where(
                        skip, 0.0, props[f"{coef}_{name}"])

    mesh.props = props
    return props
