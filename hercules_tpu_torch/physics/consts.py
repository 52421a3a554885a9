"""Solver constants: Rayleigh a/b bases, per-element coefficients,
lumped node masses with absorbing-boundary dashpots, stability checks.

Mirrors compute_setab (psolve.c:5813-5876), solver_init's element/node
loops (psolve.c:3360-3473), mu_and_lambda (psolve.c:3236-3278),
compute_setflag / theIDBoundaryMatrix / compute_setboundary
(psolve.c:5630-5805) and solver_set_critical_T (psolve.c:2779-3140),
vectorized over elements.

The reference's default build enables -DBOUNDARY -DHALFSPACE
(quake/forward/Makefile:19): absorbing dashpots on the four sides and
bottom, free surface on top.

The port's copy of ``hercules_tpu/physics/consts.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np

PI = np.pi


def compute_setab(freq: float, damping_type: str):
    """Rayleigh/mass damping a,b bases (to be scaled by per-element
    zeta).  psolve.c:5813-5876."""
    if damping_type == "rayleigh":
        w1 = 2 * PI * freq * 0.2
        w2 = 2 * PI * freq * 1.0
        lw1, lw2 = np.log(w1), np.log(w2)
        sw1, sw2 = w1 * w1, w2 * w2
        cw1, cw2 = w1 ** 3, w2 ** 3
        numer = w1 * w2 * (-2 * sw1 * lw2 + 2 * sw1 * lw1
                           - 2 * w1 * w2 * lw2 + 2 * w1 * w2 * lw1
                           + 3 * sw2 - 3 * sw1 - 2 * sw2 * lw2
                           + 2 * sw2 * lw1)
        denom = cw1 - cw2 + 3 * sw2 * w1 - 3 * sw1 * w2
        a_base = numer / denom
        numer = 3 * (2 * w1 * w2 * lw2 - 2 * w1 * w2 * lw1 + sw1 - sw2)
        b_base = numer / denom
        return a_base, b_base
    if damping_type == "mass":
        w1 = 2 * PI * freq * 0.1
        w2 = 2 * PI * freq * 8
        numer = 2 * w2 * w1 * np.log(w2 / w1)
        denom = w2 - w1
        return 1.3 * numer / denom, 0.0
    # none | bkt
    return 0.0, 0.0


def mu_and_lambda(vp, vs, rho, threshold_vpvs):
    """Vectorized mu_and_lambda (psolve.c:3236-3278).  Returns
    (mu, lambda, vp_adjusted)."""
    vp = np.asarray(vp, dtype=np.float64).copy()
    mu = rho * vs * vs
    lam = np.where(vp > vs * threshold_vpvs,
                   rho * vs * vs * threshold_vpvs ** 2 - 2 * mu,
                   rho * vp * vp - 2 * mu)
    neg = lam < 0
    if neg.any():
        # Poisson-ratio fix (psolve.c:3253-3262): adjust Vp, then
        # lambda = rho * Vp^2 (the reference drops the -2mu here)
        vp_fix = np.where(vs < 500, 2.45 * vs,
                          np.where(vs < 1200, 2.0 * vs, 1.87 * vs))
        vp = np.where(neg, vp_fix, vp)
        lam = np.where(neg, rho * vp * vp, lam)
    if (lam < 0).any():
        raise ValueError("negative lambda after Poisson fix")
    return mu, lam, vp


def element_coefficients(props, edge_m, params, a_base, b_base):
    """Per-element c1..c4 (+ zeta, a, b) as in solver_init
    (psolve.c:3380-3409)."""
    vp, vs, rho = props["Vp"], props["Vs"], props["rho"]
    mu, lam, vp = mu_and_lambda(vp, vs, rho, params.threshold_vpvs)
    dt = params.delta_t
    dt2 = dt * dt
    c1 = dt2 * edge_m * mu / 9.0
    c2 = dt2 * edge_m * lam / 9.0
    zeta = np.minimum(10.0 / vs, params.threshold_damping)
    a = zeta * a_base
    b = zeta * b_base
    c3 = b * dt * edge_m * mu / 9.0
    c4 = b * dt * edge_m * lam / 9.0
    return {"c1": c1, "c2": c2, "c3": c3, "c4": c4,
            "zeta": zeta, "a": a, "b": b, "mu": mu, "lambda": lam,
            "Vp": vp}


def boundary_flags(mesh):
    """Per-element (fx, fy, fz) in {-1,0,1}: which domain faces the
    element touches (compute_setflag, psolve.c:5630-5714)."""
    e = mesh.edgeticks()
    far = mesh.farendp

    def axis_flag(lo, axis):
        hi = lo.astype(np.int64) + e
        return (np.where(lo == 0, -1, 0)
                + np.where(hi == far[axis], 1, 0)).astype(np.int8)

    return (axis_flag(mesh.elem_x, 0), axis_flag(mesh.elem_y, 1),
            axis_flag(mesh.elem_z, 2))


def boundary_dashpots(mesh, props, halfspace=True):
    """Per-element-node dashpot coefficients [E, 8, 3]
    (compute_setboundary, psolve.c:5752-5805): each domain face a node
    lies on contributes Vp in the face-normal direction and Vs in the
    two tangential directions, scaled by rho*(h/2)^2.

    halfspace=True (-DHALFSPACE): the free surface (z=0) contributes no
    dashpot (flag < 9 -> flag + 9 remap, psolve.c:5761-5763)."""
    eb, dash_b = _boundary_dashpots_subset(mesh, props,
                                           halfspace=halfspace)
    dash = np.zeros((mesh.lenum, 8, 3))
    dash[eb] = dash_b
    return dash


def _boundary_dashpots_subset(mesh, props, halfspace=True):
    """(eb, dash_b): boundary-element indices and their [Eb, 8, 3]
    dashpots — the sparse form of boundary_dashpots (interior elements
    are all zero, so node_masses never materializes the full [E, 8, 3]
    array)."""
    fx, fy, fz = boundary_flags(mesh)
    if halfspace:
        fz = np.where(fz == -1, 0, fz).astype(np.int8)
    eb = np.flatnonzero((fx != 0) | (fy != 0) | (fz != 0))
    vp = props["Vp"][eb]
    vs = props["Vs"][eb]
    rho = props["rho"][eb]
    h = mesh.edge_m[eb]
    scale = rho * (h / 2) ** 2
    Eb = len(eb)
    w = np.arange(8)
    node_bit = np.stack([(w & 1), (w >> 1) & 1, (w >> 2) & 1])
    flags = np.stack([fx[eb], fy[eb], fz[eb]])
    on = np.zeros((3, Eb, 8), dtype=bool)
    for axis in range(3):
        f = flags[axis][:, None]
        nb = node_bit[axis][None, :]
        on[axis] = ((f == -1) & (nb == 0)) | ((f == 1) & (nb == 1))
    faces_on = on.sum(axis=0).astype(np.float64)
    dash_b = np.empty((Eb, 8, 3))
    for comp in range(3):
        oc = on[comp].astype(np.float64)
        dash_b[:, :, comp] = (vs[:, None] * (faces_on - oc)
                              + vp[:, None] * oc)
    dash_b *= scale[:, None, None]
    return eb, dash_b


def node_masses(mesh, props, coeffs, params, boundary=True,
                halfspace=True):
    """Lumped node masses (solver_init, psolve.c:3411-3473):
    mass_simple[N], mass_minusaM[N,3], mass2_minusaM[N,3], including
    dashpot folding and the dangling-node mass distribution
    (DN/AN mass messages + compute_adjust DISTRIBUTION,
    psolve.c:3475-3507)."""
    N = mesh.nnum
    E = mesh.lenum
    dt = params.delta_t
    rho = props["rho"]
    h = mesh.edge_m
    M = rho * h ** 3 / 8.0          # per corner
    a = coeffs["a"]

    lnid = mesh.elem_lnid.ravel()
    M8 = np.repeat(M, 8)
    aM8 = np.repeat(dt * a * M, 8)

    # bincount is the fast scatter-add here (ufunc.at is unbuffered
    # and ~10x slower on multi-million-entry index arrays)
    mass_simple = np.bincount(lnid, weights=M8, minlength=N)

    base = M8 - aM8                  # per element-node, same all axes
    base2 = 2 * M8 - aM8
    accA = np.bincount(lnid, weights=base, minlength=N)
    accB = np.bincount(lnid, weights=base2, minlength=N)
    mass_minusaM = np.repeat(accA[:, None], 3, axis=1)
    mass2_minusaM = np.repeat(accB[:, None], 3, axis=1)
    if boundary:
        # the dashpot term is sparse (boundary elements only); scatter
        # just those corners per component
        eb, dash_b = _boundary_dashpots_subset(mesh, props,
                                               halfspace=halfspace)
        lnid_b = mesh.elem_lnid[eb].ravel()
        for c in range(3):
            dcol = np.bincount(lnid_b,
                               weights=dash_b[:, :, c].ravel(),
                               minlength=N)
            mass_minusaM[:, c] -= dt * dcol
            mass2_minusaM[:, c] -= dt * dcol

    # distribute dangling-node masses to anchors (DISTRIBUTION of the
    # whole n_t record; dangling nodes keep their own copy, which the
    # per-step ASSIGNMENT then makes irrelevant)
    dn = mesh.dn_ids
    if len(dn):
        anc = mesh.dn_anchors.ravel()  # [D*4]
        wgt = mesh.dn_weights          # [D,4]
        mass_simple += np.bincount(
            anc, weights=(mass_simple[dn][:, None] * wgt).ravel(),
            minlength=N)
        for c in range(3):
            mass_minusaM[:, c] += np.bincount(
                anc, weights=(mass_minusaM[dn, c][:, None]
                              * wgt).ravel(), minlength=N)
            mass2_minusaM[:, c] += np.bincount(
                anc, weights=(mass2_minusaM[dn, c][:, None]
                              * wgt).ravel(), minlength=N)

    return mass_simple, mass_minusaM, mass2_minusaM


def critical_dt(props, edge_m):
    """min h/Vp over elements (solver_set_critical_T's theCriticalT,
    psolve.c:3002; also the AUTO_DELTA_T override value, :3033-3040)."""
    return float(np.min(edge_m / props["Vp"]))


def critical_dt_factors(props, edge_m, params):
    """Reference-exact stability factors (solver_set_critical_T,
    psolve.c:2864-2872): per element

      ratio = h/Vp,  zeta = min(10/Vs, threshold),
      omega = 3.4641.../ratio, xi = a/(2w) + b*w/2,
      dt_X = 0.57735 (1 - xi) ratio,  dt_Z = 0.57735 (1 - zeta) ratio

    Returns (min h/Vp, min dt_X, min dt_Z).  The actual CFL bound for
    the damped explicit scheme is min(dt_X, dt_Z), tighter than the
    bare h/Vp the reference reports as theCriticalT."""
    vp, vs = props["Vp"], props["Vs"]
    ratio = edge_m / vp
    zeta = np.minimum(10.0 / vs, params.threshold_damping)
    a_base, b_base = compute_setab(params.freq, params.type_of_damping)
    omega = 3.46410161514 / ratio
    a = zeta * a_base
    b = zeta * b_base
    xi = a / (2 * omega) + b * omega / 2
    dt_x = 0.57735026919 * (1 - xi) * ratio
    dt_z = 0.57735026919 * (1 - zeta) * ratio
    return float(ratio.min()), float(dt_x.min()), float(dt_z.min())
