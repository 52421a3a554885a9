"""Nonlinear (elastoplastic) soil response.

Counterpart of ``hercules_tpu/nonlinear.py``.  Its numpy parts are
copied (``strain_operator``, ``force_operator``, ``NonlinearConfig``,
``NLTables``, ``build_nonlinear_tables``, ``smooth_rise_factor``,
``NL_STATION_HEADER``, ``nonlinear_station_series``,
``station_constants``; ``tests/test_torch_host.py`` holds them equal);
its jnp parts (``nl_device_tables``, ``nl_stress``, ``nl_invariants``,
``nl_state_update``, ``nl_force``) are plain torch functions on
tensors, which the unstructured solver (``solver/step.py``) and the
mesh route's subset pass (``solver/fused_mesh.py``) call.  The JAX
package computes them in XLA, outside any Pallas kernel.

The reference's nonlinear.c (2230 lines), vectorized over the
nonlinear element subset:

- material models LINEAR / VONMISES / DRUCKERPRAGER with cohefriction
  or alphakay property tables interpolated by element Vs
  (nonlinear_initparameters :266-404, get_alpha/get_kay :142-196)
- quadrature-point strain/stress via constant shape-gradient operators
  (point_strain :873, point_dxi :802, qc = 1/sqrt(3))
- yield surface fs = alpha*I1 + sqrt(J2) (:991), plastic multiplier
  compute_dLambdaII (:1052, rate-dependent and rate-independent with
  linear hardening), plastic strain update (:1100)
- element force correction -dt^2 * Integral(grad(phi) . sigma)
  (compute_addforce_nl :1544-1670)
- geostatic gravity loading: smooth rise factor (:1244), bottom
  reactions (:1436), displacement fix (:1506)

The per-step state lives as [Enl, 8qp, 6] tensors in Voigt order
(xx, yy, zz, xy, yz, xz).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .physics.consts import mu_and_lambda

QC = 0.577350269189  # 1/sqrt(3), quadrature point coordinate
G = 9.8

XI = np.array([
    [-1, 1, -1, 1, -1, 1, -1, 1],
    [-1, -1, 1, 1, -1, -1, 1, 1],
    [-1, -1, -1, -1, 1, 1, 1, 1],
], dtype=np.float64)


def _dxi_unit(lx, ly, lz, i):
    """Shape-gradient of node i at local coords, for unit h (point_dxi
    with h=1: J = 0.25)."""
    dx = 0.25 * XI[0][i] * (1 + XI[1][i] * ly) * (1 + XI[2][i] * lz)
    dy = 0.25 * (1 + XI[0][i] * lx) * XI[1][i] * (1 + XI[2][i] * lz)
    dz = 0.25 * (1 + XI[0][i] * lx) * (1 + XI[1][i] * ly) * XI[2][i]
    return dx, dy, dz


def _grad_table():
    """DX[j, i, 3]: gradients (unit h) of node i at quadrature point j."""
    DX = np.zeros((8, 8, 3))
    for j in range(8):
        lx, ly, lz = XI[0][j] * QC, XI[1][j] * QC, XI[2][j] * QC
        for i in range(8):
            DX[j, i] = _dxi_unit(lx, ly, lz, i)
    return DX


def strain_operator():
    """S[8qp, 6, 24] with strain[j] = (1/h) * S[j] @ u24 (node-major
    u: index 3i+c), Voigt (xx,yy,zz,xy,yz,xz) with engineering 0.5
    factors on the shear terms (point_strain)."""
    DX = _grad_table()
    S = np.zeros((8, 6, 24))
    for j in range(8):
        for i in range(8):
            dx, dy, dz = DX[j, i]
            S[j, 0, 3 * i + 0] += dx
            S[j, 1, 3 * i + 1] += dy
            S[j, 2, 3 * i + 2] += dz
            S[j, 3, 3 * i + 0] += 0.5 * dy
            S[j, 3, 3 * i + 1] += 0.5 * dx
            S[j, 4, 3 * i + 1] += 0.5 * dz
            S[j, 4, 3 * i + 2] += 0.5 * dy
            S[j, 5, 3 * i + 0] += 0.5 * dz
            S[j, 5, 3 * i + 2] += 0.5 * dx
    return S


def force_operator():
    """F[8qp, 24, 6] with f24 = (h^2/8) * sum_j F[j] @ sigma[j]
    (compute_addforce_nl's Gauss integration; WiJi = h^3/8 and
    gradients carry 1/h)."""
    DX = _grad_table()
    F = np.zeros((8, 24, 6))
    for j in range(8):
        for i in range(8):
            dx, dy, dz = DX[j, i]
            F[j, 3 * i + 0, 0] += dx
            F[j, 3 * i + 0, 3] += dy
            F[j, 3 * i + 0, 5] += dz
            F[j, 3 * i + 1, 1] += dy
            F[j, 3 * i + 1, 3] += dx
            F[j, 3 * i + 1, 4] += dz
            F[j, 3 * i + 2, 2] += dz
            F[j, 3 * i + 2, 4] += dy
            F[j, 3 * i + 2, 5] += dx
    return F


@dataclass
class NonlinearConfig:
    material_model: str = "linear"        # linear|vonmises|druckerprager
    properties_type: str = "cohefriction"  # cohefriction|alphakay
    plasticity_type: str = "rate_dependant"
    vs_cut: float = 0.0
    vs_min: float = 0.0
    geostatic_loading_t: float = 0.0
    geostatic_cushion_t: float = 0.0
    vs_limits: Optional[np.ndarray] = None
    alpha_cohes: Optional[np.ndarray] = None
    kay_phis: Optional[np.ndarray] = None
    strain_rates: Optional[np.ndarray] = None
    sensitivities: Optional[np.ndarray] = None
    hardening: Optional[np.ndarray] = None

    @classmethod
    def parse(cls, cfg):
        """nonlinear_initparameters (nonlinear.c:266-404)."""
        c = cls()
        c.vs_cut = cfg.get_double("nonlinear_shear_velocity_cut",
                                  required=True)
        c.vs_min = cfg.get_double("nonlinear_shear_velocity_min", 0.0)
        c.geostatic_loading_t = cfg.get_double(
            "geostatic_loading_time_sec", 0.0)
        c.geostatic_cushion_t = cfg.get_double(
            "geostatic_cushion_time_sec", 0.0)
        c.material_model = cfg.get_string("material_model",
                                          "linear").lower()
        c.properties_type = cfg.get_string("material_properties_type",
                                           "cohefriction").lower()
        c.plasticity_type = cfg.get_string("material_plasticity_type",
                                           "rate_dependant").lower()
        n = cfg.get_int("material_properties_count", required=True)
        tbl = cfg.get_table("material_properties_list", n, 6)
        c.vs_limits = tbl[:, 0]
        c.alpha_cohes = tbl[:, 1]
        c.kay_phis = tbl[:, 2]
        c.strain_rates = tbl[:, 3]
        c.sensitivities = tbl[:, 4]
        c.hardening = tbl[:, 5]
        return c

    def geostatic_final_step(self, dt):
        return int((self.geostatic_loading_t + self.geostatic_cushion_t)
                   / dt)

    # ------------------------------------------------------------------
    def _interp(self, vs, table):
        """interpolate_property_value: clamped linear interpolation."""
        return np.interp(vs, self.vs_limits, table)

    def alpha_k(self, vs):
        """get_alpha / get_kay (nonlinear.c:142-196)."""
        if self.material_model == "linear":
            z = np.zeros_like(vs)
            return z, z
        if self.properties_type == "alphakay":
            alpha = self._interp(vs, self.alpha_cohes)
            k = self._interp(vs, self.kay_phis)
        else:
            c = self._interp(vs, self.alpha_cohes)
            phi = self._interp(vs, self.kay_phis) * np.pi / 180.0
            alpha = 2 * np.sin(phi) / (np.sqrt(3.0) * (3 - np.sin(phi)))
            k = 6 * c * np.cos(phi) / (np.sqrt(3.0) * (3 - np.sin(phi)))
        if self.material_model == "vonmises":
            alpha = np.zeros_like(vs)
        return alpha, k


@dataclass
class NLTables:
    cfg: NonlinearConfig
    eidx: np.ndarray          # [Enl] global element indices
    mu: np.ndarray
    lam: np.ndarray
    alpha: np.ndarray
    k: np.ndarray
    hard: np.ndarray
    strainrate: np.ndarray
    sensitivity: np.ndarray
    h: np.ndarray             # edge size [Enl]
    # geostatic
    bot_eidx: np.ndarray = None   # [Eb] bottom elements
    bot_W: np.ndarray = None      # weight per bottom element
    grav_W: np.ndarray = None     # [E] per-element corner weight W

    @property
    def n(self):
        return len(self.eidx)


def build_nonlinear_tables(mesh, params, cfg: NonlinearConfig):
    vs = mesh.props["Vs"]
    sel = (vs <= cfg.vs_cut) & (vs >= cfg.vs_min)
    eidx = np.flatnonzero(sel)
    vse = vs[eidx]
    mu, lam, _ = mu_and_lambda(mesh.props["Vp"][eidx], vse,
                               mesh.props["rho"][eidx],
                               params.threshold_vpvs)
    alpha, k = cfg.alpha_k(vse)
    t = NLTables(
        cfg=cfg, eidx=eidx, mu=mu, lam=lam, alpha=alpha, k=k,
        hard=cfg._interp(vse, cfg.hardening),
        strainrate=cfg._interp(vse, cfg.strain_rates),
        sensitivity=cfg._interp(vse, cfg.sensitivities),
        h=mesh.edge_m[eidx],
    )
    if cfg.geostatic_loading_t > 0:
        depth = params.region_depth_deep_m
        ts = mesh.ticksize
        zhi = (mesh.elem_z.astype(np.float64)
               + mesh.edgeticks().astype(np.float64)) * ts
        t.bot_eidx = np.flatnonzero(np.abs(zhi - depth) < 1e-9)
        rho = mesh.props["rho"]
        t.grav_W = rho * mesh.edge_m ** 3 * G * 0.125
    return t


# ---------------------------------------------------------------------------
# device-side pieces (used by the solver step; torch tensors)

def nl_device_tables(t: NLTables, dtype, device="cuda"):
    """The per-element constants of ``t`` as tensors in ``dtype`` on
    ``device``, with the operators S [48, 24] and F [24, 48]."""
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    d = {
        "S": f(strain_operator().reshape(48, 24)),     # [48, 24]
        "F": f(force_operator().transpose(1, 0, 2).reshape(24, 48)),
        "mu": f(t.mu), "lam": f(t.lam), "alpha": f(t.alpha),
        "k": f(t.k), "hard": f(t.hard),
        "strainrate": f(t.strainrate),
        "sensitivity": f(t.sensitivity),
        "h": f(t.h),
        "model": t.cfg.material_model,
        "rate_dep": t.cfg.plasticity_type.startswith("rate_dep"),
    }
    return d


# The JAX package adds a scalar to the three normal components as a
# [..., 6] concatenation (the scalar, then zeros); here it is added in
# place to the [..., :3] slice: the same values, without a strided
# six-way copy (a torch.stack of that shape ran at a tenth of the
# card's memory rate).

def nl_stress(strain6, mu, lam):
    """point_stress, Voigt [..., 6] with engineering half-shears."""
    skk = strain6[..., 0] + strain6[..., 1] + strain6[..., 2]
    sig = (2.0 * mu)[..., None] * strain6
    sig[..., :3] += (lam * skk)[..., None]
    return sig


def nl_invariants(sig):
    I1 = sig[..., 0] + sig[..., 1] + sig[..., 2]
    dev = sig.clone()
    dev[..., :3] -= (I1 / 3.0)[..., None]
    J2 = 0.5 * (dev[..., 0] ** 2 + dev[..., 1] ** 2 + dev[..., 2] ** 2) \
        + dev[..., 3] ** 2 + dev[..., 4] ** 2 + dev[..., 5] ** 2
    return I1, dev, J2


def nl_state_update(d, ue24, state, dt):
    """compute_nonlinear_state (nonlinear.c:1671-1823), vectorized.

    ue24 [Enl, 24] current displacements; state = (stresses, pstrains,
    ep) with shapes [Enl, 8, 6], [Enl, 8, 6], [Enl, 8].
    Returns new state.  The branches not taken are guarded as the JAX
    package guards them (sqrt(J2) == 0, FsT <= 0), so no NaN enters
    through torch.where."""
    stresses, pstrains, ep = state
    Enl = ue24.shape[0]
    # strains at all qp: [Enl, 48] -> [Enl, 8, 6]
    tstr = (ue24 @ d["S"].T).reshape(Enl, 8, 6) / d["h"][:, None, None]
    mu, lam = d["mu"][:, None], d["lam"][:, None]

    if d["model"] == "linear":
        return (nl_stress(tstr, mu, lam), pstrains, ep)

    estr = tstr - pstrains
    sig = nl_stress(estr, mu, lam)
    I1, dev, J2 = nl_invariants(sig)
    sqJ2 = torch.sqrt(J2)
    alpha = d["alpha"]
    fs = alpha[:, None] * I1 + sqJ2

    # plastic multiplier (compute_dLambdaII)
    if d["rate_dep"]:
        factor = fs / d["k"][:, None]
        dlam = (d["strainrate"][:, None]
                * torch.pow(torch.clamp(factor, min=0.0),
                            1.0 / d["sensitivity"][:, None]))
    else:
        s = d["hard"][:, None]
        kap = d["lam"] + 2.0 * d["mu"] / 3.0
        phi_pt = torch.sqrt(0.5 + 3.0 * alpha ** 2)
        FsT = fs - d["k"][:, None] - s * ep
        denom = (d["mu"] + 9.0 * kap * alpha ** 2)[:, None] \
            + s * phi_pt[:, None]
        dlam = torch.where(FsT > 0, FsT / denom, torch.zeros_like(FsT))

    # dfds (guard J2 == 0)
    safe = torch.where(sqJ2 > 0, 2.0 * sqJ2, torch.ones_like(sqJ2))
    dfds = dev / safe[..., None]
    dfds[..., :3] += alpha[:, None, None]
    scale = (dt * dlam if d["rate_dep"] else dlam)[..., None]
    pstr2 = pstrains + scale * dfds
    phi_pt = torch.sqrt(0.5 + 3.0 * alpha ** 2)
    ep2 = ep + dlam * phi_pt[:, None]

    if not d["rate_dep"]:
        # corrected stress where plastic flow occurred
        sig2 = nl_stress(tstr - pstr2, mu, lam)
        sig = torch.where((dlam > 0)[..., None], sig2, sig)

    return (sig, pstr2, ep2)


def nl_state_shapes(t: NLTables):
    """Shapes of the plastic state both routes carry: stresses and
    plastic strains [Enl, 8, 6], ep [Enl, 8][, with geostatic loading
    the bottom elements' reactions [Eb, 4]]."""
    shapes = [(t.n, 8, 6), (t.n, 8, 6), (t.n, 8)]
    if t.cfg.geostatic_loading_t > 0:
        shapes.append((len(t.bot_eidx), 4))
    return shapes


def nl_force(d, state, dt2):
    """compute_addforce_nl: f24 = -dt^2 * (h^2/8) sum_j F[j] sigma[j]."""
    sig = state[0]
    Enl = sig.shape[0]
    f = sig.reshape(Enl, 48) @ d["F"].T
    return -dt2 * (d["h"] ** 2 / 8.0)[:, None] * f


def smooth_rise_factor(steps, total_geostatic_steps):
    """smooth_rise_factor (nonlinear.c:1244-1299), vectorized over an
    array of step indices."""
    N = total_geostatic_steps
    n1 = int(0.1 * N)
    n2 = int(0.5 * N)
    n3 = int(0.9 * N)
    n31 = n3 - n1
    C1 = 2.0 / (n31 * (n2 - n1))
    C2 = 2.0 / (n31 * (n2 - n3))
    B1 = 0.5 * n1 * n1
    B2 = 0.5 * (n31 * (n2 - n3) + n3 * n3)
    s = np.asarray(steps, np.float64)
    n22 = 0.5 * s * s
    out = np.where(s > n3, 1.0,
                   np.where(s <= n1, 0.0,
                            np.where(s <= n2, C1 * (n22 - s * n1 + B1),
                                     C2 * (n22 - s * n3 + B2))))
    return out


# ---------------------------------------------------------------------------
# nonlinear station extras (nonlinear.c:1947-2228)

NL_STATION_HEADER = (
    "       e-xx(-)      s-xx(Pa)        e-yy(-)      s-yy(Pa)"
    "        e-zz(-)      s-zz(Pa)         e-kk(-)      s-kk(Pa)"
    "        e-xy(-)      s-xy(Pa)        e-yz(-)      s-yz(Pa)"
    "        e-xz(-)      s-xz(Pa)      dLambda     Fs(Pa)     kh(Pa)")


def nonlinear_station_series(u8_series, h, con, dt, model, rate_dep):
    """Per-step nonlinear station columns (print_nonlinear_stations,
    nonlinear.c:2078-2228): strain/stress tensors at the first Gauss
    point (the reference hardcodes lx=ly=lz=-1/sqrt(3), :2147-2149),
    bulk strain/stress, plastic multiplier, yield-surface value, and
    the hardened strength k + hard*ep.

    u8_series: [T, 8, 3] corner displacements of the station's element;
    con: dict with mu, lam, alpha, k, hard, strainrate, sensitivity.
    Returns [T, 17] float64."""
    T = u8_series.shape[0]
    S0 = strain_operator()[0]                    # [6, 24] Gauss point 0
    eps = u8_series.reshape(T, 24) @ S0.T / h    # [T, 6] Voigt

    mu, lam = con["mu"], con["lam"]
    alpha, k = con["alpha"], con["k"]
    hard = con["hard"]

    def stress(e6):
        skk = e6[0] + e6[1] + e6[2]
        s = 2.0 * mu * e6
        s[:3] += lam * skk
        return s

    def invariants(s6):
        I1 = s6[0] + s6[1] + s6[2]
        dev = s6.copy()
        dev[:3] -= I1 / 3.0
        J2 = 0.5 * (dev[0] ** 2 + dev[1] ** 2 + dev[2] ** 2) \
            + dev[3] ** 2 + dev[4] ** 2 + dev[5] ** 2
        return I1, dev, J2

    out = np.zeros((T, 17))
    pstr = np.zeros(6)
    ep = 0.0
    phi_pt = np.sqrt(0.5 + 3.0 * alpha * alpha)
    kap = lam + 2.0 * mu / 3.0
    for s in range(T):
        e = eps[s]
        dlam = 0.0
        if model == "linear":
            sig = stress(e)
            I1, dev, J2 = invariants(sig)
            fs = alpha * I1 + np.sqrt(J2)
        else:
            sig = stress(e - pstr)
            I1, dev, J2 = invariants(sig)
            sqJ2 = np.sqrt(J2)
            fs = alpha * I1 + sqJ2
            if rate_dep:
                factor = fs / k
                dlam = (con["strainrate"]
                        * max(factor, 0.0) ** (1.0 / con["sensitivity"]))
            else:
                FsT = fs - k - hard * ep
                denom = mu + 9.0 * kap * alpha * alpha + hard * phi_pt
                dlam = FsT / denom if FsT > 0 else 0.0
            dfds = dev / (2.0 * sqJ2 if sqJ2 > 0 else 1.0)
            dfds[:3] += alpha
            pstr = pstr + (dt * dlam if rate_dep else dlam) * dfds
            ep = ep + dlam * phi_pt
            if not rate_dep and dlam > 0:
                sig = stress(e - pstr)
                I1, dev, J2 = invariants(sig)
                fs = alpha * I1 + np.sqrt(J2)
        bE = e[0] + e[1] + e[2]
        bS = sig[0] + sig[1] + sig[2]
        out[s] = [e[0], sig[0], e[1], sig[1], e[2], sig[2], bE, bS,
                  e[3], sig[3], e[4], sig[4], e[5], sig[5],
                  dlam, fs, k + hard * ep]
    return out


def station_constants(t: NLTables, eidx):
    """Constants dict for a station's element (global index eidx), or
    None if the element is linear."""
    w = np.flatnonzero(t.eidx == eidx)
    if not len(w):
        return None
    i = int(w[0])
    return {"mu": t.mu[i], "lam": t.lam[i], "alpha": t.alpha[i],
            "k": t.k[i], "hard": t.hard[i],
            "strainrate": t.strainrate[i],
            "sensitivity": t.sensitivity[i], "h": t.h[i]}
