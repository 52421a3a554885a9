"""A plain reference of Hercules's explicit finite-element step, for
horizontally layered media, written from the method and not from the
port's code.

The semantics it follows (Bielak et al. 2005, Tu et al. 2006; the
CMU-Quake solver): a linear octree of cubes refined until each edge is
at most the least shear speed sampled in it over points per wavelength
times the maximum frequency, balanced 2:1, with trilinear elements whose
hanging (dangling) nodes are held to the average of their 2 or 4
anchors; lumped masses rho h^3 / 8 per corner; Lysmer dashpots on the
four sides and the bottom (none on the free surface); central
differences

    M (u+ - 2u + u-) = dt^2 (f - K u) - dt C (u - u-)

with the dangling nodes' forces and masses handed to their anchors
before the update and their displacements interpolated after it; a
point double couple as the moment tensor contracted with the shape
functions' gradients at the hypocentre; receivers interpolated
trilinearly, sampled before each step.

Everything is worked out here from the configuration file: the medium
as the benchmark's etree holds it (octants of the configuration's
resolution, each holding the layer at its centre, in float32), the
octree, the element stiffness by Gauss quadrature, the masses, the
dashpots and the source forces.  It imports nothing of the program.

A run steps [N, 3] fields on any device in any floating type: float64
for the reference, a lower type for the control.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch

# corner w of an element: x (north) = bit 0, y (east) = bit 1, z (depth)
# = bit 2
CORNER_BITS = np.array([[(w >> a) & 1 for a in range(3)] for w in range(8)])
SIGNS = 2 * CORNER_BITS - 1            # [8, 3] in {-1, 1}


# ---------------------------------------------------------------- medium

def cvm_edge(cfg) -> float:
    """Edge of the benchmark's etree octants: the domain's largest extent
    over the power of two that brings it to the resolution or below."""
    r = cfg["region_m"]
    maxdim = max(r["north"], r["east"], r["depth"])
    level = int(math.ceil(math.log2(maxdim / cfg["cvm_resolution_m"])))
    return maxdim / 2 ** level


def medium_at(cfg, depth):
    """(vp, vs, rho) float64 arrays at ``depth`` (m): the layer at the
    centre of the etree octant that holds the point, as float32."""
    layers = np.asarray(cfg["layers"], np.float64)
    e = cvm_edge(cfg)
    zc = (np.floor(np.asarray(depth, np.float64) / e) + 0.5) * e
    li = np.clip(np.searchsorted(layers[:, 0], zc, side="right") - 1,
                 0, len(layers) - 1)
    vals = layers[li, 1:4].astype(np.float32).astype(np.float64)
    return vals[..., 0], vals[..., 1], vals[..., 2]


# ------------------------------------------------------------------ mesh

def element_rows(cfg):
    """[(z0, edge)] of the element layers from the surface down: the
    octree's refinement by the shear-speed rule along depth (a layered
    medium refines alike across each depth), then the 2:1 balance."""
    r = cfg["region_m"]
    depth = r["depth"]
    maxdim = max(r["north"], r["east"], depth)
    factor = cfg["fmax_hz"] * cfg["points_per_wavelength"]
    rows = []

    def visit(z0, e):
        if z0 >= depth:
            return
        zs = z0 + 0.5 * e * np.array([0.01, 1.0, 1.99])
        inside = zs < depth
        vs = medium_at(cfg, zs[inside])[1]
        vs_min = vs.min() if inside.any() else factor * e / 2
        if z0 + e > depth or e > vs_min / factor:
            visit(z0, e / 2)
            visit(z0 + e / 2, e / 2)
        else:
            rows.append([z0, e])

    visit(0.0, maxdim)
    while True:                     # 2:1 between neighbouring rows
        lv = [-math.log2(e) for _, e in rows]
        bad = [i for i in range(len(rows) - 1) if abs(lv[i] - lv[i + 1]) > 1]
        if not bad:
            break
        i = bad[0]
        j = i if rows[i][1] > rows[i + 1][1] else i + 1
        z0, e = rows.pop(j)
        rows[j:j] = [[z0, e / 2], [z0 + e / 2, e / 2]]
    for z0, e in rows:
        for extent in (r["north"], r["east"]):
            if abs(extent / e - round(extent / e)) > 1e-9:
                raise ValueError("the reference meshes domains whose "
                                 "extents are whole numbers of elements")
    return [(float(z0), float(e)) for z0, e in rows]


@dataclass
class Mesh:
    """The reference mesh: node keys in units of the finest edge ``hmin``
    (i north, j east, k down), elements' corner node ids, edges and
    materials, the dangling table."""

    hmin: float
    nodes: np.ndarray        # [N, 3] int64 (i, j, k)
    lnid: np.ndarray         # [E, 8] int64
    elem_lo: np.ndarray      # [E, 3] int64 low corner keys
    edge: np.ndarray         # [E] m
    vp: np.ndarray
    vs: np.ndarray
    rho: np.ndarray
    dn_ids: np.ndarray       # [D] int64
    dn_anchors: np.ndarray   # [D, 4] int64 (padded with the node itself)
    dn_weights: np.ndarray   # [D, 4]
    rows: list               # [(z0, edge)]
    extents: tuple           # (north, east, depth) m

    @property
    def E(self):
        return len(self.edge)

    @property
    def N(self):
        return len(self.nodes)


def node_keys(ijk, dims):
    """A node's integer key from its (i, j, k) on the finest grid."""
    i, j, k = (np.asarray(ijk[..., a], np.int64) for a in range(3))
    return (k * (dims[1] + 1) + j) * (dims[0] + 1) + i


def build_mesh(cfg) -> Mesh:
    """The mesh of a layered configuration."""
    r = cfg["region_m"]
    rows = element_rows(cfg)
    hmin = min(e for _, e in rows)
    dims = tuple(int(round(x / hmin)) for x in (r["north"], r["east"],
                                                r["depth"]))
    lo_all, edge_all, z0_all = [], [], []
    for z0, e in rows:
        s = int(round(e / hmin))
        nx, ny = int(round(r["north"] / e)), int(round(r["east"] / e))
        i, j = np.meshgrid(np.arange(nx) * s, np.arange(ny) * s,
                           indexing="ij")
        lo = np.stack([i.ravel(), j.ravel(),
                       np.full(nx * ny, int(round(z0 / hmin)))], 1)
        lo_all.append(lo)
        edge_all.append(np.full(nx * ny, e))
        z0_all.append(np.full(nx * ny, z0))
    lo = np.concatenate(lo_all).astype(np.int64)
    edge = np.concatenate(edge_all)
    z0 = np.concatenate(z0_all)
    s = np.round(edge / hmin).astype(np.int64)
    corners = lo[:, None, :] + CORNER_BITS[None] * s[:, None, None]
    keys = node_keys(corners, dims).ravel()
    # the sorted distinct keys and each corner's index among them (what
    # np.unique(keys, return_inverse=True) gives), by a mark on every
    # key of the finest grid
    marked = np.zeros((dims[0] + 1) * (dims[1] + 1) * (dims[2] + 1), bool)
    marked[keys] = True
    ukeys = np.flatnonzero(marked)
    lnid = (np.cumsum(marked) - 1)[keys].reshape(-1, 8)
    n = len(ukeys)
    nodes = np.empty((n, 3), np.int64)
    nodes[:, 0] = ukeys % (dims[0] + 1)
    nodes[:, 1] = (ukeys // (dims[0] + 1)) % (dims[1] + 1)
    nodes[:, 2] = ukeys // ((dims[0] + 1) * (dims[1] + 1))

    # material: the mean of 27 samples at 0.005, 0.5 and 0.995 of the
    # edge (a layered medium varies along depth alone)
    vp = np.zeros(len(edge))
    vs = np.zeros(len(edge))
    rho = np.zeros(len(edge))
    for p in (0.005, 0.5, 0.995):
        a, b, c = medium_at(cfg, z0 + p * edge)
        vp += 9 * a
        vs += 9 * b
        rho += 9 * c
    vp /= 27.0
    vs /= 27.0
    rho /= 27.0

    # dangling nodes: on a plane between rows of different edges, the
    # finer row's nodes that are not the coarser row's corners
    dn, anc, wts = [], [], []
    for (za, ea), (zb, eb) in zip(rows, rows[1:]):
        if ea == eb:
            continue
        fine, coarse = (ea, eb) if ea < eb else (eb, ea)
        sf, sc = int(round(fine / hmin)), int(round(coarse / hmin))
        k = int(round(zb / hmin))
        nxf, nyf = int(round(r["north"] / fine)), int(round(r["east"] / fine))
        i, j = np.meshgrid(np.arange(nxf + 1) * sf, np.arange(nyf + 1) * sf,
                           indexing="ij")
        i, j = i.ravel(), j.ravel()
        oi, oj = i % sc != 0, j % sc != 0
        hang = oi | oj
        i, j, oi, oj = i[hang], j[hang], oi[hang], oj[hang]
        kk = np.full(len(i), k)
        # a face centre hangs on the 4 corners around it, an edge
        # midpoint on the 2 ends of its edge (the first two slots; the
        # others repeat the first with weight 0)
        face = oi & oj
        a4 = []
        for di, dj in ((-1, -1), (1, 1), (1, -1), (-1, 1)):
            ai = np.where(face | oi, i + di * sf, i)
            aj = np.where(face, j + dj * sf, np.where(oj, j + di * sf, j))
            a4.append(np.stack([ai, aj, kk], 1))
        a4 = np.stack(a4, 1)                        # [D, 4, 3]
        dn.append(_node_index(ukeys,
                              node_keys(np.stack([i, j, kk], 1), dims)))
        ak = _node_index(ukeys, node_keys(a4, dims))   # [D, 4]
        ak[~face, 2:] = ak[~face, :1]
        ww = np.where(face[:, None], 0.25, np.array([0.5, 0.5, 0.0, 0.0]))
        anc.append(ak)
        wts.append(ww)
    if dn:
        dn_ids = np.concatenate(dn)
        dn_anchors = np.concatenate(anc)
        dn_weights = np.concatenate(wts)
    else:
        dn_ids = np.zeros(0, np.int64)
        dn_anchors = np.zeros((0, 4), np.int64)
        dn_weights = np.zeros((0, 4))
    return Mesh(hmin=hmin, nodes=nodes, lnid=lnid, elem_lo=lo, edge=edge,
                vp=vp, vs=vs, rho=rho, dn_ids=dn_ids, dn_anchors=dn_anchors,
                dn_weights=dn_weights, rows=rows,
                extents=(r["north"], r["east"], r["depth"]))


def _node_index(ukeys, keys):
    pos = np.searchsorted(ukeys, keys)
    if not (ukeys[np.minimum(pos, len(ukeys) - 1)] == keys).all():
        raise ValueError("a dangling node's anchor is not a mesh node")
    return pos.astype(np.int64)


def locate(mesh: Mesh, xyz):
    """(element [P], local coordinates [P, 3] in [-1, 1]) of points
    (north, east, depth) m: the row that holds the depth (the lower row
    on a plane between rows), then the column."""
    xyz = np.atleast_2d(np.asarray(xyz, np.float64))
    if ((xyz < 0) | (xyz > np.array(mesh.extents))).any():
        raise ValueError("a point lies outside the domain")
    tops = np.array([z0 for z0, _ in mesh.rows])
    row = np.clip(np.searchsorted(tops, xyz[:, 2], side="right") - 1,
                  0, len(tops) - 1)
    base = np.cumsum([0] + [int(round(mesh.extents[0] / e))
                            * int(round(mesh.extents[1] / e))
                            for _, e in mesh.rows])
    out_e, out_l = [], []
    for p, rw in zip(xyz, row):
        z0, e = mesh.rows[rw]
        nx = int(round(mesh.extents[0] / e))
        ny = int(round(mesh.extents[1] / e))
        ix = min(int(p[0] // e), nx - 1)
        iy = min(int(p[1] // e), ny - 1)
        out_e.append(base[rw] + ix * ny + iy)
        lo = np.array([ix * e, iy * e, z0])
        out_l.append(2.0 * (p - lo) / e - 1.0)
    return np.array(out_e, np.int64), np.array(out_l)


def shape_values(loc):
    """[P, 8] trilinear shape functions at local coordinates [P, 3]."""
    return np.prod(1.0 + SIGNS[None] * loc[:, None, :], axis=2) / 8.0


# ----------------------------------------------------------- element

def unit_stiffness():
    """(Kmu, Klam) [24, 24]: the stiffness of a unit cube for mu = 1,
    lambda = 0 and for lambda = 1, mu = 0, by 2-point Gauss quadrature
    (exact for the trilinear cube).  DOF 3 w + c is component c of
    corner w.  An element of edge h has h (mu Kmu + lambda Klam)."""
    g = 0.5 / math.sqrt(3.0)
    Kmu = np.zeros((24, 24))
    Klam = np.zeros((24, 24))
    for q in np.array(np.meshgrid([-g, g], [-g, g], [-g, g],
                                  indexing="ij")).reshape(3, -1).T:
        x = q + 0.5                                  # in [0, 1]^3
        # dN_w/dx_a on the unit cube, N_w = prod (b ? x : 1 - x)
        f = np.where(CORNER_BITS == 1, x[None], 1.0 - x[None])   # [8, 3]
        d = np.where(CORNER_BITS == 1, 1.0, -1.0)
        grad = np.empty((8, 3))
        for a in range(3):
            grad[:, a] = d[:, a] * np.prod(np.delete(f, a, 1), 1)
        B = np.zeros((6, 24))
        for w in range(8):
            gx, gy, gz = grad[w]
            B[0, 3 * w] = gx
            B[1, 3 * w + 1] = gy
            B[2, 3 * w + 2] = gz
            B[3, 3 * w], B[3, 3 * w + 1] = gy, gx
            B[4, 3 * w + 1], B[4, 3 * w + 2] = gz, gy
            B[5, 3 * w], B[5, 3 * w + 2] = gz, gx
        Dmu = np.diag([2.0, 2.0, 2.0, 1.0, 1.0, 1.0])
        Dlam = np.zeros((6, 6))
        Dlam[:3, :3] = 1.0
        Kmu += B.T @ Dmu @ B / 8.0
        Klam += B.T @ Dlam @ B / 8.0
    return Kmu, Klam


def lame(cfg, mesh: Mesh):
    """(mu, lambda) per element, with the solver's clamp of Vp / Vs."""
    vp, vs, rho = mesh.vp, mesh.vs, mesh.rho
    thr = cfg.get("threshold_vp_over_vs", 3.0)
    mu = rho * vs * vs
    lam = np.where(vp > vs * thr, rho * vs * vs * thr ** 2 - 2 * mu,
                   rho * vp * vp - 2 * mu)
    if (lam < 0).any():
        raise ValueError("the reference takes media with a positive lambda")
    return mu, lam


def node_tables(cfg, mesh: Mesh):
    """(mass [N], damped mass [N, 3]): rho h^3 / 8 per corner, less dt
    times the dashpots (rho (h/2)^2 Vp normal, Vs tangential, per domain
    face a corner lies on, the surface left free), the dangling nodes'
    shares handed to their anchors."""
    dt = cfg["dt_s"]
    N = mesh.N
    m = mesh.rho * mesh.edge ** 3 / 8.0
    mass = np.bincount(mesh.lnid.ravel(), np.repeat(m, 8), minlength=N)
    s = np.round(mesh.edge / mesh.hmin).astype(np.int64)
    far = np.round(np.array(mesh.extents) / mesh.hmin).astype(np.int64)
    # the elements on a damped face (the others add nothing)
    lo, hi = mesh.elem_lo == 0, mesh.elem_lo + s[:, None] == far
    lo[:, 2] = False                               # the free surface
    b = np.flatnonzero((lo | hi).any(1))
    dash = np.zeros((len(b), 8, 3))
    vp, vs = mesh.vp[b], mesh.vs[b]
    for a in range(3):
        on = ((lo[b, a][:, None] & (CORNER_BITS[None, :, a] == 0))
              | (hi[b, a][:, None] & (CORNER_BITS[None, :, a] == 1)))
        for c in range(3):
            v = vp if c == a else vs
            dash[:, :, c] += on * v[:, None]
    dash *= (mesh.rho[b] * (mesh.edge[b] / 2) ** 2)[:, None, None]
    damped = np.repeat(mass[:, None], 3, 1)
    for c in range(3):
        damped[:, c] -= dt * np.bincount(mesh.lnid[b].ravel(),
                                         dash[:, :, c].ravel(), minlength=N)
    if len(mesh.dn_ids):
        w = mesh.dn_weights
        a = mesh.dn_anchors.ravel()
        mass = mass + np.bincount(a, (mass[mesh.dn_ids][:, None] * w).ravel(),
                                  minlength=N)
        for c in range(3):
            damped[:, c] += np.bincount(
                a, (damped[mesh.dn_ids, c][:, None] * w).ravel(), minlength=N)
    return mass, damped


# ---------------------------------------------------------------- source

def time_function(cfg, steps):
    """[steps] normalised slip history at t = s dt (zero at t = 0): ramp,
    or 1 - (1 + t/T) exp(-t/T); low-passed where the configuration
    filters it (Hercules's FilterSignal: differentiate, pad to a power of
    two, Butterworth magnitude, re-integrate by trapezoids)."""
    src = cfg["source_model"]
    dt = cfg["dt_s"]
    t = dt * np.arange(steps, dtype=np.float64)
    T0 = src["risetime_s"]
    if src["function"] == "ramp":
        d = np.where(t < T0, t / T0, 1.0)
    elif src["function"] == "exponential":
        d = 1 - (1 + t / T0) * np.exp(-t / T0)
    else:
        raise ValueError(f"no time function {src['function']!r}")
    d = np.where(t > 0, d, 0.0)
    if src.get("filter_hz"):
        fs = 1.0 / dt
        v = np.empty_like(d)
        v[0] = 0.5 * fs * (-3 * d[0] + 4 * d[1] - d[2])
        v[-1] = 0.5 * fs * (d[-3] - 4 * d[-2] + 3 * d[-1])
        v[1:-1] = 0.5 * fs * (d[2:] - d[:-2])
        size = 1 << (int(np.log(steps) / np.log(2)) + 2)
        pad = np.zeros(size)
        pad[:steps] = v
        f = fs * np.arange(size // 2 + 1) / size
        h = np.sqrt(1.0 / (1.0 + (f / src["filter_hz"])
                           ** (2 * src["filter_poles"])))
        h[0] = 1.0
        y = np.fft.irfft(np.fft.rfft(pad) * h, n=size)[:steps]
        d = np.zeros(steps)
        d[1:] = np.cumsum(0.5 / fs * (y[:-1] + y[1:]))
    return d


def double_couple(strike, dip, rake):
    """The unit moment tensor [3, 3] (north, east, down) of a double
    couple: n t^T + t n^T with the fault normal n and slip t."""
    s, d, r = (math.radians(v) for v in (strike, dip, rake))
    n = np.array([-math.sin(s) * math.sin(d), math.cos(s) * math.sin(d),
                  -math.cos(d)])
    t = np.array([math.cos(r) * math.cos(s)
                  + math.sin(r) * math.sin(s) * math.cos(d),
                  math.cos(r) * math.sin(s)
                  - math.sin(r) * math.cos(s) * math.cos(d),
                  -math.sin(r) * math.sin(d)])
    return np.outer(n, t) + np.outer(t, n)


def source_weights(mesh: Mesh, src):
    """(node ids [8], weights [8, 3]): M0 times the moment tensor
    contracted with each corner's shape-function gradient at the
    hypocentre (src: hypocentre_m, strike_deg, dip_deg, rake_deg,
    moment_nm)."""
    e, loc = locate(mesh, src["hypocentre_m"])
    h = mesh.edge[e[0]]
    loc = loc[0]
    f = 1.0 + SIGNS * loc[None, :]                   # [8, 3]
    grad = np.empty((8, 3))
    for a in range(3):
        grad[:, a] = SIGNS[:, a] * (2.0 / h) * np.prod(
            np.delete(f, a, 1), 1) / 8.0
    M = double_couple(src["strike_deg"], src["dip_deg"], src["rake_deg"])
    return mesh.lnid[e[0]], src["moment_nm"] * grad @ M.T


# ---------------------------------------------------------------- solver

class Solver:
    """The reference's time loop on ``device`` in ``dtype``; the source's
    time function is that of a job of ``steps`` steps, and a later step
    takes its last value."""

    def __init__(self, cfg, mesh: Mesh, src, receivers, steps,
                 dtype=torch.float64, device="cpu"):
        self.cfg, self.mesh = cfg, mesh
        self.dtype, self.device = dtype, torch.device(device)
        dt = cfg["dt_s"]
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
            device=self.device, dtype=dtype)
        i = lambda x: torch.as_tensor(np.asarray(x, np.int64),
                                      device=self.device)
        mu, lam = lame(cfg, mesh)
        # [48, 24]: [mu part of ue, lambda part of ue] @ K48 is K ue
        # (both matrices are symmetric); held negated, so that the product
        # is the elements' force -K ue itself (a sign flip is exact)
        self.minus_K48 = f(-np.concatenate(unit_stiffness(), 0))
        self.coef = f(np.stack([dt * dt * mesh.edge * mu,
                                dt * dt * mesh.edge * lam], 1))   # [E, 2]
        self.lnid = i(mesh.lnid)
        # each node's element corners, padded with an all-zero row
        flat = mesh.lnid.ravel()
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=mesh.N)
        width = int(counts.max())
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(flat)) - np.repeat(start, counts)
        inc = np.full((mesh.N, width), len(flat), np.int64)
        inc[flat[order], slot] = order
        self.inc = i(inc)
        mass, damped = node_tables(cfg, mesh)
        self.inv_mass = f(1.0 / mass)[:, None]
        self.damped = f(damped)
        self.dn = i(mesh.dn_ids)
        self.dn_anc = i(mesh.dn_anchors)
        self.dn_w = f(mesh.dn_weights)
        sn, sw = source_weights(mesh, src)
        self.src_nodes = i(sn)
        self.src_w = f(sw * dt * dt)
        self.decay = time_function(cfg, steps)
        e, loc = locate(mesh, receivers)
        self.rec_nodes = i(mesh.lnid[e])
        self.rec_phi = f(shape_values(loc))

    def on(self, device):
        """This solver with its tables on ``device``."""
        other = copy.copy(self)
        other.device = torch.device(device)
        for k, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                setattr(other, k, v.to(other.device))
        return other

    def zeros(self):
        z = torch.zeros((self.mesh.N, 3), dtype=self.dtype,
                        device=self.device)
        return z, z.clone()

    def sample(self, u):
        return torch.einsum("rw,rwc->rc", self.rec_phi, u[self.rec_nodes])

    def step(self, u, up, s):
        E = self.mesh.E
        ue = u[self.lnid].reshape(E, 24)
        ab = (self.coef[:, :, None] * ue[:, None, :]).reshape(E, 48)
        # the element forces [E, 24] as [8 E, 3] rows, then the all-zero
        # row that pads ``inc``
        fe = ue.new_empty((8 * E + 1, 3))
        torch.matmul(ab, self.minus_K48, out=fe[:8 * E].view(E, 24))
        fe[8 * E] = 0.0
        F = fe[self.inc].sum(1)
        F.index_add_(0, self.src_nodes, self.src_w * float(
            self.decay[min(s, len(self.decay) - 1)]))
        if len(self.dn):
            F.index_add_(0, self.dn_anc.ravel(),
                         (F[self.dn][:, None, :]
                          * self.dn_w[:, :, None]).reshape(-1, 3))
        un = u + (F + self.damped * (u - up)) * self.inv_mass
        if len(self.dn):
            un[self.dn] = (un[self.dn_anc] * self.dn_w[:, :, None]).sum(1)
        return un, u

    def run(self, u, up, s0, k):
        """Steps [s0, s0 + k) from (u, u-): (u, u-, samples [k, R, 3])."""
        return run_legs([(self, u, up, s0, k)])[0]


def run_legs(legs):
    """Runs of solvers [(solver, u, u-, s0, k)] stepped in turns, each
    as ``Solver.run`` steps it; legs on different devices overlap.
    Returns [(u, u-, samples [k, R, 3])] in the legs' order."""
    state = [[u, up, []] for _, u, up, _, _ in legs]
    for i in range(max(k for *_, k in legs)):
        for (solver, _, _, s0, k), st in zip(legs, state):
            if i < k:
                st[2].append(solver.sample(st[0]))
                st[0], st[1] = solver.step(st[0], st[1], s0 + i)
    return [(u, up, torch.stack(ys)) for u, up, ys in state]
