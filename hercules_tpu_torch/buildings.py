"""Buildings + foundations above a pushed-down free surface.

Re-implements buildings.c (1310 lines): the free surface is shifted
down by ``surface_shift_m``; rectangular buildings (above the shifted
surface) and their foundations (below it) override material
properties; everything else above the shifted surface is "air"
(Vp = -1) and carved from the octree.  Refinement follows the
buildings_n_factor subdivision, the per-zone Vs rule, and the
crossing rules against building and surface boundaries
(bldgs_toexpand/bldgs_refine, buildings.c:549-633).

Optionally, building bases can be driven by prescribed displacement
time histories (consider_fixed_base; fixedbase_read :975,
bldgs_load_fixedbase_disps :1146).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

FENCELIMIT = 0.9999


@dataclass
class Buildings:
    n: int = 0
    n_factor: float = 1.0
    min_oct: float = 0.0
    surface_shift: float = 0.0
    fixed_base: bool = False
    # adjusted bounds [n]
    xmin: np.ndarray = None
    xmax: np.ndarray = None
    ymin: np.ndarray = None
    ymax: np.ndarray = None
    zmin: np.ndarray = None
    zmax: np.ndarray = None
    bldg_props: np.ndarray = None   # [n, 3] Vp Vs rho
    fdtn_props: np.ndarray = None
    # fixed base config
    fb_dt: float = 0.0
    fb_dir: str = ""
    fb_startindex: int = 0
    fb_sufix: str = ""

    @classmethod
    def parse(cls, cfg):
        """buildings_initparameters (buildings.c:817-969) +
        adjust_dimensions (:1177)."""
        b = cls()
        b.n = cfg.get_int("number_of_buildings", required=True)
        b.n_factor = cfg.get_double("buildings_n_factor", required=True)
        b.min_oct = cfg.get_double("min_octant_size_m", required=True)
        b.surface_shift = cfg.get_double("surface_shift_m", required=True)
        fb = cfg.get_string("consider_fixed_base", "no")
        b.fixed_base = fb.lower() == "yes"
        if b.fixed_base:
            b.fb_dt = cfg.get_double("fixedbase_input_dt", required=True)
            b.fb_dir = cfg.get_string("fixedbase_input_dir",
                                      required=True)
            b.fb_startindex = cfg.get_int("fixedbase_input_startindex",
                                          0)
            b.fb_sufix = cfg.get_string("fixedbase_input_sufix", "")
        tbl = cfg.get_table("building_properties", b.n, 12)

        def adjust(v):
            return b.min_oct * np.round(v / b.min_oct)

        b.surface_shift = float(adjust(b.surface_shift))
        b.xmin = adjust(tbl[:, 0])
        b.xmax = adjust(tbl[:, 1])
        b.ymin = adjust(tbl[:, 2])
        b.ymax = adjust(tbl[:, 3])
        depth = adjust(tbl[:, 4])
        height = adjust(tbl[:, 5])
        b.zmin = np.maximum(b.surface_shift - height, 0.0)
        b.zmax = b.surface_shift + depth
        b.bldg_props = tbl[:, 6:9]
        b.fdtn_props = tbl[:, 9:12]
        return b

    # ------------------------------------------------------------------
    def _which(self, x, y, z, esize):
        """bldg_meshingsearch over all buildings, vectorized over
        leaves: building index + 1 or 0.  The fence expands the min
        bounds by FENCELIMIT*esize (buildings.c:389-414)."""
        which = np.zeros(len(x), np.int32)
        for i in range(self.n - 1, -1, -1):
            inb = ((x >= self.xmin[i] - FENCELIMIT * esize)
                   & (x < self.xmax[i])
                   & (y >= self.ymin[i] - FENCELIMIT * esize)
                   & (y < self.ymax[i])
                   & (z >= self.zmin[i] - FENCELIMIT * esize)
                   & (z < self.zmax[i]))
            which = np.where(inb, i + 1, which)
        return which

    def _which_exclusive(self, x, y, z):
        """bldg_exclusivesearch (no fence)."""
        which = np.zeros(len(x), np.int32)
        for i in range(self.n - 1, -1, -1):
            inb = ((x >= self.xmin[i]) & (x < self.xmax[i])
                   & (y >= self.ymin[i]) & (y < self.ymax[i])
                   & (z >= self.zmin[i]) & (z < self.zmax[i]))
            which = np.where(inb, i + 1, which)
        return which

    # ------------------------------------------------------------------
    def setrec_override(self, x_m, y_m, z_m, esize, rec, cvm, origin,
                        ticksize):
        """bldgs_setrec (buildings.c:510-545): override props inside
        buildings/foundations; air above the shifted surface.

        x_m etc: leaf low corner coords [n]; rec: dict of Vp/Vs/rho to
        update in place.  Returns handled mask."""
        which = self._which(x_m, y_m, z_m, esize)
        inb = which > 0
        w = np.maximum(which - 1, 0)
        infdn = z_m >= self.surface_shift
        props = np.where(infdn[:, None], self.fdtn_props[w],
                         self.bldg_props[w])
        for c, name in enumerate(("Vp", "Vs", "rho")):
            rec[name] = np.where(inb, props[:, c], rec[name])

        air = (~inb) & (z_m < self.surface_shift)
        if air.any():
            # air props (get_airprops :209): Vs grows away from the
            # surface (per-tick scale stops further refinement),
            # Vp = -1 marks the octant for carving
            zc = z_m[air] + esize[air] / 2
            ok, vp, vs, rho = cvm.query(
                y_m[air] + esize[air] / 2 + origin.y,
                x_m[air] + esize[air] / 2 + origin.x,
                np.zeros(int(air.sum())))
            rec["Vs"] = rec["Vs"].copy()
            rec["Vp"] = rec["Vp"].copy()
            rec["rho"] = rec["rho"].copy()
            rec["Vs"][air] = 2.0 * vs * (self.surface_shift - zc) \
                / ticksize
            rec["Vp"][air] = -1.0
            rec["rho"][air] = 0.0
        return inb | air

    def toexpand(self, x_m, y_m, z_m, esize, vs, factor):
        """bldgs_toexpand (buildings.c:606-633): tri-state per leaf:
        1 split, 0 keep, -1 not-a-building (fall through to vsrule)."""
        n = len(x_m)
        res = np.full(n, -1, np.int8)
        which = self._which(x_m, y_m, z_m, esize)
        inb = which > 0
        w = np.maximum(which - 1, 0)

        def crossing(lo, size, bound):
            return (lo < bound) & (lo + size > bound)

        split = crossing(z_m, esize, self.surface_shift)
        split |= (esize > (self.xmax[w] - self.xmin[w]) / self.n_factor)
        split |= (esize > (self.ymax[w] - self.ymin[w]) / self.n_factor)
        zone_vs = np.where(z_m >= self.surface_shift,
                           self.fdtn_props[w, 1], self.bldg_props[w, 1])
        split |= esize > zone_vs / factor
        for arr_lo, arr_hi, lo in ((self.xmin, self.xmax, x_m),
                                   (self.ymin, self.ymax, y_m),
                                   (self.zmin, self.zmax, z_m)):
            split |= crossing(lo, esize, arr_lo[w])
            split |= crossing(lo, esize, arr_hi[w])

        res = np.where(inb, np.where(split, 1, 0), res)
        # non-building leaves crossing the shifted surface must split
        res = np.where((~inb) & crossing(z_m, esize, self.surface_shift),
                       1, res)
        return res

    def carve_mask(self, rec):
        """octor_carvebuildings: leaves with negative Vp are air."""
        return rec["Vp"] < 0

    def correct_properties(self, mesh, props):
        """bldgs_correctproperties (buildings.c:634-700): building and
        foundation elements keep their assigned table properties."""
        ts = mesh.ticksize
        x = mesh.elem_x.astype(np.float64) * ts
        y = mesh.elem_y.astype(np.float64) * ts
        z = mesh.elem_z.astype(np.float64) * ts
        which = self._which_exclusive(x, y, z)
        inb = which > 0
        w = np.maximum(which - 1, 0)
        infdn = z >= self.surface_shift
        over = np.where(infdn[:, None], self.fdtn_props[w],
                        self.bldg_props[w])
        for c, name in enumerate(("Vp", "Vs", "rho")):
            props[name] = np.where(inb, over[:, c], props[name])
        return inb

    # ------------------------------------------------------------------
    def base_nodes(self, mesh):
        """basenode_search (buildings.c:425-448): nodes at the shifted
        surface within (inclusive) building bounds; returns
        (node indices, building index)."""
        ts = mesh.ticksize
        x = mesh.node_x.astype(np.float64) * ts
        y = mesh.node_y.astype(np.float64) * ts
        z = mesh.node_z.astype(np.float64) * ts
        at = z == self.surface_shift
        which = np.zeros(mesh.nnum, np.int32)
        for i in range(self.n - 1, -1, -1):
            inb = (at & (x >= self.xmin[i]) & (x <= self.xmax[i])
                   & (y >= self.ymin[i]) & (y <= self.ymax[i]))
            which = np.where(inb, i + 1, which)
        ids = np.flatnonzero(which)
        return ids.astype(np.int32), which[ids] - 1

    def read_base_signals(self, sim_time, rundir="."):
        """read_base_input: per-building files
        <dir>/<sufix>.<startindex + i> with rows ux uy uz at fb_dt."""
        steps = int(sim_time / self.fb_dt)
        sig = np.zeros((self.n, steps + 2, 3))
        d = self.fb_dir
        if not os.path.isabs(d):
            d = os.path.join(rundir, d)
        for i in range(self.n):
            path = os.path.join(d, f"{self.fb_sufix}."
                                   f"{self.fb_startindex + i}")
            vals = np.loadtxt(path)
            k = min(len(vals), steps + 2)
            sig[i, :k] = vals[:k, :3]
            sig[i, k:] = sig[i, k - 1]
        return sig

    def base_disp_series(self, sim_time, dt, total_steps, rundir="."):
        """Per-step interpolated base displacements [T, n, 3]
        (bldgs_get_base_disp :1120-1144)."""
        sig = self.read_base_signals(sim_time, rundir)
        t = np.arange(total_steps) * dt / self.fb_dt
        lo = np.minimum(t.astype(np.int64), sig.shape[1] - 2)
        frac = (t - lo)[:, None, None]
        return (1 - frac) * sig[:, lo].transpose(1, 0, 2) \
            + frac * sig[:, lo + 1].transpose(1, 0, 2)
