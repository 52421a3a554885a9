"""Domain Reduction Method (DRM): three-phase workflow.

Counterpart of ``hercules_tpu/drm.py``, copied (numpy only;
``tests/test_torch_host.py`` holds it equal) but for ``attach_drm``,
which returns the node ids as numpy where the JAX package returns a jnp
array: the solvers move them to their device.

Re-implements drm.c (2660 lines).  The reference's phases:

- PART0: locate the DRM interface nodes in the big-domain mesh and
  save their coordinates (find_drm_nodes :833)
- PART1: big-domain run recording interface displacements at
  drm_print_rate (setup_drm_data :1081, drm_output :597)
- PART2: reduced-domain run replaying them as effective forces
  fb = -dt^2 Kbe ue,  fe = +dt^2 Keb ub across the interface
  (solver_compute_effective_drm_force :2316-2437), with linear time
  interpolation between records (:2334-2338)

The classification generalizes is_drm_elem's five-face case tables
(:453-536): a corner is *boundary* iff it lies inside-or-on the DRM
box, *exterior* otherwise; a DRM element has both kinds.  The MPI hash
tables and per-PE file redistribution (:1687, :2475-2655) disappear:
one coordinate file and one displacement file, rank-elastic.

Because the effective force is linear in the recorded displacements,
PART2 precomputes per-record force snapshots on host and the jitted
step lerps *forces* instead of displacements — same algebra, one
gather per step.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .physics.kmats import stiffness_matrices_24


@dataclass
class DRMConfig:
    part: str = "part0"         # part0 | part1 | part2
    directory: str = ""
    print_rate: int = 1
    edgesize: float = 0.0
    xmin: float = 0.0
    ymin: float = 0.0
    xmax: float = 0.0
    ymax: float = 0.0
    depth: float = 0.0
    x_offset: float = 0.0
    y_offset: float = 0.0
    part1_delta_t: float = 0.0

    @classmethod
    def parse(cls, cfg):
        """drm_initparameters (drm.c:218-313)."""
        c = cls()
        c.directory = cfg.get_string("drm_directory", required=True)
        c.part = cfg.get_string("which_drm_part", required=True).lower()
        c.edgesize = cfg.get_double("drm_edgesize", required=True)
        c.x_offset = cfg.get_double("drm_offset_x", required=True)
        c.y_offset = cfg.get_double("drm_offset_y", required=True)
        c.print_rate = cfg.get_int("drm_print_rate", required=True)
        c.part1_delta_t = cfg.get_double("part1_delta_t", required=True)
        b = cfg.get_array("drm_boundary", 5)
        c.xmin, c.ymin, c.xmax, c.ymax, c.depth = b
        return c

    def box_for_part(self):
        """PART2 meshes the reduced domain: the box shifts by the
        configured offsets (drm.c theX_Offset/theY_Offset)."""
        if self.part == "part2":
            return (self.xmin - self.x_offset, self.ymin - self.y_offset,
                    self.xmax - self.x_offset, self.ymax - self.y_offset,
                    self.depth)
        return (self.xmin, self.ymin, self.xmax, self.ymax, self.depth)


@dataclass
class DRMPlan:
    cfg: DRMConfig
    elem_idx: np.ndarray        # [Ed] DRM element indices
    mask_b: np.ndarray          # [Ed, 8] boundary-corner mask
    node_ids: np.ndarray        # [L] all corners of DRM elements (unique)
    node_coords: np.ndarray     # [L, 3] meters
    elem_node_rows: np.ndarray  # [Ed, 8] index into node_ids


def classify(mesh, cfg: DRMConfig, surface_shift=0.0) -> DRMPlan:
    """DRM element/corner classification on the current mesh."""
    xmin, ymin, xmax, ymax, depth = cfg.box_for_part()
    ts = mesh.ticksize
    e = mesh.edgeticks()
    w = np.arange(8)
    cx = (mesh.elem_x.astype(np.int64)[:, None]
          + e[:, None] * (w & 1)) * ts
    cy = (mesh.elem_y.astype(np.int64)[:, None]
          + e[:, None] * ((w >> 1) & 1)) * ts
    cz = (mesh.elem_z.astype(np.int64)[:, None]
          + e[:, None] * ((w >> 2) & 1)) * ts - surface_shift

    inside = ((cx >= xmin) & (cx <= xmax) & (cy >= ymin) & (cy <= ymax)
              & (cz <= depth))
    has_b = inside.any(axis=1)
    has_e = (~inside).any(axis=1)
    sel = has_b & has_e
    elem_idx = np.flatnonzero(sel)
    mask_b = inside[sel]

    lnids = mesh.elem_lnid[elem_idx]
    node_ids, inv = np.unique(lnids, return_inverse=True)
    rows = inv.reshape(len(elem_idx), 8)
    coords = np.stack([mesh.node_x[node_ids], mesh.node_y[node_ids],
                       mesh.node_z[node_ids]], 1).astype(np.float64) * ts
    return DRMPlan(cfg=cfg, elem_idx=elem_idx, mask_b=mask_b,
                   node_ids=node_ids.astype(np.int32),
                   node_coords=coords,
                   elem_node_rows=rows.astype(np.int32))


# ---------------------------------------------------------------------------
# file formats (single global files; replaces the per-PE drm_file
# machinery, drm.c:1687-2262)

def write_coords(outdir, plan: DRMPlan):
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "drm_coordinates.bin")
    with open(path, "wb") as f:
        np.array([len(plan.node_ids)], "<i8").tofile(f)
        plan.node_coords.astype("<f8").tofile(f)
    return path


def read_coords(outdir):
    path = os.path.join(outdir, "drm_coordinates.bin")
    with open(path, "rb") as f:
        n = int(np.fromfile(f, "<i8", 1)[0])
        coords = np.fromfile(f, "<f8", n * 3).reshape(n, 3)
    return coords


def write_info(outdir, plan: DRMPlan):
    """The reference's drm_information record (drm.c:679-684): node
    and element counts of the classified DRM boundary, written by
    part0/part1 and cross-checked by part2's sanity pass."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "drm_information")
    with open(path, "w") as f:
        f.write(f"drm_numberofnodes = {len(plan.node_ids)} \n"
                f"drm_numberofelements = {len(plan.elem_idx)}")
    return path


def sanity_check(outdir, plan: DRMPlan):
    """drm_sanity_check (drm.c:2439-2470): the part2 mesh must
    classify the same number of DRM elements as the recording run —
    a mismatch means the DRM boundary moved between parts.  No-op
    when no drm_information record exists (pre-record dirs)."""
    path = os.path.join(outdir, "drm_information")
    if not os.path.exists(path):
        return
    from .config import ConfigFile
    info = ConfigFile(path)
    n_ref = info.get_int("drm_numberofelements")
    if n_ref is not None and n_ref != len(plan.elem_idx):
        raise RuntimeError(
            f"drm boundary has changed: part2 classified "
            f"{len(plan.elem_idx)} DRM elements but the recording "
            f"run wrote drm_numberofelements = {n_ref} "
            f"(drm.c:2459-2464)")


class DRMRecorder:
    """PART1: append interface displacements every print_rate steps."""

    def __init__(self, outdir, plan: DRMPlan):
        os.makedirs(outdir, exist_ok=True)
        write_coords(outdir, plan)
        write_info(outdir, plan)
        self.fp = open(os.path.join(outdir, "drm_disp.bin"), "wb")
        self.plan = plan
        self.count = 0

    def record(self, step, u_global):
        if step % self.plan.cfg.print_rate:
            return False
        u = np.asarray(u_global)[self.plan.node_ids]
        u.astype("<f8").tofile(self.fp)
        self.count += 1
        return True

    def record_rows(self, step, rows):
        """Like record, but takes the [L, 3] interface rows directly
        (the in-scan sampling path — no full-field staging)."""
        if step % self.plan.cfg.print_rate:
            return False
        np.asarray(rows).astype("<f8").tofile(self.fp)
        self.count += 1
        return True

    def close(self):
        self.fp.close()


def read_displacements(outdir, n_nodes):
    path = os.path.join(outdir, "drm_disp.bin")
    data = np.fromfile(path, "<f8")
    s = len(data) // (n_nodes * 3)
    return data[: s * n_nodes * 3].reshape(s, n_nodes, 3)


# ---------------------------------------------------------------------------
# PART2: effective forces

def effective_force_records(plan: DRMPlan, tables, u_records):
    """Per-record effective nodal forces [S, L, 3].

    f_b = -(c1 K1 + c2 K2)[b,e] u_e ; f_e = +(c1 K1 + c2 K2)[e,b] u_b
    with the recorded field split by the boundary mask (the b-b and
    e-e couplings cancel by construction)."""
    M1, M2 = stiffness_matrices_24()
    Ed = len(plan.elem_idx)
    c1 = tables.c1[plan.elem_idx]
    c2 = tables.c2[plan.elem_idx]
    mb = np.repeat(plan.mask_b, 3, axis=1).astype(np.float64)  # [Ed, 24]
    S = u_records.shape[0]
    L = u_records.shape[1]
    out = np.zeros((S, L, 3))
    Ksym = None
    for s in range(S):
        ue24 = u_records[s][plan.elem_node_rows].reshape(Ed, 24)
        ub = ue24 * mb
        uext = ue24 * (1 - mb)
        # K u with per-element coefficients via the 24x24 operators
        ku_ext = (c1[:, None] * (uext @ M1.T)
                  + c2[:, None] * (uext @ M2.T))
        ku_b = (c1[:, None] * (ub @ M1.T) + c2[:, None] * (ub @ M2.T))
        f = -mb * ku_ext + (1 - mb) * ku_b          # [Ed, 24]
        np.add.at(out[s], plan.elem_node_rows.ravel(),
                  f.reshape(Ed * 8, 3))
    return out


def attach_drm(plan: DRMPlan, tables, params, outdir):
    """Build the PART2 bundle {"ids" [L] int32, "F" [R, L, 3] float64,
    "aux" steps per record} (consumed by step.make_step, and by
    fused_mesh.attach_drm_mesh)."""
    sanity_check(outdir, plan)
    coords = read_coords(outdir)
    if len(coords) != len(plan.node_ids):
        raise ValueError(
            f"DRM coordinate count mismatch: recorded {len(coords)}, "
            f"part2 mesh has {len(plan.node_ids)}")
    # match recorded nodes to part2 nodes by (offset-shifted) coords
    shift = np.array([plan.cfg.x_offset, plan.cfg.y_offset, 0.0])
    rec_shifted = coords - shift
    order_rec = np.lexsort(rec_shifted.T)
    order_p2 = np.lexsort(plan.node_coords.T)
    if not np.allclose(rec_shifted[order_rec],
                       plan.node_coords[order_p2], atol=1e-6):
        raise ValueError("DRM node coordinates do not match part1 "
                         "records (check drm_offset_x/y)")
    u_rec = read_displacements(outdir, len(coords))
    # reorder records into part2 node order
    perm = np.empty(len(coords), np.int64)
    perm[order_p2] = order_rec
    u_rec = u_rec[:, perm]

    F = effective_force_records(plan, tables, u_rec)
    # pad one trailing record for the lerp upper index
    F = np.concatenate([F, F[-1:]], axis=0)
    aux = int(round(plan.cfg.print_rate * plan.cfg.part1_delta_t
                    / params.delta_t))
    return {
        "ids": np.asarray(plan.node_ids, np.int32),
        "F": F,
        "aux": max(aux, 1),
    }
