"""Assemble static solver tables from the mesh: everything the time
step needs, as host (numpy) arrays.

A numpy copy of ``hercules_tpu/solver/assemble.py``: that module sits
in a package whose ``__init__`` imports jax, so the port keeps its own
copy.  The tables are array-for-array equal to the JAX package's
(tests/test_torch_tables.py).

This is solver_init (psolve.c:3280-3510) re-shaped for accelerators:
instead of per-element structs and linked comm schedules, flat arrays +
a sorted segment-sum scatter plan + dense dangling dependence tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from hercules_tpu.physics.consts import (compute_setab,
                                         element_coefficients,
                                         node_masses)
from hercules_tpu.physics.kmats import (bkt_matrices_24,
                                        stiffness_matrices_24)


@dataclass
class SolverTables:
    """Device-ready solver tables (host numpy; cast on transfer)."""

    N: int
    E: int
    dt: float
    damping: str                  # rayleigh | mass | none | bkt

    lnid: np.ndarray              # [E, 8] int32
    # stiffness/damping operator: f24 -= ab48 @ M48x24
    m48: np.ndarray               # [48, 24] = [[M1], [M2]] (row blocks)
    c1: np.ndarray                # [E]
    c2: np.ndarray
    c3: np.ndarray
    c4: np.ndarray

    inv_mass: np.ndarray          # [N] 1/mass_simple
    mass_minusaM: np.ndarray      # [N, 3]
    mass2_minusaM: np.ndarray     # [N, 3]

    # element-corner -> node scatter plan (sorted segment sum)
    scat_perm: np.ndarray         # [E*8] int32
    scat_seg: np.ndarray          # [E*8] int32 sorted node ids

    # dangling adjust
    dn_ids: np.ndarray            # [D] int32
    dn_anchors: np.ndarray        # [D, 4] int32
    dn_weights: np.ndarray        # [D, 4]
    dn_scat_perm: np.ndarray      # [D*4] int32 (distribution scatter)
    dn_scat_seg: np.ndarray       # [D*4] int32

    # BKT (zeros when damping != bkt)
    kmu: Optional[np.ndarray] = None        # [24, 24]
    kkappa: Optional[np.ndarray] = None
    bkt: dict = field(default_factory=dict)  # per-element coefficient arrays

    meta: dict = field(default_factory=dict)


def assemble(mesh, params, boundary=True, halfspace=True) -> SolverTables:
    props = mesh.props
    a_base, b_base = compute_setab(params.freq, params.type_of_damping)
    coeffs = element_coefficients(props, mesh.edge_m, params, a_base,
                                  b_base)
    mass_simple, mass_m, mass2_m = node_masses(
        mesh, props, coeffs, params, boundary=boundary,
        halfspace=halfspace)

    M1, M2 = stiffness_matrices_24()
    m48 = np.concatenate([M1.T, M2.T], axis=0)  # ab48 @ m48 = a@M1.T+b@M2.T

    E, N = mesh.lenum, mesh.nnum
    seg = mesh.elem_lnid.ravel().astype(np.int32)
    perm = np.argsort(seg, kind="stable").astype(np.int32)

    dn = mesh.dn_ids.astype(np.int32)
    D = len(dn)
    dseg = mesh.dn_anchors.ravel().astype(np.int32)
    dperm = np.argsort(dseg, kind="stable").astype(np.int32)

    t = SolverTables(
        N=N, E=E, dt=params.delta_t, damping=params.type_of_damping,
        lnid=mesh.elem_lnid.astype(np.int32),
        m48=m48,
        c1=coeffs["c1"], c2=coeffs["c2"], c3=coeffs["c3"], c4=coeffs["c4"],
        inv_mass=1.0 / mass_simple,
        mass_minusaM=mass_m, mass2_minusaM=mass2_m,
        scat_perm=perm, scat_seg=seg[perm],
        dn_ids=dn, dn_anchors=mesh.dn_anchors.astype(np.int32),
        dn_weights=mesh.dn_weights,
        dn_scat_perm=dperm, dn_scat_seg=dseg[dperm],
        meta={"coeffs": coeffs},
    )

    if params.type_of_damping == "bkt":
        kmu, kkappa = bkt_matrices_24()
        t.kmu, t.kkappa = kmu.T, kkappa.T
        t.bkt = bkt_element_tables(props, t.c1, t.c2, params)

    return t


def bkt_element_tables(props, c1, c2, params) -> dict:
    """Per-element BKT recursion/combine coefficient rows
    (calc_conv / constant_Q_addforce constants, damping.c:110-416)
    from the attenuation props — shared by the global assemble and
    the shard-local table builders (parallel/shardbuild.py)."""
    rmax = 2.0 * np.pi * params.freq * params.delta_t
    b = {}
    for name in ("shear", "kappa"):
        g0 = props[f"g0_{name}"] * rmax
        g1 = props[f"g1_{name}"] * rmax
        c1_ = g0 / 2.0
        c3_ = g1 / 2.0
        b[f"{name}_c1"] = c1_
        b[f"{name}_c2"] = c1_ * (1.0 - g0)
        b[f"{name}_c3"] = c3_
        b[f"{name}_c4"] = c3_ * (1.0 - g1)
        b[f"{name}_e0"] = np.exp(-g0)
        b[f"{name}_e1"] = np.exp(-g1)
        b[f"{name}_coef"] = np.where(
            props[f"b_{name}"] != 0,
            props[f"b_{name}"] / rmax, 0.0)
        b[f"a0_{name}"] = props[f"a0_{name}"]
        b[f"a1_{name}"] = props[f"a1_{name}"]
    # operator coefficients (damping.c:376-377)
    b["mu_f"] = -0.5625 * c1
    b["kappa_f"] = -0.5625 * (c2 + 2.0 / 3.0 * c1)
    return b
