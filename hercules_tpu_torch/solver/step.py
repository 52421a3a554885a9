"""The unstructured explicit central-difference step in plain PyTorch
ops: the route of ``Simulation.run`` for meshes that do not decompose
into bricks (route name "unstructured"), and the port's second oracle.

Counterpart of ``hercules_tpu/solver/step.py``; the JAX names,
arguments and return shapes are kept (``element_forces``,
``scatter_to_nodes``, ``dangling_distribute``, ``dangling_assign``,
``make_step``, ``init_state``, ``run_solver``).  The JAX package
computes this step in XLA, outside any Pallas kernel, and so does the
port in torch ops: the element force is one batched [E, 48] @ [48, 24]
product against the constant operators (physics.kmats), the corner
gathers index the node field, and every sum over a scattered set (the
element-to-node accumulation, the dangling distribution, the sources
and the DRM forces at their nodes) runs in a fixed order
(``brickstep.SegmentSum``), so that a CUDA run repeats its bits.

Per step (solver_run, psolve.c:4241-4324): the station sample of the
current displacement (row s of the samples is the field before step
s), the source forces, the DRM effective forces, the element forces
scattered to the nodes, the dangling distribution, the node update,
the fixed-base displacements, the dangling assignment.

The state is global: (u [N, 3], u- [N, 3], conv), conv None or, with
BKT damping, four [E, 8, 3] memory-variable arrays (s0, s1, k0, k1).

The nonlinear branch (``nl=``, ``_geostatic_forces``,
``attach_nonlinear``) needs the nonlinear tables of ROADMAP Queue 1,
item 7: passing ``nl`` raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timers import measure
from .brickstep import SegmentSum
from .chunking import run_chunked

NL_REFUSAL = ("the unstructured solver's nonlinear branch needs the "
              "nonlinear soil tables (Queue 1, item 7)")


def _dev(tables, dtype, device):
    """The solver tables as tensors on ``device``: floats in ``dtype``,
    indices int64; the segment sums of the element-to-node scatter and
    of the dangling distribution."""
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    d = {
        "lnid": i(tables.lnid),
        "m48": f(tables.m48),
        "c1": f(tables.c1), "c2": f(tables.c2),
        "c3": f(tables.c3), "c4": f(tables.c4),
        "inv_mass": f(tables.inv_mass),
        "mass_minusaM": f(tables.mass_minusaM),
        "scat_perm": i(tables.scat_perm),
        "scat_sum": SegmentSum(tables.scat_seg, device),
        "dn_ids": i(tables.dn_ids),
        "dn_anchors": i(tables.dn_anchors),
        "dn_weights": f(tables.dn_weights),
        "dn_scat_perm": i(tables.dn_scat_perm),
        "dn_sum": SegmentSum(tables.dn_scat_seg, device),
    }
    if tables.damping == "bkt":
        d["kmu"] = f(tables.kmu)
        d["kkappa"] = f(tables.kkappa)
        d["bkt"] = {k: f(v) for k, v in tables.bkt.items()}
    return d


def element_forces(d, damping, u_now, u_prev, conv=None):
    """Element nodal forces [E, 8, 3] from current/previous displacement.

    rayleigh/mass/none: f = -(c1 M1 + c2 M2) u - (c3 M1 + c4 M2) du
    (compute_addforce_effective + damping_addforce); returns (f, None).
    bkt: calc_conv + constant_Q_addforce; returns (f, new_conv)."""
    lnid = d["lnid"]
    E = lnid.shape[0]
    ue = u_now[lnid].reshape(E, 24)
    upe = u_prev[lnid].reshape(E, 24)

    if damping != "bkt":
        du = ue - upe
        a = d["c1"][:, None] * ue + d["c3"][:, None] * du
        b = d["c2"][:, None] * ue + d["c4"][:, None] * du
        f = -(torch.cat([a, b], 1) @ d["m48"])        # [E, 24]
        return f.reshape(E, 8, 3), None

    # ---- BKT ----
    bk = d["bkt"]
    ue3 = ue.reshape(E, 8, 3)
    upe3 = upe.reshape(E, 8, 3)
    s0, s1, k0, k1 = conv

    def col(name):
        return bk[name][:, None, None]

    def upd(f0, f1, p):
        f0n = (col(f"{p}_c2") * ue3 + col(f"{p}_c1") * upe3
               + col(f"{p}_e0") * f0)
        f1n = (col(f"{p}_c4") * ue3 + col(f"{p}_c3") * upe3
               + col(f"{p}_e1") * f1)
        return f0n, f1n

    s0, s1 = upd(s0, s1, "shear")
    k0, k1 = upd(k0, k1, "kappa")

    du3 = ue3 - upe3
    # damping vectors (constant_Q_addforce, damping.c:266-372)
    dvs = (col("shear_coef") * du3
           - (col("a0_shear") * s0 + col("a1_shear") * s1) + ue3)
    dvk = (col("kappa_coef") * du3
           - (col("a0_kappa") * k0 + col("a1_kappa") * k1) + ue3)
    f = (bk["mu_f"][:, None] * (dvs.reshape(E, 24) @ d["kmu"])
         + bk["kappa_f"][:, None] * (dvk.reshape(E, 24) @ d["kkappa"]))
    return f.reshape(E, 8, 3), (s0, s1, k0, k1)


def _segment_total(seg_sum, rows, N):
    """[N, 3]: ``rows`` summed by segment in their fixed order, zero at
    the nodes no row reaches."""
    sums = seg_sum(rows)
    if sums.shape[0] == N:                   # ids are 0 .. N-1
        return sums
    return sums.new_zeros((N, 3)).index_copy_(0, seg_sum.ids, sums)


def scatter_to_nodes(d, N, f_elem):
    """Element-corner forces -> node forces via sorted segment sum."""
    flat = f_elem.reshape(-1, 3)[d["scat_perm"]]
    return _segment_total(d["scat_sum"], flat, N)


def dangling_distribute(d, N, v):
    """compute_adjust DISTRIBUTION: add each dangling value (prorated)
    to its anchors (psolve.c:5943-5988)."""
    if d["dn_ids"].shape[0] == 0:
        return v
    contrib = (v[d["dn_ids"]][:, None, :]
               * d["dn_weights"][:, :, None]).reshape(-1, 3)
    s = d["dn_sum"]
    # each anchor once: v + its total, as v + the [N, 3] sum
    return v.index_add(0, s.ids, s(contrib[d["dn_scat_perm"]]))


def dangling_assign(d, v):
    """compute_adjust ASSIGNMENT: dangling value = prorated sum of its
    anchors (psolve.c:5990-6036).  Writes into ``v`` (the step's own
    new field) at the unique dangling ids."""
    if d["dn_ids"].shape[0] == 0:
        return v
    vals = (v[d["dn_anchors"]] * d["dn_weights"][:, :, None]).sum(dim=1)
    v[d["dn_ids"]] = vals
    return v


def _np_dtype(dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def make_step(tables, src_ids, st_nodes=None, st_phi=None,
              dtype=torch.float64, nl=None, drm=None, device="cuda"):
    """Build the step function; returns (step, d).

    step(carry, x) -> (carry, sample):
    carry = (u_now, u_prev, conv)   [conv None unless BKT]
    x     = (per-step source force [L, 3] (dt^2-scaled), step index
            (a Python int)[, fixed-base displacements [B, 3]])
    sample = station displacements [S, 3] of u_now (empty if no
            stations)

    drm: optional PART2 bundle {"ids" [M], "Fdev" [R, M, 3] tensor,
    "aux" steps per record}: the effective forces, interpolated
    linearly between records (drm.c:2316-2437).  d["fb_ids"], set by
    the caller, names the fixed-base nodes that x's third entry
    prescribes (buildings.c:1146)."""
    if nl is not None:
        raise NotImplementedError(NL_REFUSAL)
    device = torch.device(device)
    d = _dev(tables, dtype, device)
    N = tables.N
    damping = tables.damping
    src = SegmentSum(np.asarray(src_ids, np.int64), device)
    has_src = len(src_ids) > 0
    if st_nodes is not None:
        st_nodes = torch.as_tensor(np.asarray(st_nodes, np.int64),
                                   device=device)
        st_phi = torch.as_tensor(np.asarray(st_phi), dtype=dtype,
                                 device=device)
    if drm is not None:
        drm_sum = SegmentSum(np.asarray(drm["ids"], np.int64), device)
        n_rec = drm["Fdev"].shape[0]
        aux = int(drm["aux"])
        fdt = _np_dtype(dtype)

    def step(carry, x):
        srcf, step_idx = x[0], int(x[1])
        fb_disp = x[2] if len(x) == 3 else None
        u_now, u_prev, conv = carry

        # station sample of the current displacement (output row s)
        if st_nodes is not None:
            sample = torch.einsum("sn,snc->sc", st_phi, u_now[st_nodes])
        else:
            sample = u_now.new_zeros((0, 3))

        # source force (compute_addforce_s, psolve.c:5912-5928): each
        # source node once, its forces summed in their order
        force = u_now.new_zeros((N, 3))
        if has_src:
            force[src.ids] = src(srcf)

        if drm is not None:
            # DRM effective force: lerp between force records
            # (solver_compute_effective_drm_force, drm.c:2316-2437); k
            # and frac from the step index on the host, frac in the
            # run's type as the JAX package casts it
            k = min(step_idx // aux, n_rec - 2)
            frac = fdt(step_idx % aux) / fdt(aux)
            Fdev = drm["Fdev"]
            fd = float(fdt(1.0) - frac) * Fdev[k] + float(frac) * Fdev[k + 1]
            force = force.index_add(0, drm_sum.ids, drm_sum(fd))

        f_elem, conv = element_forces(d, damping, u_now, u_prev, conv)
        force = force + scatter_to_nodes(d, N, f_elem)
        force = dangling_distribute(d, N, force)

        # node update (solver_compute_displacement, psolve.c:4072-4114)
        # in increment form: u+ = u + (F + m*(u - u-))/ms
        u_next = u_now + (force + d["mass_minusaM"]
                          * (u_now - u_prev)) * d["inv_mass"][:, None]

        if fb_disp is not None and "fb_ids" in d:
            # fixed-base buildings: prescribed base displacements
            # (bldgs_load_fixedbase_disps, buildings.c:1146)
            u_next[d["fb_ids"]] = fb_disp

        u_next = dangling_assign(d, u_next)
        return (u_next, u_now, conv), sample

    return step, d


def init_state(tables, dtype=torch.float64, nl=None, device="cuda"):
    """The zero state (u, u-, conv) on ``device``."""
    if nl is not None:
        raise NotImplementedError(NL_REFUSAL)
    u = torch.zeros((tables.N, 3), dtype=dtype, device=device)
    conv = None
    if tables.damping == "bkt":
        conv = tuple(torch.zeros((tables.E, 8, 3), dtype=dtype,
                                 device=device) for _ in range(4))
    return (u, u, conv)


def run_solver(tables, src_ids, src_forces, total_steps, dt,
               st_nodes=None, st_phi=None, dtype=torch.float64,
               chunk=None, state=None, start_step=0, on_chunk=None,
               nl=None, fb_ids=None, fb_series=None, drm=None,
               on_samples=None, device="cuda"):
    """Run the time loop in chunks; the contract of the JAX package's
    run_solver.

    src_forces: [T, L, 3] host array (unscaled; dt^2 applied here, in
    float64 before the cast).  fb_ids/fb_series: optional fixed-base
    node ids [B] and prescribed displacements [T, B, 3].  drm: optional
    PART2 bundle {"ids", "F" [R, M, 3] host array, "aux"}.  state: (u,
    u-, conv), tensors or arrays (cast to ``dtype`` on ``device``), zero
    when None.  Runs on the CUDA device unless ``device`` is the CPU.
    Returns (final_state, station_samples [T, S, 3] numpy)."""
    from .fused_brick import solver_device

    if nl is not None:
        raise NotImplementedError(NL_REFUSAL)
    device = solver_device(device)
    with measure("Solver tables", device):
        if drm is not None:
            drm = dict(drm)
            drm["Fdev"] = torch.as_tensor(np.asarray(drm.pop("F")),
                                          dtype=dtype, device=device)
        step, d = make_step(tables, src_ids, st_nodes, st_phi, dtype,
                            drm=drm, device=device)
        if fb_ids is not None:
            d["fb_ids"] = torch.as_tensor(np.asarray(fb_ids, np.int64),
                                          device=device)
    if state is None:
        state = init_state(tables, dtype, device=device)
    else:
        on = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        u, up, conv = state
        state = (on(u), on(up),
                 None if conv is None else tuple(on(c) for c in conv))
    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt

    def advance(state, s, k):
        srcf = torch.as_tensor(np.asarray(src_forces[s:s + k]) * dt2,
                               dtype=dtype, device=device)
        fb = (None if fb_series is None else
              torch.as_tensor(np.asarray(fb_series[s:s + k]), dtype=dtype,
                              device=device))
        samples = []
        for i in range(k):
            x = (srcf[i], s + i) if fb is None else (srcf[i], s + i, fb[i])
            state, sample = step(state, x)
            samples.append(sample)
        return state, torch.stack(samples).cpu().numpy()

    with measure("Solver time loop", device):
        return run_chunked(advance, state, total_steps,
                           start_step=start_step, chunk=chunk,
                           on_chunk=on_chunk, on_samples=on_samples)
