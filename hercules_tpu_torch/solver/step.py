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
s), the plastic state update of the nonlinear elements, the source
forces, the DRM effective forces, the element forces scattered to the
nodes (the nonlinear elements' linear stiffness zeroed: their elastic
force is the stress integral), the nonlinear elements' force and, with
geostatic loading, the gravity and bottom-reaction forces
(``_geostatic_forces``), the dangling distribution, the node update,
the geostatic bottom pin, the fixed-base displacements, the dangling
assignment.

The state is global: (u [N, 3], u- [N, 3], conv), conv None or, with
BKT damping, four [E, 8, 3] memory-variable arrays (s0, s1, k0, k1);
with nonlinear soil (``nl=``, the bundle of ``attach_nonlinear``) a
fourth entry, the plastic state (stresses [Enl, 8, 6], plastic strains
[Enl, 8, 6], ep [Enl, 8][, bottom reactions [Eb, 4] with geostatic
loading]), as the JAX carry holds it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nonlinear import (G, nl_device_tables, nl_force, nl_state_shapes,
                         nl_state_update, smooth_rise_factor)
from ..utils.timers import measure
from .brickstep import SegmentSum
from .chunking import run_chunked


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


def drm_lerp(Fdev, aux, step_idx):
    """The DRM effective force of step ``step_idx``: the records Fdev
    [R, M, 3] interpolated linearly, ``aux`` steps per record; k and
    frac from the step index on the host, frac in Fdev's type as the
    JAX package casts it."""
    fdt = {torch.float32: np.float32, torch.float64: np.float64}[Fdev.dtype]
    k = min(step_idx // aux, Fdev.shape[0] - 2)
    frac = fdt(step_idx % aux) / fdt(aux)
    return float(fdt(1.0) - frac) * Fdev[k] + float(frac) * Fdev[k + 1]


def make_step(tables, src_ids, st_nodes=None, st_phi=None,
              dtype=torch.float64, nl=None, drm=None, device="cuda"):
    """Build the step function; returns (step, d).

    step(carry, x) -> (carry, sample):
    carry = (u_now, u_prev, conv[, nl_state])   [conv None unless BKT]
    x     = (per-step source force [L, 3] (dt^2-scaled), step index
            (a Python int)[, fixed-base displacements [B, 3]])
    sample = station displacements [S, 3] of u_now (empty if no
            stations)

    nl: optional nonlinear bundle from attach_nonlinear(), on the same
    device: the nonlinear elements' elastic force flows through the
    plastic stress integral instead of the linear stiffness operator
    (stiffness.c:46-105 excludes them), with optional geostatic
    gravity loading.  drm: optional PART2 bundle {"ids" [M], "Fdev"
    [R, M, 3] tensor, "aux" steps per record}: the effective forces,
    interpolated linearly between records (drm.c:2316-2437).
    d["fb_ids"], set by the caller, names the fixed-base nodes that x's
    third entry prescribes (buildings.c:1146)."""
    device = torch.device(device)
    d = _dev(tables, dtype, device)
    if nl is not None:
        # zero the linear stiffness coefficients of nonlinear elements
        # (linear_elements_mapping); damping c3/c4 stay active for all.
        # Out of place: on the CPU d's tensors share the tables' memory
        for k in ("c1", "c2"):
            d[k] = d[k].index_fill(0, nl["rows"], 0.0)
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
        aux = int(drm["aux"])

    def step(carry, x):
        srcf, step_idx = x[0], int(x[1])
        fb_disp = x[2] if len(x) == 3 else None
        u_now, u_prev, conv = carry[:3]

        # station sample of the current displacement (output row s)
        if st_nodes is not None:
            sample = torch.einsum("sn,snc->sc", st_phi, u_now[st_nodes])
        else:
            sample = u_now.new_zeros((0, 3))

        # nonlinear state update first (solver_nonlinear_state,
        # psolve.c:4287)
        if nl is not None:
            nlstate = carry[3]
            ue = u_now[nl["lnid"]].reshape(nl["n"], 24)
            nlstate = nl_state_update(nl["d"], ue, nlstate[:3], nl["dt"]) \
                + tuple(nlstate[3:])

        # source force (compute_addforce_s, psolve.c:5912-5928): each
        # source node once, its forces summed in their order
        force = u_now.new_zeros((N, 3))
        if has_src:
            force[src.ids] = src(srcf)

        if drm is not None:
            # DRM effective force: lerp between force records
            # (solver_compute_effective_drm_force, drm.c:2316-2437)
            fd = drm_lerp(drm["Fdev"], aux, step_idx)
            force = force.index_add(0, drm_sum.ids, drm_sum(fd))

        f_elem, conv = element_forces(d, damping, u_now, u_prev, conv)
        force = force + scatter_to_nodes(d, N, f_elem)

        if nl is not None:
            fnl = nl_force(nl["d"], nlstate[:3], nl["dt2"])  # [Enl, 24]
            s = nl["scat_sum"]
            force = force.index_add(0, s.ids, s(fnl.reshape(-1, 3)))
            if nl["geostatic"]:
                force, nlstate = _geostatic_forces(d, nl, force, u_now,
                                                   step_idx, nlstate)

        force = dangling_distribute(d, N, force)

        # node update (solver_compute_displacement, psolve.c:4072-4114)
        # in increment form: u+ = u + (F + m*(u - u-))/ms
        u_next = u_now + (force + d["mass_minusaM"]
                          * (u_now - u_prev)) * d["inv_mass"][:, None]

        if nl is not None and nl["geostatic"] \
                and step_idx <= nl["final_step"]:
            # geostatic_displacements_fix: bottom z pinned during loading
            u_next[nl["bot_nodes"], 2] = 0.0

        if fb_disp is not None and "fb_ids" in d:
            # fixed-base buildings: prescribed base displacements
            # (bldgs_load_fixedbase_disps, buildings.c:1146)
            u_next[d["fb_ids"]] = fb_disp

        u_next = dangling_assign(d, u_next)
        if nl is None:
            return (u_next, u_now, conv), sample
        return (u_next, u_now, conv, nlstate), sample

    return step, d


def _geostatic_forces(d, nl, force, u_now, step_idx, nlstate):
    """compute_addforce_gravity + bottom reactions
    (nonlinear.c:1302-1504): the rise-scaled gravity weights of every
    element corner; the bottom elements' reactions captured at the
    final geostatic step and added after it (the JAX package's
    jnp.where on the step index, here a branch on the host)."""
    sig, pstr, ep, reactions = nlstate
    rise = nl["rise"][min(step_idx, nl["rise"].shape[0] - 1)]
    g = nl["grav_sum"]
    force = force.clone()
    force[g.ids, 2] += g(nl["grav_W"][:, None] * rise)[:, 0]
    Eb = nl["bot_lnid"].shape[0]
    if Eb:
        if step_idx == nl["final_step"]:
            ub = u_now[nl["bot_lnid"]].reshape(Eb, 24)
            a = nl["bc1"][:, None] * ub
            b = nl["bc2"][:, None] * ub
            kf = (torch.cat([a, b], 1) @ d["m48"]).reshape(Eb, 8, 3)
            reactions = kf[:, 4:, 2] - nl["bot_W"][:, None]   # [Eb, 4]
        if step_idx > nl["final_step"]:
            s = nl["bot_sum"]
            force[s.ids, 2] += s(reactions.reshape(-1, 1))[:, 0]
    return force, (sig, pstr, ep, reactions)


def attach_nonlinear(mesh, params, tables, nl_tables, dtype=torch.float64,
                     device="cuda"):
    """Build the nonlinear bundle consumed by make_step, on ``device``
    (the CUDA device unless the caller asks for the CPU): the plastic
    constants (nonlinear.nl_device_tables), the elements' corner nodes
    and the fixed-order sum of their forces into the nodes; with
    geostatic loading, the gravity weights per corner (dt^2 folded),
    the smooth rise factor table, the bottom elements' stiffness
    coefficients, weights and reaction sum, and the pinned bottom
    nodes."""
    from .fused_brick import solver_device

    device = solver_device(device)
    t = nl_tables
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    lnid = mesh.elem_lnid[t.eidx].astype(np.int64)
    nl = {
        "d": nl_device_tables(t, dtype, device),
        "rows": i(t.eidx),
        "lnid": i(lnid),
        "scat_sum": SegmentSum(lnid.ravel(), device),
        "dt": params.delta_t,
        "dt2": params.delta_t ** 2,
        "geostatic": t.cfg.geostatic_loading_t > 0,
        "n": t.n,
        "parts": nl_state_shapes(t),
    }
    if nl["geostatic"]:
        dt2 = params.delta_t ** 2
        final = t.cfg.geostatic_final_step(params.delta_t)
        nl["final_step"] = final
        # per-corner gravity weights (dt^2 folded), summed into nodes
        nl["grav_W"] = f(np.repeat(t.grav_W * dt2, 8))
        nl["grav_sum"] = SegmentSum(mesh.elem_lnid.ravel(), device)
        # smooth rise factor lookup for the geostatic window
        ngeo = int(t.cfg.geostatic_loading_t / params.delta_t)
        nl["rise"] = f(smooth_rise_factor(np.arange(final + 2), ngeo))
        # bottom elements: reaction capture + replay
        be = t.bot_eidx
        bl = mesh.elem_lnid[be].astype(np.int64)
        nl["bot_lnid"] = i(bl)
        nl["bc1"] = f(tables.c1[be])
        nl["bc2"] = f(tables.c2[be])
        nl["bot_W"] = f(mesh.props["rho"][be] * mesh.edge_m[be] ** 3 * G
                        * 0.125 * dt2)
        nl["bot_sum"] = SegmentSum(bl[:, 4:].ravel(), device)
        # bottom nodes for the displacement fix
        nl["bot_nodes"] = i(np.unique(bl[:, 4:]))
    return nl




def init_state(tables, dtype=torch.float64, nl=None, device="cuda"):
    """The zero state (u, u-, conv[, nl_state]) on ``device``."""
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    u = z((tables.N, 3))
    conv = None
    if tables.damping == "bkt":
        conv = tuple(z((tables.E, 8, 3)) for _ in range(4))
    if nl is None:
        return (u, u, conv)
    return (u, u, conv, tuple(z(s) for s in nl["parts"]))


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
    PART2 bundle {"ids", "F" [R, M, 3] host array, "aux"}.  nl: optional
    attach_nonlinear bundle (on ``device``).  state: (u, u-, conv[,
    nl_state]), tensors or arrays (cast to ``dtype`` on ``device``),
    zero when None.  Runs on the CUDA device unless ``device`` is the
    CPU.  Returns (final_state, station_samples [T, S, 3] numpy)."""
    from .fused_brick import solver_device

    device = solver_device(device)
    with measure("Solver tables", device):
        if drm is not None:
            drm = dict(drm)
            drm["Fdev"] = torch.as_tensor(np.asarray(drm.pop("F")),
                                          dtype=dtype, device=device)
        step, d = make_step(tables, src_ids, st_nodes, st_phi, dtype,
                            nl=nl, drm=drm, device=device)
        if fb_ids is not None:
            d["fb_ids"] = torch.as_tensor(np.asarray(fb_ids, np.int64),
                                          device=device)
    if state is None:
        state = init_state(tables, dtype, nl=nl, device=device)
    else:
        on = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        u, up, conv = state[:3]
        fitted = (on(u), on(up),
                  None if conv is None else tuple(on(c) for c in conv))
        if nl is not None:
            want = nl["parts"]
            got = [tuple(np.shape(a)) for a in state[3]] \
                if len(state) > 3 else []
            if got != want:
                raise RuntimeError(f"nonlinear state {got} does not match "
                                   f"this mesh's layout {want}")
            fitted += (tuple(on(a) for a in state[3]),)
        state = fitted
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
        return state, torch.stack(samples)

    with measure("Solver time loop", device):
        return run_chunked(advance, state, total_steps,
                           start_step=start_step, chunk=chunk,
                           on_chunk=on_chunk, on_samples=on_samples,
                           device=device)
