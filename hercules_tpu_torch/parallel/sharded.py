"""The unstructured multi-chip step: contiguous Z-order element blocks
(``partition.shard_tables``) on the ranks of a ``ranks.RankGroup``.

Counterpart of ``hercules_tpu/parallel/sharded.py``
(``sharded_step_builder``, ``init_sharded_state``, ``gather_global``).
Each rank's step is the unstructured solver's (``solver/step.py``: its
``element_forces``, ``scatter_to_nodes``, ``dangling_distribute``,
``dangling_assign``, ``_geostatic_forces`` and ``drm_lerp``, on the
rank's local tables):

1. element forces, the [E, 48] @ [48, 24] product as torch.matmul (the
   JAX package computes it in XLA, outside any Pallas kernel);
2. fixed-order segment sums to the local nodes (the sources and the DRM
   forces on the rank that owns their node);
3. the dangling distribution applied to the partial forces (linear, so
   one sum is exact);
4. one ``allsum`` per step of the [B_pad, 3] shared-node boundary
   buffer;
5. the update, which every replica of a shared node computes from the
   same totals: bit-identical, no share-back.

The state per rank: (u [N_pad, 3], u- [N_pad, 3], conv[, plastic
state]), conv () or with BKT four [E_pad, 8, 3] arrays, the plastic
state as ``partition.shard_nonlinear`` pads it ([NLpad, 8, 6] twice,
[NLpad, 8][, bottom reactions [EBpad, 4]]).  Node N_pad - 1 is the
trash slot padding scatters into; it stays zero.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver.brickstep import SegmentSum
from ..solver.step import (_geostatic_forces, dangling_assign,
                           dangling_distribute, drm_lerp, element_forces,
                           scatter_to_nodes)

NL_CONSTS = ("mu", "lam", "alpha", "k", "hard", "strainrate",
             "sensitivity", "h")


class ShardedStep:
    """The per-rank step of ``sharded_step_builder`` on a RankGroup.

    nl: partition.shard_nonlinear's bundle (the plastic state rides the
    state); drm: partition.shard_drm's (the effective forces lerped per
    step); fb: partition.shard_fixedbase's (the prescribed base
    displacements set on every local copy after the update)."""

    def __init__(self, st, group, dtype, nl=None, drm=None, fb=None):
        self.st, self.group, self.dtype = st, group, dtype
        self.nl, self.fb = nl, fb
        self.geostatic = bool(nl and nl["geostatic"])
        # per rank: the sources it owns (indices among the L sources)
        self.src_cols = [np.zeros(0, np.int64) if st.src_lidx is None
                         else np.flatnonzero(st.src_mask[r])
                         for r in range(group.size)]
        self.d = [self._rank_tables(r, dev, drm)
                  for r, dev in enumerate(group.devices)]

    def _rank_tables(self, r, dev, drm):
        st, nl = self.st, self.nl
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                      device=dev)
        i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
        d = {"lnid": i(st.lnid[r]), "m48": f(st.m48),
             "inv_mass": f(st.inv_mass[r]),
             "mass_minusaM": f(st.mass_minusaM[r]),
             "scat_perm": i(st.scat_perm[r]),
             "scat_sum": SegmentSum(st.scat_seg[r], dev),
             "dn_ids": i(st.dn_ids[r]), "dn_anchors": i(st.dn_anchors[r]),
             "dn_weights": f(st.dn_weights[r]),
             "dn_scat_perm": i(st.dn_scat_perm[r]),
             "dn_sum": SegmentSum(st.dn_scat_seg[r], dev)}
        d.update({k: f(v[r]) for k, v in st.c.items()})
        if st.damping == "bkt":
            d["kmu"], d["kkappa"] = f(st.kmu), f(st.kkappa)
            d["bkt"] = {k: f(v[r]) for k, v in st.bkt.items()}
        b = np.flatnonzero(st.b_mask[r])
        d["b_lidx"] = i(st.b_lidx[r][b])
        d["b_pos"] = i(b)
        own = self.src_cols[r]
        if len(own):
            d["src_sum"] = SegmentSum(st.src_lidx[r][own], dev)
        own = (np.zeros(0, np.int64) if drm is None
               else np.flatnonzero(drm["mask"][r]))
        if len(own):
            d["drm_Fdev"] = f(np.asarray(drm["F"])[:, own])
            d["drm_sum"] = SegmentSum(drm["lidx"][r][own], dev)
            d["drm_aux"] = int(drm["aux"])
        if self.fb is not None:
            own = np.flatnonzero(self.fb["mask"][r])
            d["fb_cols"] = i(own)
            d["fb_lidx"] = i(self.fb["lidx"][r][own])
        if nl is not None:
            from ..nonlinear import force_operator, strain_operator
            dn = {k: f(nl["consts"][k][r]) for k in NL_CONSTS}
            dn.update(S=f(strain_operator().reshape(48, 24)),
                      F=f(force_operator().transpose(1, 0, 2)
                          .reshape(24, 48)),
                      model=nl["model"], rate_dep=nl["rate_dep"])
            lnid = nl["lnid"][r]
            b = {"d": dn, "lnid": i(lnid),
                 "scat_sum": SegmentSum(lnid.ravel(), dev),
                 "dt": nl["dt"], "dt2": nl["dt2"]}
            if self.geostatic:
                gperm = nl["gscat_perm"][r]
                bl = nl["bot_lnid"][r]
                b.update(final_step=nl["final_step"], rise=f(nl["rise"]),
                         grav_W=f(nl["grav_W"][r][gperm]),
                         grav_sum=SegmentSum(nl["gscat_seg"][r], dev),
                         bot_lnid=i(bl), bc1=f(nl["bc1"][r]),
                         bc2=f(nl["bc2"][r]), bot_W=f(nl["bot_W"][r]),
                         bot_sum=SegmentSum(bl[:, 4:].ravel(), dev),
                         bot_nodes=i(nl["bot_nodes"][r][
                             nl["bot_nodes_mask"][r]]))
            d["nl"] = b
        return d

    def init_state(self):
        """The zero state of every rank (init_sharded_state)."""
        st, nl = self.st, self.nl
        out = []
        for dev in self.group.devices:
            z = lambda shape: torch.zeros(shape, dtype=self.dtype,
                                          device=dev)
            u = z((st.N_pad, 3))
            conv = (tuple(z((st.E_pad, 8, 3)) for _ in range(4))
                    if st.damping == "bkt" else ())
            state = (u, u, conv)
            if nl is not None:
                parts = [(nl["NLpad"], 8, 6), (nl["NLpad"], 8, 6),
                         (nl["NLpad"], 8)]
                if self.geostatic:
                    parts.append((nl["EBpad"], 4))
                state += (tuple(z(s) for s in parts),)
            out.append(state)
        return out

    @staticmethod
    def fields(state):
        return state[0], state[1]

    def step(self, states, srcf, step_idx, fb_disp=None):
        """One step of every rank; srcf[r]: the step's forces [Lr, 3]
        (dt^2 applied) of the sources rank r owns (``src_cols``), or
        None; fb_disp[r]: the fixed-base displacements [B, 3] on rank
        r's device, or None."""
        st, N = self.st, self.st.N_pad
        forces, parts = [], []
        for r, state in enumerate(states):
            d = self.d[r]
            u_now, u_prev, conv = state[:3]
            f_elem, conv = element_forces(d, st.damping, u_now, u_prev,
                                          conv or None)
            nlstate = None
            if "nl" in d:
                from ..nonlinear import nl_state_update
                b = d["nl"]
                Enl = b["lnid"].shape[0]
                ue = u_now[b["lnid"]].reshape(Enl, 24)
                nlstate = nl_state_update(b["d"], ue, state[3][:3],
                                          b["dt"]) + tuple(state[3][3:])
            force = u_now.new_zeros((N, 3))
            if "src_sum" in d:
                s = d["src_sum"]
                force[s.ids] = s(srcf[r])
            if "drm_sum" in d:
                s = d["drm_sum"]
                fd = drm_lerp(d["drm_Fdev"], d["drm_aux"], step_idx)
                force = force.index_add(0, s.ids, s(fd))
            force = force + scatter_to_nodes(d, N, f_elem)
            if nlstate is not None:
                from ..nonlinear import nl_force
                b = d["nl"]
                fnl = nl_force(b["d"], nlstate[:3], b["dt2"])
                s = b["scat_sum"]
                force = force.index_add(0, s.ids, s(fnl.reshape(-1, 3)))
                if self.geostatic:
                    force, nlstate = _geostatic_forces(
                        d, b, force, u_now, step_idx, nlstate)
            force = dangling_distribute(d, N, force)
            forces.append(force)
            parts.append((conv, nlstate))
        # the one boundary exchange: the shared nodes' partial forces
        bufs = []
        for d, force in zip(self.d, forces):
            buf = force.new_zeros((st.B_pad, 3))
            buf[d["b_pos"]] = force[d["b_lidx"]]
            bufs.append(buf)
        tots = self.group.allsum(bufs)
        out = []
        for r, state in enumerate(states):
            d, force = self.d[r], forces[r]
            force[d["b_lidx"]] = tots[r][d["b_pos"]]
            u_now, u_prev = state[0], state[1]
            # increment form (see solver/step.py)
            u_next = u_now + (force + d["mass_minusaM"] * (u_now - u_prev)) \
                * d["inv_mass"][:, None]
            if self.geostatic and step_idx <= d["nl"]["final_step"]:
                # bottom z pinned during loading, on every local replica
                u_next[d["nl"]["bot_nodes"], 2] = 0.0
            if fb_disp is not None:
                # prescribed base displacements on every local copy
                u_next[d["fb_lidx"]] = fb_disp[r][d["fb_cols"]]
            u_next = dangling_assign(d, u_next)
            u_next[N - 1] = 0.0
            conv, nlstate = parts[r]
            new = (u_next, u_now, conv or ())
            out.append(new if nlstate is None else new + (nlstate,))
        return out


def gather_global(st, u_ranks, N):
    """The global [N, 3] field (numpy) from the ranks' [N_pad, 3] fields:
    each node from the rank that owns it."""
    arrs = [torch.as_tensor(a).cpu().numpy() for a in u_ranks]
    u = np.zeros((N, 3), arrs[0].dtype)
    for d in range(st.n_dev):
        u[st.owned_global[d]] = arrs[d][st.owned_local[d]]
    return u
