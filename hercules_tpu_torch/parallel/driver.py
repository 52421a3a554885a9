"""The multi-chip driver: the solver's whole surface (stations, taps,
checkpoints, restart, source streaming) on the slab and sharded paths.

Counterpart of ``hercules_tpu/parallel/driver.py``; the JAX names are
kept (``_localize``, ``_station_plan``, ``SlabXLAPath``,
``SlabPallasPath``, ``GslabPath``, ``GMeshPath``, ``ShardedPath``,
``choose_path``, ``run_multichip``) and so are the path names, which
checkpoints store: "slab" (the plain slab step), "slab_pallas" (a step
kernel per fragment: K1, K2 or K4), "gslab" (the depth-graded stacked
slabs: K1, K2 or K4 per brick fragment, the plane interfaces
reconciled by point-to-point sends), "gmesh" (any brick plan: K1 or K2
per brick fragment, the interfaces reconciled over one allsum;
nonlinear soil) and "sharded" (the unstructured partition).

The JAX driver scans each chunk inside ``shard_map``; here a chunk is
k steps of the path's ``step`` over every rank of its
``ranks.RankGroup`` in turn.  Stations: each station is sampled by the
first rank holding all 8 of its element's nodes, before the step (row s
of the samples is the field before step s), and the host adds the
ranks' disjoint rows, the JAX driver's masked per-device samples summed
on the host.  Sources stream chunk by chunk with dt^2 applied, each
rank receiving the forces of the sources it owns.  ``on_chunk``,
``on_samples`` and the taps fire at chunk boundaries
(``sim.SimOutputs.make_mc_hook``).

Path choice (``choose_path``), the JAX package's order on a TPU
(``driver.py:787-849``): a mesh that is one uniform brick with an
element layer per rank takes the slab decomposition -- on CUDA devices
the kernels ("slab_pallas") in float32 and float64 alike, since the
port's kernels take both (the JAX package's TPU rule takes the XLA slab
for float64, ``driver.py:802-806``); on the CPU the plain step ("slab"),
as the JAX package's CPU rule does -- then, on CUDA devices, "gslab",
then "gmesh" (off the TPU the JAX package skips both, and the port
skips them on the CPU), and every other mesh the sharded path, with the
reason each path gave for refusing the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver.chunking import run_chunked
from ..utils.timers import measure

PATHS = ("slab", "slab_pallas", "gslab", "gmesh", "sharded")


# ---------------------------------------------------------------------------
# station plans

def _localize(node_set: np.ndarray, st_nodes: np.ndarray):
    """(lidx [S,8], present [S]) of station nodes in one device's
    local node-id set (positions into node_set's own order)."""
    S = len(st_nodes)
    if S == 0:
        return np.zeros((0, 8), np.int32), np.zeros(0, bool)
    order = np.argsort(node_set, kind="stable")
    srt = node_set[order]
    pos = np.searchsorted(srt, st_nodes)
    pos = np.clip(pos, 0, len(srt) - 1)
    ok = srt[pos] == st_nodes
    lidx = np.where(ok, order[pos], 0).astype(np.int32)
    return lidx, ok.all(axis=1)


def _station_plan(node_sets, st_nodes):
    """Per-device station plan over a list of per-device global-node-id
    arrays.  Each station is assigned to the FIRST device holding all 8
    of its element's nodes (replicas of shared nodes are consistent, so
    the choice doesn't matter).  Returns (lidx [d,S,8], own [d,S])."""
    n_dev = len(node_sets)
    S = len(st_nodes)
    lidx = np.zeros((n_dev, S, 8), np.int32)
    own = np.zeros((n_dev, S), bool)
    assigned = np.zeros(S, bool)
    for d in range(n_dev):
        li, present = _localize(np.asarray(node_sets[d]), st_nodes)
        take = present & ~assigned
        lidx[d][take] = li[take]
        own[d] = take
        assigned |= take
    if S and not assigned.all():
        missing = np.flatnonzero(~assigned)
        raise RuntimeError(
            f"stations {missing.tolist()} not local to any device")
    return lidx, own


# ---------------------------------------------------------------------------
# path adapters

class _PathBase:
    """What run_multichip and the taps use of a path: ``name``,
    ``n_dev``, ``group``, ``dtype``, ``step`` (the path's step object:
    init_state, step), ``src_cols``, the station plan, the global fields
    and the checkpoint tail."""

    name = "?"
    # per rank (station indices, local node ids [Sr, 8], weights) or
    # None, and the station count (attach_stations)
    _st = None
    n_st = 0

    def _node_sets(self):
        raise NotImplementedError

    def attach_stations(self, st_nodes, st_phi):
        """Sample the stations (st_nodes [S, 8] global node ids, st_phi
        [S, 8] weights) from the rank that owns each."""
        lidx, own = _station_plan(self._node_sets(), np.asarray(st_nodes))
        self.n_st = len(st_nodes)
        self._st = []
        for r, dev in enumerate(self.group.devices):
            idx = np.flatnonzero(own[r])
            self._st.append(None if not len(idx) else (
                idx, torch.as_tensor(lidx[r][idx].astype(np.int64),
                                     device=dev),
                torch.as_tensor(np.asarray(st_phi)[idx], dtype=self.dtype,
                                device=dev)))

    def sample(self, r, state):
        """Rank r's owned stations' displacements [Sr, 3] of ``state``
        (None when it owns none)."""
        got = None if self._st is None else self._st[r]
        if got is None:
            return None
        _, lidx, phi = got
        u = self.step.fields(state)[0]
        if self.component_major:                  # [3, n] fragments
            return torch.einsum("sk,csk->sc", phi, u[:, lidx])
        return torch.einsum("sk,skc->sc", phi, u[lidx])

    def init_state(self):
        return self.step.init_state()

    def u_global(self, state):
        raise NotImplementedError

    def up_global(self, state):
        raise NotImplementedError

    def tail(self, state):
        """The carry tail (memory variables, plastic state) as a flat
        tuple of rank-stacked numpy arrays [n_dev, ...], for a
        checkpoint (bfloat16 widened to float32, exactly)."""
        per_rank = [_flat(s[self._tail_from:]) for s in state]
        return tuple(np.stack([_host(x) for x in parts])
                     for parts in zip(*per_rank))


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(x for t in tree for x in _flat(t))
    return (tree,)


def _host(t):
    dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dt, copy=True).numpy()


def _tensor(a, like, dev):
    return torch.as_tensor(np.asarray(a), dtype=like, device=dev)


class SlabXLAPath(_PathBase):
    """The uniform single-brick z-slab decomposition, plain step
    (slab.SlabStep)."""

    name = "slab"
    _tail_from = 2
    component_major = True

    def __init__(self, st, group, dtype, N):
        self.st, self.group, self.dtype, self.N = st, group, dtype, N
        self.n_dev = st.n_dev
        self.step = self._make_step(st, group, dtype)

    @staticmethod
    def _make_step(st, group, dtype):
        from .slab import SlabStep
        return SlabStep(st, group, dtype)

    def _node_sets(self):
        return self.st.gnid_local

    def src_cols(self):
        from .slab import rank_sources
        return [cols for _, cols in rank_sources(self.st)]

    def u_global(self, state):
        from .slab import slab_u_global
        return slab_u_global(self.st, [self.step.fields(s)[0]
                                       for s in state], self.N)

    def up_global(self, state):
        from .slab import slab_u_global
        return slab_u_global(self.st, [self.step.fields(s)[1]
                                       for s in state], self.N)

    def _fields_of(self, u, up):
        """Per rank (u, u-) [3, tot_local] numpy from global [N, 3]."""
        st = self.st
        out = []
        for g in st.gnid_local:
            pair = []
            for x in (u, up):
                a = np.zeros((3, st.tot_local), np.asarray(x).dtype)
                a[:, :len(g)] = np.asarray(x)[g].T
                pair.append(a)
            out.append(pair)
        return out

    def state_from_global(self, u, up, tail_flat):
        """The ranks' state from canonical global [N, 3] fields and a
        checkpoint tail (empty, or this path's own at this rank count:
        with BKT the four [n_dev, 24, S] memory-variable arrays)."""
        st = self.st
        nconv = 4 if st.damping == "bkt" else 0
        if len(tail_flat) not in (0, nconv):
            raise RuntimeError(f"slab checkpoint tail has {len(tail_flat)} "
                               f"arrays; this run needs {nconv}")
        want = (st.n_dev, 24, st.meta.S)
        if any(np.shape(a) != want for a in tail_flat):
            raise RuntimeError(f"slab BKT checkpoint state does not match "
                               f"{want}")
        zero = self.init_state()
        out = []
        for r, ((a, b), dev) in enumerate(zip(self._fields_of(u, up),
                                              self.group.devices)):
            s = (_tensor(a, self.dtype, dev), _tensor(b, self.dtype, dev))
            if nconv:
                s += ((tuple(_tensor(c[r], self.dtype, dev)
                             for c in tail_flat) if tail_flat
                       else zero[r][2]),)
            out.append(s)
        return out


class SlabPallasPath(SlabXLAPath):
    """The uniform single-brick z-slab decomposition, a step kernel per
    fragment (slab.SlabKernelStep: K1, K2 or K4; their plain versions
    on the CPU)."""

    name = "slab_pallas"
    _tail_from = 1

    @staticmethod
    def _make_step(st, group, dtype):
        from .slab import SlabKernelStep
        return SlabKernelStep(st, group, dtype)

    def state_from_global(self, u, up, tail_flat):
        """The ranks' packed state from canonical global [N, 3] fields
        and a checkpoint tail (empty, or one rank-stacked memory
        variable array [n_dev, rows, LEN'] of this path at this rank
        count: the port's own, or the JAX package's, node basis of 8 or
        16 rows or corner basis, fitted by solver/restart.fit_conv)."""
        from ..solver.restart import fit_conv
        step = self.step
        if self.st.damping != "bkt":
            if tail_flat:
                raise RuntimeError("unexpected checkpoint tail for the "
                                   "elastic slab path")
        elif len(tail_flat) not in (0, 1) or (
                tail_flat and np.shape(tail_flat[0])[0] != self.n_dev):
            raise RuntimeError("the kernel slab path's BKT checkpoint "
                               "state must be one [n_dev, rows, LEN] array")
        out = []
        for r, ((a, b), dev) in enumerate(zip(self._fields_of(u, up),
                                              self.group.devices)):
            mod, = step.mods[r]
            S = np.zeros((8, step.LEN), a.dtype)
            S[0:3, :a.shape[1]], S[3:6, :b.shape[1]] = a, b
            s = (_tensor(S, self.dtype, dev),)
            if self.st.damping == "bkt":
                parts = (tail_flat[0][r],) if tail_flat else ()
                cv = fit_conv(mod, step.LEN, parts)
                s += tuple(torch.as_tensor(c, device=dev).to(dt)
                           for c, (_, dt) in zip(
                               cv, mod.state_parts(step.LEN)))
            out.append(s)
        return out


class GslabPath(_PathBase):
    """The depth-graded stacked-slab decomposition (gslab.GSlabStep: K1,
    K2 or K4 per brick fragment; their plain versions on the CPU)."""

    name = "gslab"
    _tail_from = 1

    def __init__(self, st, group, dtype, N):
        self.st, self.group, self.dtype, self.N = st, group, dtype, N
        self.n_dev = st.n_dev
        self.step = self._make_step(st, group, dtype)

    @staticmethod
    def _make_step(st, group, dtype):
        from .gslab import GSlabStep
        return GSlabStep(st, group, dtype)

    def src_cols(self):
        return self.step.rows

    def _arrays(self, state):
        """(the per-brick arrays, the loose section's or None) of a
        rank's state."""
        return state[0], None

    def attach_stations(self, st_nodes, st_phi):
        """Sample each station from the first brick, and in it the first
        rank, holding all 8 of its element's nodes (the JAX package's
        order, driver.py:363-382); a gmesh station in the loose section
        from rank 0's copy."""
        st_nodes, st_phi = np.asarray(st_nodes), np.asarray(st_phi)
        S = len(st_nodes)
        assigned = np.zeros(S, bool)
        parts = [[] for _ in range(self.n_dev)]

        def take(r, where, node_set):
            li, present = _localize(np.asarray(node_set), st_nodes)
            got = present & ~assigned
            if got.any():
                idx = np.flatnonzero(got)
                dev = self.group.devices[r]
                parts[r].append((where, idx, torch.as_tensor(
                    li[idx].astype(np.int64), device=dev),
                    torch.as_tensor(st_phi[idx], dtype=self.dtype,
                                    device=dev)))
            assigned[got] = True

        for b, fb in enumerate(self.st.bricks):
            for r in range(self.n_dev):
                take(r, b, fb.gnid_local[r])
        if S and not assigned.all() and getattr(self.st, "NL", 0):
            take(0, "loose", self.st.gnid_loose)
        if S and not assigned.all():
            missing = np.flatnonzero(~assigned)
            raise RuntimeError(f"stations {missing.tolist()} not local to "
                               f"any device/brick")
        self.n_st = S
        self._st = [None if not p else
                    (np.concatenate([q[1] for q in p]), p) for p in parts]

    def sample(self, r, state):
        got = self._st[r] if self._st is not None else None
        if got is None:
            return None
        Ss, S_l = self._arrays(state)
        return torch.cat([
            torch.einsum("sk,csk->sc", phi,
                         (S_l if where == "loose" else Ss[where])[0:3][:,
                                                                   lidx])
            for where, _, lidx, phi in got[1]])

    def u_global(self, state):
        from .gslab import gslab_u_global
        return gslab_u_global(self.st, [s[0] for s in state], self.N)

    def up_global(self, state):
        from .gslab import gslab_u_global
        return gslab_u_global(self.st, [s[0] for s in state], self.N,
                              row0=3)

    def _bricks_of_fields(self, u, up):
        """Per rank the per-brick S [8, LEN_b] (numpy) of global [N, 3]
        fields u, u-."""
        u, up = np.asarray(u), np.asarray(up)
        out = []
        for r in range(self.n_dev):
            Ss = []
            for fb in self.st.bricks:
                g = fb.gnid_local[r]
                S = np.zeros((8, fb.LEN), u.dtype)
                S[0:3, :len(g)], S[3:6, :len(g)] = u[g].T, up[g].T
                Ss.append(S)
            out.append(Ss)
        return out

    def _convs(self, r, tail_flat):
        """Rank r's per-brick memory variables from a checkpoint tail
        (one rank-stacked array [n_dev, rows, LEN'] per brick: the
        port's, or the JAX package's node basis of 8 or 16 rows or corner
        basis, fitted by solver/restart.fit_conv) or at zero."""
        from ..solver.restart import fit_conv
        dev = self.group.devices[r]
        out = []
        for b, (mod, fb) in enumerate(zip(self.step.mods[r],
                                          self.st.bricks)):
            parts = (tail_flat[b][r],) if tail_flat else ()
            cv = fit_conv(mod, fb.LEN, parts)
            out.append(tuple(torch.as_tensor(c, device=dev).to(dt)
                             for c, (_, dt) in zip(
                                 cv, mod.state_parts(fb.LEN))))
        return tuple(out)

    def _check_conv_tail(self, tail_flat):
        NB = len(self.st.bricks)
        if self.st.damping != "bkt":
            if tail_flat:
                raise RuntimeError(f"unexpected checkpoint tail for the "
                                   f"elastic {self.name} path")
        elif tail_flat and (len(tail_flat) != NB or any(
                np.shape(a)[0] != self.n_dev for a in tail_flat)):
            raise RuntimeError(f"the {self.name} path's BKT checkpoint "
                               f"state must be one [n_dev, rows, LEN] "
                               f"array per brick ({NB})")

    def state_from_global(self, u, up, tail_flat):
        """The ranks' state from canonical global [N, 3] fields and a
        checkpoint tail (empty, or per brick one rank-stacked memory
        variable array of this path at this rank count, see _convs)."""
        self._check_conv_tail(tail_flat)
        out = []
        for r, (Ss, dev) in enumerate(zip(
                self._bricks_of_fields(u, up), self.group.devices)):
            s = (tuple(_tensor(S, self.dtype, dev) for S in Ss),)
            if self.st.damping == "bkt":
                s += (self._convs(r, tail_flat),)
            out.append(s)
        return out


class GMeshPath(GslabPath):
    """The general graded decomposition (gmesh.GMeshStep: K1 or K2 per
    brick fragment, the interfaces over one allsum, the loose section
    replicated, nonlinear soil)."""

    name = "gmesh"
    _tail_from = 2

    @staticmethod
    def _make_step(st, group, dtype):
        from .gmesh import GMeshStep
        return GMeshStep(st, group, dtype)

    def src_cols(self):
        L = len(self.st.src_ids) if self.st.src_ids is not None else 0
        return [np.arange(L)] * self.n_dev

    def _arrays(self, state):
        return state[0], state[1]

    def u_global(self, state):
        from .gmesh import gmesh_u_global
        return gmesh_u_global(self.st, [s[0] for s in state], state[0][1],
                              self.N)

    def up_global(self, state):
        from .gmesh import gmesh_u_global
        return gmesh_u_global(self.st, [s[0] for s in state], state[0][1],
                              self.N, row0=3)

    def _nl_width(self):
        """The JAX package's common plastic-state width: the largest
        rank's count of nonlinear elements, at least 1."""
        return max(max(len(h["idx"]) for h in self.st.nl), 1)

    def tail(self, state):
        """The checkpoint tail: the bricks' memory variables with BKT;
        with nonlinear soil the plastic state, each rank's padded with
        zero rows to the JAX package's common width (gmesh.py:424-428)."""
        if self.st.nl is None:
            return super().tail(state)
        M = self._nl_width()
        out = []
        for k in range(3):
            parts = [_host(s[2][k]) for s in state]
            a = np.zeros((self.n_dev, M) + parts[0].shape[1:],
                         parts[0].dtype)
            for r, x in enumerate(parts):
                a[r, :len(x)] = x
            out.append(a)
        return tuple(out)

    def state_from_global(self, u, up, tail_flat):
        """As GslabPath's, with the loose section; with nonlinear soil
        the tail is the plastic state in the JAX package's padded layout
        (tail) or empty."""
        st = self.st
        if st.nl is None:
            self._check_conv_tail(tail_flat)
        elif tail_flat:
            M = self._nl_width()
            want = [(self.n_dev, M, 8, 6), (self.n_dev, M, 8, 6),
                    (self.n_dev, M, 8)]
            if [tuple(np.shape(a)) for a in tail_flat] != want:
                raise RuntimeError(f"gmesh nonlinear checkpoint state "
                                   f"{[np.shape(a) for a in tail_flat]} "
                                   f"does not match {want}")
        zero = self.init_state()
        out = []
        for r, (Ss, dev) in enumerate(zip(
                self._bricks_of_fields(u, up), self.group.devices)):
            S_l = np.zeros((8, st.NL), np.asarray(u).dtype)
            if st.NL:
                S_l[0:3] = np.asarray(u)[st.gnid_loose].T
                S_l[3:6] = np.asarray(up)[st.gnid_loose].T
            s = (tuple(_tensor(S, self.dtype, dev) for S in Ss),
                 _tensor(S_l, self.dtype, dev))
            if st.damping == "bkt":
                s += (self._convs(r, tail_flat),)
            elif st.nl is not None:
                n = len(st.nl[r]["idx"])
                s += ((tuple(_tensor(np.asarray(a)[r, :n], self.dtype, dev)
                             for a in tail_flat) if tail_flat
                       else zero[r][2]),)
            out.append(s)
        return out


class ShardedPath(_PathBase):
    """The unstructured Z-order element-block decomposition
    (partition.py + sharded.py), which takes any mesh."""

    name = "sharded"
    _tail_from = 2
    component_major = False

    def __init__(self, st, group, dtype, N, nl=None, drm=None, fb=None,
                 fb_series=None):
        from .sharded import ShardedStep
        self.st, self.group, self.dtype, self.N = st, group, dtype, N
        self.n_dev = st.n_dev
        self.nl = nl
        self.step = ShardedStep(st, group, dtype, nl=nl, drm=drm, fb=fb)
        # the fixed-base displacement series [T, B, 3], streamed by
        # run_multichip
        self.fb_series = fb_series if fb is not None else None

    def _node_sets(self):
        return self.st.local_globals

    def src_cols(self):
        return self.step.src_cols

    def u_global(self, state):
        from .sharded import gather_global
        return gather_global(self.st, [s[0] for s in state], self.N)

    def up_global(self, state):
        from .sharded import gather_global
        return gather_global(self.st, [s[1] for s in state], self.N)

    def state_from_global(self, u, up, tail_flat):
        """The ranks' state from canonical global [N, 3] fields and a
        checkpoint tail (empty, or this path's own at this rank count:
        the four memory-variable arrays with BKT, then the plastic
        state's arrays, each [n_dev, ...])."""
        st = self.st
        zero = self.init_state()
        nconv = 4 if st.damping == "bkt" else 0
        nnl = len(zero[0][3]) if self.nl is not None else 0
        if tail_flat and len(tail_flat) != nconv + nnl:
            raise RuntimeError(f"sharded checkpoint tail has "
                               f"{len(tail_flat)} arrays; this run needs "
                               f"{nconv + nnl}")
        want = [(st.n_dev,) + tuple(x.shape)
                for x in _flat(zero[0][2:]) if x is not None]
        if tail_flat and [np.shape(a) for a in tail_flat] != want:
            raise RuntimeError("sharded checkpoint tail does not match "
                               "this partition's layout")
        out = []
        for r, (g, dev) in enumerate(zip(st.local_globals,
                                         self.group.devices)):
            pair = []
            for x in (u, up):
                a = np.zeros((st.N_pad, 3), np.asarray(x).dtype)
                a[:len(g)] = np.asarray(x)[g]
                pair.append(_tensor(a, self.dtype, dev))
            if not tail_flat:
                out.append(tuple(pair) + zero[r][2:])
                continue
            arrs = [_tensor(a[r], self.dtype, dev) for a in tail_flat]
            s = tuple(pair) + (tuple(arrs[:nconv]),)
            if nnl:
                s += (tuple(arrs[nconv:]),)
            out.append(s)
        return out


# ---------------------------------------------------------------------------
# path selection

def choose_path(mesh, tables, group, src_ids=None, dtype=torch.float32,
                prefer=None, plans=None):
    """(path, reason): the parallel path for this mesh on ``group``'s
    ranks, and why each path tried before it refused the mesh ("" when
    the first was taken).

    prefer: None (the JAX package's order: the slab decomposition where
    the mesh is one uniform brick with an element layer per rank -- the
    kernels on CUDA devices, the plain step on the CPU -- then on CUDA
    devices "gslab" and "gmesh", else "sharded"), or a path name, which
    is built on any device (the kernels' plain versions on the CPU) or
    raises its table function's RuntimeError.  ``plans(legacy_axes)``: the
    mesh's brick plan (build_plan's default floor) in that storage order
    (the slab paths' and gslab's pinned (z, y, x), gmesh's default),
    built here once each when not given."""
    from ..solver.bricks import build_plan
    from .gmesh import build_gmesh_tables
    from .gslab import build_gslab_tables
    from .partition import shard_tables
    from .slab import build_slab_tables

    if prefer not in (None, *PATHS):
        raise ValueError(f"mc_path={prefer!r}; expected one of "
                         f"{', '.join(PATHS)}")
    P = group.size
    cuda = group.devices[0].type == "cuda"
    if plans is None:
        made = {}

        def plans(legacy_axes):
            if legacy_axes not in made:
                made[legacy_axes] = build_plan(mesh,
                                               legacy_axes=legacy_axes)
            return made[legacy_axes]
    reasons = []
    if prefer in (None, "slab", "slab_pallas"):
        try:
            st = build_slab_tables(mesh, tables, P, src_ids=src_ids,
                                   plan=plans(True))
        except RuntimeError as e:
            if prefer is not None:
                raise
            reasons.append(f"no slab decomposition: {e}")
        else:
            kernels = prefer == "slab_pallas" or (prefer is None and cuda)
            cls = SlabPallasPath if kernels else SlabXLAPath
            return cls(st, group, dtype, mesh.nnum), ""
    for name, build, cls, legacy in (
            ("gslab", build_gslab_tables, GslabPath, True),
            ("gmesh", build_gmesh_tables, GMeshPath, False)):
        if prefer == name or (prefer is None and cuda):
            try:
                st = build(mesh, tables, P, src_ids=src_ids,
                           plan=plans(legacy))
            except RuntimeError as e:
                if prefer == name:
                    raise
                reasons.append(f"no {name}: {e}")
            else:
                return cls(st, group, dtype, mesh.nnum), "; ".join(reasons)
    ust = shard_tables(tables, mesh, P, src_ids=src_ids)
    return ShardedPath(ust, group, dtype, mesh.nnum), "; ".join(reasons)


# ---------------------------------------------------------------------------
# the chunked multi-chip loop

def run_multichip(path, src_forces, total_steps, dt, chunk=None,
                  state=None, start_step=0, on_chunk=None, on_samples=None):
    """Drive the loop over [start_step, total_steps) on every rank of
    the path.

    src_forces: [T, L, 3] host array (unscaled; dt^2 applied here in
    float64, then cast, chunk by chunk).  on_chunk(done, state): at
    every chunk boundary (checkpoints, taps, monitor).  on_samples(s0,
    ys): consumes each chunk's sample rows (steps [s0, s0 + len)) and
    returns what to accumulate.  Returns (state, station samples [T, S,
    3] numpy); ``state`` is the list of the ranks' states, None at the
    ranks of other processes (a ``ranks.DistRankGroup``'s: this process
    steps its local ranks, and the path's collectives cross to the
    others)."""
    group, dtype = path.group, path.dtype
    if state is None:
        state = path.init_state()
    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt
    L = src_forces.shape[1] if src_forces is not None else 0
    cols = path.src_cols()
    fb_series = getattr(path, "fb_series", None)
    n_st = path.n_st
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    loc = group.local_ranks

    def advance(state, s, k):
        srcf = [None] * group.size
        fb = None
        if L:
            f = np.asarray(src_forces[s:s + k]) * dt2
            for r in loc:
                if len(cols[r]):
                    srcf[r] = _tensor(f[:, cols[r]], dtype, group.devices[r])
        if fb_series is not None:
            fb = [_tensor(fb_series[s:s + k], dtype, dev)
                  for dev in group.devices]
        rows = [[] for _ in range(group.size)]
        for i in range(k):
            for r in loc:
                y = path.sample(r, state[r])
                if y is not None:
                    rows[r].append(y)
            state = path.step.step(
                state, [None if x is None else x[i] for x in srcf], s + i,
                None if fb_series is None else [x[i] for x in fb])
        ys = np.zeros((k, n_st, 3), np_dtype)
        for r, rr in enumerate(rows):
            if rr:
                idx = path._st[r][0]
                ys[:, idx] += torch.stack(rr).cpu().numpy()
        return state, ys

    with measure("Solver time loop", group.devices[loc[0]]):
        return run_chunked(advance, state, total_steps,
                           start_step=start_step, chunk=chunk,
                           on_chunk=on_chunk, on_samples=on_samples,
                           device=group.devices[loc[0]])
