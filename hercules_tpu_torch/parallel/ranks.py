"""Groups of ranks: the port's counterpart of the JAX package's
``shard_map`` over a device mesh.  ``RankGroup`` holds every rank in one
process; ``DistRankGroup`` spreads them over the processes of a
``torch.distributed`` group (the JAX package's multi-process shape,
``parallel/multihost.py``).

Rank r's tensors live on ``devices[r]``; a process runs the ranks of
its ``local_ranks`` (a ``RankGroup``'s are all of them), and the steps
index every per-rank list by the global rank, with None at the ranks of
other processes.  The multi-chip paths
(``slab.py``, ``gslab.py``, ``gmesh.py``, ``sharded.py``) run each
rank's step in turn and exchange through the collectives their JAX
counterparts call inside ``shard_map``:

- ``shift(xs, d)``: the ring ``jax.lax.ppermute`` of
  ``hercules_tpu/parallel/slab.py:538-541``: rank r receives rank
  (r - d) mod P's tensor (d = +1 sends each rank's tensor to the next
  rank, d = -1 to the previous one);
- ``allsum(xs)``: ``jax.lax.psum`` (``hercules_tpu/parallel/
  sharded.py:190-192``), computed once: the ranks' tensors are added on
  rank 0's device in rank order, and that one total is copied to every
  rank, so the replicas of a shared node read bit-identical values
  (``partition.py``'s argument).

Every transfer is a copy into a new tensor on the receiving rank's
device, as a ppermute's result is a buffer of its own: on one card a
device copy, between cards a device-to-device copy (``Tensor.to``),
which a machine with several cards has yet to verify.

The group counts what each rank sends, per collective call, in bytes
and in dependent phases (``sent``, ``phases``); ``comm_model.py``
predicts the same counts from the tables (tests/test_torch_comm_model.py
holds them equal).  A shift is one phase in which every rank sends its
tensor.  An allsum is two phases: the ranks after 0 send their tensors
to rank 0, then rank 0 sends the total to each of them.  A send is one
phase at each end, its bytes counted against the sender.
"""

from __future__ import annotations

import socket
import time

import torch


class RankGroup:
    """P ranks in one process, rank r on ``devices[r]`` (a device may
    hold several ranks)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a rank group needs at least one device")
        self.size = len(self.devices)
        self.local_ranks = range(self.size)
        self.reset_counts()

    def is_local(self, r):
        """Whether rank r runs in this process."""
        return r in self.local_ranks

    def reset_counts(self):
        """Zero the per-rank byte and phase counts."""
        self.sent = [0] * self.size
        self.phases = [0] * self.size

    def _move(self, x, r):
        return x.to(self.devices[r], copy=True)

    def shift(self, xs, d):
        """The ring permutation by ``d``: out[(r + d) mod P] = xs[r],
        on the receiving rank's device."""
        P = self.size
        out = [None] * P
        for r in self.local_ranks:
            x = xs[r]
            to = (r + d) % P
            out[to] = self._move(x, to)
            self.sent[r] += x.numel() * x.element_size()
            self.phases[r] += 1
        return out

    def send(self, x, src, dst):
        """Rank src's tensor ``x`` copied onto rank dst's device."""
        self.sent[src] += x.numel() * x.element_size()
        self.phases[src] += 1
        self.phases[dst] += 1
        return self._move(x, dst)

    def allsum(self, xs):
        """The sum of the ranks' tensors, added in rank order on rank
        0's device, and a copy of it on every rank."""
        P = self.size
        total = xs[0].clone()
        for r in range(1, P):
            total += xs[r].to(self.devices[0])
        out = [total] + [self._move(total, r) for r in range(1, P)]
        nbytes = xs[0].numel() * xs[0].element_size()
        for r in range(P):
            self.sent[r] += nbytes * (P - 1 if r == 0 else 1) if P > 1 else 0
            self.phases[r] += 2 if P > 1 else 0
        return out


class DistRankGroup(RankGroup):
    """Global ranks 0..P-1 over the processes of the default
    ``torch.distributed`` group: process k runs the contiguous ranks
    ``local_ranks`` = [d0, d1), rank d0 + i on ``devices_local[i]``
    (``devices[r]`` is None for the ranks of other processes).

    The collectives keep RankGroup's results bit for bit:

    - ``shift`` and ``send`` move a tensor within the process as a
      RankGroup does, and between processes post all of a call's sends
      and receives in one ``dist.batch_isend_irecv`` (no process waits
      on a peer that waits on it).  A receiver allocates its buffer from
      what it holds: ``shift``'s tensors have one shape and dtype on
      every rank (its own rank's is the template), and ``send``'s
      receiving process passes a tensor of the shape and dtype to
      receive as ``x``.  No metadata crosses per call.
    - ``allsum`` sends every local rank's tensor to every other process
      and adds all P in rank order on each process, the operand order of
      RankGroup.allsum (an IEEE add gives the same bits on the CPU and a
      card), so every process holds RankGroup's total.
      ``dist.all_reduce`` is not used: its order is the library's.

    Transports: the default group's backend.  NCCL moves CUDA tensors
    directly, one rank per process, and needs a card of its own for
    every process (it refuses a communicator with one card twice, so
    this group refuses first);
    gloo moves CPU tensors, and CUDA tensors through copies to and from
    the host.  ``host_group``: a gloo group for the set-up's small
    object gathers (the default group where it is gloo).

    ``sent`` and ``phases`` count the local ranks' traffic by
    RankGroup's rules, whatever the transport moved, so that
    comm_model's predictions hold rank by rank.  ``exchange_s`` sums the
    host seconds of the exchanges with other processes, and
    ``exchange_wait_s`` the part of them spent waiting for the local
    cards to finish the work before (a synchronise ahead of the
    transfer; gloo's copies to the host would wait for it anyway)."""

    def __init__(self, devices_local, host_group=None):
        import torch.distributed as dist
        self._dist = dist
        self.backend = dist.get_backend()
        self.nproc, self.pid = dist.get_world_size(), dist.get_rank()
        local = [torch.device(d) for d in devices_local]
        if not local:
            raise ValueError("a process of a rank group needs a device")
        if host_group is None and self.backend != "gloo":
            host_group = dist.new_group(backend="gloo")
        self.host_group = host_group
        where = [(socket.gethostname(), d.type, d.index) for d in local]
        every = [None] * self.nproc
        dist.all_gather_object(every, where, group=host_group)
        if self.backend == "nccl":
            if len(local) != 1:
                raise RuntimeError("NCCL runs one rank per process")
            if any(t != "cuda" for w in every for _, t, _ in w):
                raise RuntimeError("NCCL moves CUDA tensors only; CPU ranks "
                                   "need the gloo backend")
            cards = [(h, i) for w in every for h, _, i in w]
            if len(set(cards)) != len(cards):
                raise RuntimeError(
                    "NCCL needs a card of its own for every rank of every "
                    f"process, and ranks share a card ({sorted(cards)}); "
                    "use the gloo backend")
        counts = [len(w) for w in every]
        self.owner = [p for p, n in enumerate(counts) for _ in range(n)]
        d0 = sum(counts[:self.pid])
        self.size = len(self.owner)
        self.local_ranks = range(d0, d0 + len(local))
        self.devices = [None] * self.size
        for r, dev in zip(self.local_ranks, local):
            self.devices[r] = dev
        self.reset_counts()

    # ---- transport ------------------------------------------------------

    def _exchange(self, sends, recvs):
        """Post sends [(tensor, peer process, tag)] and receives
        [(template, local rank receiving, peer process, tag)] in one
        batch, wait for all, and return the received tensors on their
        ranks' devices.  gloo takes CPU tensors: a CUDA tensor crosses
        as a host copy."""
        d, gloo = self._dist, self.backend == "gloo"
        t0 = time.perf_counter()
        if gloo:
            for r in self.local_ranks:
                if self.devices[r].type == "cuda":
                    torch.cuda.synchronize(self.devices[r])
        t1 = time.perf_counter()
        ops, bufs = [], []
        for x, peer, tag in sends:
            x = (x.detach().to("cpu") if gloo else x.detach()).contiguous()
            ops.append(d.P2POp(d.isend, x, peer, tag=tag))
        for like, r, peer, tag in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if gloo else self.devices[r])
            bufs.append((buf, r))
            ops.append(d.P2POp(d.irecv, buf, peer, tag=tag))
        if ops:
            for q in d.batch_isend_irecv(ops):
                q.wait()
        out = [buf.to(self.devices[r]) for buf, r in bufs]
        self.exchange_wait_s += t1 - t0
        self.exchange_s += time.perf_counter() - t0
        return out

    def reset_counts(self):
        super().reset_counts()
        self.exchange_s = self.exchange_wait_s = 0.0

    # ---- collectives ----------------------------------------------------

    def shift(self, xs, d):
        P = self.size
        out = [None] * P
        sends, recvs = [], []
        for r in self.local_ranks:
            x = xs[r]
            to = (r + d) % P
            if self.is_local(to):
                out[to] = self._move(x, to)
            else:
                sends.append((x, self.owner[to], to))
            self.sent[r] += x.numel() * x.element_size()
            self.phases[r] += 1
            frm = (r - d) % P
            if not self.is_local(frm):
                recvs.append((x, r, self.owner[frm], r))
        for (_, r, _, _), y in zip(recvs, self._exchange(sends, recvs)):
            out[r] = y
        return out

    def send(self, x, src, dst):
        """Rank src's tensor ``x`` on rank dst's device: returned where
        dst is local, else None.  On a process that holds dst but not
        src, ``x`` is a tensor of the shape and dtype to receive."""
        if self.is_local(src):
            self.sent[src] += x.numel() * x.element_size()
            self.phases[src] += 1
        if self.is_local(dst):
            self.phases[dst] += 1
        if self.is_local(src) and self.is_local(dst):
            return self._move(x, dst)
        if self.is_local(src):
            self._exchange([(x, self.owner[dst], dst)], [])
            return None
        if self.is_local(dst):
            return self._exchange([], [(x, dst, self.owner[src], dst)])[0]
        return None

    def allsum(self, xs):
        P = self.size
        loc = list(self.local_ranks)
        like = xs[loc[0]]
        peers = [p for p in range(self.nproc) if p != self.pid]
        sends = [(xs[r], p, r) for p in peers for r in loc]
        recvs = [(like, loc[0], self.owner[frm], frm) for frm in range(P)
                 if not self.is_local(frm)]
        got = dict(zip((frm for *_, frm in recvs),
                       self._exchange(sends, recvs)))
        dev0 = self.devices[loc[0]]
        total = None
        for r in range(P):
            x = xs[r] if self.is_local(r) else got[r]
            if total is None:
                total = x.to(dev0, copy=True)
            else:
                total += x.to(dev0)
        out = [None] * P
        for r in loc:
            out[r] = total if r == loc[0] else self._move(total, r)
        nbytes = like.numel() * like.element_size()
        for r in loc:
            self.sent[r] += nbytes * (P - 1 if r == 0 else 1) if P > 1 else 0
            self.phases[r] += 2 if P > 1 else 0
        return out
