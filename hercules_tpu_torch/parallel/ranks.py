"""A group of ranks in one process: the port's counterpart of the JAX
package's ``shard_map`` over a device mesh.

Rank r's tensors live on ``devices[r]``.  The multi-chip paths
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

import torch


class RankGroup:
    """P ranks in one process, rank r on ``devices[r]`` (a device may
    hold several ranks)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a rank group needs at least one device")
        self.size = len(self.devices)
        self.reset_counts()

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
        for r, x in enumerate(xs):
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
