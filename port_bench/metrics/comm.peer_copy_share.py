"""Percent of the cards' device time in the traced window spent in
copies from one card to another (the profiler's ``Memcpy PtoP``
operations: ``RankGroup.shift`` in ``parallel/ranks.py``, which
``parallel/slab.py:halo_exchange`` calls twice a step), over every
operation's device time on every card.  None where the window copied
nothing between cards."""

PEER = "PtoP"


def read(ctx):
    if not ctx.trace or not ctx.trace["device"]:
        return None
    peer = [d for n, c, _, d in ctx.trace["device"]
            if c == "gpu_memcpy" and PEER in n]
    if not peer:
        return None
    return 100.0 * sum(peer) / sum(d for _, _, _, d in ctx.trace["device"])
