"""Percent of the device's clock spent between chunks, over the traced
run's untraced stretch (the chunks of steps [chunk, chunk + its steps)):
the gaps from one chunk's end to the next one's start, over the chunks'
device time plus those gaps.  Read from the program's span log
(``hercules_tpu_torch.utils.timers``): each ``Solver chunk`` span holds
the CUDA events' ``device_s`` (its first device operation to its
samples' copy) and ``gap_s`` (since the previous chunk's end).  None
where the program keeps no such log or no device times."""

CHUNK = "Solver chunk"


def read(ctx):
    from hercules_tpu_torch.utils import timers
    log = getattr(timers.GLOBAL_TIMERS, "log", None)
    if not log or not ctx.untraced or not ctx.untraced[0]:
        return None
    run = []
    for r in log:
        if r.name == CHUNK:
            if run and r.step <= run[-1].step:
                run = []                 # a later run's chunks
            run.append(r)
    lo, hi = ctx.chunk, ctx.chunk + ctx.untraced[0]
    got = [r.counts for r in run if lo <= r.step < hi]
    if not got or any(c.get("device_s") is None for c in got) or \
            any(c.get("gap_s") is None for c in got[1:]):
        return None
    idle = sum(c["gap_s"] for c in got[1:])
    return 100.0 * idle / (idle + sum(c["device_s"] for c in got))
