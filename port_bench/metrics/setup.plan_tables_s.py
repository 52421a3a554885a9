"""Seconds of the brick plan and the solver's tables in set-up: the
program's ``Solver plan`` and ``Solver tables`` timers (the latter fenced
by a device synchronisation)."""


def read(ctx):
    got = [ctx.timers[n] for n in ("Solver plan", "Solver tables")
           if n in ctx.timers]
    return sum(got) if got else None
