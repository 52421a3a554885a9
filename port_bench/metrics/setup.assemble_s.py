"""Seconds of the assembly of masses, dashpots and stiffness in set-up:
the program's ``Solver assemble`` span (``Simulation.setup``)."""


def read(ctx):
    return ctx.timers.get("Solver assemble")
