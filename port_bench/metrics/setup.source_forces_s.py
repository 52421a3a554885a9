"""Seconds of the source in set-up, the forces of every step of the job
computed up front: the program's ``Source forces`` span
(``Simulation.setup``: ``SourceModel.parse`` and ``compute_forces``)."""


def read(ctx):
    return ctx.timers.get("Source forces")
