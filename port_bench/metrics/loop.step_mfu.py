"""Percent of the cards' peak that the whole time loop reaches: the
least time of the steps on the run's cards (``roofline.py``, every
brick, at the steps a launch advances on the route the program took)
over their wall time, read over the traced run's untraced stretch,
before the profiler starts and slows the host."""

from port_bench import roofline


def read(ctx):
    if not ctx.trace or not ctx.trace["device"] or not ctx.untraced \
            or not ctx.untraced[0]:
        return None
    steps, seconds = ctx.untraced
    least = steps * roofline.least_step_seconds(ctx.bricks, ctx.launch_steps,
                                                ctx.precision, ctx.cards)
    return 100.0 * least / seconds
