"""Percent of its roofline that the step kernel K1
(``brick_step_kernel``) reaches in the traced window: the least time of
one step of every whole brick on one card (``roofline.py``), times the
steps, over the launches' device time summed over the cards; read where
the window launches it once per brick, rank and step (a brick split
over ranks launches once on each rank's fragment)."""

from port_bench import roofline

KERNEL = "brick_step_kernel"


def read(ctx):
    durs = [d for n, _, _, d in ctx.trace["device"]
            if ctx.kernel_of(n) == KERNEL] if ctx.trace else []
    if not durs or len(durs) != ctx.steps * len(ctx.bricks) * ctx.ranks:
        return None
    least = ctx.steps * sum(
        roofline.least_seconds(e, n, 1, ctx.precision)
        for e, n in ctx.bricks)
    return 100.0 * least / sum(durs)
