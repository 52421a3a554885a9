"""Percent of its roofline that the step kernel K1
(``brick_step_kernel``) reaches in the traced window: the least time of
one step of every brick (``roofline.py``), times the steps, over the
launches' device time; read where the window launches it once per
brick and step."""

from port_bench import roofline

KERNEL = "brick_step_kernel"


def read(ctx):
    durs = [d for n, _, _, d in ctx.trace["device"]
            if ctx.kernel_of(n) == KERNEL] if ctx.trace else []
    if not durs or len(durs) != ctx.steps * len(ctx.bricks):
        return None
    least = ctx.steps * sum(
        roofline.least_seconds(e, n, 1, ctx.precision)
        for e, n in ctx.bricks)
    return 100.0 * least / sum(durs)
