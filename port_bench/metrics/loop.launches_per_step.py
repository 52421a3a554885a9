"""Device operations (kernels, copies, sets) per step over the traced
window."""


def read(ctx):
    if not ctx.trace or not ctx.trace["device"] or not ctx.steps:
        return None
    return len(ctx.trace["device"]) / ctx.steps
