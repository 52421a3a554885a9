"""Percent of the device time in the traced window that the port's own
CUDA kernels take (``port_kernels.json``)."""


def read(ctx):
    if not ctx.trace or not ctx.trace["device"]:
        return None
    total = sum(d for _, _, _, d in ctx.trace["device"])
    own = sum(d for n, _, _, d in ctx.trace["device"]
              if ctx.kernel_of(n) is not None)
    return 100.0 * own / total if total > 0 else None
