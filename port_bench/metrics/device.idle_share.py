"""Percent of the traced window in which no operation ran on the
device: the mean of the run's cards' idle shares."""


def read(ctx):
    if not ctx.trace or not ctx.trace["device"]:
        return None
    busy = ctx.trace["busy_by_card"]
    return sum(100.0 * (1.0 - b / ctx.trace["window_s"])
               for b in busy) / len(busy)
