"""idle_pct.archive: the share of the traced window in which no operation
ran on the device, in %."""


def read(ctx):
    if ctx.mode != "archive" or ctx.trace is None:
        return None
    return (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"]) * 100.0
