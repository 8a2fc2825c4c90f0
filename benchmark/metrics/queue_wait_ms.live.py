"""queue_wait_ms.live: the 95th percentile of the time from a frame's due
time to the start of its step (the benchmark's span, host clock)."""

from benchmark.drive import p95


def read(ctx):
    if ctx.mode != "live" or not ctx.run["records"]:
        return None
    return p95([(start - due) * 1e3 for _, _, due, start, _, _ in ctx.run["records"]])
