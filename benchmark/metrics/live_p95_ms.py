"""live_p95_ms: the 95th percentile, over every frame of every stream due
inside the window, of the time from its due time to its uint8 SR frame on
the host (host clock); a frame never served counts as infinitely late."""

import math

from benchmark.drive import p95


def read(ctx):
    if ctx.mode != "live":
        return None
    lat = [(done - due) * 1e3 for _, _, due, _, _, done in ctx.run["records"]]
    return p95(lat + [math.inf] * (ctx.run["offered"] - len(lat)))
