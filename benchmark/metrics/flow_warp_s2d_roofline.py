"""flow_warp_s2d_roofline: the least time of one flow_warp_s2d call at the
cell's size (the bytes of the configuration's architecture's counts.py:
the flow and the carry read once, the feedback written) over the mean
device time a call of the kernel (``dense_flow_warp_kernel``) in the
trace, in %."""

KERNEL = "dense_flow_warp_kernel"


def read(ctx):
    counts = getattr(ctx.arch, "counts", None)
    if ctx.trace is None or not hasattr(counts, "flow_warp_s2d_bytes"):
        return None
    s = n = 0
    for name, (sec, count) in ctx.trace["kernels"].items():
        if KERNEL in name:
            s += sec
            n += count
    if not n or s <= 0:
        return None
    least = counts.least_s(counts.flow_warp_s2d_bytes(ctx.traffic["height"],
                                                      ctx.traffic["width"]))
    return least / (s / n) * 100.0
