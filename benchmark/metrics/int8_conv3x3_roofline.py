"""int8_conv3x3_roofline: the least time of a frame's 37 int8_conv3x3
launches (each layer's bytes or int8 operations; benchmark/counts.py)
over their device time a frame in the trace, in %."""

from benchmark import counts
from benchmark.kernels import hand_kernel_time


def read(ctx):
    if ctx.trace is None:
        return None
    s, n = hand_kernel_time(ctx.trace, "int8_conv3x3")
    least, launches = counts.int8_least_s_per_frame(
        ctx.traffic["height"], ctx.traffic["width"], False, ctx.config["num_resblock"])
    if not n or s <= 0:
        return None
    return least * (n / launches) / s * 100.0
