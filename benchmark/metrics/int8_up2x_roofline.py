"""int8_up2x_roofline: the least time of a frame's 2 int8_up2x launches
(benchmark/counts.py) over their device time a frame in the trace, in %."""

from benchmark import counts
from benchmark.kernels import hand_kernel_time


def read(ctx):
    if ctx.trace is None:
        return None
    s, n = hand_kernel_time(ctx.trace, "int8_up2x")
    least, launches = counts.int8_least_s_per_frame(
        ctx.traffic["height"], ctx.traffic["width"], True, ctx.config["num_resblock"])
    if not n or s <= 0:
        return None
    return least * (n / launches) / s * 100.0
