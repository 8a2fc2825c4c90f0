"""conv_out_s2d_roofline: the least time of one conv_out_s2d call at the
cell's size (benchmark/counts.py; bytes-bound) over the kernel's mean
device time a call in the trace, in %."""

from benchmark import counts
from benchmark.kernels import hand_kernel_time


def read(ctx):
    if ctx.trace is None:
        return None
    s, n = hand_kernel_time(ctx.trace, "conv_out_s2d")
    if not n:
        return None
    least = counts.conv_out_s2d_least_s(ctx.traffic["height"], ctx.traffic["width"])
    return least / (s / n) * 100.0
