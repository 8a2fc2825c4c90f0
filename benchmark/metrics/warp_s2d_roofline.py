"""warp_s2d_roofline: the least time of one warp_s2d call, its bytes
counted for this run's own LR frames (the carry pixels its samples read
inside the frame; benchmark/counts.py), over the kernel's mean device
time a call in the trace, in %."""

from benchmark import counts
from benchmark.kernels import hand_kernel_time


def read(ctx):
    if ctx.trace is None or not ctx.lr_samples:
        return None
    s, n = hand_kernel_time(ctx.trace, "warp_s2d")
    if not n:
        return None
    least = sum(counts.warp_s2d_least_s(lr) for lr in ctx.lr_samples) / len(ctx.lr_samples)
    return least / (s / n) * 100.0
