"""library_ms.archive: device ms a frame in kernels not written by hand
(cuDNN, PyTorch's own), from the device trace; copies and memsets are not
kernels."""

from benchmark.kernels import is_copy, which_hand_kernel


def read(ctx):
    if ctx.mode != "archive" or ctx.trace is None or not ctx.run["frames"]:
        return None
    s = sum(v[0] for k, v in ctx.trace["kernels"].items()
            if which_hand_kernel(k) is None and not is_copy(k))
    return s / ctx.run["frames"] * 1e3 if s > 0 else None
