"""mfu.archive: a frame's model operations at the published peak of the
precision each runs in (int8 layers at 1,979 TOP/s, the rest at 989
TFLOP/s), as the cell's architecture counts them (its ``frame_peak_s``),
over the traced window's time a frame, in %.  The peaks are those of a
card at its 700 W limit; the result line's device record names the card."""


def read(ctx):
    if ctx.mode != "archive" or ctx.trace is None or not ctx.run["frames"]:
        return None
    least = ctx.arch.frame_peak_s(ctx.config, ctx.traffic["height"], ctx.traffic["width"])
    return least * ctx.run["frames"] / ctx.trace["window_s"] * 100.0
