"""mfu.archive: a frame's model operations at the published peak of the
precision each runs in (the int8 tail at 1,979 TOP/s, the rest at 989
TFLOP/s; benchmark/counts.py) over the traced window's time a frame, in %.
The peaks are those of a card at its 700 W limit; the result line's
device record names the card."""

from benchmark import counts


def read(ctx):
    if ctx.mode != "archive" or ctx.trace is None or not ctx.run["frames"]:
        return None
    least = counts.frame_peak_s(ctx.traffic["height"], ctx.traffic["width"],
                                ctx.config["num_resblock"], ctx.config["int8_tail"])
    return least * ctx.run["frames"] / ctx.trace["window_s"] * 100.0
