"""The operations of one frame of this generator, for ``mfu.archive``:
multiply-accumulates counted from its shapes, at the peak of the precision
each layer runs in (the peaks are the yardstick's, ``benchmark/counts.py``).
"""

from __future__ import annotations

from benchmark.counts import PEAK_BF16_FLOPS, PEAK_INT8_OPS


def generator_macs_per_frame(h: int, w: int, num_resblock: int = 16,
                             out_channels: int = 3) -> int:
    """Multiply-accumulates of one generator frame at LR (h, w), the
    transposed convs counted at input-pixel granularity."""
    px = h * w
    macs = 9 * 51 * 64 * px
    macs += num_resblock * 2 * 9 * 64 * 64 * px
    macs += 9 * 64 * 64 * px
    macs += 2 * 9 * 64 * 64 * (4 * px)
    macs += 9 * (64 * 128 + 128 * 128) * (4 * px)
    macs += 9 * 128 * 128 * (4 * px)
    macs += 9 * 128 * 64 * (16 * px)
    macs += 9 * 64 * out_channels * (16 * px)
    return macs


def int8_tail_macs_per_frame(h: int, w: int, num_resblock: int = 16) -> int:
    """Multiply-accumulates of the int8 tail: the generator without
    ``conv_in`` and ``conv_out``."""
    return (generator_macs_per_frame(h, w, num_resblock)
            - 9 * 51 * 64 * h * w - 9 * 64 * 3 * 16 * h * w)


def frame_peak_s(h: int, w: int, num_resblock: int, int8_tail: bool) -> float:
    """A frame's model operations at the peak of the precision each runs
    in: all of it in bf16, or the int8 tail at the int8 peak and the rest
    (``conv_in``, ``conv_out``) in bf16."""
    macs = generator_macs_per_frame(h, w, num_resblock)
    if not int8_tail:
        return 2.0 * macs / PEAK_BF16_FLOPS
    tail = int8_tail_macs_per_frame(h, w, num_resblock)
    return 2.0 * (macs - tail) / PEAK_BF16_FLOPS + 2.0 * tail / PEAK_INT8_OPS
