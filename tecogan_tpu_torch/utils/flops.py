"""Analytic FLOP accounting for the generator (MFU reporting).

Counts the useful multiply-accumulates of one generator forward, with
transposed convs counted at input-pixel granularity; elementwise work
(warp, sigmoid, relu, space-to-depth) is excluded.  Same count as
tecogan_tpu/utils/flops.py::generator_macs_per_frame.
"""

from __future__ import annotations

# NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet, 700 W).
H100_PEAK_BF16_FLOPS = 989e12


def generator_macs_per_frame(
    h: int, w: int, num_resblock: int = 16, out_channels: int = 3
) -> int:
    """MACs for one generator forward at LR resolution (h, w)."""
    px = h * w
    macs = 0
    macs += 9 * 51 * 64 * px                      # conv_in
    macs += num_resblock * 2 * 9 * 64 * 64 * px   # LR resblocks
    macs += 9 * 64 * 64 * px                      # up1 (convT s2, input px)
    macs += 2 * 9 * 64 * 64 * (4 * px)            # trunk_rb1 @ 2Hx2W
    macs += 9 * (64 * 128 + 128 * 128) * (4 * px)  # trunk_rb2 @ 2Hx2W
    macs += 9 * 128 * 128 * (4 * px)              # up2 (convT s2, input 2Hx2W)
    macs += 9 * 128 * 64 * (16 * px)              # conv_hr @ 4Hx4W
    macs += 9 * 64 * out_channels * (16 * px)     # conv_out @ 4Hx4W
    return macs
