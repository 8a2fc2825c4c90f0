"""The operations of one frame of TecoGAN as published, for
``mfu.archive``, and the bytes of its two hand kernels, for their
rooflines: counted from shapes, as ``benchmark/counts.py`` counts the
other kernels (each input byte read once, each output byte written once;
the peaks and the bandwidth are that file's).
"""

from __future__ import annotations

from benchmark.counts import HBM_BYTES_PER_S, PEAK_BF16_FLOPS

FNET_DOWN = (32, 64, 128)
FNET_UP = (256, 128, 64)


def generator_macs_per_frame(h: int, w: int, num_resblock: int = 16) -> int:
    """Multiply-accumulates of one generator frame at LR (h, w): ``conv_in``,
    the resblocks, the two transposed convs (counted at input-pixel
    granularity) and ``conv_out``; the bicubic skip is not counted."""
    px = h * w
    macs = 9 * 51 * 64 * px
    macs += num_resblock * 2 * 9 * 64 * 64 * px
    macs += 9 * 64 * 64 * px + 9 * 64 * 64 * (4 * px)
    macs += 9 * 64 * 3 * (16 * px)
    return macs


def fnet_macs_per_frame(h: int, w: int) -> int:
    """Multiply-accumulates of FNet on an LR pair (h, w): each block's two
    convs at its level's size (the pools floor), the output stage at ``8 *
    (h // 8)`` by ``8 * (w // 8)``."""
    macs, cin = 0, 6
    for f in FNET_DOWN:
        macs += 9 * (cin * f + f * f) * h * w
        cin, h, w = f, h // 2, w // 2
    for f in FNET_UP:
        macs += 9 * (cin * f + f * f) * h * w
        cin, h, w = f, 2 * h, 2 * w
    return macs + 9 * (cin * 32 + 32 * 2) * h * w


def frame_macs(h: int, w: int, num_resblock: int = 16) -> int:
    return generator_macs_per_frame(h, w, num_resblock) + fnet_macs_per_frame(h, w)


def frame_peak_s(h: int, w: int, num_resblock: int = 16) -> float:
    """A frame's model operations (generator and FNet) at the bf16 peak."""
    return 2.0 * frame_macs(h, w, num_resblock) / PEAK_BF16_FLOPS


def flow_warp_s2d_bytes(h: int, w: int, batch: int = 1) -> float:
    """``flow_warp_s2d`` at LR (h, w): the f32 flow (B, h, w, 2) and the
    f32 carry (B, h, w, 48) read once, the bf16 feedback written."""
    return float(batch * h * w * (2 * 4 + 48 * 4 + 48 * 2))


def conv_out_bicubic_s2d_bytes(h: int, w: int, batch: int = 1) -> float:
    """``conv_out_bicubic_s2d`` at LR (h, w): the bf16 (B, 4h, 4w, 64)
    features, the f32 LR frame (B, h, w, 3) and the f32 weights and bias
    read once, the f32 (B, h, w, 48) carry written."""
    feat = batch * 16 * h * w * 64 * 2
    return float(feat + batch * h * w * 3 * 4 + (9 * 64 * 3 + 3) * 4 + batch * h * w * 48 * 4)


def least_s(bytes_moved: float) -> float:
    """Both kernels are bound by bytes: their least time at HBM bandwidth."""
    return bytes_moved / HBM_BYTES_PER_S
