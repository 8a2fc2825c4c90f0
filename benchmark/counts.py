"""The yardstick's arithmetic: the peaks of one NVIDIA H100 SXM (data
sheet, dense, at its 700 W limit), and the operations and bytes each hand
kernel needs, computed from shapes (and, for the data-dependent warp, from
its inputs).  A frame's model operations are each architecture's own
(``benchmark/architectures/<name>/counts.py``).

A kernel's least time is the larger of its bytes over the HBM bandwidth
and its operations over the peak of the unit it runs on; each input byte
is counted read once and each output byte written once.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12

# the warp's float32 operations: a pixel's grid (the 4x bilinear upscale
# of R and G, 9 + 3 each), its sample weights (8), deprocess and packing
# (3 x 3); a tap of a channel (5)
WARP_OPS_PER_PIXEL = 2 * (9 + 3) + 8 + 3 * 3
WARP_OPS_PER_TAP_CHANNEL = 5


def least_s(bytes_moved: float, ops: float, peak: float) -> float:
    """The least time in seconds: bytes at the HBM bandwidth or operations
    at ``peak``, whichever takes longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / peak)


def conv_out_s2d_work(h: int, w: int, batch: int = 1) -> Tuple[float, float]:
    """(bytes, operations) of ``conv_out_s2d`` at LR (h, w): the bf16
    (B, 4h, 4w, 64) features read, the bf16 (B, h, w, 48) carry written;
    a 3x3 conv of 64 channels to 3 at 4h x 4w."""
    out = batch * h * w * 48
    return (batch * 16 * h * w * 64 + out) * 2.0, 2.0 * out * 9 * 64


def conv_out_s2d_least_s(h: int, w: int, batch: int = 1) -> float:
    return least_s(*conv_out_s2d_work(h, w, batch), PEAK_BF16_FLOPS)


def warp_s2d_work(prev_lr: torch.Tensor) -> Tuple[float, float]:
    """(bytes, operations) of ``warp_s2d`` warping a carry of LR size
    (B, h, w) by the pseudo-flow of ``prev_lr`` (B, h, w, 3) float [0, 1]:
    the carry's taps that its samples read inside the frame (each pixel
    once, 3 bf16 channels), the R and G planes of ``prev_lr`` (float32),
    the (B, h, w, 48) bf16 feedback written."""
    B, h, w, _ = prev_lr.shape
    H4, W4 = 4 * h, 4 * w
    rg = prev_lr.permute(0, 3, 1, 2)[:, 0:2].float() * 4.0
    g = F.interpolate(rg, scale_factor=4, mode="bilinear",
                      align_corners=False).contiguous().reshape(B, H4, W4, 2)
    ix = torch.floor(((g[..., 0] + 1) * W4 - 1) / 2)
    iy = torch.floor(((g[..., 1] + 1) * H4 - 1) / 2)
    touched = torch.zeros((B, H4, W4), dtype=torch.bool, device=prev_lr.device)
    b = torch.arange(B, device=prev_lr.device).view(B, 1, 1).expand_as(ix)
    taps = 0
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = ix + dx, iy + dy
            ok = (x >= 0) & (x <= W4 - 1) & (y >= 0) & (y <= H4 - 1)
            taps += int(ok.sum())
            touched[b[ok], y[ok].long(), x[ok].long()] = True
    bytes_moved = int(touched.sum()) * 3 * 2 + B * h * w * 2 * 4 + B * h * w * 48 * 2
    ops = B * H4 * W4 * WARP_OPS_PER_PIXEL + taps * 3 * WARP_OPS_PER_TAP_CHANNEL
    return float(bytes_moved), float(ops)


def warp_s2d_least_s(prev_lr: torch.Tensor) -> float:
    return least_s(*warp_s2d_work(prev_lr), PEAK_F32_FLOPS)


def int8_layers(h: int, w: int, blocks: int = 16) -> List[tuple]:
    """The int8 kernels' layers a frame at LR (h, w), ``blocks`` residual
    blocks at LR: (transposed, (B, H, W, Cin, Cout) of the input,
    residual, launches a frame)."""
    return [(False, (1, h, w, 64, 64), False, blocks),
            (False, (1, h, w, 64, 64), True, blocks),
            (True, (1, h, w, 64, 64), False, 1),
            (False, (1, 2 * h, 2 * w, 64, 64), False, 1),
            (False, (1, 2 * h, 2 * w, 64, 64), False, 1),
            (False, (1, 2 * h, 2 * w, 64, 128), False, 1),
            (False, (1, 2 * h, 2 * w, 128, 128), False, 1),
            (True, (1, 2 * h, 2 * w, 128, 128), False, 1),
            (False, (1, 4 * h, 4 * w, 128, 64), False, 1)]


def int8_layer_work(transposed: bool, shape: tuple, residual: bool,
                    act_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, int8 operations) of one int8 layer: its input read once,
    its output written once (and the residual read), the int8 weights,
    the float32 dequantization scales and bias; ``2 * 9 * Cin * Cout``
    operations an input pixel."""
    B, H, W, cin, cout = shape
    oh, ow = (2 * H, 2 * W) if transposed else (H, W)
    out = B * oh * ow * cout
    moved = (B * H * W * cin + out * (2 if residual else 1)) * act_bytes
    return float(moved + 9 * cin * cout + cout * 8), 2.0 * 9 * cin * cout * B * H * W


def int8_least_s_per_frame(h: int, w: int, transposed: bool,
                           blocks: int = 16) -> Tuple[float, int]:
    """(least seconds a frame, launches a frame) of the int8 layers that
    are (``transposed``) 2x transposed convs, or the 3x3 convs."""
    total, launches = 0.0, 0
    for tr, shape, residual, n in int8_layers(h, w, blocks):
        if tr == transposed:
            total += n * least_s(*int8_layer_work(tr, shape, residual), PEAK_INT8_OPS)
            launches += n
    return total, launches
