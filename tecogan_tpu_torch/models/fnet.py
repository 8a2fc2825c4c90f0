"""FNet optical-flow estimator (tecogan_tpu/models/fnet.py; reference
code/models.py:22-50), the flow source of the FNet training variant
(engine/fnet_train.py).

A U-Net: 4 down blocks (conv, lrelu, conv, lrelu, 2x2 max-pool)
3 -> 32 -> 64 -> 128 -> 256, 4 up blocks (conv, lrelu, conv, lrelu,
bilinear 2x) -> 512 -> 256 -> 128 -> 64, then conv 64 -> 32, lrelu,
conv 32 -> 2 and ``tanh(.) * 24`` in float32: flow in [-24, 24] pixels.
The submodules carry flax's names (``_DownBlock_{i}.Conv_{j}``,
``_UpBlock_{i}.Conv_{j}``, ``Conv_0``, ``Conv_1``), so the weight bridge
(``utils.convert.fnet_state_dict_from_jax``) is a pure layout map.  The
interface is NHWC; inside, NCHW.

:class:`PublishedFNet` is TecoGAN's FNet as published (Chu et al. 2020,
github.com/thunil/TecoGAN ``lib/frvsr.py``'s ``fnet``), which the
published model serves (``models.generator.PublishedTecoGAN``): 3 levels,
a floor max-pool and TF1's bilinear 2x.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upscale_two, upscale_two_tf
from .layers import Conv, lrelu

DOWN = (32, 64, 128, 256)
UP = (512, 256, 128, 64)


class _Block(nn.Module):
    """conv-lrelu-conv-lrelu, then a 2x2 max-pool (down) or a bilinear 2x
    (up)."""

    def __init__(self, in_ch: int, features: int, up: bool, dtype: torch.dtype):
        super().__init__()
        self.up = up
        self.Conv_0 = Conv(in_ch, features, dtype=dtype)
        self.Conv_1 = Conv(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = lrelu(self.Conv_1(lrelu(self.Conv_0(x))))
        return upscale_two(x) if self.up else F.max_pool2d(x, 2, 2)


class FNet(nn.Module):
    def __init__(self, in_channels: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = in_channels
        for i, f in enumerate(DOWN):
            self.add_module(f"_DownBlock_{i}", _Block(ch, f, False, dtype))
            ch = f
        for i, f in enumerate(UP):
            self.add_module(f"_UpBlock_{i}", _Block(ch, f, True, dtype))
            ch = f
        self.Conv_0 = Conv(ch, 32, dtype=dtype)
        self.Conv_1 = Conv(32, 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) frame pair -> (B, H, W, 2) flow in [-24, 24],
        float32; H and W multiples of 16."""
        net = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(len(DOWN)):
            net = getattr(self, f"_DownBlock_{i}")(net)
        for i in range(len(UP)):
            net = getattr(self, f"_UpBlock_{i}")(net)
        net = self.Conv_1(lrelu(self.Conv_0(net)))
        return (torch.tanh(net.float()) * 24.0).permute(0, 2, 3, 1)


PUBLISHED_DOWN = (32, 64, 128)
PUBLISHED_UP = (256, 128, 64)


class _PublishedBlock(nn.Module):
    """``lib/frvsr.py``'s ``down_block`` / ``up_block``: conv-lrelu-conv-lrelu,
    then a 2x2 max-pool of stride 2 that drops an odd last row or column
    (VALID) or TF1's bilinear 2x (:func:`ops.resize.upscale_two_tf`)."""

    def __init__(self, in_ch: int, features: int, up: bool, dtype: torch.dtype):
        super().__init__()
        self.up = up
        self.conv_1 = Conv(in_ch, features, dtype=dtype)
        self.conv_2 = Conv(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = lrelu(self.conv_2(lrelu(self.conv_1(x))))
        return upscale_two_tf(x) if self.up else F.max_pool2d(x, 2, 2)


class _OutputStage(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(in_ch, 32, dtype=dtype)
        self.conv2 = Conv(32, 2, dtype=dtype)


class PublishedFNet(nn.Module):
    """TecoGAN's published FNet: encoders ``encoder_{1,2,3}`` at 32, 64 and
    128 channels, decoders ``decoder_{1,2,3}`` at 256, 128 and 64, then
    ``output_stage.conv1`` (64 -> 32), lrelu, ``output_stage.conv2`` (32 ->
    2) and ``tanh(.) * 24`` in float32; every conv 3x3 SAME with a bias,
    the leaky ReLUs at 0.2.  The submodules carry the published code's
    scope names.  Held ``channels_last``."""

    def __init__(self, in_channels: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = in_channels
        for i, f in enumerate(PUBLISHED_DOWN):
            self.add_module(f"encoder_{i + 1}", _PublishedBlock(ch, f, False, dtype))
            ch = f
        for i, f in enumerate(PUBLISHED_UP):
            self.add_module(f"decoder_{i + 1}", _PublishedBlock(ch, f, True, dtype))
            ch = f
        self.output_stage = _OutputStage(ch, dtype)
        self.to(memory_format=torch.channels_last)

    def forward(self, prev_lr: torch.Tensor, cur_lr: torch.Tensor) -> torch.Tensor:
        """The LR frames (B, H, W, 3) -> the flow (B, H, W, 2) float32 in
        LR pixels, channel 0 rows and channel 1 columns.  The network
        gives ``8 * (H // 8)`` rows and ``8 * (W // 8)`` columns; the rest
        are padded at the bottom and right by mirroring, edge included
        (TF's SYMMETRIC pad), as the published inference pads them."""
        H, W = cur_lr.shape[1:3]
        x = torch.cat([prev_lr.to(self.dtype), cur_lr.to(self.dtype)], dim=-1)
        net = x.permute(0, 3, 1, 2)
        for name in ("encoder_1", "encoder_2", "encoder_3", "decoder_1", "decoder_2",
                     "decoder_3"):
            net = getattr(self, name)(net)
        out = self.output_stage
        net = out.conv2(lrelu(out.conv1(net)))
        flow = (torch.tanh(net.float()) * 24.0).permute(0, 2, 3, 1)
        return pad_symmetric(flow, H, W)


def pad_symmetric(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """NHWC ``x`` of at most H rows and W columns, padded at the bottom and
    right to (H, W) with its last rows and columns mirrored, the edge
    repeated (TF's ``SYMMETRIC``); ``x`` itself where it fits."""
    ph, pw = H - x.shape[1], W - x.shape[2]
    if ph:
        x = torch.cat([x, x[:, x.shape[1] - ph:].flip(1)], dim=1)
    if pw:
        x = torch.cat([x, x[:, :, x.shape[2] - pw:].flip(2)], dim=2)
    return x
