"""Spatio-temporal discriminator (tecogan_tpu/models/discriminator.py).

Input (B, H, W, 27): three triplets of 3 RGB frames -- [before-warp
targets, warped targets, bilinear-upscaled LR] -- or, with ``Dt_mergeDs``
off, the 9-channel warped triplet alone.

Topology:
  conv3x3 in->64 + lrelu(0.2)
  block1: conv4x4 s2 no-bias -> BN -> lrelu
  resids1: R x [BN(resblock(64)) + skip]          -> feature 1
  block2: conv4x4 s2 -> BN -> lrelu, 64->C
  resids2: R x [BN(resblock(C)) + skip]           -> feature 2
  block3: conv4x4 s2 C->C + resids3               -> feature 3
  block4: conv4x4 s2 C->64                        -> feature 4
  block5: conv4x4 s2 64->3
  flatten (NCHW order) -> dense(->1) -> sigmoid

The submodules carry the flax names (``conv_in``, ``block{k}.Conv_0`` /
``BatchNorm_0``, ``resids{k}.rb_{i}`` / ``bn_{i}``, ``fc``), so the weight
bridge is a pure layout map.  Params are float32; ``dtype`` is the
compute dtype.  The train step runs the module with its state's params
(``torch.func.functional_call``), in their layout.  The fc input size follows from ``in_size``, the input's
spatial size (48 at 128x128), as the flax module infers it from the input.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .layers import BatchNorm, Conv, Dense, ResidualBlock, lrelu


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _down(size: int) -> int:
    """Spatial size after a 4x4 stride-2 conv with padding 1."""
    return (size + 2 - 4) // 2 + 1


class _DiscBlock(nn.Module):
    """conv4x4 s2 (no bias) -> BN -> lrelu."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, bias=False, kernel=4, stride=2)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, stats: Dict[str, torch.Tensor], name: str, group=None):
        return lrelu(self.BatchNorm_0(self.Conv_0(x), stats, f"{name}.BatchNorm_0", group))


class _ResidBNGroup(nn.Module):
    """R x [BN(conv-relu-conv) + skip]."""

    def __init__(self, features: int, count: int):
        super().__init__()
        self.count = count
        for i in range(count):
            self.add_module(f"rb_{i}", ResidualBlock(features, features))
            self.add_module(f"bn_{i}", BatchNorm(features))

    def forward(self, x, stats: Dict[str, torch.Tensor], name: str, group=None):
        for i in range(self.count):
            y = getattr(self, f"rb_{i}")(x)
            x = getattr(self, f"bn_{i}")(y, stats, f"{name}.bn_{i}", group) + x
        return x


class Discriminator(nn.Module):
    def __init__(self, resblocks: int = 4, channels: int = 128,
                 dtype: torch.dtype = torch.float32, in_channels: int = 27,
                 in_size: int = 128):
        super().__init__()
        self.dtype = dtype
        C = channels
        self.conv_in = Conv(in_channels, 64)
        self.block1 = _DiscBlock(64, 64)
        self.resids1 = _ResidBNGroup(64, resblocks)
        self.block2 = _DiscBlock(64, C)
        self.resids2 = _ResidBNGroup(C, resblocks)
        self.block3 = _DiscBlock(C, C)
        self.resids3 = _ResidBNGroup(C, resblocks)
        self.block4 = _DiscBlock(C, 64)
        self.block5 = _DiscBlock(64, 3)
        side = in_size
        for _ in range(5):
            side = _down(side)
        self.fc = Dense(3 * side * side, 1)

    def forward(self, x: torch.Tensor, group: Optional[object] = None) -> Tuple[
            torch.Tensor, List[torch.Tensor], Dict[str, torch.Tensor]]:
        """x: (B, H, W, in_channels) -> (score (B, 1) float32 in (0, 1),
        the 4 feature maps (NHWC, compute dtype), the batch statistics of
        every BN layer by name, detached).  ``group``: the data-parallel
        process group whose global batch the BN statistics are taken over
        (``layers.BatchNorm``), None for this process's batch."""
        stats: Dict[str, torch.Tensor] = {}
        layers = []
        net = lrelu(self.conv_in(_nchw(x.to(self.dtype))))
        net = self.block1(net, stats, "block1", group)
        net = self.resids1(net, stats, "resids1", group)
        layers.append(_nhwc(net))
        net = self.block2(net, stats, "block2", group)
        net = self.resids2(net, stats, "resids2", group)
        layers.append(_nhwc(net))
        net = self.block3(net, stats, "block3", group)
        net = self.resids3(net, stats, "resids3", group)
        layers.append(_nhwc(net))
        net = self.block4(net, stats, "block4", group)
        layers.append(_nhwc(net))
        net = self.block5(net, stats, "block5", group)
        # flatten in NCHW order, as the reference's view on NCHW;
        # reshape is in logical order whatever the memory format
        net = net.reshape(net.shape[0], -1)
        score = torch.sigmoid(self.fc(net).float())
        return score, layers, stats
