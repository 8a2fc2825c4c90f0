"""FRVSR-style recurrent SR generator (tecogan_tpu/models/generator.py).

Topology (4x SR):
  input (B, H, W, 51): 3 LR RGB + 48 space-to-depth feedback channels
  -> conv3x3 51->64 + ReLU
  -> num_resblock x [conv-ReLU-conv + skip]
  -> convT 3x3 s2 64->64 + ReLU
  -> resblock(64), resblock(64->128) as plain conv stacks (no skip)
  -> convT 3x3 s2 128->128 + ReLU
  -> conv3x3 128->64 + ReLU
  -> conv3x3 64->out + sigmoid

``dtype`` is the compute dtype (weights are held in it, as the JAX
package casts its float32 params at use); ``out_dtype`` is the dtype of
the sigmoid.  The public methods take and return NHWC tensors and run
NCHW ``channels_last`` inside, so the permutes are free views.  The
``forward`` / ``tail`` / ``tail_features`` split is the JAX one: the
fused route computes the first layer itself and swaps ``conv_out`` for
the s2d kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, ConvTranspose2x, ResidualBlock


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Generator(nn.Module):
    def __init__(self, num_resblock: int = 16, out_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_resblock = num_resblock
        self.dtype = dtype
        self.out_dtype = out_dtype
        self.conv_in = Conv(51, 64, dtype=dtype)
        for i in range(num_resblock):
            self.add_module(f"resblock_{i}", ResidualBlock(64, 64, dtype=dtype))
        self.up1 = ConvTranspose2x(64, 64, dtype=dtype)
        self.trunk_rb1 = ResidualBlock(64, 64, dtype=dtype)
        self.trunk_rb2 = ResidualBlock(64, 128, dtype=dtype)
        self.up2 = ConvTranspose2x(128, 128, dtype=dtype)
        self.conv_hr = Conv(128, 64, dtype=dtype)
        self.conv_out = Conv(64, out_channels, dtype=dtype)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 51) -> (B, 4H, 4W, out_channels) in [0, 1]."""
        net = F.relu(self.conv_in(_nchw(x.to(self.dtype))))
        return _nhwc(self._tail(net))

    def tail(self, net: torch.Tensor) -> torch.Tensor:
        """Everything after the first activation: (B, H, W, 64) ->
        (B, 4H, 4W, out_channels)."""
        return _nhwc(self._tail(_nchw(net.to(self.dtype))))

    def tail_features(self, net: torch.Tensor) -> torch.Tensor:
        """The tail up to the conv_hr activation: (B, H, W, 64) ->
        (B, 4H, 4W, 64), contiguous NHWC."""
        return _nhwc(self._features(_nchw(net.to(self.dtype))))

    def _tail(self, net: torch.Tensor) -> torch.Tensor:
        net = self.conv_out(self._features(net))
        return torch.sigmoid(net.to(self.out_dtype))

    def _features(self, net: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_resblock):
            net = getattr(self, f"resblock_{i}")(net) + net
        net = F.relu(self.up1(net))
        net = self.trunk_rb1(net)
        net = self.trunk_rb2(net)
        net = F.relu(self.up2(net))
        return F.relu(self.conv_hr(net))
