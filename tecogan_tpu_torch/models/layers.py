"""Layer building blocks (tecogan_tpu/models/layers.py).

These run on NCHW tensors; the generator keeps them in
``torch.channels_last`` so cuDNN reads and writes NHWC memory.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Conv2d):
    """3x3 cross-correlation, stride 1, padding 1 (the reference conv2)."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 3, stride=1, padding=1, bias=bias,
                         dtype=dtype)


class ConvTranspose2x(nn.ConvTranspose2d):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1): exact 2x upsample
    (the reference conv2_tran)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 3, stride=2, padding=1,
                         output_padding=1, dtype=dtype)


class ResidualBlock(nn.Module):
    """conv(bias) - ReLU - conv(no bias).  The skip is added by the caller:
    the generator's trunk uses the block without one."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, bias=True, dtype=dtype)
        self.Conv_1 = Conv(features, features, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.relu(self.Conv_0(x)))
