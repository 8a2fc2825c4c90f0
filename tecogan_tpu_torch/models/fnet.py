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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upscale_two
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
