"""Space-to-depth / depth-to-space in the reference channel order.

The recurrent feedback packs the warped 4x SR frame into 48 LR channels
numbered ``c*16 + a*4 + b`` ((a, b) = sub-pixel row, col), which is
exactly ``F.pixel_unshuffle``'s order on an NCHW tensor
(tecogan_tpu/ops/space.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 4  # the SR factor


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``(B, 4H, 4W, C) -> (B, H, W, 16C)``."""
    y = F.pixel_unshuffle(x.permute(0, 3, 1, 2), BLOCK)
    return y.permute(0, 2, 3, 1)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` (same channel numbering)."""
    y = F.pixel_shuffle(x.permute(0, 3, 1, 2), BLOCK)
    return y.permute(0, 2, 3, 1)
