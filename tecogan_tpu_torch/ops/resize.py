"""4x bilinear upsample (tecogan_tpu/ops/resize.py::upscale_four):
half-pixel source centers, edge clamp (``align_corners=False``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upscale_four(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``(B, C, H, W) -> (B, C, 4H, 4W)``."""
    return F.interpolate(x, scale_factor=4, mode="bilinear",
                         align_corners=False)
