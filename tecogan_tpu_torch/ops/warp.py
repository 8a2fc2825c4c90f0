"""Bilinear warp and the reference's pseudo-flow grid
(tecogan_tpu/ops/warp.py).

``grid_sample`` is ``F.grid_sample`` with the reference's defaults:
bilinear, zero padding, ``align_corners=False``; ``grid[..., 0]`` is the
width coordinate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .resize import upscale_four


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """image ``(B, H, W, C)`` NHWC, grid ``(B, Hg, Wg, 2)`` normalized
    ``[-1, 1]`` -> ``(B, Hg, Wg, C)``."""
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid.to(image.dtype),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def pseudo_flow_nchw(prev_lr_nchw: torch.Tensor,
                     parity_half: bool = False) -> torch.Tensor:
    """Bilinear 4x of ``prev_lr * 4``, channels 0:2, viewed raw (a
    C-order reinterpretation, not a permute) as a ``(B, 4H, 4W, 2)``
    grid.  ``parity_half`` rounds the grid through fp16 like the
    reference's ``cur_flow.half()`` under CUDA AMP."""
    B, _, H, W = prev_lr_nchw.shape
    flow = upscale_four(prev_lr_nchw[:, 0:2] * 4.0)
    # reshape is in logical (C) order whatever the memory format, which is
    # the reference's .view of the contiguous NCHW upsample
    grid = flow.reshape(B, 4 * H, 4 * W, 2)
    if parity_half:
        grid = grid.to(torch.float16).to(torch.float32)
    return grid
