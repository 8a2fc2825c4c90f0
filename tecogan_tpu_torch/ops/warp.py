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


def round_through_half(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float16 (to nearest, ties to even) and back to
    float32: the reference's ``.half()``, JAX's ``astype(float16)``.
    torch takes float64 to float16 through a float32 rounded to nearest,
    which rounds twice and can land on the wrong side of a float16
    midpoint; a float64 ``x`` goes to float32 rounded to odd first, after
    which the one rounding to float16 is exact."""
    if x.dtype == torch.float64:
        r = x.float()
        inexact = r.double() != x
        even = (r.view(torch.int32) & 1) == 0
        toward = torch.where(x > r.double(), torch.inf, -torch.inf).float()
        x = torch.where(inexact & even, torch.nextafter(r, toward), r)
    return x.to(torch.float16).to(torch.float32)


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
        grid = round_through_half(grid)
    return grid
