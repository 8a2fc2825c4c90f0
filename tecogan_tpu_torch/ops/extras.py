"""Working versions of the reference's dead or broken op stubs
(tecogan_tpu/ops/extras.py; reference code/ops.py:93-125,218-224):
what each stub meant to compute.

* :func:`pixelshuffle`: sub-pixel upsample (a typo'd ``nn.PixelShuffel``);
* :func:`phase_shift`: the ESPCN phase-shift core (invalid transpose
  arguments in the reference);
* :func:`random_flip` / :func:`random_flip_batch`: a horizontal flip
  where the decision is below 0.5 (a nonexistent ``torch.identity``);
* :func:`gaussian_2dkernel`: a normalized 2D Gaussian (works in the
  reference).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pixelshuffle(x_nhwc: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Sub-pixel upsample, NHWC: (B, H, W, C s^2) -> (B, sH, sW, C), the
    channel order of ``ops.space.depth_to_space``."""
    return F.pixel_shuffle(x_nhwc.permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)


def phase_shift(x: torch.Tensor, scale: int, shape_1, shape_2) -> torch.Tensor:
    """Reshape to ``shape_1`` (5-D), swap dims 2 and 3, reshape to
    ``shape_2``: the interleave of the sub-pixel phases.  ``scale`` is
    unused, as in the JAX function."""
    return x.reshape(shape_1).permute(0, 1, 3, 2, 4).reshape(shape_2)


def random_flip_batch(x: torch.Tensor, decision: torch.Tensor) -> torch.Tensor:
    """Each sample of an NCHW batch flipped along W where its ``decision``
    is below 0.5."""
    cond = (torch.as_tensor(decision) < 0.5).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond.to(x.device), torch.flip(x, dims=(3,)), x)


def random_flip(x: torch.Tensor, decision) -> torch.Tensor:
    """The whole tensor flipped along dim 3 when ``decision`` < 0.5."""
    return torch.flip(x, dims=(3,)) if decision < 0.5 else x


def gaussian_2dkernel(size: int = 5, sig: float = 1.0) -> np.ndarray:
    """Normalized 2D Gaussian kernel, float64 (reference ops.py:218-224)."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2.0 * sig ** 2))
    k = np.outer(g, g)
    return k / k.sum()
