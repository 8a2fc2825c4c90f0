"""Resizes (tecogan_tpu/ops/resize.py, and the two ``jax.image.resize``
modes the adaptation slice calls).

* :func:`upscale_four` / :func:`upscale_two`: 4x / 2x bilinear,
  half-pixel source centers, edge clamp (``align_corners=False``), the
  recurrence's pseudo-flow and FNet's up blocks.
* :func:`resize_bilinear_aa` and :func:`resize_bicubic`:
  ``jax.image.resize(x, shape, "bilinear", antialias=True)`` and
  ``jax.image.resize(x, shape, "bicubic")``.  Each resized axis is one
  contraction with a weight matrix computed as JAX's
  ``scale_and_translate`` computes it, in float32: half-pixel sample
  positions, the triangle or Keys cubic (a = -0.5) kernel stretched by the
  inverse scale when downsampling with antialias, every output's weights
  normalized to sum to 1.  ``F.interpolate``'s bicubic is not this
  function (a = -0.75 and another edge rule).  The contractions run in
  full float32 on any device (JAX resizes at ``Precision.HIGHEST``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .precision import full_f32


def upscale_four(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``(B, C, H, W) -> (B, C, 4H, 4W)``."""
    return F.interpolate(x, scale_factor=4, mode="bilinear",
                         align_corners=False)


def upscale_two(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear as :func:`upscale_four` (FNet's up blocks, reference
    code/models.py:17): NCHW ``(B, C, H, W) -> (B, C, 2H, 2W)``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= f(1.0), ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= f(2.0), f(0.0), out).astype(np.float32)


def weight_matrix(n_in: int, n_out: int, kernel: Callable, antialias: bool) -> np.ndarray:
    """(n_in, n_out) float32 weights: ``out = x @ w`` along one axis
    (``jax._src.image.scale.compute_weight_mat`` at translation 0)."""
    f = np.float32
    inv_scale = f(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f(1.0)) if antialias else f(1.0)
    sample_f = (np.arange(n_out, dtype=f) + f(0.5)) * inv_scale - f(0.0) - f(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f)[:, None]) / kernel_scale
    w = kernel(x.astype(f))
    total = np.sum(w, axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0) * np.finfo(f).eps,
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample_f >= f(-0.5)) & (sample_f <= f(n_in) - f(0.5))
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def _resize(x: torch.Tensor, shape: Sequence[int], kernel: Callable,
            antialias: bool) -> torch.Tensor:
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} has not the rank of x {tuple(x.shape)}")
    x = x.float()
    with full_f32():
        for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
            if n_in == n_out:
                continue
            w = torch.from_numpy(weight_matrix(n_in, n_out, kernel, antialias))
            x = torch.movedim(torch.tensordot(x, w.to(x.device), dims=([d], [0])), -1, d)
    return x


def resize_bilinear_aa(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear", antialias=True)``: every
    axis whose size changes is resized; float32 out."""
    return _resize(x, shape, _triangle, antialias=True)


def resize_bicubic(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bicubic")`` (Keys a = -0.5; JAX's
    antialias only acts when downsampling); float32 out."""
    return _resize(x, shape, _keys_cubic, antialias=True)
