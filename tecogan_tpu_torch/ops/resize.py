"""Resizes (tecogan_tpu/ops/resize.py, and the two ``jax.image.resize``
modes the adaptation slice calls).

* :func:`upscale_four` / :func:`upscale_two`: 4x / 2x bilinear,
  half-pixel source centers, edge clamp (``align_corners=False``), the
  recurrence's pseudo-flow and FNet's up blocks.
* :func:`upscale_four_tf`, :func:`bicubic_four` and :func:`upscale_two_tf`:
  the resizes of TecoGAN as published (github.com/thunil/TecoGAN,
  ``lib/ops.py``'s ``upscale_four`` and ``bicubic_four``, and TF1's
  ``tf.image.resize_images`` in FNet's decoder): the output pixel ``s*i +
  a`` samples the source at ``i + a/s`` (offsets 0, 1/4, 1/2, 3/4 for 4x),
  with the last row and column repeated past the edge (and the first row
  and column before it, for the bicubic).  ``bicubic_four`` is the cubic
  convolution of Keys with a = -0.75 (TF1's ``resize_bicubic``), rows
  first, then columns, as ``lib/ops.py`` sums them.  All in float32.
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


def _repeat_edge(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """``x`` with its first index repeated ``before`` times ahead of it
    and its last ``after`` times behind it along ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, idx)


def upscale_four_tf(x: torch.Tensor) -> torch.Tensor:
    """TecoGAN's ``upscale_four``: NHWC ``(B, H, W, C) -> (B, 4H, 4W, C)``,
    bilinear at offsets 0, 1/4, 1/2 and 3/4, the last row and column
    repeated.  Pixel (4i + a, 4j + b) is ``tl * (1 - a/4) * (1 - b/4) +
    tr * (1 - a/4) * (b/4) + bl * (a/4) * (1 - b/4) + br * (a/4) * (b/4)``,
    summed left to right, as ``lib/ops.py`` writes it."""
    B, H, W, C = x.shape
    p = _repeat_edge(_repeat_edge(x.float(), 1, 0, 1), 2, 0, 1)
    tl, tr = p[:, :-1, :-1], p[:, :-1, 1:]
    bl, br = p[:, 1:, :-1], p[:, 1:, 1:]
    rows = []
    for a in range(4):
        cols = []
        for b in range(4):
            ya, yb, xa, xb = 1.0 - 0.25 * a, 0.25 * a, 1.0 - 0.25 * b, 0.25 * b
            cols.append(tl * ya * xa + tr * ya * xb + bl * yb * xa + br * yb * xb)
        rows.append(torch.stack(cols, dim=3))  # (B, H, W, 4b, C)
    out = torch.stack(rows, dim=2)  # (B, H, 4a, W, 4b, C)
    return out.reshape(B, 4 * H, 4 * W, C)


BICUBIC_A = -0.75


def bicubic_weights(t: float) -> tuple:
    """The four taps (at -1, 0, 1, 2 from the source pixel) of Keys' cubic
    convolution with a = -0.75 at fraction ``t``: ``[1, t, t^2, t^3]``
    times ``lib/ops.py``'s matrix (exact in float32 at multiples of 1/4)."""
    r = -BICUBIC_A
    m = np.float64([[0, 1, 0, 0], [-r, 0, r, 0], [2 * r, r - 3, 3 - 2 * r, -r],
                    [-r, 2 - r, r - 2, r]])
    return tuple(float(v) for v in np.float64([1.0, t, t * t, t ** 3]) @ m)


def bicubic_four(x: torch.Tensor) -> torch.Tensor:
    """TecoGAN's ``bicubic_four``: NHWC ``(B, H, W, C) -> (B, 4H, 4W, C)``
    float32.  Rows first: row 4i + a is ``w0 * x[i-1] + w1 * x[i] + w2 *
    x[i+1] + w3 * x[i+2]`` with :func:`bicubic_weights` ``(a/4)``, rows
    past the edges repeating the edge row; then columns alike."""
    B, H, W, C = x.shape
    p = _repeat_edge(_repeat_edge(x.float(), 1, 1, 2), 2, 1, 2)  # (B, H+3, W+3, C)

    def along(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        taps = [t.narrow(dim, k, n) for k in range(4)]
        phases = []
        for a in range(4):
            w = bicubic_weights(0.25 * a)
            phases.append(w[0] * taps[0] + w[1] * taps[1] + w[2] * taps[2] + w[3] * taps[3])
        out = torch.stack(phases, dim=dim + 1)
        shape = list(t.shape)
        shape[dim] = 4 * n
        return out.reshape(shape)

    return along(along(p, 1, H), 2, W)


def upscale_two_tf(x: torch.Tensor) -> torch.Tensor:
    """TF1's ``tf.image.resize_images(x, 2 * size)`` (bilinear,
    ``align_corners=False``, no half-pixel centers) as FNet's published
    decoder calls it: NCHW ``(B, C, H, W) -> (B, C, 2H, 2W)`` in ``x``'s
    dtype.  Output row 2i is row i, row 2i + 1 the midpoint of rows i and
    i + 1 (row i again past the last); columns alike.  Each axis is two
    gathers and one ``torch.lerp`` at 0.5, TF's ``a + (b - a) * 0.5``; a
    ``channels_last`` input stays ``channels_last``."""
    nhwc = x.permute(0, 2, 3, 1)
    for dim in (1, 2):
        lo, hi = _two_x_sources(nhwc.shape[dim], x.device)
        nhwc = torch.lerp(nhwc.index_select(dim, lo), nhwc.index_select(dim, hi), 0.5)
    return nhwc.permute(0, 3, 1, 2)


_SOURCES: dict = {}


def _two_x_sources(n: int, device: torch.device) -> tuple:
    """The source indices ``i`` and ``min(i + 1, n - 1)`` of
    :func:`upscale_two_tf`'s ``2n`` outputs along one axis, made once per
    size and device."""
    key = (n, device)
    if key not in _SOURCES:
        out = torch.arange(2 * n)
        _SOURCES[key] = ((out // 2).to(device), ((out + 1) // 2).clamp(max=n - 1).to(device))
    return _SOURCES[key]


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
