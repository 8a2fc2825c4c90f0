"""Quality metrics (tecogan_tpu/ops/metrics.py): PSNR in the reference's
255-scale convention, SSIM, and the VGG-feature distances (plain and
LPIPS-form).  Images are NHWC; every metric returns a 0-d (or, per frame,
1-d) float32 tensor on the input's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .precision import full_f32

SSIM_SIGMA, SSIM_WINDOW = 1.5, 11


def psnr_255(ref: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR of [0, 255] inputs: MSE over all elements, peak 255."""
    mse = torch.mean(torch.square(target.float() - ref.float()))
    return 10.0 * torch.log10(255.0 * 255.0 / mse)


def psnr(ref01: torch.Tensor, target01: torch.Tensor) -> torch.Tensor:
    """PSNR of [0, 1] inputs."""
    return psnr_255(ref01 * 255.0, target01 * 255.0)


def psnr_per_frame(ref01: torch.Tensor, target01: torch.Tensor) -> torch.Tensor:
    """Per-frame PSNR of a (T, H, W, C) clip -> (T,) dB, the VSR papers'
    mean-of-frames convention."""
    d = torch.square((target01 - ref01) * 255.0)
    mse = torch.mean(d.reshape(d.shape[0], -1), dim=1)
    return 10.0 * torch.log10(255.0 * 255.0 / mse)


def _gaussian_window(device: torch.device) -> torch.Tensor:
    """The 11 x 11 window ``outer(g, g)``, g the normalized Gaussian of
    sigma 1.5, in float32 as JAX computes it."""
    coords = torch.arange(SSIM_WINDOW, dtype=torch.float32) - SSIM_WINDOW // 2
    g = torch.exp(-(coords ** 2) / (2 * SSIM_SIGMA ** 2))
    g = g / g.sum()
    return torch.outer(g, g).to(device)


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over NHWC batches: the 11 x 11 Gaussian window applied as
    a VALID depthwise conv, K1 = 0.01, K2 = 0.03.

    The variances ``E[x^2] - E[x]^2`` cancel, so the filter must run in
    full float32 (JAX asks for ``Precision.HIGHEST``): the conv runs with
    TF32 off, whatever the global flags."""
    C = x.shape[-1]
    k = _gaussian_window(x.device).expand(C, 1, SSIM_WINDOW, SSIM_WINDOW)

    def filt(img):
        return F.conv2d(img.float().permute(0, 3, 1, 2), k, groups=C)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    with full_f32():
        mx, my = filt(x), filt(y)
        mxx, myy, mxy = filt(x * x), filt(y * y), filt(x * y)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return torch.mean(s)


def _unit(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-10)


def vgg_perceptual_distance(feats_x: Dict[str, torch.Tensor],
                            feats_y: Dict[str, torch.Tensor],
                            layers: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Mean squared difference of channel-unit-normalized VGG features,
    averaged over ``layers`` (default: every key, sorted)."""
    layers = layers or sorted(feats_x)
    total = 0.0
    for name in layers:
        total = total + torch.mean(torch.square(_unit(feats_x[name]) - _unit(feats_y[name])))
    return total / len(layers)


def lpips_distance(feats_x: Dict[str, torch.Tensor], feats_y: Dict[str, torch.Tensor],
                   layers: Optional[Sequence[str]] = None,
                   lin_weights: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """LPIPS (Zhang et al. 2018): ``sum_l mean_hw(sum_c w_lc (fx - fy)_c^2)``
    over unit-normalized features, ``w_l`` the layer's learned per-channel
    weights from ``lin_weights`` (layer -> (C_l,)), else uniform 1 / C_l
    (then the result is the surrogate, not the published metric)."""
    layers = layers or sorted(feats_x)
    total = 0.0
    for name in layers:
        sq = torch.square(_unit(feats_x[name]) - _unit(feats_y[name]))
        if lin_weights is not None and name in lin_weights:
            w = torch.as_tensor(lin_weights[name], dtype=sq.dtype, device=sq.device)
            w = w.reshape(1, 1, 1, -1)
        else:
            w = 1.0 / sq.shape[-1]
        total = total + torch.mean(torch.sum(sq * w, dim=-1))
    return total
