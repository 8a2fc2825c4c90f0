"""Range maps and the uint8 transfer pair (tecogan_tpu/ops/image.py)."""

from __future__ import annotations

import torch

_INV_255 = torch.tensor(1.0 / 255.0, dtype=torch.float32).item()


def preprocess(image: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1]."""
    return image * 2.0 - 1.0


def deprocess(image: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1]."""
    return (image + 1.0) / 2.0


def transfer_dequantize_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 [0,1] as ``x * f32(1/255)``: a multiply by the
    float32 reciprocal, not a division, so the result is bit-identical to
    the JAX package's device half of the u8 transfer round trip."""
    return x.to(torch.float32) * _INV_255


def transfer_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """``clip(x * 255, 0, 255)`` in float32, then a truncating convert to
    uint8 (the JAX package's transfer_to_uint8 / host to_uint8)."""
    x = x.to(torch.float32) * 255.0
    return x.clamp(0.0, 255.0).to(torch.uint8)
