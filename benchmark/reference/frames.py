"""The frame conventions that every architecture's plain reference and the
check of ``correct`` share: the LR frame's dequantization, the served
frame's uint8 conversion, and float32 without TF32.  It imports nothing of
the program under test.
"""

from __future__ import annotations

import torch

INV_255 = torch.tensor(1.0 / 255.0, dtype=torch.float32).item()


def exact_float32() -> None:
    """No TF32 in convolutions or matrix products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dequant(lr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 [0, 1]."""
    return lr_u8.to(torch.float32) * INV_255


def to_u8(frame: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8 by ``clamp(x * 255, 0, 255)`` truncated."""
    return (frame.to(torch.float32) * 255.0).clamp(0.0, 255.0).to(torch.uint8)
