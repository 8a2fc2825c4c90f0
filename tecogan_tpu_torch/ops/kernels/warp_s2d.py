"""The fused warp of the s2d carry: the CUDA kernel and its plain PyTorch
version.

Replaces the TPU Pallas kernel ``warp_combine``
(tecogan_tpu/ops/pallas/warp_combine.py) and the coordinate, gather and
space-to-depth graph the JAX s2d-carry route runs around that combine
(tecogan_tpu/engine/fused.py::warp_s2d_carry).  The kernel source is
``tecogan_tpu_torch/csrc/warp_s2d.cu``; its header says what bounds it
and how it is laid out.  ``_build.load`` compiles it at first use; its
plain C entry point is bound with ``ctypes``.

Contract: ``carry`` ``(B, H, W, 48)`` bf16 (the s2d SR frame that
``conv_out_s2d`` writes, channel ``c*16 + a*4 + b``) and ``prev_lr``
``(B, H, W, 3)`` f32, both contiguous NHWC -> ``(B, H, W, 48)`` bf16 in
the same channel order, holding ``deprocess(warp(u8(carry)))``: the 48
channels ``conv_in`` reads after the LR frame.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..image import deprocess
from ..space import depth_to_space
from ..warp import grid_sample, pseudo_flow_nchw
from ._build import CSRC, load
from ._library import register

SOURCE = CSRC / "warp_s2d.cu"

# Kernel launches; only the CUDA wrapper adds to it, callers reset it to 0.
launch_count = 0

_lib = None


def warp_s2d_feedback_reference(carry: torch.Tensor,
                                prev_lr: torch.Tensor) -> torch.Tensor:
    """Plain version, in float32: quantize the carry to the u8 grid,
    unpack it to the frame, ``F.grid_sample`` (bilinear, zeros,
    ``align_corners=False``) on the pseudo-flow grid, ``deprocess`` and
    ``F.pixel_unshuffle(., 4)``; returned NHWC float32."""
    q = torch.round(carry.float() * 255.0).clamp(0.0, 255.0) * (1.0 / 255.0)
    grid = pseudo_flow_nchw(prev_lr.float().permute(0, 3, 1, 2))
    warped = grid_sample(depth_to_space(q), grid)
    fb = F.pixel_unshuffle(deprocess(warped).permute(0, 3, 1, 2), 4)
    return fb.permute(0, 2, 3, 1).contiguous()


def build() -> str:
    """Compile (unless this source's library is already in ``build/``) and
    load the kernel's library.  Returns the compiler's log ('' when the
    library was already built)."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = load(SOURCE)
    fn = lib.warp_s2d_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return log


def _check(carry: torch.Tensor, prev_lr: torch.Tensor) -> None:
    if carry.device.type != "cuda":
        raise ValueError(f"warp_s2d kernel needs a CUDA tensor, got {carry.device}")
    if carry.dtype != torch.bfloat16:
        raise ValueError(f"carry must be bfloat16, got {carry.dtype}")
    if carry.dim() != 4 or carry.shape[3] != 48:
        raise ValueError(f"carry must be (B, H, W, 48), got {tuple(carry.shape)}")
    B, H, W, _ = carry.shape
    if tuple(prev_lr.shape) != (B, H, W, 3) or prev_lr.dtype != torch.float32:
        raise ValueError(f"prev_lr must be ({B}, {H}, {W}, 3) float32, got "
                         f"{tuple(prev_lr.shape)} {prev_lr.dtype}")
    if B > 65535 or H > 65535:
        raise ValueError(f"carry {tuple(carry.shape)} exceeds the launch grid")
    for name, t in (("carry", carry), ("prev_lr", prev_lr)):
        if t.device != carry.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous NHWC on {carry.device}")
    if carry.data_ptr() % 16 or prev_lr.data_ptr() % 4:
        raise ValueError("carry must be 16-byte and prev_lr 4-byte aligned")


def warp_s2d_feedback_cuda(carry: torch.Tensor,
                           prev_lr: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).
    Raises on any input it does not take."""
    global launch_count
    _check(carry, prev_lr)
    B, H, W, _ = carry.shape
    out = torch.empty_like(carry)
    if out.numel() == 0:
        return out
    build()
    with torch.cuda.device(carry.device):
        err = _lib.warp_s2d_launch(carry.data_ptr(), prev_lr.data_ptr(),
                                   out.data_ptr(), B, H, W,
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp_s2d launch failed with CUDA error {err}")
    launch_count += 1
    return out


def _warp_s2d_feedback_cpu(carry: torch.Tensor, prev_lr: torch.Tensor) -> torch.Tensor:
    return warp_s2d_feedback_reference(carry, prev_lr).to(torch.bfloat16)


def _warp_s2d_feedback_fake(carry, prev_lr):
    return carry.new_empty(carry.shape)


warp_s2d_feedback = register("warp_s2d_feedback", "(Tensor carry, Tensor prev_lr) -> Tensor",
                             warp_s2d_feedback_cuda, _warp_s2d_feedback_cpu,
                             _warp_s2d_feedback_fake)
