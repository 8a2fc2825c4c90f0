"""Recurrent 4x VSR clip inference (tecogan_tpu/engine/inference.py).

Frame 0 runs with zero feedback; each later frame warps the previous SR
output by the pseudo-flow, packs it space-to-depth, concatenates the next
LR frame and runs the generator.  The JAX ``lax.scan`` becomes a Python
loop over T; the carry stays on the model's device for the whole clip.
"""

from __future__ import annotations

import torch

from tecogan_tpu.config import TecoConfig

from ..models import Generator
from ..ops.image import deprocess, transfer_dequantize_f32
from ..ops.space import space_to_depth
from ..ops.warp import grid_sample, pseudo_flow_nchw
from .fused import fused_first_frame_s2d, fused_sr_step_s2d, s2d_to_frame


def sr_step(model: Generator, prev_sr: torch.Tensor, prev_lr: torch.Tensor,
            cur_lr: torch.Tensor, parity_half: bool = True) -> torch.Tensor:
    """One recurrent step, all NHWC: prev_sr (B, 4H, 4W, 3), LR frames
    (B, H, W, 3) -> SR frame (B, 4H, 4W, 3)."""
    grid = pseudo_flow_nchw(prev_lr.permute(0, 3, 1, 2), parity_half)
    warped = grid_sample(prev_sr.float(), grid)
    feedback = space_to_depth(deprocess(warped))  # (B, H, W, 48)
    return model(torch.cat([cur_lr.float(), feedback], dim=-1))


def first_frame(model: Generator, lr0: torch.Tensor) -> torch.Tensor:
    """Frame 0: 48 zero feedback channels."""
    B, H, W, _ = lr0.shape
    zeros = torch.zeros((B, H, W, 48), dtype=torch.float32, device=lr0.device)
    return model(torch.cat([lr0.float(), zeros], dim=-1))


def _dequant_in(lr: torch.Tensor) -> torch.Tensor:
    """uint8 input -> float32 [0,1] on the device; float input passes."""
    if lr.dtype == torch.uint8:
        return transfer_dequantize_f32(lr)
    return lr


def build_clip_inference(cfg: TecoConfig):
    """Returns ``infer(model, lr_clip) -> sr_clip``.

    ``model`` is a ``models.Generator`` (``engine.state.model_defs(cfg)``
    with loaded weights) on the clip's device; its dtype is the compute
    dtype.  lr_clip: (B, T, H, W, 3) float [0,1] or uint8;
    sr_clip: (B, T, 4H, 4W, 3) float32.

    The route follows ``cfg`` as in the JAX package: ``use_pallas`` without
    ``bug_parity`` is the fused s2d-carry route (``warp_group`` 4); every
    other setting is the exact route, with the fp16 grid rounding under
    ``bug_parity``.  ``cfg.gather_unroll_streams`` only picks a TPU gather
    lowering, so it has nothing to select here.
    """
    use_fused = cfg.use_pallas and not cfg.bug_parity
    if use_fused and cfg.warp_group != 4:
        raise ValueError(
            f"the fused route needs warp_group=4 (got {cfg.warp_group}); "
            "the NHWC fused route is not ported")

    @torch.inference_mode()
    def infer(model: Generator, lr_clip: torch.Tensor) -> torch.Tensor:
        lr_clip = _dequant_in(lr_clip)
        T = lr_clip.shape[1]
        if use_fused:
            carry = fused_first_frame_s2d(model, lr_clip[:, 0])
            carries = [carry]
            for t in range(1, T):
                carry = fused_sr_step_s2d(model, carry, lr_clip[:, t - 1],
                                          lr_clip[:, t])
                carries.append(carry)
            frames = s2d_to_frame(torch.stack(carries, dim=1))
            return frames.to(torch.float32, memory_format=torch.contiguous_format)

        sr = first_frame(model, lr_clip[:, 0])
        frames = [sr]
        for t in range(1, T):
            sr = sr_step(model, sr, lr_clip[:, t - 1], lr_clip[:, t],
                         parity_half=cfg.bug_parity)
            frames.append(sr)
        return torch.stack(frames, dim=1).float()

    return infer
