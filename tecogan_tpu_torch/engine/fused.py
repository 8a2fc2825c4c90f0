"""The fused s2d-carry serving route (tecogan_tpu/engine/fused.py, the
subset ``build_clip_inference`` runs with ``bug_parity=False``,
``use_pallas=True``, ``warp_group=4``).

The recurrent state is the SR frame in space-to-depth layout
``(B, H, W, 48)`` bf16, channel ``c*16 + a*4 + b``: conv_out writes it
directly (the ``conv_out_s2d`` CUDA kernel) and the next frame's warp
reads it (the ``warp_s2d`` CUDA kernel), which returns the 48 feedback
channels ``conv_in`` reads after the LR frame.  This ports what the JAX
functions compute, not their TPU layouts: there is no packed u8 table,
no planar coordinate matrices and no identity-s2d conv.  As in the JAX
route, the warp reads the carry quantized to the u8 grid.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import Generator
from ..ops.kernels.conv_out_s2d import conv_out_s2d_cuda, conv_out_s2d_reference
from ..ops.kernels.warp_s2d import warp_s2d_feedback_cuda, warp_s2d_feedback_reference
from ..ops.space import depth_to_space


def conv_out_s2d(feat_hr: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """(B, 4H, 4W, 64) conv_hr features -> sigmoid SR frame in s2d layout
    (B, H, W, 48) bf16, the carry.  ``kernel`` (3, 3, 64, 3) HWIO,
    ``bias`` (3,).

    A CPU tensor takes the plain version; any other tensor takes the CUDA
    kernel: in bfloat16 (the served route) the tensor-core kernel, in
    float32 (the fp32 route, a precision reference) the f32 kernel; it
    raises on any other dtype."""
    if feat_hr.device.type == "cpu":
        return conv_out_s2d_reference(feat_hr, kernel, bias).to(torch.bfloat16)
    return conv_out_s2d_cuda(feat_hr, kernel, bias)


def warp_s2d_feedback(carry: torch.Tensor, prev_lr: torch.Tensor) -> torch.Tensor:
    """The bf16 s2d carry (B, H, W, 48) warped by the pseudo-flow of
    ``prev_lr`` (B, H, W, 3) -> the feedback ``deprocess(warp(u8(carry)))``
    as (B, H, W, 48) bf16 in the carry's channel order.

    A CPU tensor takes the plain version; any other tensor takes the CUDA
    kernel, which raises on what it does not take."""
    if carry.device.type == "cpu":
        return warp_s2d_feedback_reference(carry, prev_lr).to(torch.bfloat16)
    return warp_s2d_feedback_cuda(carry, prev_lr.contiguous())


def s2d_to_frame(s2d: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 16C) s2d frame(s) -> (..., 4H, 4W, C), NHWC view."""
    *lead, H, W, C16 = s2d.shape
    y = depth_to_space(s2d.reshape(-1, H, W, C16))
    return y.reshape(*lead, 4 * H, 4 * W, C16 // 16)


def conv_out_params(model: Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_out's weights as the kernel takes them: HWIO and bias, f32."""
    w = model.conv_out.weight.permute(2, 3, 1, 0).float().contiguous()
    return w, model.conv_out.bias.float().contiguous()


def fused_first_layer(model: Generator, cur_lr: torch.Tensor,
                      feedback: torch.Tensor) -> torch.Tensor:
    """relu(conv_in([lr || feedback])): cur_lr (B, H, W, 3), the warp's
    feedback (B, H, W, 48) -> (B, H, W, 64), all NHWC."""
    dt = model.dtype
    inp = torch.cat([cur_lr.to(dt), feedback.to(dt)], dim=-1)
    return F.relu(model.conv_in(inp.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


def first_layer_zero_feedback(model: Generator, lr0: torch.Tensor) -> torch.Tensor:
    """Frame 0's first layer (zero feedback): conv_in reduces to its LR
    slice.  (B, H, W, 3) -> (B, H, W, 64), NHWC."""
    conv_in = model.conv_in
    x = lr0.permute(0, 3, 1, 2).to(model.dtype)
    net = F.relu(F.conv2d(x, conv_in.weight[:, :3], conv_in.bias, padding=1))
    return net.permute(0, 2, 3, 1)


def fused_first_frame_s2d(model: Generator, lr0: torch.Tensor,
                          tail_fn: Optional[Callable] = None) -> torch.Tensor:
    """Frame 0 -> its s2d carry.  ``tail_fn(net)`` replaces
    ``model.tail_features`` (the int8 tail, engine/quant.py)."""
    net = first_layer_zero_feedback(model, lr0)
    feat = model.tail_features(net) if tail_fn is None else tail_fn(net)
    return conv_out_s2d(feat, *conv_out_params(model))


def fused_sr_step_s2d(model: Generator, carry_s2d: torch.Tensor,
                      prev_lr: torch.Tensor, cur_lr: torch.Tensor,
                      tail_fn: Optional[Callable] = None) -> torch.Tensor:
    """One recurrent step, s2d carry in -> s2d carry out (NHWC);
    ``tail_fn`` as in :func:`fused_first_frame_s2d`."""
    net = fused_first_layer(model, cur_lr, warp_s2d_feedback(carry_s2d, prev_lr))
    feat = model.tail_features(net) if tail_fn is None else tail_fn(net)
    return conv_out_s2d(feat, *conv_out_params(model))
