"""The fused s2d-carry serving route (tecogan_tpu/engine/fused.py, the
subset ``build_clip_inference`` runs with ``bug_parity=False``,
``use_pallas=True``, ``warp_group=4``).

The recurrent state is the SR frame in space-to-depth layout
``(B, H, W, 48)`` bf16, channel ``c*16 + a*4 + b``: conv_out writes it
directly (the ``conv_out_s2d`` CUDA kernel) and the next frame's warp
reads it.  This ports what the JAX functions compute, not their TPU
layouts: the warp is ``F.grid_sample`` of the unpacked carry in float32
on the pseudo-flow grid (no packed-int8 table, no planar coordinate
matrices), and the first layer is one conv over
``[lr || pixel_unshuffle(deprocess(warped))]`` (no identity-s2d conv).
The JAX warp reads a uint8-quantized carry; this one does not, which
moves each tap by at most 1/510.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..models import Generator
from ..ops.image import deprocess
from ..ops.kernels.conv_out_s2d import conv_out_s2d_cuda, conv_out_s2d_reference
from ..ops.space import depth_to_space
from ..ops.warp import grid_sample, pseudo_flow_nchw


def conv_out_s2d(feat_hr: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """(B, 4H, 4W, 64) conv_hr features -> sigmoid SR frame in s2d layout
    (B, H, W, 48) bf16, the carry.  ``kernel`` (3, 3, 64, 3) HWIO,
    ``bias`` (3,).

    A CPU tensor takes the plain version; any other tensor takes the CUDA
    kernel, which raises on what it does not take."""
    if feat_hr.device.type == "cpu":
        return conv_out_s2d_reference(feat_hr, kernel, bias).to(torch.bfloat16)
    return conv_out_s2d_cuda(feat_hr, kernel, bias)


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
                      warped_hr: torch.Tensor) -> torch.Tensor:
    """relu(conv_in([lr || s2d(deprocess(warped))])): cur_lr (B, H, W, 3),
    warped_hr (B, 4H, 4W, 3) -> (B, H, W, 64), all NHWC."""
    dt = model.dtype
    fb = F.pixel_unshuffle(deprocess(warped_hr.permute(0, 3, 1, 2)), 4)
    inp = torch.cat([cur_lr.permute(0, 3, 1, 2).to(dt), fb.to(dt)], dim=1)
    return F.relu(model.conv_in(inp)).permute(0, 2, 3, 1)


def fused_first_frame_s2d(model: Generator, lr0: torch.Tensor) -> torch.Tensor:
    """Frame 0 (zero feedback): conv_in reduces to its LR slice."""
    conv_in = model.conv_in
    x = lr0.permute(0, 3, 1, 2).to(model.dtype)
    net = F.relu(F.conv2d(x, conv_in.weight[:, :3], conv_in.bias, padding=1))
    feat = model.tail_features(net.permute(0, 2, 3, 1))
    return conv_out_s2d(feat, *conv_out_params(model))


def fused_sr_step_s2d(model: Generator, carry_s2d: torch.Tensor,
                      prev_lr: torch.Tensor, cur_lr: torch.Tensor) -> torch.Tensor:
    """One recurrent step, s2d carry in -> s2d carry out (NHWC)."""
    grid = pseudo_flow_nchw(prev_lr.permute(0, 3, 1, 2))
    warped = grid_sample(s2d_to_frame(carry_s2d).float(), grid)
    net = fused_first_layer(model, cur_lr, warped)
    feat = model.tail_features(net)
    return conv_out_s2d(feat, *conv_out_params(model))
