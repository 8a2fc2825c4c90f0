"""The fused s2d-carry serving route (tecogan_tpu/engine/fused.py, what
``build_clip_inference`` runs with ``bug_parity=False``,
``use_pallas=True``: the s2d route at ``warp_group=4`` and the NHWC
route at other groups, whose carry here is the same s2d frame).

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
from ..ops.kernels import conv_out_s2d as _conv_out_kernel
from ..ops.kernels import warp_s2d as _warp_kernel
from ..ops.image import deprocess
from ..ops.space import depth_to_space, space_to_depth
from ..ops.warp import grid_sample, pseudo_flow_nchw
from ..utils.spans import span


def conv_out_s2d(feat_hr: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """(B, 4H, 4W, 64) conv_hr features -> sigmoid SR frame in s2d layout
    (B, H, W, 48) bf16, the carry.  ``kernel`` (3, 3, 64, 3) HWIO,
    ``bias`` (3,).

    The custom op ``tecogan_tpu_torch::conv_out_s2d``: a CPU tensor takes
    the plain version; a CUDA tensor the CUDA kernel: in bfloat16 (the
    served route) the tensor-core kernel, in float32 (the fp32 route, a
    precision reference) the f32 kernel; it raises on any other dtype."""
    return _conv_out_kernel.conv_out_s2d(feat_hr, kernel, bias)


def warp_s2d_feedback(carry: torch.Tensor, prev_lr: torch.Tensor) -> torch.Tensor:
    """The bf16 s2d carry (B, H, W, 48) warped by the pseudo-flow of
    ``prev_lr`` (B, H, W, 3) -> the feedback ``deprocess(warp(u8(carry)))``
    as (B, H, W, 48) bf16 in the carry's channel order.

    The custom op ``tecogan_tpu_torch::warp_s2d_feedback``: a CPU tensor
    takes the plain version; a CUDA tensor the CUDA kernel, which raises
    on what it does not take."""
    return _warp_kernel.warp_s2d_feedback(carry, prev_lr.contiguous())


def frame_warp_feedback(carry: torch.Tensor, prev_lr: torch.Tensor) -> torch.Tensor:
    """The feedback of the NHWC fused route where the u8 table does not
    apply (``4W % warp_group != 0``): the bf16 frame of the carry warped
    by ``F.grid_sample`` with no u8 rounding (the JAX route's
    ``grid_sample_patch``), rounded to bf16, then ``s2d(deprocess(.))``
    -> (B, H, W, 48) bf16."""
    frame = s2d_to_frame(carry).float()
    warped = grid_sample(frame, pseudo_flow_nchw(prev_lr.permute(0, 3, 1, 2)))
    return space_to_depth(deprocess(warped.to(torch.bfloat16)))


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
    ``model.tail_features`` (the int8 tail, engine/quant.py).  Spans
    ``first_layer``, ``trunk`` and ``conv_out`` (``utils/spans.py``)."""
    with span("first_layer"):
        net = first_layer_zero_feedback(model, lr0)
    return _tail_s2d(model, net, tail_fn)


def _tail_s2d(model: Generator, net: torch.Tensor,
              tail_fn: Optional[Callable]) -> torch.Tensor:
    """First-layer activations -> the s2d carry, under the spans ``trunk``
    and ``conv_out``."""
    with span("trunk"):
        feat = model.tail_features(net) if tail_fn is None else tail_fn(net)
    with span("conv_out"):
        return conv_out_s2d(feat, *conv_out_params(model))


def carry_feedback(carry_s2d: torch.Tensor, prev_lr: torch.Tensor,
                   warp_group: int = 4) -> torch.Tensor:
    """The warp's feedback (B, H, W, 48) bf16 from the s2d carry.  The JAX
    route warps the frame through its u8 table where ``warp_group``
    divides the HR width 4W, which gives the s2d route's result bit for
    bit: that is the ``warp_s2d`` kernel here; other widths warp the bf16
    frame (:func:`frame_warp_feedback`)."""
    if (4 * carry_s2d.shape[2]) % warp_group == 0:
        return warp_s2d_feedback(carry_s2d, prev_lr)
    return frame_warp_feedback(carry_s2d, prev_lr)


def fused_sr_step_s2d(model: Generator, carry_s2d: torch.Tensor,
                      prev_lr: torch.Tensor, cur_lr: torch.Tensor,
                      tail_fn: Optional[Callable] = None,
                      warp_group: int = 4) -> torch.Tensor:
    """One recurrent step, s2d carry in -> s2d carry out (NHWC);
    ``tail_fn`` as in :func:`fused_first_frame_s2d`, the warp as
    :func:`carry_feedback`.  Spans ``warp``, ``first_layer``, ``trunk``
    and ``conv_out``."""
    with span("warp"):
        feedback = carry_feedback(carry_s2d, prev_lr, warp_group)
    with span("first_layer"):
        net = fused_first_layer(model, cur_lr, feedback)
    return _tail_s2d(model, net, tail_fn)
