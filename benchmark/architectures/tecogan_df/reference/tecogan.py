"""Plain float32 reference of the served generator and its recurrence:
dwight-foster/Pytorch-TecoGAN's modified TecoGAN generator (that repo's
``code/models.py:61-86``: TecoGAN, Chu et al. 2020, arXiv:1811.09393,
with FNet and the bilinear skip removed and a 64 -> 128 trunk block, a
128 -> 128 ``up2`` and a 128 -> 64 ``conv_hr`` added), written from that
code and the route's stated semantics.  It imports nothing of the
program under test and uses no hand kernel: only ``torch`` convolutions,
``F.grid_sample`` and ``F.interpolate``.

One frame, NCHW inside, NHWC at the edges:

* the LR frame, uint8, dequantized as ``u8 * float32(1/255)``;
* frame 0: zero feedback; later frames: the previous SR frame rounded to
  the u8 grid (``round(x * 255) / 255``), warped bilinearly (zero
  padding, ``align_corners=False``) on the pseudo-flow grid (the previous
  LR frame's R and G planes times 4, upscaled 4x bilinearly and read as a
  ``(B, 4H, 4W, 2)`` grid in memory order), mapped ``(x + 1) / 2`` and
  packed space-to-depth (channel ``c*16 + a*4 + b``) into 48 channels;
* ``conv_in`` (51 -> 64) + ReLU, 16 residual blocks ``x + conv(relu(conv
  x))``, a 2x transposed conv (k3, s2, p1, output padding 1) + ReLU, two
  plain conv stacks (64 -> 64 -> 64, 64 -> 128 -> 128), a 2x transposed
  conv + ReLU, ``conv_hr`` (128 -> 64) + ReLU, ``conv_out`` (64 -> 3) and
  a sigmoid: the SR frame in [0, 1];
* the served uint8 frame: ``clamp(x * 255, 0, 255)`` truncated.

``quant`` hooks let a control compute the same network in a lower
precision (``controls.py`` beside this file); the reference itself passes
none.  Call ``benchmark.reference.frames.exact_float32`` before running
it on a card, so that no matrix product runs in TF32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.frames import INV_255, dequant, to_u8

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor, str], torch.Tensor]]


def carry_to_frame(carry: torch.Tensor) -> torch.Tensor:
    """A space-to-depth frame (B, H, W, 48), channel ``c*16 + a*4 + b``,
    -> the frame (B, 4H, 4W, 3) float32."""
    return F.pixel_shuffle(carry.permute(0, 3, 1, 2).to(torch.float32), 4).permute(0, 2, 3, 1)


def pseudo_flow(prev_lr: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) float32 -> the (B, 4H, 4W, 2) sampling grid."""
    B, H, W, _ = prev_lr.shape
    rg = prev_lr.permute(0, 3, 1, 2)[:, 0:2] * 4.0
    up = F.interpolate(rg, scale_factor=4, mode="bilinear", align_corners=False)
    return up.contiguous().reshape(B, 4 * H, 4 * W, 2)


def feedback(prev_frame: torch.Tensor, prev_lr: torch.Tensor) -> torch.Tensor:
    """The 48 feedback channels (B, 48, H, W) from the previous SR frame
    (B, 4H, 4W, 3) and the previous LR frame (B, H, W, 3), float32."""
    q = torch.round(prev_frame.to(torch.float32) * 255.0).clamp(0.0, 255.0) * INV_255
    warped = F.grid_sample(q.permute(0, 3, 1, 2), pseudo_flow(prev_lr),
                           mode="bilinear", padding_mode="zeros", align_corners=False)
    return F.pixel_unshuffle((warped + 1.0) / 2.0, 4)


def _conv(x, p: Params, name: str, quant: Quant, bias: bool = True):
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x, "act:" + name), quant(w, "weight:" + name)
    return F.conv2d(x, w, p[f"{name}.bias"] if bias else None, padding=1)


def _conv_t(x, p: Params, name: str, quant: Quant):
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x, "act:" + name), quant(w, "weight_t:" + name)
    return F.conv_transpose2d(x, w, p[f"{name}.bias"], stride=2, padding=1,
                              output_padding=1)


def features(p: Params, net: torch.Tensor, num_resblock: int, quant: Quant = None,
             tail_conv: Optional[Callable] = None) -> torch.Tensor:
    """The tail after the first activation: (B, 64, H, W) -> the conv_hr
    activation (B, 64, 4H, 4W).  ``tail_conv(x, name, relu, residual)``
    replaces each of its convs (the int8 reference)."""
    if tail_conv is None:
        def tail_conv(x, name, relu=False, residual=None):
            transposed = name in ("up1", "up2")
            key = name.replace("/", ".")
            y = (_conv_t(x, p, key, quant) if transposed
                 else _conv(x, p, key, quant, bias=not key.endswith("Conv_1")))
            if relu:
                y = F.relu(y)
            return y if residual is None else y + residual

    for i in range(num_resblock):
        y = tail_conv(net, f"resblock_{i}/Conv_0", relu=True)
        net = tail_conv(y, f"resblock_{i}/Conv_1", residual=net)
    net = tail_conv(net, "up1", relu=True)
    for nm in ("trunk_rb1", "trunk_rb2"):
        net = tail_conv(net, f"{nm}/Conv_0", relu=True)
        net = tail_conv(net, f"{nm}/Conv_1")
    net = tail_conv(net, "up2", relu=True)
    return tail_conv(net, "conv_hr", relu=True)


def first_layer(p: Params, lr: torch.Tensor, fb: Optional[torch.Tensor],
                quant: Quant = None) -> torch.Tensor:
    """relu(conv_in([lr || feedback])), NCHW; ``fb`` None is frame 0."""
    x = lr.permute(0, 3, 1, 2)
    if fb is None:
        B, _, H, W = x.shape
        fb = torch.zeros((B, 48, H, W), dtype=x.dtype, device=x.device)
    return F.relu(_conv(torch.cat([x, fb], dim=1), p, "conv_in", quant))


def frame(p: Params, lr: torch.Tensor, prev_frame: Optional[torch.Tensor],
          prev_lr: Optional[torch.Tensor], num_resblock: int = 16, quant: Quant = None,
          tail_conv: Optional[Callable] = None) -> torch.Tensor:
    """One recurrent step: LR frame ``lr`` (B, H, W, 3) float32 after the
    previous SR frame (B, 4H, 4W, 3) and LR frame (None for frame 0) ->
    the SR frame (B, 4H, 4W, 3) float32 in [0, 1]."""
    fb = None if prev_frame is None else feedback(prev_frame, prev_lr)
    net = first_layer(p, lr, fb, quant)
    feat = features(p, net, num_resblock, quant, tail_conv)
    out = _conv(feat, p, "conv_out", quant)
    return torch.sigmoid(out).permute(0, 2, 3, 1)


def run_clip(p: Params, lr_u8: torch.Tensor, num_resblock: int = 16, quant: Quant = None,
             tail_conv: Optional[Callable] = None, keep=None):
    """Free-running recurrence over ``lr_u8`` (B, T, H, W, 3) uint8 from
    frame 0.  Yields ``(t, sr_u8)`` for each ``t`` in ``keep`` (all frames
    when None), (B, 4H, 4W, 3) uint8 on the frames' device."""
    prev = prev_lr = None
    last = lr_u8.shape[1] - 1 if keep is None else max(keep)
    for t in range(last + 1):
        lr = dequant(lr_u8[:, t])
        prev = frame(p, lr, prev, prev_lr, num_resblock, quant, tail_conv)
        prev_lr = lr
        if keep is None or t in keep:
            yield t, to_u8(prev)
