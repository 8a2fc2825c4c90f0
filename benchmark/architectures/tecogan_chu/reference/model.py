"""Plain float32 reference of TecoGAN as published (Chu et al. 2020,
arXiv:1811.09393; github.com/thunil/TecoGAN: ``lib/frvsr.py``'s ``fnet``
and ``generator_F``, ``lib/ops.py``'s ``upscale_four`` and
``bicubic_four``, ``main.py``'s inference), written from those equations
as the configuration states them.  It imports nothing of the program under
test and uses no hand kernel: only ``torch`` convolutions, pooling and
indexing.

One frame, NCHW inside, NHWC at the edges; x[t] is the LR frame, uint8,
dequantized as ``u8 * float32(1/255)``:

* frame 0: zero feedback, no flow;
* frame t >= 1, the flow: FNet on ``cat(x[t-1], x[t])``: three encoder
  blocks (conv, leaky ReLU 0.2, conv, leaky ReLU, 2x2 max-pool of stride
  2 dropping an odd last row or column) at 32, 64, 128 channels, three
  decoder blocks (conv, lrelu, conv, lrelu, bilinear 2x sampling output
  row r at source row r / 2, the last row repeated) at 256, 128, 64, conv
  64 -> 32, lrelu, conv 32 -> 2, ``tanh * 24``; every conv 3x3, zero
  padded, with a bias.  The flow is padded at the bottom and right to the
  frame, mirrored with the edge (TF's SYMMETRIC);
* the feedback: ``f`` = the flow times 4, bilinear 4x (source r / 4, the
  last row and column repeated), in HR pixels; the previous SR frame y
  sampled bilinearly at ``p - f(p)`` (channel 0 rows, channel 1 columns),
  the position clamped into the frame; packed space-to-depth (channel
  ``c*16 + a*4 + b``) into 48 channels;
* the generator: ``conv_in`` (51 -> 64) + ReLU, resblocks ``x +
  conv(relu(conv(x)))`` (both convs with a bias), two transposed convs
  (k3, s2, p1, output padding 1) 64 -> 64 each + ReLU, ``conv_out`` (64 ->
  3), plus the LR frame's bicubic 4x (Keys' cubic convolution, a = -0.75,
  source row r / 4, rows past the edges repeating the edge);
* y[t] is fed back as it is, not clamped; the served uint8 frame is
  ``clamp(y * 255, 0, 255)`` truncated.

``quant(x, what)`` hooks round every conv's input and weights for a
control (``controls.py`` beside this file); the reference passes none.
Call ``benchmark.reference.frames.exact_float32`` before running it on a
card, so that no matrix product runs in TF32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.frames import dequant, to_u8

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor, str], torch.Tensor]]
KEYS_A = -0.75


def carry_to_frame(carry: torch.Tensor) -> torch.Tensor:
    """A space-to-depth frame (B, H, W, 48), channel ``c*16 + a*4 + b``,
    -> the frame (B, 4H, 4W, 3) float32."""
    return F.pixel_shuffle(carry.permute(0, 3, 1, 2).to(torch.float32), 4).permute(0, 2, 3, 1)


def _conv(x, p: Params, name: str, quant: Quant):
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x, "act:" + name), quant(w, "weight:" + name)
    return F.conv2d(x, w, p[f"{name}.bias"], padding=1)


def _conv_t(x, p: Params, name: str, quant: Quant):
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x, "act:" + name), quant(w, "weight_t:" + name)
    return F.conv_transpose2d(x, w, p[f"{name}.bias"], stride=2, padding=1, output_padding=1)


def _sources(n_in: int, factor: int, device):
    """Per output index along one axis: source ``o / factor``'s two
    neighbours (the second clamped to the edge) and its fraction."""
    src = torch.arange(n_in * factor, device=device, dtype=torch.float32) / factor
    i0 = torch.floor(src).long()
    return i0, torch.clamp(i0 + 1, max=n_in - 1), src - i0


def resize_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW ``x`` upsampled ``factor``x, bilinear, output r at source r /
    factor, the last row and column repeated."""
    for dim in (2, 3):
        i0, i1, frac = _sources(x.shape[dim], factor, x.device)
        shape = [1, 1, 1, 1]
        shape[dim] = -1
        frac = frac.view(shape)
        x = x.index_select(dim, i0) * (1.0 - frac) + x.index_select(dim, i1) * frac
    return x


def _keys(d: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.75 at distance ``d``."""
    a = KEYS_A
    d = d.abs()
    near = ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0
    far = ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a
    return torch.where(d <= 1.0, near, torch.where(d < 2.0, far, torch.zeros_like(d)))


def resize_bicubic4(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` upsampled 4x by Keys' cubic convolution, output r at
    source r / 4 from source rows floor - 1 .. floor + 2, clamped to the
    frame."""
    for dim in (2, 3):
        n = x.shape[dim]
        src = torch.arange(4 * n, device=x.device, dtype=torch.float32) / 4.0
        base = torch.floor(src)
        shape = [1, 1, 1, 1]
        shape[dim] = -1
        out = 0.0
        for k in (-1, 0, 1, 2):
            idx = torch.clamp(base.long() + k, 0, n - 1)
            w = _keys(src - (base + k)).view(shape)
            out = out + x.index_select(dim, idx) * w
        x = out
    return x


def fnet(p: Params, prev_lr: torch.Tensor, lr: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """The LR frames (B, H, W, 3) -> the flow (B, 2, H, W) in LR pixels."""
    H, W = lr.shape[1:3]
    net = torch.cat([prev_lr, lr], dim=-1).permute(0, 3, 1, 2)
    for name in ("encoder_1", "encoder_2", "encoder_3", "decoder_1", "decoder_2",
                 "decoder_3"):
        net = F.leaky_relu(_conv(net, p, f"fnet.{name}.conv_1", quant), 0.2)
        net = F.leaky_relu(_conv(net, p, f"fnet.{name}.conv_2", quant), 0.2)
        if name.startswith("encoder"):
            net = F.max_pool2d(net, 2, 2)
        else:
            net = resize_linear(net, 2)
    net = F.leaky_relu(_conv(net, p, "fnet.output_stage.conv1", quant), 0.2)
    flow = torch.tanh(_conv(net, p, "fnet.output_stage.conv2", quant)) * 24.0
    rows, cols = torch.arange(H, device=lr.device), torch.arange(W, device=lr.device)
    h, w = flow.shape[2:]
    # SYMMETRIC: index n >= h reads 2h - 1 - n
    rows = torch.where(rows < h, rows, 2 * h - 1 - rows)
    cols = torch.where(cols < w, cols, 2 * w - 1 - cols)
    return flow.index_select(2, rows).index_select(3, cols)


def warp(prev_frame: torch.Tensor, flow_hr: torch.Tensor) -> torch.Tensor:
    """The previous SR frame (B, 3, H, W) sampled at ``p - flow_hr(p)``
    (B, 2, H, W), the position clamped into the frame."""
    B, C, H, W = prev_frame.shape
    ys = torch.arange(H, device=prev_frame.device, dtype=torch.float32).view(1, H, 1)
    xs = torch.arange(W, device=prev_frame.device, dtype=torch.float32).view(1, 1, W)
    qy = torch.clamp(ys - flow_hr[:, 0], 0.0, H - 1.0)
    qx = torch.clamp(xs - flow_hr[:, 1], 0.0, W - 1.0)
    y0 = torch.clamp(torch.floor(qy), max=H - 2.0)
    x0 = torch.clamp(torch.floor(qx), max=W - 2.0)
    wy, wx = (qy - y0).unsqueeze(1), (qx - x0).unsqueeze(1)
    flat = prev_frame.reshape(B, C, H * W)

    def at(y, x):
        idx = (y.long() * W + x.long()).view(B, 1, H * W).expand(B, C, H * W)
        return flat.gather(2, idx).view(B, C, H, W)

    top = at(y0, x0) * (1.0 - wx) + at(y0, x0 + 1) * wx
    bottom = at(y0 + 1, x0) * (1.0 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bottom * wy


def feedback(p: Params, prev_frame: torch.Tensor, prev_lr: torch.Tensor, lr: torch.Tensor,
             quant: Quant = None) -> torch.Tensor:
    """The 48 feedback channels (B, 48, H, W): the previous SR frame (B, 4H,
    4W, 3) warped by FNet's flow of (prev_lr, lr), space-to-depth."""
    flow_hr = resize_linear(fnet(p, prev_lr, lr, quant) * 4.0, 4)
    warped = warp(prev_frame.to(torch.float32).permute(0, 3, 1, 2), flow_hr)
    return F.pixel_unshuffle(warped, 4)


def frame(p: Params, lr: torch.Tensor, prev_frame: Optional[torch.Tensor],
          prev_lr: Optional[torch.Tensor], num_resblock: int = 16,
          quant: Quant = None) -> torch.Tensor:
    """One recurrent step: LR frame ``lr`` (B, H, W, 3) float32 after the
    previous SR frame (B, 4H, 4W, 3) and LR frame (None for frame 0) ->
    the SR frame (B, 4H, 4W, 3) float32, not clamped."""
    x = lr.permute(0, 3, 1, 2)
    if prev_frame is None:
        fb = torch.zeros((x.shape[0], 48) + x.shape[2:], dtype=x.dtype, device=x.device)
    else:
        fb = feedback(p, prev_frame, prev_lr, lr, quant)
    net = F.relu(_conv(torch.cat([x, fb], dim=1), p, "generator.conv_in", quant))
    for i in range(num_resblock):
        y = F.relu(_conv(net, p, f"generator.resblock_{i}.Conv_0", quant))
        net = net + _conv(y, p, f"generator.resblock_{i}.Conv_1", quant)
    net = F.relu(_conv_t(net, p, "generator.up1", quant))
    net = F.relu(_conv_t(net, p, "generator.up2", quant))
    out = _conv(net, p, "generator.conv_out", quant) + resize_bicubic4(x)
    return out.permute(0, 2, 3, 1)


def run_clip(p: Params, lr_u8: torch.Tensor, num_resblock: int = 16, quant: Quant = None,
             keep=None):
    """Free-running recurrence over ``lr_u8`` (B, T, H, W, 3) uint8 from
    frame 0.  Yields ``(t, sr_u8)`` for each ``t`` in ``keep`` (all frames
    when None), (B, 4H, 4W, 3) uint8 on the frames' device."""
    prev = prev_lr = None
    last = lr_u8.shape[1] - 1 if keep is None else max(keep)
    for t in range(last + 1):
        lr = dequant(lr_u8[:, t])
        prev = frame(p, lr, prev, prev_lr, num_resblock, quant)
        prev_lr = lr
        if keep is None or t in keep:
            yield t, to_u8(prev)
