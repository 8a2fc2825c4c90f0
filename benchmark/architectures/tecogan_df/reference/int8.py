"""Plain reference of the W8A8 serving mode: the generator's tail convs
(the 16 residual blocks, the two 2x transposed convs, the two trunk
stacks and ``conv_hr``) with symmetric int8 weights per output channel
and symmetric int8 activations per tensor, the activation scales
calibrated on the first frames of a calibration clip through the float
recurrence.  The first layer, ``conv_out`` and every residual add stay in
float.  Computed here in float32 from the float32 params alone; it imports
nothing of the program under test and takes none of its scales.

One quantized layer ``name`` with calibrated maximum ``m`` (the largest
``|x|`` its input took over the calibration frames):

* ``ws[o] = max|w[o]| / L`` and ``wq = round(w / ws)`` (``L = 127``);
* ``xq = clamp(round(x * (L / m)), -L, L)``;
* ``y = conv(xq, wq) * (m / L * ws) + bias``, then ReLU and the residual
  add where the layer has them.

``levels`` = 7 gives the int4 control of ``controls.py`` beside this file.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import tecogan

TRANSPOSED = ("up1", "up2")


def layer_names(num_resblock: int) -> list:
    names = []
    for i in range(num_resblock):
        names += [f"resblock_{i}/Conv_0", f"resblock_{i}/Conv_1"]
    return names + ["up1", "trunk_rb1/Conv_0", "trunk_rb1/Conv_1", "trunk_rb2/Conv_0",
                    "trunk_rb2/Conv_1", "up2", "conv_hr"]


def calibrate(p, calib_u8: torch.Tensor, frames: int = 8,
              num_resblock: int = 16) -> Dict[str, torch.Tensor]:
    """{layer: max|input|} over the first ``frames`` frames of
    ``calib_u8`` (B, T, H, W, 3) uint8, through the float32 recurrence."""
    maxes: Dict[str, torch.Tensor] = {}

    def tail_conv(x, name, relu=False, residual=None):
        m = x.abs().max()
        maxes[name] = m if name not in maxes else torch.maximum(maxes[name], m)
        key = name.replace("/", ".")
        if name in TRANSPOSED:
            y = F.conv_transpose2d(x, p[f"{key}.weight"], p[f"{key}.bias"], stride=2,
                                   padding=1, output_padding=1)
        else:
            y = F.conv2d(x, p[f"{key}.weight"], p.get(f"{key}.bias"), padding=1)
        if relu:
            y = F.relu(y)
        return y if residual is None else y + residual

    prev = prev_lr = None
    for t in range(min(frames, calib_u8.shape[1])):
        lr = tecogan.dequant(calib_u8[:, t])
        prev = tecogan.frame(p, lr, prev, prev_lr, num_resblock, tail_conv=tail_conv)
        prev_lr = lr
    return maxes


def quantize(p, maxes: Dict[str, torch.Tensor], levels: int = 127) -> Dict[str, dict]:
    """Per layer: the integer weights (in the conv's own layout, as
    float32), the input's scale ``levels / m`` and the output's ``m /
    levels * ws``."""
    q = {}
    for name, m in maxes.items():
        key = name.replace("/", ".")
        w = p[f"{key}.weight"].to(torch.float32)
        out_dim = 1 if name in TRANSPOSED else 0
        other = tuple(d for d in range(4) if d != out_dim)
        ws = torch.clamp_min(w.abs().amax(dim=other), 1e-12) / levels
        shape = [1, 1, 1, 1]
        shape[out_dim] = -1
        m = torch.clamp_min(m.to(torch.float32), 1e-12)
        q[name] = {"wq": torch.round(w / ws.view(shape)), "inv_s": levels / m,
                   "deq": m / levels * ws, "bias": p.get(f"{key}.bias"),
                   "levels": levels}
    return q


def tail_conv_from(q: Dict[str, dict]):
    """The ``tail_conv`` hook of :func:`tecogan.features` that runs the
    quantized layers of ``q``."""
    def tail_conv(x, name, relu=False, residual=None):
        layer = q[name]
        L = float(layer["levels"])
        xq = torch.clamp(torch.round(x * layer["inv_s"]), -L, L)
        if name in TRANSPOSED:
            y = F.conv_transpose2d(xq, layer["wq"], None, stride=2, padding=1,
                                   output_padding=1)
        else:
            y = F.conv2d(xq, layer["wq"], None, padding=1)
        y = y * layer["deq"].view(1, -1, 1, 1)
        if layer["bias"] is not None:
            y = y + layer["bias"].view(1, -1, 1, 1)
        if relu:
            y = F.relu(y)
        return y if residual is None else y + residual

    return tail_conv
