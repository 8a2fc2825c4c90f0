"""The bf16 tail of the serving generator on the fused conv kernels.

``tail_features_bf16`` is ``Generator.tail_features`` with each of the 39
conv layers (``2 * num_resblock`` resblock convs, ``up1``, ``trunk_rb1``,
``trunk_rb2``, ``up2``, ``conv_hr``) one call of a fused op
(``ops/kernels/bf16_conv.py``): the conv, its bias, ReLU and skip add in one
kernel on the card, the module's own chain of torch ops on the CPU.  It
runs ``engine.quant._chain``, the control flow and spans the int8 tail
runs.  The fused serving route takes it for a bf16 model
(``engine/inference.py::_route``).

The kernels take each layer's weight as ``(Cout, 3, 3, Cin)`` and its bias,
both bf16, as a bf16 model holds them.  The serving generator holds its
weights channels_last, so for a 3x3 layer that weight is a view of the
module's; for ``up1`` and ``up2`` it is the flipped ``ConvTranspose2d``
weight, copied each call.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models import Generator
from ..ops.kernels import bf16_conv as _kernels
from .quant import _chain, _conv_layers, forward_kernel


def tail_features_bf16(model: Generator, net: torch.Tensor) -> torch.Tensor:
    """``model.tail_features`` on the fused ops: (B, H, W, 64) first-layer
    activations -> (B, 4H, 4W, 64) conv_hr features, contiguous NHWC bf16."""
    layers = _conv_layers(model)

    def conv(x, name, relu=False, residual=None):
        layer = layers[name]
        return fused_conv(layer.module, layer.transposed, x, relu, residual)

    return _chain(model, net.to(torch.bfloat16).contiguous(), conv)


def fused_conv(m: nn.Module, transposed: bool, x: torch.Tensor, relu: bool = False,
               residual=None) -> torch.Tensor:
    """The 3x3 layer ``m`` (a ``ConvTranspose2x`` 2x layer when
    ``transposed``) on NHWC bf16 ``x`` as one fused op: ``bf16_up2x`` or
    ``bf16_conv3x3``, with its bias, then ReLU if ``relu``, then ``+
    residual``."""
    w = forward_kernel(m.weight, transposed).contiguous()
    fn = _kernels.bf16_up2x if transposed else _kernels.bf16_conv3x3
    return fn(x, w, m.bias, relu, residual)
