"""int8 (W8A8) tail of the generator for serving
(tecogan_tpu/engine/quant.py).

* Weights: symmetric per-output-channel int8,
  ``ws[o] = max|w[o]| / 127``, quantized once from the float32 params.
* Activations: symmetric per-tensor int8 with static scales calibrated
  on a clip prefix (``calibrate_clip`` records ``max|x|`` at every conv
  input through the real fused recurrence).
* Each conv is one launch of a hand kernel (``ops/kernels/int8_conv.py``):
  the input quantized while it is staged, s8 x s8 -> s32 on the tensor
  cores, and the dequantization, bias, ReLU and residual add in the
  epilogue.  A CPU tensor takes the kernels' plain versions; on the card
  the kernels serve bf16 and the fp32 route's float32.
* The first layer and ``conv_out`` stay in the compute dtype, and so do
  the residual adds.

The quantized tail (``qtail``) is a dict ``{layer: {"wq", "inv_s",
"deq", "bias"}}`` keyed by the JAX layer names (``resblock_{i}/Conv_0``,
..., ``up1``, ``up2``, ``conv_hr``): ``wq`` ``(Cout, 3, 3, Cin)`` int8 of
the forward kernel (for ``up1`` / ``up2`` the spatially flipped
``ConvTranspose2d`` weight, the kernel the JAX layer convolves with),
``inv_s = 127 / m`` a float32 scalar, ``deq = (m / 127) * ws`` and the
bias, float32 ``(Cout,)``, the bias ``None`` where the layer has none.
Whether a layer is transposed comes from the model, not the qtail.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import Generator
from ..ops.kernels import int8_conv as _int8_kernels
from ..utils.convert import GENERATOR_TRANSPOSED
from ..utils.spans import span
from . import fused
from .state import float_params, resolve_device

QTail = Dict[str, Dict[str, Optional[torch.Tensor]]]


class _Layer(NamedTuple):
    module: nn.Module
    transposed: bool


def _layer_names(num_resblock: int) -> list:
    """The tail's conv layers in execution order, by JAX name
    (``Generator._features``' topology)."""
    names = []
    for i in range(num_resblock):
        names += [f"resblock_{i}/Conv_0", f"resblock_{i}/Conv_1"]
    return names + ["up1", "trunk_rb1/Conv_0", "trunk_rb1/Conv_1", "trunk_rb2/Conv_0",
                    "trunk_rb2/Conv_1", "up2", "conv_hr"]


def forward_kernel(w: torch.Tensor, transposed: bool) -> torch.Tensor:
    """A tail layer's weight as the tail kernels take it, ``(Cout, 3, 3,
    Cin)``: the kernel the JAX layer convolves with (for a transposed layer
    the ``ConvTranspose2d`` weight ``(Cin, Cout, kh, kw)`` flipped), from
    the module's OIHW or IOHW weight."""
    return w.flip(2, 3).permute(1, 2, 3, 0) if transposed else w.permute(0, 2, 3, 1)


def _conv_layers(model: Generator) -> Dict[str, _Layer]:
    """The tail's conv layers by JAX name, in execution order."""
    return {n: _Layer(model.get_submodule(n.replace("/", ".")), n in GENERATOR_TRANSPOSED)
            for n in _layer_names(model.num_resblock)}


def _chain(model: Generator, net: torch.Tensor, conv: Callable) -> torch.Tensor:
    """``tail_features``' control flow, NHWC, with a pluggable
    ``conv(x, name, relu=False, residual=None)`` that applies the ReLU and
    then the residual add after its conv.  The spans are those of
    ``Generator._features``: ``trunk.resblocks`` and ``trunk.upsample``."""
    with span("trunk.resblocks"):
        for i in range(model.num_resblock):
            y = conv(net, f"resblock_{i}/Conv_0", relu=True)
            net = conv(y, f"resblock_{i}/Conv_1", residual=net)
    with span("trunk.upsample"):
        net = conv(net, "up1", relu=True)
        for nm in ("trunk_rb1", "trunk_rb2"):
            net = conv(net, f"{nm}/Conv_0", relu=True)
            net = conv(net, f"{nm}/Conv_1")
        net = conv(net, "up2", relu=True)
        return conv(net, "conv_hr", relu=True)


def calibrate(model: Generator, net: torch.Tensor):
    """Run the float tail on one first-layer activation ``net`` (B, H, W,
    64) and return (features, {layer: max|conv input|} as float32
    scalars).  The features are ``model.tail_features(net)``'s."""
    layers = _conv_layers(model)
    maxes: Dict[str, torch.Tensor] = {}

    def conv(x, name, relu=False, residual=None):
        maxes[name] = x.abs().max().float()
        y = layers[name].module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if relu:
            y = F.relu(y)
        if residual is not None:
            y = y + residual
        return y

    return _chain(model, net.to(model.dtype), conv), maxes


def quantize_tail(params, act_maxes: Mapping[str, torch.Tensor],
                  device=None) -> QTail:
    """The qtail from the float32 params (the flax tree or the port's
    float32 ``state_dict``, never weights already rounded to bf16) and the
    calibrated maxima, computed as the JAX package does, in float32:
    ``inv_s = 127 / m``, ``deq = (m / 127) * ws``, ``wq = round(w / ws)``.

    Every conv layer of the params' tail is quantized, as many resblocks
    as the params hold (the JAX package's ``_conv_layers(params_g)``); a
    layer missing from ``act_maxes`` raises ``KeyError`` naming it.  The
    qtail lies on ``device``, by default the device of the maxima
    (``calibrate_clip`` returns them on the model's device); for maxima
    that are not tensors the default is the card, as
    ``engine.state.resolve_device`` says: the CPU only when named."""
    sd = float_params(params)
    names = _layer_names(len({k.split(".")[0] for k in sd if k.startswith("resblock_")}))
    missing = [n for n in names if n not in act_maxes]
    if missing:
        raise KeyError(f"act_maxes has no maximum for the tail layers {missing}")
    if device is None:
        first = act_maxes[names[0]]
        device = first.device if isinstance(first, torch.Tensor) else resolve_device()
    q: QTail = {}
    for name in names:
        key = name.replace("/", ".")
        w = forward_kernel(sd[f"{key}.weight"].cpu(), name in GENERATOR_TRANSPOSED)
        ws = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
        wq = torch.round(w / ws[:, None, None, None]).to(torch.int8)
        m = torch.clamp_min(torch.as_tensor(act_maxes[name], dtype=torch.float32).cpu(),
                            1e-12)
        bias = sd.get(f"{key}.bias")
        # torch's ``127.0 / m`` multiplies by m's reciprocal (two roundings);
        # a tensor numerator divides, as JAX does
        q[name] = {"wq": wq.contiguous(), "inv_s": torch.tensor(127.0) / m,
                   "deq": m / 127.0 * ws,
                   "bias": None if bias is None else bias.cpu().contiguous()}
    return qtail_to(q, device)


def qtail_to(qtail: QTail, device) -> QTail:
    """The qtail with every tensor on ``device``."""
    return {name: {k: None if v is None else v.to(device) for k, v in layer.items()}
            for name, layer in qtail.items()}


def int8_conv3x3(x, inv_s, wq, deq, bias=None, relu=False, residual=None):
    """One int8 3x3 layer, the custom op ``tecogan_tpu_torch::int8_conv3x3``
    (``ops/kernels/int8_conv.py``).  A CPU tensor takes the plain version;
    a CUDA tensor the CUDA kernel (bf16 or float32), which raises on what
    it does not take."""
    return _int8_kernels.int8_conv3x3(x, inv_s, wq, deq, bias, relu, residual)


def int8_up2x(x, inv_s, wq, deq, bias=None, relu=False, residual=None):
    """One int8 2x transposed layer, the custom op
    ``tecogan_tpu_torch::int8_up2x``; dispatched as :func:`int8_conv3x3`."""
    return _int8_kernels.int8_up2x(x, inv_s, wq, deq, bias, relu, residual)


def tail_features_int8(model: Generator, qtail: QTail, net: torch.Tensor) -> torch.Tensor:
    """The quantized ``tail_features``: (B, H, W, 64) first-layer
    activations -> (B, 4H, 4W, 64) conv_hr features, contiguous NHWC, in
    the model's compute dtype."""
    layers = _conv_layers(model)

    def conv(x, name, relu=False, residual=None):
        q = qtail[name]
        fn = int8_up2x if layers[name].transposed else int8_conv3x3
        return fn(x, q["inv_s"], q["wq"], q["deq"], q["bias"], relu, residual)

    return _chain(model, net.to(model.dtype).contiguous(), conv)


@torch.inference_mode()
def calibrate_clip(model: Generator, lr_clip: torch.Tensor,
                   frames: int = 8) -> Dict[str, torch.Tensor]:
    """Static activation ranges from a clip prefix through the real fused
    recurrence (warp kernel, first layer, float tail, ``conv_out_s2d``):
    {layer: max|conv input|} folded over ``min(frames, T)`` frames, float32
    scalars on the model's device.  ``lr_clip`` (B, T, H, W, 3) float
    [0, 1] on the model's device."""
    maxes: Dict[str, torch.Tensor] = {}
    carry = None
    for t in range(min(int(frames), lr_clip.shape[1])):
        cur = lr_clip[:, t]
        if carry is None:
            net = fused.first_layer_zero_feedback(model, cur)
        else:
            net = fused.fused_first_layer(
                model, cur, fused.warp_s2d_feedback(carry, lr_clip[:, t - 1]))
        feat, m = calibrate(model, net)
        carry = fused.conv_out_s2d(feat, *fused.conv_out_params(model))
        maxes = m if not maxes else {k: torch.maximum(maxes[k], v) for k, v in m.items()}
    return maxes
