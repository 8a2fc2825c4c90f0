"""``tecogan_chu``: TecoGAN as published (Chu et al. 2020,
arXiv:1811.09393; github.com/thunil/TecoGAN ``lib/frvsr.py``: ``fnet`` and
``generator_F``): a 3-level FNet estimates the LR flow between the previous
and the current frame, the flow upscaled 4x densely warps the previous
1080p output into the generator's 48 feedback channels, and the generator
(16 resblocks of 64, two 64 -> 64 transposed 2x convs, ``conv_out`` 64 ->
3) adds the LR frame's bicubic 4x; no sigmoid, the feedback not clamped.
The configuration keys it reads: ``num_resblock``, ``weight_gain``,
``fnet_weight_gain``, ``precision`` and ``calibration_frames`` (0: no int8
tail).

The interface that ``benchmark.spec.architecture`` documents; the plain
reference is ``reference/`` and the system under test ``program.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import inputs

from . import counts
from .program import System  # noqa: F401
from .reference import controls, model

carry_to_frame = model.carry_to_frame


def fnet_param_shapes() -> List[Tuple[str, tuple, int]]:
    """(name, shape, input channels) of every FNet tensor, by the served
    model's ``state_dict`` names; convs are (out, in, 3, 3)."""
    out, cin = [], 6
    blocks = [(f"encoder_{i + 1}", f) for i, f in enumerate(counts.FNET_DOWN)]
    blocks += [(f"decoder_{i + 1}", f) for i, f in enumerate(counts.FNET_UP)]
    for name, f in blocks:
        for conv, c_in in (("conv_1", cin), ("conv_2", f)):
            out += [(f"fnet.{name}.{conv}.weight", (f, c_in, 3, 3), c_in),
                    (f"fnet.{name}.{conv}.bias", (f,), c_in)]
        cin = f
    for conv, c_in, f in (("conv1", cin, 32), ("conv2", 32, 2)):
        out += [(f"fnet.output_stage.{conv}.weight", (f, c_in, 3, 3), c_in),
                (f"fnet.output_stage.{conv}.bias", (f,), c_in)]
    return out


def generator_param_shapes(num_resblock: int = 16) -> List[Tuple[str, tuple, int]]:
    """(name, shape, input channels) of every generator tensor, by the
    served model's ``state_dict`` names.  Convs are (out, in, 3, 3); the 2x
    transposed convs (in, out, 3, 3)."""
    out = [("generator.conv_in.weight", (64, 51, 3, 3), 51), ("generator.conv_in.bias", (64,), 51)]
    for i in range(num_resblock):
        for conv in ("Conv_0", "Conv_1"):
            out += [(f"generator.resblock_{i}.{conv}.weight", (64, 64, 3, 3), 64),
                    (f"generator.resblock_{i}.{conv}.bias", (64,), 64)]
    for up in ("up1", "up2"):
        out += [(f"generator.{up}.weight", (64, 64, 3, 3), 64), (f"generator.{up}.bias", (64,), 64)]
    return out + [("generator.conv_out.weight", (3, 64, 3, 3), 64),
                  ("generator.conv_out.bias", (3,), 64)]


def param_shapes(num_resblock: int = 16) -> List[Tuple[str, tuple, int]]:
    return fnet_param_shapes() + generator_param_shapes(num_resblock)


def make_params(seed: int, config: dict, device) -> Dict[str, torch.Tensor]:
    """float32 weights: the conv kernels in one draw of
    ``inputs.uniform_params`` at gain 1, then FNet's times
    ``fnet_weight_gain`` and the generator's times ``weight_gain``; every
    bias zero, as the published code's layers start (TF slim's
    ``conv2d`` and ``conv2d_transpose`` initialize their biases to zero)."""
    shapes = param_shapes(config["num_resblock"])
    kernels = inputs.uniform_params(seed, [s for s in shapes if s[0].endswith("weight")], 1.0,
                                    device)
    params = {}
    for name, shape, _ in shapes:
        if name in kernels:
            gain = config["fnet_weight_gain" if name.startswith("fnet.") else "weight_gain"]
            params[name] = kernels[name] * gain
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


def hooks(config: dict, params, calib, control: bool):
    """The reference's ``quant`` hook: none, or the control's fp8."""
    return controls.fp8_quant if control else None


def run_clip(params, config: dict, lr_u8: torch.Tensor, hooks, keep=None):
    """:func:`model.run_clip` under ``hooks``."""
    return model.run_clip(params, lr_u8, config["num_resblock"], hooks, keep=keep)


def frame(params, config: dict, lr, prev_frame, prev_lr, hooks) -> torch.Tensor:
    """:func:`model.frame` under ``hooks``."""
    return model.frame(params, lr, prev_frame, prev_lr, config["num_resblock"], hooks)


def frame_peak_s(config: dict, h: int, w: int) -> float:
    return counts.frame_peak_s(h, w, config["num_resblock"])
