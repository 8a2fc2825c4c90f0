"""``tecogan_df``: dwight-foster/Pytorch-TecoGAN's modified TecoGAN
generator (that repo's ``code/models.py:61-86``): TecoGAN (Chu et al.
2020, arXiv:1811.09393) with FNet and the bilinear skip removed, and a
64 -> 128 trunk block, a 128 -> 128 ``up2`` and a 128 -> 64 ``conv_hr``
added; its feedback is warped by the pseudo-flow of the previous LR
frame.  The configuration keys it reads: ``num_resblock``, ``weight_gain``,
``int8_tail`` and ``calibration_frames``, and in :class:`System` the
port's route (``precision``, ``bug_parity``, ``use_pallas``,
``warp_group``).

The interface that ``benchmark.spec.architecture`` documents; the plain
reference is ``reference/`` and the system under test ``program.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import inputs

from . import counts
from .program import System  # noqa: F401
from .reference import controls, int8, tecogan

carry_to_frame = tecogan.carry_to_frame


def param_shapes(num_resblock: int = 16) -> List[Tuple[str, tuple, int]]:
    """(name, shape, input channels) of every generator tensor, by the
    served generator's ``state_dict`` names.  Convs are (out, in, 3, 3);
    the 2x transposed convs (in, out, 3, 3)."""
    out = [("conv_in.weight", (64, 51, 3, 3), 51), ("conv_in.bias", (64,), 51)]
    for i in range(num_resblock):
        out += [(f"resblock_{i}.Conv_0.weight", (64, 64, 3, 3), 64),
                (f"resblock_{i}.Conv_0.bias", (64,), 64),
                (f"resblock_{i}.Conv_1.weight", (64, 64, 3, 3), 64)]
    out += [("up1.weight", (64, 64, 3, 3), 64), ("up1.bias", (64,), 64),
            ("trunk_rb1.Conv_0.weight", (64, 64, 3, 3), 64), ("trunk_rb1.Conv_0.bias", (64,), 64),
            ("trunk_rb1.Conv_1.weight", (64, 64, 3, 3), 64),
            ("trunk_rb2.Conv_0.weight", (128, 64, 3, 3), 64),
            ("trunk_rb2.Conv_0.bias", (128,), 64),
            ("trunk_rb2.Conv_1.weight", (128, 128, 3, 3), 128),
            ("up2.weight", (128, 128, 3, 3), 128), ("up2.bias", (128,), 128),
            ("conv_hr.weight", (64, 128, 3, 3), 128), ("conv_hr.bias", (64,), 128),
            ("conv_out.weight", (3, 64, 3, 3), 64), ("conv_out.bias", (3,), 64)]
    return out


def make_params(seed: int, config: dict, device) -> Dict[str, torch.Tensor]:
    """float32 weights (``inputs.uniform_params``): the conv kernels, not
    the biases, times ``weight_gain``."""
    return inputs.uniform_params(seed, param_shapes(config["num_resblock"]),
                                 config["weight_gain"], device)


def hooks(config: dict, params, calib, control: bool):
    """(quant, tail_conv) of the reference, or of its control."""
    nrb = config["num_resblock"]
    if config["int8_tail"]:
        if control:
            return None, controls.int4_tail(params, calib[None], config["calibration_frames"], nrb)
        maxes = int8.calibrate(params, calib[None], config["calibration_frames"], nrb)
        return None, int8.tail_conv_from(int8.quantize(params, maxes))
    return (controls.fp8_quant if control else None), None


def run_clip(params, config: dict, lr_u8: torch.Tensor, hooks, keep=None):
    """:func:`tecogan.run_clip` under ``hooks``."""
    quant, tail = hooks
    return tecogan.run_clip(params, lr_u8, config["num_resblock"], quant, tail, keep=keep)


def frame(params, config: dict, lr, prev_frame, prev_lr, hooks) -> torch.Tensor:
    """:func:`tecogan.frame` under ``hooks``."""
    quant, tail = hooks
    return tecogan.frame(params, lr, prev_frame, prev_lr, config["num_resblock"], quant, tail)


def frame_peak_s(config: dict, h: int, w: int) -> float:
    return counts.frame_peak_s(h, w, config["num_resblock"], config["int8_tail"])
