"""The controls: the plain reference put in the program's place and
computed one precision below what the configuration states, which the
check of ``correct`` has to fail.

* A bf16 configuration: every conv's input and weights rounded to
  float8 e4m3 (the input scaled per tensor, the weights per output
  channel, each so that its largest magnitude maps to 448, e4m3's
  largest), the products summed in float32.
* An int8 configuration: the int8 reference with 7 levels a side (int4)
  in place of 127, weights and activations alike.
"""

from __future__ import annotations

import torch

from . import int8

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_quant(x: torch.Tensor, what: str) -> torch.Tensor:
    """The ``quant`` hook of :mod:`tecogan`: float8 e4m3 rounding."""
    if what.startswith("act:"):
        return _fp8(x, None)
    out_dim = 1 if what.startswith("weight_t:") else 0
    return _fp8(x, tuple(d for d in range(4) if d != out_dim))


def int4_tail(p, calib_u8, frames: int, num_resblock: int):
    """The ``tail_conv`` hook of the int4 control."""
    maxes = int8.calibrate(p, calib_u8, frames, num_resblock)
    return int8.tail_conv_from(int8.quantize(p, maxes, levels=7))
