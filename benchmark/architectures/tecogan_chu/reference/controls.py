"""The control: the plain reference put in the program's place and
computed one precision below the configuration's bf16: every conv's input
and weights, FNet's and the generator's, rounded to float8 e4m3 (the input
scaled per tensor, the weights per output channel, each so that its
largest magnitude maps to 448, e4m3's largest), the products summed in
float32.  The check of ``correct`` has to fail it.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_quant(x: torch.Tensor, what: str) -> torch.Tensor:
    """The ``quant`` hook of :mod:`model`: float8 e4m3 rounding."""
    if what.startswith("act:"):
        return _fp8(x, None)
    out_dim = 1 if what.startswith("weight_t:") else 0
    return _fp8(x, tuple(d for d in range(4) if d != out_dim))
