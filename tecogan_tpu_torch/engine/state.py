"""Model construction and random generator weights
(tecogan_tpu/engine/state.py::model_defs).

Weights are made in the JAX package's numpy layout (flax names, HWIO
kernels), so one tree feeds both packages: the JAX generator directly and
the port through ``utils.convert.generator_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..config import TecoConfig
from ..models import Generator


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.  Raises
    when the caller asked for no device and no GPU is visible: nothing
    falls back to the CPU unless the caller names it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is visible; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def model_defs(cfg: TecoConfig, device=None) -> Generator:
    """The generator for ``cfg`` (compute dtype from ``cfg.precision``) on
    ``device`` (default: the card, see :func:`resolve_device`).  The JAX
    function also returns the discriminator, which belongs to training
    and is not ported yet."""
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    dev = resolve_device(device)
    return Generator(num_resblock=cfg.num_resblock, out_channels=3,
                     dtype=dtype).to(dev)


def _conv_params(gen: torch.Generator, in_ch: int, out_ch: int,
                 bias: bool = True) -> Dict[str, np.ndarray]:
    """torch's Conv2d default init, U(+-sqrt(1/fan_in)) for kernel and
    bias, drawn as an HWIO kernel (tecogan_tpu/models/layers.py)."""
    bound = math.sqrt(1.0 / (9 * in_ch))

    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).numpy()

    p = {"kernel": uniform((3, 3, in_ch, out_ch))}
    if bias:
        p["bias"] = uniform((out_ch,))
    return p


def init_generator(cfg: TecoConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random generator params as a nested dict of float32 numpy arrays in
    the flax layout, drawn from ``generator`` (a seeded torch.Generator on
    the CPU)."""

    def resblock(in_ch, features):
        return {"Conv_0": _conv_params(generator, in_ch, features),
                "Conv_1": _conv_params(generator, features, features,
                                       bias=False)}

    params: Dict[str, Any] = {"conv_in": _conv_params(generator, 51, 64)}
    for i in range(cfg.num_resblock):
        params[f"resblock_{i}"] = resblock(64, 64)
    params["up1"] = _conv_params(generator, 64, 64)
    params["trunk_rb1"] = resblock(64, 64)
    params["trunk_rb2"] = resblock(64, 128)
    params["up2"] = _conv_params(generator, 128, 128)
    params["conv_hr"] = _conv_params(generator, 128, 64)
    params["conv_out"] = _conv_params(generator, 64, 3)
    return params
