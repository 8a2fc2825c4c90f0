"""Model construction, random weights and the training state
(tecogan_tpu/engine/state.py).

Weights are made in the JAX package's numpy layout (flax names, HWIO
kernels), so one tree feeds both packages: the JAX models directly and
the port through ``utils.convert``.

The training state mirrors the JAX ``TrainState``: float32 params (the
layers cast them to ``cfg.precision`` at use), the discriminator's BN
running statistics, one Adam state per model and the step and epoch
counters.  Params and moments are ``state_dict``-keyed tensors on the
training device; :func:`engine.train.build_train_step` returns a new
state each step and leaves the old one as it was.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import TecoConfig
from ..models import Discriminator, Generator, PublishedTecoGAN
from ..utils.convert import (discriminator_state_dict_from_jax,
                             generator_state_dict_from_jax)

Tensors = Dict[str, torch.Tensor]


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


def _compute_dtype(cfg: TecoConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "bf16" else torch.float32


def model_defs(cfg: TecoConfig, device=None) -> Generator:
    """The serving generator for ``cfg`` (weights held in the compute dtype
    from ``cfg.precision``) on ``device`` (default: the card, see
    :func:`resolve_device`).  The training models are
    :func:`train_model_defs`."""
    dtype = _compute_dtype(cfg)
    dev = resolve_device(device)
    return Generator(num_resblock=cfg.num_resblock, out_channels=3,
                     dtype=dtype).to(dev)


def published_model_defs(cfg: TecoConfig, device=None) -> PublishedTecoGAN:
    """TecoGAN as published (``models.PublishedTecoGAN``: its FNet and
    generator, ``cfg.num_resblock`` resblocks), weights held in the compute
    dtype from ``cfg.precision``, on ``device`` (as :func:`model_defs`).
    The inference loops serve it on its own route."""
    return PublishedTecoGAN(num_resblock=cfg.num_resblock,
                            dtype=_compute_dtype(cfg)).to(resolve_device(device))


def train_model_defs(cfg: TecoConfig, device=None) -> Tuple[Generator, Discriminator]:
    """The generator and the discriminator of the train step, computing in
    ``cfg.precision``, the discriminator sized for
    :func:`engine.losses.d_input_spec`.  The train step runs them with the
    state's float32 params (``torch.func.functional_call``); their own
    params are never read there."""
    from .losses import d_input_spec

    dtype = _compute_dtype(cfg)
    dev = resolve_device(device)
    d_ch, d_hw = d_input_spec(cfg)
    gen = Generator(num_resblock=cfg.num_resblock, out_channels=3, dtype=dtype)
    disc = Discriminator(resblocks=cfg.discrim_resblocks,
                         channels=cfg.discrim_channels, dtype=dtype,
                         in_channels=d_ch, in_size=d_hw)
    return gen.to(dev), disc.to(dev)


# ---------------------------------------------------------------------------
# random weights in the flax layout
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> np.ndarray:
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).numpy()


def _conv_params(gen: torch.Generator, in_ch: int, out_ch: int,
                 bias: bool = True, kernel: int = 3) -> Dict[str, np.ndarray]:
    """torch's Conv2d default init, U(+-sqrt(1/fan_in)) for kernel and
    bias, drawn as an HWIO kernel (tecogan_tpu/models/layers.py)."""
    bound = math.sqrt(1.0 / (kernel * kernel * in_ch))
    p = {"kernel": _uniform(gen, (kernel, kernel, in_ch, out_ch), bound)}
    if bias:
        p["bias"] = _uniform(gen, (out_ch,), bound)
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


def init_discriminator(cfg: TecoConfig, generator: torch.Generator
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Random discriminator ``(params, batch_stats)`` in the flax layout,
    drawn from ``generator``: torch's conv init as for the generator,
    BatchNorm scale 1 and bias 0, running mean 0 and var 1 (flax's
    defaults), the fc kernel xavier-uniform with a U(+-1/sqrt(in)) bias
    (tecogan_tpu/models/layers.py:171-203)."""
    from .losses import d_input_spec

    d_ch, d_hw = d_input_spec(cfg)
    C = cfg.discrim_channels
    params: Dict[str, Any] = {"conv_in": _conv_params(generator, d_ch, 64)}
    stats: Dict[str, Any] = {}

    def bn(features):
        return ({"scale": np.ones(features, np.float32),
                 "bias": np.zeros(features, np.float32)},
                {"mean": np.zeros(features, np.float32),
                 "var": np.ones(features, np.float32)})

    def block(name, in_ch, features):
        p, s = bn(features)
        params[name] = {"Conv_0": _conv_params(generator, in_ch, features,
                                               bias=False, kernel=4),
                        "BatchNorm_0": p}
        stats[name] = {"BatchNorm_0": s}

    def resids(name, features):
        params[name], stats[name] = {}, {}
        for i in range(cfg.discrim_resblocks):
            params[name][f"rb_{i}"] = {
                "Conv_0": _conv_params(generator, features, features),
                "Conv_1": _conv_params(generator, features, features, bias=False)}
            params[name][f"bn_{i}"], stats[name][f"bn_{i}"] = bn(features)

    block("block1", 64, 64)
    resids("resids1", 64)
    block("block2", 64, C)
    resids("resids2", C)
    block("block3", C, C)
    resids("resids3", C)
    block("block4", C, 64)
    block("block5", 64, 3)
    side = d_hw
    for _ in range(5):
        side = (side + 2 - 4) // 2 + 1
    fc_in = 3 * side * side
    params["fc"] = {"kernel": _uniform(generator, (fc_in, 1), math.sqrt(6.0 / (fc_in + 1))),
                    "bias": _uniform(generator, (1,), 1.0 / math.sqrt(fc_in))}
    return params, stats


# ---------------------------------------------------------------------------
# optimizers and the training state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamState:
    """``optax.inject_hyperparams(optax.adam)``'s state: the update count,
    the first and second moments keyed like the params, and the learning
    rate of the last update (the injected hyperparameter, float32)."""

    count: int
    mu: Tensors
    nu: Tensors
    learning_rate: float


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam in optax's form (tecogan_tpu/engine/state.py:47-58): ``mu = (1
    - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``update = mu_hat /
    (sqrt(nu_hat) + eps)`` with the bias corrections of the new count,
    the learning rate set every step.  Functional, on lists of tensors
    (``torch._foreach_*``): ``torch.optim.Adam`` cannot advance its
    moments without applying the step, which the masked D update needs."""

    b1: float
    b2: float
    eps: float
    lr_scale: float

    def init(self, params: Tensors, learning_rate: float) -> AdamState:
        return AdamState(
            count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            learning_rate=float(np.float32(learning_rate * self.lr_scale)))

    def update(self, params: Tensors, grads: Tensors, state: AdamState,
               learning_rate: float, apply: Optional[torch.Tensor] = None
               ) -> Tuple[Tensors, AdamState]:
        """One step at ``learning_rate`` (the schedule's rate; this
        optimizer's scale is applied here).  ``apply``, a bool tensor,
        masks the update of the params; the moments and the count advance
        either way."""
        keys = list(params)
        g = [grads[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1),
                                torch._foreach_mul([state.mu[k] for k in keys], self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
            torch._foreach_mul([state.nu[k] for k in keys], self.b2))
        count = state.count + 1
        # the bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                                 self.eps)
        step = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        lr = float(np.float32(learning_rate) * np.float32(self.lr_scale))
        step = torch._foreach_mul(step, -lr)
        if apply is not None:
            step = [torch.where(apply, s, 0.0) for s in step]
        new = torch._foreach_add([params[k] for k in keys], step)
        return (dict(zip(keys, new)),
                AdamState(count=count, mu=dict(zip(keys, mu)),
                          nu=dict(zip(keys, nu)), learning_rate=lr))


def lr_schedule(cfg: TecoConfig):
    """StepLR: ``lr * decay_rate ** (epoch // decay_step)``, staircase, in
    float32 -- torch's StepLR stepped per epoch (main.py:247-248,296)."""

    def schedule(epoch: int) -> float:
        return float(np.float32(cfg.learning_rate) * np.power(
            np.float32(cfg.decay_rate), np.float32(epoch // cfg.decay_step)))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """``optax.cosine_decay_schedule(init_value, decay_steps)`` (alpha 0,
    exponent 1) in float32: ``init * 0.5 (1 + cos(pi min(count, decay) /
    decay))``.  ``optax.adam(schedule)`` scales update ``k`` by the rate
    at count ``k``, read before the increment."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f = np.float32

    def schedule(count: int) -> float:
        c = f(min(count, decay_steps))
        cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * c / f(decay_steps)))
        return float(f(init_value) * cosine)

    return schedule


def make_optimizers(cfg: TecoConfig) -> Tuple[Adam, Adam, Any]:
    """(G's Adam, D's Adam, the schedule): Adam(beta, 0.999, adameps) for
    both, D's rate x0.3 when ``Dt_mergeDs`` is off (main.py:237-238)."""
    d_scale = 1.0 if cfg.Dt_mergeDs else 0.3
    return (Adam(cfg.beta, 0.999, cfg.adameps, 1.0),
            Adam(cfg.beta, 0.999, cfg.adameps, d_scale), lr_schedule(cfg))


@dataclasses.dataclass(frozen=True)
class TrainState:
    """The JAX ``TrainState`` (tecogan_tpu/engine/state.py:24-32):
    ``params_g`` / ``params_d`` are the models' float32 params by
    ``state_dict`` key, ``batch_stats_d`` the discriminator's BN running
    statistics (``<bn module>.mean`` / ``.var``).

    ``model_shards`` is None for a full state.  A rank's tensor-parallel
    shard (``parallel.tp.shard_state_tp``) holds there, under
    ``params_g`` and ``params_d``, each params key's dim that is split over
    the model group (None where the leaf is replicated); the Adam moments
    follow their params."""

    params_g: Tensors
    params_d: Tensors
    batch_stats_d: Tensors
    opt_g: AdamState
    opt_d: AdamState
    step: int
    epoch: int
    model_shards: Optional[Dict[str, Dict[str, Optional[int]]]] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def train_tensors(sd: Tensors, dev: torch.device) -> Tensors:
    """``sd`` as training-state tensors: float32 on ``dev``, the 4-D conv
    kernels in the layout the train step's convs then run in (a conv
    follows its weight's layout).  That is channels_last on the card, for
    cuDNN's NHWC kernels, and NCHW on the CPU, where oneDNN's
    channels_last backward of the discriminator's 4x4 stride-2 convs loses
    f32 precision (its conv_in / block1 grads sit 1.3e-3 of the leaf's
    largest element off a float64 run, 7e-6 in NCHW)."""
    fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
    return {k: v.to(dev, torch.float32,
                    memory_format=fmt if v.dim() == 4 else torch.preserve_format)
            for k, v in sd.items()}


def float_params(params) -> Tensors:
    """The generator's float32 params as a ``state_dict``: a flax tree
    (nested dict of arrays) is converted, a ``state_dict`` taken as it is
    (float32 copies on its device)."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return generator_state_dict_from_jax(params)
    return {k: v.detach().to(torch.float32, copy=True) for k, v in params.items()}


def state_from_params(cfg: TecoConfig, params_g: Dict[str, Any],
                      params_d: Dict[str, Any], batch_stats_d: Dict[str, Any],
                      device=None) -> TrainState:
    """A fresh training state (zero moments, step and epoch 0) from flax
    trees of weights, e.g. the JAX package's or ``init_generator``'s."""
    dev = resolve_device(device)
    opt_g, opt_d, _ = make_optimizers(cfg)
    pg = train_tensors(generator_state_dict_from_jax(params_g), dev)
    pd, sd = discriminator_state_dict_from_jax(params_d, batch_stats_d)
    pd, sd = train_tensors(pd, dev), train_tensors(sd, dev)
    return TrainState(params_g=pg, params_d=pd, batch_stats_d=sd,
                      opt_g=opt_g.init(pg, cfg.learning_rate),
                      opt_d=opt_d.init(pd, cfg.learning_rate), step=0, epoch=0)


def init_state(cfg: TecoConfig, generator: torch.Generator, device=None) -> TrainState:
    """Random weights for both models from ``generator`` (a seeded
    torch.Generator on the CPU) as a fresh training state on ``device``
    (default: the card, see :func:`resolve_device`)."""
    params_g = init_generator(cfg, generator)
    params_d, stats_d = init_discriminator(cfg, generator)
    return state_from_params(cfg, params_g, params_d, stats_d, device)
