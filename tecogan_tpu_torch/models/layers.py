"""Layer building blocks (tecogan_tpu/models/layers.py).

These run on NCHW tensors.  The serving generator keeps them in
``torch.channels_last`` so cuDNN reads and writes NHWC memory; the train
step runs in the layout of its state's params
(``engine.state.train_tensors``).

Weights held in another dtype than the input are cast to the input's
dtype at use, as the JAX layers cast their float32 params to the compute
dtype: the training path holds float32 params and computes in bf16.  The
serving generator holds its weights in the compute dtype, where the cast
is a no-op.  The bias goes through ``F.conv2d``, whose cuDNN path adds it
after the conv in the output dtype, as the JAX layers add it.

Tensor parallelism (parallel/tp.py): :func:`set_model_group` gives a
model's convs whose output channels split over the group
(:func:`shards_over_model`) that group.  Such a conv is then given its
rank's slice of the weight and runs column-parallel: the input through
``copy_to_model``, the conv of the slice, the slices joined by
``gather_channels``, and the bias, which is replicated, added in full
after the join.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(p, dtype: torch.dtype):
    return None if p is None else p.to(dtype)


def shards_over_model(out_channels: int, n_model: int) -> bool:
    """Whether a conv's output channels split over ``n_model`` ranks: the
    JAX package's rule for a 4-D leaf (tecogan_tpu/parallel/tp.py:33-45),
    they divide evenly and each rank keeps at least two."""
    return n_model > 1 and out_channels % n_model == 0 and out_channels >= 2 * n_model


def _column_parallel(conv, x: torch.Tensor, bias: Optional[torch.Tensor],
                     group) -> torch.Tensor:
    """``conv`` (this rank's slice of the output channels, no bias) of
    ``x``, the group's slices joined, then the full bias."""
    from ..parallel.collectives import copy_to_model, gather_channels

    y = gather_channels(conv(copy_to_model(x, group)), group)
    return y if bias is None else y + bias[:, None, None]


class Conv(nn.Conv2d):
    """kxk cross-correlation, padding (k-1)//2 (the reference conv2):
    3x3 stride 1 in the generator, 4x4 stride 2 in the discriminator."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, kernel: int = 3,
                 stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=(kernel - 1) // 2, bias=bias, dtype=dtype)

    model_group = None  # set by set_model_group: run column-parallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        if self.model_group is None:
            return self._conv_forward(x, w, b)
        return _column_parallel(lambda t: self._conv_forward(t, w, None), x, b,
                                self.model_group)


class ConvTranspose2x(nn.ConvTranspose2d):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1): exact 2x upsample
    (the reference conv2_tran)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 3, stride=2, padding=1,
                         output_padding=1, dtype=dtype)

    model_group = None  # set by set_model_group: run column-parallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), _cast(self.bias, x.dtype)

        def conv(t, bias=None):
            return F.conv_transpose2d(t, w, bias, stride=2, padding=1, output_padding=1)

        if self.model_group is None:
            return conv(x, b)
        return _column_parallel(conv, x, b, self.model_group)


class ResidualBlock(nn.Module):
    """conv(bias) - ReLU - conv(no bias; with ``bias1``, a bias, as TecoGAN
    as published has it).  The skip is added by the caller: the
    generator's trunk uses the block without one."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32, bias1: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, bias=True, dtype=dtype)
        self.Conv_1 = Conv(features, features, bias=bias1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.relu(self.Conv_0(x)))


class BatchNorm(nn.Module):
    """BatchNorm2d(eps=1e-3) in train mode with flax's arithmetic
    (``flax.linen.BatchNorm``, tecogan_tpu/models/layers.py:171-186):
    the batch mean and the biased variance ``E[x^2] - E[x]^2`` (clipped at
    0) in float32 over (N, H, W), ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in float32, the result in the input's dtype.

    It holds no running statistics.  ``forward`` records the batch's
    (detached) mean and variance into ``stats`` under ``name + '.mean'`` /
    ``'.var'``; the caller folds them into its running averages
    (``0.9 * old + 0.1 * batch``, engine/losses.py) or leaves them, as the
    generator objective does.

    With a process ``group`` (data-parallel training, parallel/dp.py) the
    batch is the global one: each rank's f32 mean and ``E[x^2]`` are summed
    over the ranks by a differentiable all-reduce and divided by the world
    size before the variance, as the JAX package's SPMD step computes
    them; every rank then records the same statistics.  The ranks' batches
    must be of equal size.  Without a group nothing else runs."""

    EPS = 1e-3

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, stats: Dict[str, torch.Tensor],
                name: str, group: Optional[object] = None) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        if group is None:
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        else:
            from ..parallel.collectives import all_reduce_sum

            moments = all_reduce_sum(torch.cat([mean, (xf * xf).mean(dim=(0, 2, 3))]),
                                     group) / group.size()
            mean, sq = moments.chunk(2)
            var = torch.clamp_min(sq - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.EPS) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        stats[f"{name}.mean"] = mean.detach()
        stats[f"{name}.var"] = var.detach()
        return y.to(x.dtype)


class Dense(nn.Linear):
    """Linear layer; ``weight`` is (out, in), the flax kernel transposed.
    The bias is added after the product in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def lrelu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """LeakyReLU(0.2) (reference ops.py:71-72)."""
    return F.leaky_relu(x, negative_slope=alpha)


def set_model_group(module: nn.Module, group) -> set:
    """Every ``Conv`` / ``ConvTranspose2x`` of ``module`` whose output
    channels split over ``group``'s ranks (:func:`shards_over_model`)
    runs column-parallel over ``group``; the others stay as they are.
    Returns the ``state_dict`` keys of the split weights."""
    keys = set()
    for name, m in module.named_modules():
        if (isinstance(m, (Conv, ConvTranspose2x))
                and shards_over_model(m.out_channels, group.size())):
            m.model_group = group
            keys.add(f"{name}.weight")
    return keys
