"""VGG-19 feature extractor (tecogan_tpu/models/vgg.py): the perceptual
loss's and the evaluation metrics' features.

``VGG19`` is the full conv stack; it returns the final pool and every
conv and pool activation keyed ``vgg_19/<name>``, NHWC, as the JAX model
does.  Weights cross in the flax layout (``utils.convert``): a converted
``.ckpt`` through :func:`load_vgg_params`; the JAX package's
``"surrogate"`` weights, which :func:`fixed_seed_vgg_params` regenerates
bit for bit from the same JAX PRNG key (``utils.jax_prng``, numpy only);
or :func:`init_vgg`'s draw from a torch generator at VGG-19's widths.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import jax_prng
from .layers import Conv

# (name, out_channels) per VGG-19 layer; None is a 2x2 max pool
VGG19_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("pool3", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), ("pool4", None),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), ("pool5", None),
]

VGG_MEAN = (123.68, 116.78, 103.94)  # reference train.py:6
SURROGATE_SEED = 20260816  # tecogan_tpu/models/vgg.py's fixed seed
# params_sha256 of the JAX package's fixed_seed_vgg_params(): what the
# regenerated surrogate hashes to on any host
SURROGATE_SHA256 = "a851feade8d6616c2527d92c8abf63d10b55df43fdd56c150b401f4d35832f41"


class VGG19(nn.Module):
    """The VGG-19 conv stack: 3x3 convs (padding 1) + ReLU, 2x2 max pools
    of stride 2.  ``forward`` takes and returns NHWC and runs NCHW
    ``channels_last`` inside."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        in_ch = 3
        for name, ch in VGG19_CFG:
            if ch is not None:
                self.add_module(name, Conv(in_ch, ch, dtype=dtype))
                in_ch = ch
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, stop_after: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, H, W, 3) -> (the last activation, {'vgg_19/<name>': NHWC
        activation}).  ``stop_after`` names the last layer to run (the
        layers after it feed nothing the caller reads)."""
        end_points: Dict[str, torch.Tensor] = {}
        net = x.to(self.dtype).permute(0, 3, 1, 2)
        for name, ch in VGG19_CFG:
            if ch is None:
                net = F.max_pool2d(net, 2, 2)
            else:
                net = F.relu(getattr(self, name)(net))
            end_points[f"vgg_19/{name}"] = net.permute(0, 2, 3, 1)
            if name == stop_after:
                break
        return net.permute(0, 2, 3, 1), end_points


def init_vgg(generator: torch.Generator) -> Dict[str, Any]:
    """Random VGG-19 params at its published widths, in the flax layout
    (float32 numpy), drawn from ``generator`` (a seeded CPU
    torch.Generator) with torch's conv init, as
    ``engine.state.init_generator`` draws the generator's."""
    from ..engine.state import _conv_params

    params, in_ch = {}, 3
    for name, ch in VGG19_CFG:
        if ch is not None:
            params[name] = _conv_params(generator, in_ch, ch)
            in_ch = ch
    return params


def fixed_seed_vgg_params(seed: int = SURROGATE_SEED) -> Dict[str, Any]:
    """The JAX package's surrogate VGG-19 params
    (``tecogan_tpu.models.vgg.fixed_seed_vgg_params``: flax's init of
    ``VGG19`` under ``PRNGKey(seed)``), bit for bit, as float32 numpy in
    the flax layout: HWIO ``kernel`` and ``bias`` per ``conv*``, each
    ``U(+-sqrt(1 / (9 cin)))`` (tecogan_tpu/models/layers.py's torch-style
    init), drawn with ``utils.jax_prng`` under the key flax gives the
    parameter (its module name, then counter 1 for the kernel and 2 for
    the bias)."""
    root = jax_prng.prng_key(seed)
    params, cin = {}, 3
    for name, ch in VGG19_CFG:
        if ch is None:
            continue
        bound = math.sqrt(1.0 / (9 * cin))
        params[name] = {
            "kernel": jax_prng.uniform(jax_prng.flax_param_key(root, name, 1),
                                       (3, 3, cin, ch), -bound, bound),
            "bias": jax_prng.uniform(jax_prng.flax_param_key(root, name, 2),
                                     (ch,), -bound, bound)}
        cin = ch
    return params


def params_sha256(params: Dict[str, Any]) -> str:
    """SHA-256 of a flax-layout VGG-19 tree: each ``conv*`` layer in
    order, its float32 ``kernel`` then ``bias`` bytes (C order)."""
    h = hashlib.sha256()
    for name, ch in VGG19_CFG:
        if ch is not None:
            for leaf in ("kernel", "bias"):
                h.update(np.ascontiguousarray(params[name][leaf], dtype=np.float32).tobytes())
    return h.hexdigest()


def load_vgg_params(vgg_ckpt: str) -> Dict[str, Any]:
    """Resolve ``--vgg_ckpt``: the literal ``"surrogate"`` gives
    :func:`fixed_seed_vgg_params` (the JAX package's weights); a path
    gives the flax-layout params of a converted VGG-19 ``.ckpt`` (its
    ``model_state_dict`` subtree when it has one)."""
    if vgg_ckpt == "surrogate":
        return fixed_seed_vgg_params()
    from ..utils.checkpoint import load_flat, unflatten

    tree = unflatten(load_flat(vgg_ckpt)[0])
    return tree.get("model_state_dict", tree)


def vgg_model(params: Dict[str, Any], device=None,
              dtype: torch.dtype = torch.float32) -> VGG19:
    """A frozen ``VGG19`` on ``device`` (default: the card, see
    ``engine.state.resolve_device``) holding ``params`` (the flax tree)."""
    from ..engine.state import resolve_device
    from ..utils.convert import vgg_state_dict_from_jax

    model = VGG19(dtype=dtype).to(resolve_device(device))
    model.load_state_dict(vgg_state_dict_from_jax(params))
    return model.eval().requires_grad_(False)


def vgg19_features(model: VGG19, images01_nhwc: torch.Tensor,
                   deep_list: Optional[Iterable[str]] = None,
                   norm_flag: bool = True) -> Dict[str, torch.Tensor]:
    """VGG19_slim (reference train.py:30-45): [0, 1] images scaled to
    [0, 255] less ``VGG_MEAN``, the features of ``deep_list`` (default:
    every layer), unit-normalized over channels (``+1e-12`` under the
    square root) when ``norm_flag``."""
    mean = torch.tensor(VGG_MEAN, dtype=images01_nhwc.dtype, device=images01_nhwc.device)
    wanted = None if deep_list is None else set(deep_list)
    stop = None
    if wanted is not None:
        names = [f"vgg_19/{n}" for n, _ in VGG19_CFG]
        stop = max((names.index(k) for k in wanted if k in names), default=0)
        stop = VGG19_CFG[stop][0]
    _, end_points = model(images01_nhwc * 255.0 - mean, stop_after=stop)
    results = {}
    for key, feat in end_points.items():
        if wanted is None or key in wanted:
            if norm_flag:
                feat = feat / torch.sqrt(torch.sum(torch.square(feat), dim=-1,
                                                   keepdim=True) + 1e-12)
            results[key] = feat
    return results


def make_vgg_apply(model: VGG19) -> Callable:
    """The ``vgg_apply(images01_nhwc, deep_list) -> {label: features}``
    that ``engine.train.build_train_step`` takes for the VGG loss."""
    def vgg_apply(images01_nhwc, deep_list):
        return vgg19_features(model, images01_nhwc, deep_list)

    return vgg_apply
