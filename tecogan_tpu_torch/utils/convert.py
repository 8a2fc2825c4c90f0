"""Weight bridge between the JAX package's flax trees and the port's
``state_dict``s, both ways.

The port's submodules carry the flax names (generator: ``conv_in``,
``resblock_{i}.Conv_0`` / ``Conv_1``, ``up1``, ``trunk_rb1``,
``trunk_rb2``, ``up2``, ``conv_hr``, ``conv_out``; discriminator:
``conv_in``, ``block{k}.Conv_0`` / ``BatchNorm_0``, ``resids{k}.rb_{i}`` /
``bn_{i}``, ``fc``; VGG-19: ``conv{i}_{j}``; FNet: ``_DownBlock_{i}`` /
``_UpBlock_{i}.Conv_{j}``, ``Conv_{j}``), so the bridge is a pure
layout map: a flax path ``a/b/leaf`` is the key ``a.b.leaf``, with ``kernel`` renamed ``weight``:

* ``Conv`` kernels are HWIO in flax and OIHW in torch.
* ``ConvTranspose2x`` kernels are stored in flax as spatially flipped
  forward-conv kernels (tecogan_tpu/models/layers.py:139-150);
  ``nn.ConvTranspose2d`` wants ``(I, O, kh, kw)`` of the unflipped kernel
  (the same map as tools/convert_torch_ckpt.py::_conv_tran_rev).
* The ``Dense`` kernel is ``(in, out)`` in flax and ``(out, in)`` in torch.
* BatchNorm ``scale`` / ``bias`` and the running ``mean`` / ``var`` keep
  their names.

Every map is a permutation of elements, so a round trip is exact.  The
reverse maps carry the Adam moments too, which have the params' layout.

A JAX quantized tail (``tecogan_tpu/engine/quant.py::quantize_tail``)
crosses with :func:`qtail_from_jax`: its ``wq`` is the HWIO int8 kernel the
JAX layer convolves with, the forward kernel for the transposed layers too
(the flax layout stores them flipped), and the port's is the same kernel
with the output channel first.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

GENERATOR_TRANSPOSED = ("up1", "up2")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a copy


def _flat(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def state_dict_from_jax(tree: Mapping[str, Any],
                        transposed: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays in the flax layout -> float32 ``state_dict``.
    ``transposed`` names the ``ConvTranspose2x`` modules."""
    sd: Dict[str, torch.Tensor] = {}
    for key, leaf in _flat(tree):
        module, name = key.rsplit(".", 1)
        a = np.asarray(leaf)
        if name == "kernel":
            name = "weight"
            if a.ndim == 2:
                a = a.T
            elif module in transposed:
                a = np.transpose(a[::-1, ::-1], (2, 3, 0, 1))  # (I, O, kh, kw)
            else:
                a = np.transpose(a, (3, 2, 0, 1))  # OIHW
        sd[f"{module}.{name}"] = _tensor(a)
    return sd


def state_dict_to_jax(sd: Mapping[str, torch.Tensor],
                      transposed: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: a nested dict of float32
    numpy arrays in the flax layout (tensors may live on any device)."""
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        *path, name = key.split(".")
        a = t.detach().float().cpu().numpy()
        if name == "weight":
            name = "kernel"
            if a.ndim == 2:
                a = a.T
            elif ".".join(path) in transposed:
                a = np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
            else:
                a = np.transpose(a, (2, 3, 1, 0))  # HWIO
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def generator_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays in the flax layout (what
    ``load_generator_params`` or ``engine.state.init_generator`` return)
    -> float32 ``state_dict`` for ``models.Generator``."""
    return state_dict_from_jax(params, GENERATOR_TRANSPOSED)


def generator_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``models.Generator``'s params -> the flax tree."""
    return state_dict_to_jax(sd, GENERATOR_TRANSPOSED)


def fnet_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax FNet params (``_DownBlock_{i}/Conv_{j}``, ...) -> float32
    ``state_dict`` for ``models.fnet.FNet``."""
    return state_dict_from_jax(params)


def fnet_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``models.fnet.FNet``'s params -> the flax tree."""
    return state_dict_to_jax(sd)


def vgg_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax VGG-19 params (``conv{i}_{j}/kernel``, ``/bias``) -> float32
    ``state_dict`` for ``models.vgg.VGG19``."""
    return state_dict_from_jax(params)


def vgg_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``models.vgg.VGG19``'s params -> the flax tree."""
    return state_dict_to_jax(sd)


def discriminator_state_dict_from_jax(
        params: Mapping[str, Any], batch_stats: Mapping[str, Any],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The flax discriminator's params and ``batch_stats`` -> (its params
    as a ``state_dict`` for ``models.Discriminator``, its running
    statistics keyed ``<bn module>.mean`` / ``.var``)."""
    return state_dict_from_jax(params), state_dict_from_jax(batch_stats)


def discriminator_params_to_jax(
        params: Mapping[str, torch.Tensor],
        batch_stats: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`discriminator_state_dict_from_jax`."""
    return state_dict_to_jax(params), state_dict_to_jax(batch_stats)


def qtail_from_jax(qtail: Mapping[str, Mapping[str, Any]], device="cpu") -> Dict[str, Any]:
    """A JAX qtail ``{layer: {wq (3, 3, I, O) int8, inv_s, deq (O,),
    bias (O,) or None}}`` (arrays) -> the port's qtail
    (``engine/quant.py``): ``wq`` ``(O, 3, 3, I)`` int8, the rest float32
    tensors, on ``device``."""
    out: Dict[str, Any] = {}
    for name, layer in qtail.items():
        wq = np.transpose(np.asarray(layer["wq"], dtype=np.int8), (3, 0, 1, 2))
        out[name] = {
            "wq": torch.from_numpy(np.ascontiguousarray(wq)).to(device),
            "inv_s": _tensor(layer["inv_s"]).to(device),
            "deq": _tensor(layer["deq"]).to(device),
            "bias": None if layer["bias"] is None else _tensor(layer["bias"]).to(device),
        }
    return out
