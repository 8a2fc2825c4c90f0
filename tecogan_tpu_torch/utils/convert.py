"""Weight bridge: the JAX package's flax generator params -> the port's
``state_dict``.

The port's submodules carry the flax names (``conv_in``,
``resblock_{i}.Conv_0`` / ``Conv_1``, ``up1``, ``trunk_rb1``,
``trunk_rb2``, ``up2``, ``conv_hr``, ``conv_out``), so the bridge is a pure
layout map:

* ``Conv`` kernels are HWIO in flax and OIHW in torch.
* ``ConvTranspose2x`` kernels are stored in flax as spatially flipped
  forward-conv kernels (tecogan_tpu/models/layers.py:139-150);
  ``nn.ConvTranspose2d`` wants ``(I, O, kh, kw)`` of the unflipped kernel
  (the same map as tools/convert_torch_ckpt.py::_conv_tran_rev).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TRANSPOSED = ("up1", "up2")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a copy


def _put(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any],
         transposed: bool) -> None:
    k = np.asarray(p["kernel"])
    if transposed:
        w = np.transpose(k[::-1, ::-1], (2, 3, 0, 1))  # (I, O, kh, kw)
    else:
        w = np.transpose(k, (3, 2, 0, 1))  # OIHW
    sd[f"{prefix}.weight"] = _tensor(w)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _tensor(p["bias"])


def generator_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays in the flax layout (what
    ``load_generator_params`` or ``engine.state.init_generator`` return)
    -> float32 ``state_dict`` for ``models.Generator``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if "kernel" in p:
            _put(sd, name, p, transposed=name in _TRANSPOSED)
        else:  # a ResidualBlock: Conv_0 / Conv_1
            for sub, q in p.items():
                _put(sd, f"{name}.{sub}", q, transposed=False)
    return sd
