"""jax-free reader of the ``.ckpt`` checkpoint format.

A ``.ckpt`` file (tecogan_tpu/utils/checkpoint.py) is an ``np.savez``
archive of a flattened pytree: each leaf's path is joined with ``//`` and
metadata leaves carry the ``__meta__`` prefix.  Both
``save_train_state``'s ``generator.ckpt`` and ``save_generator_params``
store the generator's flax params under ``model_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

_SEP = "//"
_META = "__meta__"


def load_flat(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Returns ``(data, meta)``: the flat leaves and the metadata leaves
    (prefix stripped) of a ``.ckpt`` file."""
    with np.load(path, allow_pickle=False) as z:
        data, meta = {}, {}
        for k in z.files:
            if k.startswith(_META):
                meta[k[len(_META):]] = z[k]
            else:
                data[k] = z[k]
    return data, meta


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Rebuild a nested dict from ``//``-joined flat keys."""
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split(_SEP)
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    return tree


def load_generator_params(path: str) -> Dict[str, Any]:
    """The generator's numpy params tree (flax layout) stored under
    ``model_state_dict``; optimizer state and metadata are ignored."""
    flat, _ = load_flat(path)
    prefix = "model_state_dict" + _SEP
    params = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if not params:
        raise KeyError(f"{path} holds no model_state_dict leaves")
    return unflatten(params)
