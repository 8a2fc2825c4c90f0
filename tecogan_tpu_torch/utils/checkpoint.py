"""jax-free reader and writer of the ``.ckpt`` checkpoint format.

A ``.ckpt`` file (tecogan_tpu/utils/checkpoint.py) is an ``np.savez``
archive of a flattened pytree: each leaf's path is joined with ``//`` and
metadata leaves carry the ``__meta__`` prefix.  Both
``save_train_state``'s ``generator.ckpt`` and ``save_generator_params``
store the generator's flax params under ``model_state_dict``.

A training checkpoint is a pair of files, written as the JAX package
writes them, so that a checkpoint of either package resumes in the other:
``generator.ckpt`` holds ``model_state_dict`` (G's flax params) and
``optimizer_state_dict`` (optax's ``inject_hyperparams(adam)`` state in
its flattened layout: ``count``, ``hyperparams//learning_rate``,
``inner_state//#0//{count,mu,nu}``) with ``__meta__`` epoch and step;
``discrim.ckpt`` holds D's params, its optimizer state and
``batch_stats``, with ``__meta__`` epoch.  ``save_train_state`` can write
the pair in a background thread (``async_save``), after copying the state
to the host.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .convert import (discriminator_params_to_jax,
                      discriminator_state_dict_from_jax,
                      generator_params_to_jax, generator_state_dict_from_jax)

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
    params = _sub(load_flat(path)[0], "model_state_dict")
    if not params:
        raise KeyError(f"{path} holds no model_state_dict leaves")
    return params


def save_generator_params(path: str, params, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the generator's params alone (no optimizer state) as the JAX
    package's ``save_generator_params`` does: the flax tree under
    ``model_state_dict``, what :func:`load_generator_params` and the JAX
    loader read.  ``params`` is a ``models.Generator`` ``state_dict``
    (tensors on any device) or the flax tree."""
    if any(isinstance(v, torch.Tensor) for v in params.values()):
        params = generator_params_to_jax(params)
    save_pytree(path, {"model_state_dict": params}, meta=meta)


def _sub(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """The subtree under ``prefix`` of a flat checkpoint, nested."""
    prefix += _SEP
    return unflatten({k[len(prefix):]: v for k, v in flat.items()
                      if k.startswith(prefix)})


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def write_pytree_tmp(path: str, tree: Mapping[str, Any],
                     meta: Optional[Dict[str, Any]] = None) -> str:
    """Serialize a nested dict of arrays to ``path + '.tmp.npz'`` without
    publishing it; the caller renames.  Lets a checkpoint pair commit all
    or nothing."""
    flat = _flatten(tree)
    for k, v in (meta or {}).items():
        flat[f"{_META}{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    return tmp


def save_pytree(path: str, tree: Mapping[str, Any],
                meta: Optional[Dict[str, Any]] = None) -> None:
    os.replace(write_pytree_tmp(path, tree, meta), path)


def generator_ckpt_path(output_dir: str) -> str:
    return os.path.join(output_dir, "generator.ckpt")


def discriminator_ckpt_path(output_dir: str) -> str:
    return os.path.join(output_dir, "discrim.ckpt")


def has_checkpoint(output_dir: str) -> bool:
    """True when both files of a checkpoint pair exist."""
    return (os.path.exists(generator_ckpt_path(output_dir))
            and os.path.exists(discriminator_ckpt_path(output_dir)))


def _opt_tree(opt, to_jax) -> Dict[str, Any]:
    """An ``engine.state.AdamState`` in optax's flattened layout."""
    count = np.asarray(opt.count, np.int32)
    return {"count": count,
            "hyperparams": {"learning_rate": np.asarray(opt.learning_rate, np.float32)},
            "inner_state": {"#0": {"count": count, "mu": to_jax(opt.mu),
                                   "nu": to_jax(opt.nu)}}}


def _train_state_files(state, epoch: int):
    """The flat host copies of the generator and discriminator files of a
    checkpoint pair: ``((g_flat, g_meta), (d_flat, d_meta))``."""
    params_d, stats_d = discriminator_params_to_jax(state.params_d,
                                                    state.batch_stats_d)
    g = {"model_state_dict": generator_params_to_jax(state.params_g),
         "optimizer_state_dict": _opt_tree(state.opt_g, generator_params_to_jax)}
    d = {"model_state_dict": params_d,
         "optimizer_state_dict": _opt_tree(
             state.opt_d, lambda sd: discriminator_params_to_jax(sd, {})[0]),
         "batch_stats": stats_d}

    def host(tree):  # copies: a CPU tensor's numpy view may share its memory
        return {k: np.array(v) for k, v in _flatten(tree).items()}

    return ((host(g), {"epoch": epoch, "step": int(state.step)}),
            (host(d), {"epoch": epoch}))


_ASYNC_SAVE: Dict[str, Any] = {"thread": None, "error": None}


def _grid_barrier(mesh) -> None:
    """Every rank of the grid waits for its rank 0: the model groups' ranks
    wait for their model rank 0, then each data group for its data rank 0."""
    import torch.distributed as dist

    for group in (mesh.model_group, mesh.group):
        if group is not None:
            dist.barrier(group=group)


def save_train_state(output_dir: str, state, epoch: int, async_save: bool = False,
                     mesh=None) -> None:
    """Write the generator / discriminator checkpoint pair of an
    ``engine.state.TrainState``: both files to tmp names first, then both
    renamed, so a crash never publishes a new G beside a stale D.

    The state is copied to the host before this returns.  ``async_save``
    writes the files in a background thread; a pending save is joined
    before the next one starts, and :func:`wait_for_async_save` joins it
    and raises what its writing raised.

    A tensor-parallel shard (``parallel.tp``) needs its ``mesh``, and
    every rank of the grid calls this: the full tensors are gathered and
    rank 0 of the grid writes the pair a full state writes; without
    ``async_save`` every rank returns once the pair is written."""
    if state.model_shards is not None:
        from ..parallel.tp import gather_state_tp

        if mesh is None:
            raise ValueError("saving a tensor-parallel shard needs its mesh")
        state = gather_state_tp(mesh, state)
        if mesh.rank == 0 and mesh.model_rank == 0:
            save_train_state(output_dir, state, epoch, async_save)
        if not async_save:
            _grid_barrier(mesh)
        return
    wait_for_async_save()
    (g_flat, g_meta), (d_flat, d_meta) = _train_state_files(state, epoch)
    gp, dp = generator_ckpt_path(output_dir), discriminator_ckpt_path(output_dir)

    def write():
        g_tmp = write_pytree_tmp(gp, g_flat, g_meta)
        d_tmp = write_pytree_tmp(dp, d_flat, d_meta)
        os.replace(g_tmp, gp)
        os.replace(d_tmp, dp)

    if not async_save:
        write()
        return

    def run():
        try:
            write()
        except BaseException as e:  # raised by wait_for_async_save
            _ASYNC_SAVE["error"] = e

    t = threading.Thread(target=run, daemon=False)
    _ASYNC_SAVE["thread"] = t
    t.start()


def wait_for_async_save() -> None:
    """Join a pending ``save_train_state(async_save=True)``; raises the
    exception its writing raised, if any."""
    t, _ASYNC_SAVE["thread"] = _ASYNC_SAVE["thread"], None
    if t is not None:
        t.join()
    err, _ASYNC_SAVE["error"] = _ASYNC_SAVE["error"], None
    if err is not None:
        raise err


def _like(loaded: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor],
          what: str, dev: torch.device) -> Dict[str, torch.Tensor]:
    """``loaded`` checked key by key and shape by shape against the
    template, as training-state tensors on ``dev``."""
    from ..engine.state import train_tensors

    for k, t in template.items():
        if k not in loaded:
            raise KeyError(f"checkpoint missing leaf {what}:{k!r}")
        if tuple(loaded[k].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {what}:{k!r}: ckpt "
                             f"{tuple(loaded[k].shape)} vs model {tuple(t.shape)}")
    return train_tensors({k: loaded[k] for k in template}, dev)


def _load_opt(tree: Dict[str, Any], template, from_jax, what: str,
              dev: torch.device):
    inner = tree["inner_state"]["#0"]
    return dataclasses.replace(
        template, count=int(inner["count"]),
        mu=_like(from_jax(inner["mu"]), template.mu, what + "/mu", dev),
        nu=_like(from_jax(inner["nu"]), template.nu, what + "/nu", dev),
        learning_rate=float(np.float32(tree["hyperparams"]["learning_rate"])))


def load_train_state(output_dir: str, state, g_path: Optional[str] = None,
                     d_path: Optional[str] = None, mesh=None):
    """Returns ``(state, epoch)``: ``state`` (an ``engine.state.TrainState``
    used as the template for keys, shapes and the device) with everything
    restored from the checkpoint pair.  Raises on a missing leaf, a shape
    mismatch or a torn pair (the two files at different epochs).

    Into a tensor-parallel shard (``parallel.tp``, with its ``mesh``;
    every rank of the grid calls this) the full pair loads as this rank's
    slices."""
    if state.model_shards is not None:
        from ..parallel.tp import gather_state_tp, shard_state_tp

        if mesh is None:
            raise ValueError("loading into a tensor-parallel shard needs its mesh")
        full, epoch = load_train_state(output_dir, gather_state_tp(mesh, state),
                                       g_path, d_path)
        return shard_state_tp(mesh, full), epoch
    g_flat, g_meta = load_flat(g_path or generator_ckpt_path(output_dir))
    d_flat, d_meta = load_flat(d_path or discriminator_ckpt_path(output_dir))
    g_epoch = int(g_meta.get("epoch", 0))
    if "epoch" in d_meta and int(d_meta["epoch"]) != g_epoch:
        raise ValueError(f"torn checkpoint pair: generator epoch {g_epoch} != "
                         f"discriminator epoch {int(d_meta['epoch'])} in {output_dir}")
    params_d, stats_d = discriminator_state_dict_from_jax(
        _sub(d_flat, "model_state_dict"), _sub(d_flat, "batch_stats"))
    dev = next(iter(state.params_g.values())).device
    new_state = state.replace(
        params_g=_like(generator_state_dict_from_jax(_sub(g_flat, "model_state_dict")),
                       state.params_g, "generator", dev),
        opt_g=_load_opt(_sub(g_flat, "optimizer_state_dict"), state.opt_g,
                        generator_state_dict_from_jax, "generator optimizer", dev),
        params_d=_like(params_d, state.params_d, "discriminator", dev),
        batch_stats_d=_like(stats_d, state.batch_stats_d, "batch_stats", dev),
        opt_d=_load_opt(_sub(d_flat, "optimizer_state_dict"), state.opt_d,
                        lambda t: discriminator_state_dict_from_jax(t, {})[0],
                        "discriminator optimizer", dev),
        step=int(g_meta.get("step", 0)), epoch=g_epoch)
    return new_state, g_epoch
