"""Tensor (channel) parallelism over the ``model`` axis of the grid
(tecogan_tpu/parallel/tp.py).

JAX shards every conv kernel's output-channel dim over the ``model`` mesh
axis, lets the Adam moments follow their params, and leaves the SPMD
partitioner to place the collectives.  Here each rank of a model group
(``parallel.mesh``) holds its slice of every sharded weight and computes
only those output channels; ``models.layers`` joins the slices with the
two operators of ``parallel.collectives`` (``copy_to_model``,
``gather_channels``), and everything between two sharded convs runs alike
on every rank of the group.  Sharding a weight changes where it lives,
never the math: the step equals the single-process step up to summation
order.

Which leaves shard is the JAX rule (``models.layers.shards_over_model``):
a 4-D leaf whose output channels divide by ``n_model`` with at least two
a rank.  Those are dim 0 of a ``Conv`` weight and dim 1 of a
``ConvTranspose2x`` weight ``(in, out, kh, kw)``; biases, BatchNorm
params and statistics, the Dense kernel and ``conv_out`` (3 channels)
stay replicated.

Usage, on every rank of the grid::

    mesh = make_mesh(n_data=2, n_model=2, device=dev)
    state = shard_state_tp(mesh, replicate_state(mesh, init_state(cfg, gen, device=dev)))
    step = build_tp_train_step(cfg, mesh)
    lr, hr = shard_batch(mesh, lr_np, hr_np)     # over the data index only
    state, metrics, gen_out = step(state, lr, hr)
    full = gather_state_tp(mesh, state)          # the full tensors

``utils.checkpoint.save_train_state(dir, state, epoch, mesh=mesh)`` writes
a shard's full tensors as the single-process ``.ckpt`` pair.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..config import TecoConfig
from ..engine.state import TrainState, train_tensors
from ..engine.train import build_train_step
from ..models.layers import shards_over_model
from ..utils.convert import GENERATOR_TRANSPOSED
from .collectives import gather_cat
from .mesh import Mesh

Dims = Dict[str, Optional[int]]


def _dims(sd: Dict[str, torch.Tensor], n_model: int, transposed=()) -> Dims:
    """Each key's output-channel dim where the leaf shards, else None."""
    out = {}
    for k, v in sd.items():
        dim = 1 if k.rsplit(".", 1)[0] in transposed else 0
        out[k] = dim if v.dim() == 4 and shards_over_model(v.shape[dim], n_model) else None
    return out


def state_shardings(mesh: Mesh, state: TrainState) -> TrainState:
    """``state`` with each tensor replaced by the dim it is split on over
    the model group, or None where it is replicated: the conv weights by
    the JAX rule, Adam's ``mu`` and ``nu`` as their params, the BN
    statistics replicated.  Read from a full state, or from a shard's
    ``model_shards``."""
    if state.model_shards is not None:
        g, d = state.model_shards["params_g"], state.model_shards["params_d"]
    else:
        g = _dims(state.params_g, mesh.n_model, GENERATOR_TRANSPOSED)
        d = _dims(state.params_d, mesh.n_model)
    return state.replace(params_g=g, params_d=d,
                         batch_stats_d={k: None for k in state.batch_stats_d},
                         opt_g=dataclasses.replace(state.opt_g, mu=g, nu=g),
                         opt_d=dataclasses.replace(state.opt_d, mu=d, nu=d),
                         model_shards=None)


def _map(state: TrainState, g: Dims, d: Dims, fn, dev: torch.device) -> TrainState:
    """``state`` with ``fn(tensor, dim)`` applied to every param and Adam
    moment (``g`` / ``d``: the generator's and the discriminator's dims),
    as training-state tensors on ``dev``."""
    def each(sd, dims):
        return train_tensors({k: fn(v, dims[k]) for k, v in sd.items()}, dev)

    return state.replace(
        params_g=each(state.params_g, g), params_d=each(state.params_d, d),
        opt_g=dataclasses.replace(state.opt_g, mu=each(state.opt_g.mu, g),
                                  nu=each(state.opt_g.nu, g)),
        opt_d=dataclasses.replace(state.opt_d, mu=each(state.opt_d.mu, d),
                                  nu=each(state.opt_d.nu, d)))


def shard_state_tp(mesh: Mesh, state: TrainState) -> TrainState:
    """This rank's shard of a full ``state`` (every rank of the grid passes
    the same one, e.g. from ``replicate_state``): the model rank's slice of
    each sharded param and moment, a tensor of its own in the layout
    ``engine.state.train_tensors`` gives, the rest as it is, on the mesh's
    device.  With ``n_model`` 1 the state is returned as it is."""
    if mesh.model_group is None:
        return state
    if state.model_shards is not None:
        raise ValueError("state is already a tensor-parallel shard")
    dims = state_shardings(mesh, state)
    g, d = dims.params_g, dims.params_d
    n, r = mesh.n_model, mesh.model_rank

    def cut(t, dim):
        if dim is None:
            return t
        c = t.shape[dim] // n
        return t.narrow(dim, r * c, c).clone()

    return _map(state, g, d, cut, mesh.device).replace(
        batch_stats_d=train_tensors(state.batch_stats_d, mesh.device),
        model_shards={"params_g": g, "params_d": d})


def gather_state_tp(mesh: Mesh, state: TrainState) -> TrainState:
    """The full state from this rank's shard: every sharded param and
    moment all-gathered over the model group, on every rank of the group.
    Every rank of the grid must call it.  A full state is returned as it
    is."""
    if state.model_shards is None:
        return state

    def join(t, dim):
        return t if dim is None else gather_cat(t, mesh.model_group, dim)

    shards = state.model_shards
    return _map(state, shards["params_g"], shards["params_d"], join,
                mesh.device).replace(model_shards=None)


def build_tp_train_step(cfg: TecoConfig, mesh: Mesh, vgg_apply=None):
    """``tp_step(state, lr, hr) -> (state, metrics, gen_out)`` over the
    (data, model) grid: ``state`` is this rank's shard
    (:func:`shard_state_tp`), ``lr`` / ``hr`` its data index's share of the
    batch (``shard_batch``).  The sharded convs run column-parallel over
    the model group; D's BatchNorm statistics, the gradient and metric
    means and the D-balance decision go over the data group
    (``engine.train.build_train_step``).  The metrics are the global
    batch's, ``gen_out`` the data index's share; every rank of a model
    group returns the same replicated leaves."""
    step = build_train_step(cfg, vgg_apply, mesh.device, mesh.group, mesh.model_group)
    if mesh.model_group is None:
        return step

    def tp_step(state: TrainState, lr_batch, hr_batch):
        if state.model_shards is None:
            raise ValueError("the tensor-parallel step takes a shard (shard_state_tp)")
        return step(state, lr_batch, hr_batch)

    return tp_step
