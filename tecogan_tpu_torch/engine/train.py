"""The TecoGAN train step (tecogan_tpu/engine/train.py).

One step: the generator unroll, the triplet assembly, both losses and
both Adam updates.  The G gradient is ``torch.autograd.grad`` of the full
objective with respect to G's params alone (D's params are frozen in that
pass); the D gradient re-runs only the discriminator on the detached
triplet inputs with the pre-step D params.  The step is functional: it
returns a new ``TrainState`` and leaves the one it was given as it was.

With a data-parallel process ``group`` (parallel/dp.py) each rank runs
the step on its share of the batch: D's BatchNorm statistics are the
global batch's (``models.layers.BatchNorm``), the gradients of both
objectives and every metric are averaged over the ranks (one all-reduce
each) before Adam and before the D-balance gate, so every rank takes the
same decision and holds the same state.  Since every loss is a mean over
equal shares, that is the single-process step on the global batch.

With a ``model_group`` as well (parallel/tp.py) the state holds this
rank's slices of the channel-sharded conv weights and their moments, and
those convs run column-parallel over the model group
(``models.layers.set_model_group``); the data-parallel collectives above
stay on ``group``, the ranks with this rank's channel slice.  Every rank
of the model group computes the replicated leaves' gradients itself, and
on the card a backward may sum in another order on each (cuDNN's weight
gradients, ``grid_sample``'s atomics): one more mean, over the model
group, of those gradients keeps the replicated leaves equal on its ranks.

The phases run under the port's spans (``utils/spans.py``, recorded only
under a running profiler): ``teco.gen_objective``, ``teco.gen_backward``,
``teco.disc_step``, ``teco.adam``, and ``teco.all_reduce`` with a group,
which ``tools/profile_train.py`` reads.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..config import TecoConfig
from ..models.layers import set_model_group
from ..ops.image import transfer_dequantize_f32
from ..utils.spans import span
from .losses import discriminator_loss, tecogan_losses
from .state import TrainState, make_optimizers, resolve_device, train_model_defs


def _leaves(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def _batch(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A clip on the step's device; uint8 dequantizes there."""
    x = x.to(dev, non_blocking=True)
    return transfer_dequantize_f32(x) if x.dtype == torch.uint8 else x


def _rank_mean(tensors: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each tensor's mean over the group's ranks, by one all-reduce of
    their float32 concatenation; the results keep each tensor's layout."""
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= group.size()
    out, off = {}, 0
    for k in keys:
        t = tensors[k]
        out[k] = torch.empty_like(t).copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def build_train_step(cfg: TecoConfig, vgg_apply=None, device=None, group=None,
                     model_group=None):
    """Returns ``train_step(state, lr_batch, hr_batch) -> (state, metrics,
    gen_outputs)`` on ``device`` (default: the card, see
    ``engine.state.resolve_device``).

    lr_batch: (B, T, 3, H, W), hr_batch: (B, T, 3, 4H, 4W), float32 in
    [0, 1] or uint8 (dequantized on the device).  ``metrics`` holds the
    JAX step's keys as 0-d float32 tensors on the device;
    ``gen_outputs`` is (B, T', 3, 4H, 4W), detached.

    ``group``: a data-parallel process group (see the module's
    docstring); the batches are then this rank's share of equal size,
    the metrics the global means and ``gen_outputs`` this rank's.
    ``model_group``: the tensor-parallel group (``parallel.tp``), whose
    ranks see the same samples; the state is then this rank's shard
    (``parallel.tp.shard_state_tp``)."""
    dev = resolve_device(device)
    gen, disc = train_model_defs(cfg, device=dev)
    if model_group is not None:
        sharded = {"g": set_model_group(gen, model_group),
                   "d": set_model_group(disc, model_group)}
    opt_g, opt_d, sched = make_optimizers(cfg)

    def train_step(state: TrainState, lr_batch: torch.Tensor,
                   hr_batch: torch.Tensor):
        lr_batch, hr_batch = _batch(lr_batch, dev), _batch(hr_batch, dev)
        lr_now = sched(state.epoch)

        params_g = _leaves(state.params_g)
        with span("gen_objective"):
            gen_loss, aux = tecogan_losses(
                gen, disc, params_g, state.params_d, state.batch_stats_d,
                lr_batch, hr_batch, state.step, cfg, vgg_apply, group)
        with span("gen_backward"):
            grads_g = dict(zip(params_g, torch.autograd.grad(
                gen_loss, list(params_g.values()))))

        with span("disc_step"):
            params_d = _leaves(state.params_d)
            d_loss, new_stats = discriminator_loss(
                disc, params_d, state.batch_stats_d, aux["real_in"],
                aux["fake_in"], cfg, group)
            grads_d = dict(zip(params_d, torch.autograd.grad(
                d_loss, list(params_d.values()))))

        metrics = {k: v.detach() for k, v in aux["metrics"].items()}
        metrics["d_loss"] = d_loss.detach()
        metrics["gen_loss"] = gen_loss.detach()
        if group is not None:
            with span("all_reduce"):
                grads_g = _rank_mean(grads_g, group)
                grads_d = _rank_mean(grads_d, group)
                # Dst_ratio is the same on every rank: kept out of the mean
                metrics.update(_rank_mean(
                    {k: v for k, v in metrics.items() if k != "Dst_ratio"}, group))
        if model_group is not None:
            with span("all_reduce"):
                grads = {"g": grads_g, "d": grads_d}
                replicated = _rank_mean({(m, k): v for m, gr in grads.items()
                                         for k, v in gr.items() if k not in sharded[m]},
                                        model_group)
                for (m, k), v in replicated.items():
                    grads[m][k] = v
        # D-balance gating, active with bug_parity off: skip the D update
        # while the balance EMA says D is winning (the reference threads
        # counter1/counter2 but gates nothing)
        if cfg.bug_parity:
            apply_d = torch.ones((), dtype=torch.bool, device=dev)
        else:
            apply_d = metrics["t_balance"] < cfg.Dbalance
        with span("adam"):
            new_g, opt_g_state = opt_g.update(state.params_g, grads_g,
                                              state.opt_g, lr_now)
            new_d, opt_d_state = opt_d.update(
                state.params_d, grads_d, state.opt_d, lr_now,
                apply=None if cfg.bug_parity else apply_d)

        metrics["learning_rate"] = torch.full((), lr_now, dtype=torch.float32,
                                              device=dev)
        metrics["withD_counter"] = apply_d.float()
        metrics["w_o_D_counter"] = 1.0 - apply_d.float()

        new_state = state.replace(params_g=new_g, params_d=new_d,
                                  batch_stats_d=new_stats, opt_g=opt_g_state,
                                  opt_d=opt_d_state, step=state.step + 1)
        return new_state, metrics, aux["gen_outputs"].detach()

    return train_step


def build_multi_train_step(cfg: TecoConfig, vgg_apply=None, device=None, group=None):
    """K = ``cfg.steps_per_dispatch`` train steps per call:
    ``multi_step(state, lr_k, hr_k) -> (state, metrics, last_gen_out)``
    with lr_k (K, B, T, 3, H, W) / hr_k (K, B, T, 3, 4H, 4W); every metric
    comes back stacked on a leading K axis (``metrics[...][k]`` is step
    k).  ``group`` as in :func:`build_train_step`."""
    k = int(cfg.steps_per_dispatch)
    if k <= 1:
        raise ValueError("build_multi_train_step requires steps_per_dispatch > 1")
    step = build_train_step(cfg, vgg_apply, device, group)

    def multi_step(state: TrainState, lr_k: torch.Tensor, hr_k: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor], torch.Tensor]:
        if lr_k.shape[0] != k or hr_k.shape[0] != k:
            raise ValueError(f"expected {k} batches, got {lr_k.shape[0]} and "
                             f"{hr_k.shape[0]}")
        per_step = []
        for i in range(k):
            state, metrics, gen_out = step(state, lr_k[i], hr_k[i])
            per_step.append(metrics)
        stacked = {name: torch.stack([m[name] for m in per_step])
                   for name in per_step[0]}
        return state, stacked, gen_out

    return multi_step


def set_epoch(state: TrainState, epoch: int) -> TrainState:
    """The state at ``epoch`` (it drives the StepLR schedule)."""
    return state.replace(epoch=int(epoch))
