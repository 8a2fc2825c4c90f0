"""The FNet training variant (tecogan_tpu/engine/fnet_train.py): the
FRVSR recurrence with a learned flow.

The reference ships FNet with every call site commented out and uses the
pseudo-flow instead; the JAX package implements the recurrence those call
sites sketch, and this is its port.  Per frame FNet estimates the LR flow
from (previous, current), the flow is upscaled 4x (values x4) into an HR
displacement field, the previous SR frame is warped by it, packed
space-to-depth and fed to the generator with the current LR frame.  The
step trains both on the content L2 plus ``warp_scaling`` x the LR warp
loss.  The warps are ``F.grid_sample`` with its gradient, as the JAX step
runs XLA's ``grid_sample_nchw``: no hand kernel is on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..config import TecoConfig
from ..models import Generator
from ..models.fnet import DOWN, UP, FNet
from ..ops.image import deprocess
from ..ops.resize import upscale_four
from ..ops.warp import grid_sample
from ..utils.convert import fnet_state_dict_from_jax, generator_state_dict_from_jax
from .losses import _mean_sum_w
from .state import (_compute_dtype, _conv_params, init_generator, make_optimizers,
                    resolve_device, train_tensors)


def flow_to_grid(flow_hr: torch.Tensor) -> torch.Tensor:
    """Displacement field (B, 2, H, W) in pixels -> absolute sampling grid
    (B, H, W, 2), normalized for ``align_corners=False``."""
    B, _, H, W = flow_hr.shape
    xs = torch.arange(W, dtype=torch.float32, device=flow_hr.device)
    ys = torch.arange(H, dtype=torch.float32, device=flow_hr.device)
    gx = xs[None, :] + flow_hr[:, 0].reshape(B, H, W)
    gy = ys[:, None] + flow_hr[:, 1].reshape(B, H, W)
    gx = (2.0 * gx + 1.0) / W - 1.0
    gy = (2.0 * gy + 1.0) / H - 1.0
    return torch.stack([gx, gy], dim=-1)


def _warp_nchw(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return grid_sample(image.permute(0, 2, 3, 1), grid).permute(0, 3, 1, 2)


def fnet_flow(fnet: FNet, params_f, prev_lr_nchw: torch.Tensor,
              cur_lr_nchw: torch.Tensor) -> torch.Tensor:
    """The LR flow of a frame pair, upscaled to the HR displacement
    (B, 2, 4H, 4W)."""
    pair = torch.cat([prev_lr_nchw, cur_lr_nchw], dim=1).permute(0, 2, 3, 1)
    flow_lr = functional_call(fnet, params_f, (pair,)).permute(0, 3, 1, 2)
    return upscale_four(flow_lr * 4.0)


class FnetUnroll(NamedTuple):
    gen_outputs: torch.Tensor  # (B, T, 3, 4H, 4W)
    warp_loss: torch.Tensor    # mean over the T - 1 steps


def fnet_generator_unroll(gen: Generator, fnet: FNet, params_g, params_f,
                          r_inputs: torch.Tensor, cfg: TecoConfig) -> FnetUnroll:
    """The recurrence over (B, T, 3, H, W) LR frames in [0, 1]: per frame,
    warp the previous SR frame by FNet's flow, space-to-depth, concat,
    generate; and the LR warp loss of the previous frame by the flow."""
    B, T, C, H, W = r_inputs.shape

    def apply_gen(inp_nchw):
        out = functional_call(gen, params_g, (inp_nchw.permute(0, 2, 3, 1),))
        return out.permute(0, 3, 1, 2)

    sr = apply_gen(torch.cat([r_inputs[:, 0], r_inputs.new_zeros((B, 48, H, W))], dim=1))
    outputs, warp_losses = [sr], []
    for t in range(1, T):
        prev_lr, cur_lr = r_inputs[:, t - 1], r_inputs[:, t]
        flow_hr = fnet_flow(fnet, params_f, prev_lr, cur_lr)
        warped = _warp_nchw(sr, flow_to_grid(flow_hr))
        feedback = F.pixel_unshuffle(deprocess(warped), 4)
        sr = apply_gen(torch.cat([cur_lr, feedback], dim=1))
        outputs.append(sr)
        # the LR warp loss drives FNet (the FRVSR objective)
        prev_warp_lr = _warp_nchw(prev_lr, flow_to_grid(flow_hr[:, :, ::4, ::4] / 4.0))
        warp_losses.append(_mean_sum_w(torch.square(cur_lr - prev_warp_lr)))
    return FnetUnroll(torch.stack(outputs, dim=1), torch.mean(torch.stack(warp_losses)))


def init_fnet(generator: torch.Generator, in_channels: int = 6) -> Dict[str, Any]:
    """Random FNet params in the flax layout (torch's conv init, as the
    JAX package's layers draw them), from ``generator``."""
    params: Dict[str, Any] = {}
    ch = in_channels
    for prefix, widths in (("_DownBlock", DOWN), ("_UpBlock", UP)):
        for i, f in enumerate(widths):
            params[f"{prefix}_{i}"] = {"Conv_0": _conv_params(generator, ch, f),
                                       "Conv_1": _conv_params(generator, f, f)}
            ch = f
    params["Conv_0"] = _conv_params(generator, ch, 32)
    params["Conv_1"] = _conv_params(generator, 32, 2)
    return params


def fnet_state_from_params(cfg: TecoConfig, params_g, params_f, device=None) -> Dict[str, Any]:
    """A fresh FNet-variant state (zero moments, step and epoch 0) on
    ``device`` from flax-layout trees of both models' weights."""
    dev = resolve_device(device)
    opt_g, opt_f, _ = make_optimizers(cfg)
    pg = train_tensors(generator_state_dict_from_jax(params_g), dev)
    pf = train_tensors(fnet_state_dict_from_jax(params_f), dev)
    return {"params_g": pg, "params_f": pf, "opt_g": opt_g.init(pg, cfg.learning_rate),
            "opt_f": opt_f.init(pf, cfg.learning_rate), "step": 0, "epoch": 0}


def build_fnet_train_step(cfg: TecoConfig, device=None):
    """The generator + FNet step (content L2 + ``warp_scaling`` x the warp
    loss) on ``device`` (default: the card).  Returns ``(init, step)``:

    * ``init(generator) -> state``: random weights for both models from a
      seeded ``torch.Generator``, a dict with ``params_g`` / ``params_f``
      (float32 ``state_dict``s), their Adam states ``opt_g`` / ``opt_f``,
      ``step`` and ``epoch`` (:func:`fnet_state_from_params`).
    * ``step(state, lr_batch, hr_batch) -> (state, metrics)`` with lr_batch
      (B, T, 3, H, W), hr_batch (B, T, 3, 4H, 4W) float32 in [0, 1];
      ``metrics``: ``l2_content_loss``, ``l2_warp_loss``, ``gen_loss``,
      ``learning_rate``.

    G takes make_optimizers' first Adam and FNet its second, both at the
    schedule's rate: the JAX step sets the second optimizer's injected
    rate to it, so D's 0.3 (``Dt_mergeDs`` off) does not apply to FNet."""
    dev = resolve_device(device)
    dtype = _compute_dtype(cfg)
    gen = Generator(num_resblock=cfg.num_resblock, out_channels=3, dtype=dtype).to(dev)
    fnet = FNet(dtype=dtype).to(dev)
    opt_g, opt_f, sched = make_optimizers(cfg)
    opt_f = dataclasses.replace(opt_f, lr_scale=1.0)

    def init(generator: torch.Generator) -> Dict[str, Any]:
        return fnet_state_from_params(cfg, init_generator(cfg, generator),
                                      init_fnet(generator), dev)

    def step(state: Dict[str, Any], lr_batch: torch.Tensor, hr_batch: torch.Tensor):
        lr_batch, hr_batch = lr_batch.to(dev), hr_batch.to(dev)
        lr_now = sched(state["epoch"])
        params_g = {k: v.detach().requires_grad_() for k, v in state["params_g"].items()}
        params_f = {k: v.detach().requires_grad_() for k, v in state["params_f"].items()}
        unroll = fnet_generator_unroll(gen, fnet, params_g, params_f, lr_batch, cfg)
        B, T = lr_batch.shape[:2]
        H4 = lr_batch.shape[3] * 4
        s_gen = unroll.gen_outputs.reshape(B * T, 3, H4, -1)
        s_tgt = hr_batch.reshape(B * T, 3, H4, -1)
        content = _mean_sum_w(torch.square(s_gen - s_tgt))
        loss = content + cfg.warp_scaling * unroll.warp_loss
        leaves = list(params_g.values()) + list(params_f.values())
        grads = torch.autograd.grad(loss, leaves)
        grads_g = dict(zip(params_g, grads[:len(params_g)]))
        grads_f = dict(zip(params_f, grads[len(params_g):]))
        new_g, opt_g_state = opt_g.update(state["params_g"], grads_g, state["opt_g"], lr_now)
        new_f, opt_f_state = opt_f.update(state["params_f"], grads_f, state["opt_f"], lr_now)
        metrics = {"l2_content_loss": content.detach(),
                   "l2_warp_loss": unroll.warp_loss.detach(), "gen_loss": loss.detach(),
                   "learning_rate": torch.tensor(np.float32(lr_now), device=dev)}
        return ({"params_g": new_g, "params_f": new_f, "opt_g": opt_g_state,
                 "opt_f": opt_f_state, "step": state["step"] + 1,
                 "epoch": state["epoch"]}, metrics)

    return init, step
