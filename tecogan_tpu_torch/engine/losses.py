"""The TecoGAN losses (tecogan_tpu/engine/losses.py): the generator
unroll, the discriminator triplets, both objectives and every
``bug_parity`` quirk.

Layout: the interfaces take the reference's logical NCHW clip shapes
``(B, T, 3, H, W)``, so the raw ``view`` reinterpretations the reference
relies on are ``reshape``s in logical (C) order -- ``reshape`` copies
when the memory is not contiguous, and nothing here calls ``view``.
The models run NHWC at their interfaces, their convs in the layout of
the state's params (``engine.state.train_tensors``).

``cfg.bug_parity`` selects the reference's behaviour:
  * the generator input detached every frame -- no BPTT;
  * the adversarial and feature-matching terms detached on the G side,
    so G trains on the content L2 alone;
  * fp16 rounding of the warp grids;
  * the per-step-reinstantiated EMA ``tb = 0.99 * t_balance``, the
    ``alias_mult = 2`` doubling and the ``*_avg`` shadow chain.
With ``bug_parity=False`` gradients flow through the recurrence and the
adversarial and feature terms.

Both warps are ``F.grid_sample`` (bilinear, zeros, ``align_corners=False``);
the JAX package's exact and patch samplers compute the same function.
The models run through ``torch.func.functional_call`` with the state's
params, so the state stays a set of plain tensors.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..config import TecoConfig
from ..ops.image import deprocess, preprocess
from ..ops.resize import upscale_four
from ..ops.warp import grid_sample, round_through_half

Tensors = Dict[str, torch.Tensor]

VGG_LAYER_LABELS = ("vgg_19/conv2_2", "vgg_19/conv3_4", "vgg_19/conv4_4")
D_LAYER_NORM = (12.0, 14.0, 24.0, 100.0)  # train.py:214
FIX_RANGE = 0.02  # train.py:206
BN_MOMENTUM = 0.9  # flax momentum == torch momentum 0.1


class UnrollResult(NamedTuple):
    gen_outputs: torch.Tensor  # (B, T, 3, 4H, 4W)
    gen_flow: torch.Tensor     # (B, T-1, 2, 4H, 4W) pseudo-flow
    warp_loss: torch.Tensor    # scalar LR self-warp metric


def _mean_sum_w(x: torch.Tensor) -> torch.Tensor:
    """torch ``mean(sum(., dim=3))`` on NCHW: the sum over width only."""
    return torch.mean(torch.sum(x, dim=3))


def _warp_nchw(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return grid_sample(image.permute(0, 2, 3, 1), grid).permute(0, 3, 1, 2)


def pingpang_extend(clip: torch.Tensor) -> torch.Tensor:
    """Mirror-concat a (B, T, ...) clip to 2T-1 frames."""
    return torch.cat([clip, torch.flip(clip, dims=(1,))[:, 1:]], dim=1)


def pseudo_flow_sequence(r_inputs: torch.Tensor) -> torch.Tensor:
    """All T-1 pseudo-flows: ``upscale_four(Frame_t_pre * 4)[:, 0:2]``
    as (B, T-1, 2, 4H, 4W)."""
    B, T, C, H, W = r_inputs.shape
    frames_pre = r_inputs[:, :-1].reshape(B * (T - 1), C, H, W)
    up = upscale_four(frames_pre * 4.0)
    return up[:, 0:2].reshape(B, T - 1, 2, 4 * H, 4 * W)


def flows_to_grids(gen_flow: torch.Tensor, parity_half: bool) -> torch.Tensor:
    """Per-frame raw ``view(B, 4H, 4W, 2)`` of each (B, 2, 4H, 4W) slice --
    a C-order reinterpretation, not a transpose; ``parity_half`` rounds
    it through fp16."""
    B, Tm1, _, H4, W4 = gen_flow.shape
    grids = gen_flow.reshape(B, Tm1, H4, W4, 2)
    if parity_half:
        grids = round_through_half(grids)
    return grids


def recurrent_feedback(prev_sr: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp the previous SR output (B, 3, 4H, 4W) by the pseudo-flow grid,
    deprocess, and pack it space-to-depth into 48 LR channels."""
    return F.pixel_unshuffle(deprocess(_warp_nchw(prev_sr, grid)), 4)


def generator_unroll(gen, params_g: Tensors, r_inputs: torch.Tensor,
                     cfg: TecoConfig) -> UnrollResult:
    """Run the recurrent generator over the (possibly ping-pong-extended)
    clip, a Python loop over T; ``cfg.remat`` recomputes each later frame
    in the backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` on
    the scan step.  r_inputs: (B, T, 3, H, W) in [0, 1]."""
    B, T, C, H, W = r_inputs.shape
    gen_flow = pseudo_flow_sequence(r_inputs)
    grids = flows_to_grids(gen_flow, parity_half=cfg.bug_parity)

    def apply_gen(inp):
        if cfg.bug_parity:
            inp = inp.detach()  # the reference cuts the recurrence
        x = inp.permute(0, 2, 3, 1)
        return functional_call(gen, params_g, (x,)).permute(0, 3, 1, 2)

    def step_fn(prev_sr, frame, grid):
        return apply_gen(torch.cat([frame, recurrent_feedback(prev_sr, grid)], dim=1))

    sr = apply_gen(torch.cat([r_inputs[:, 0], r_inputs.new_zeros((B, 48, H, W))], dim=1))
    outputs = [sr]
    for t in range(1, T):
        if cfg.remat:
            sr = checkpoint(step_fn, sr, r_inputs[:, t], grids[:, t - 1],
                            use_reentrant=False)
        else:
            sr = step_fn(sr, r_inputs[:, t], grids[:, t - 1])
        outputs.append(sr)
    gen_outputs = torch.stack(outputs, dim=1)

    # LR self-warp metric (train.py:81-84, 247-251): Frame_t_pre warped by
    # the raw-reshaped RG channels of Frame_t; logged, never optimized
    frames_pre = r_inputs[:, :-1].reshape(B * (T - 1), C, H, W)
    frames_nxt = r_inputs[:, 1:]
    warp_grid = frames_nxt[:, :, 0:2].reshape(B * (T - 1), H, W, 2)
    s_input_warp = _warp_nchw(frames_pre, warp_grid)
    input_frames = frames_nxt.reshape(B * (T - 1), C, H, W)
    warp_loss = _mean_sum_w(torch.square(input_frames - s_input_warp))
    return UnrollResult(gen_outputs, gen_flow, warp_loss)


def d_input_spec(cfg: TecoConfig) -> Tuple[int, int]:
    """(channels, spatial size) of the discriminator input: 27 channels at
    4*crop_size when merged (crop_dt crops then zero-pads back); the
    9-channel warped triplet at the cropped size when ``Dt_mergeDs`` is
    off."""
    h4 = 4 * cfg.crop_size
    if cfg.Dt_mergeDs:
        return 27, h4
    if cfg.crop_dt < 1.0:
        c = int(h4 * cfg.crop_dt)
        off = (h4 - c) // 2
        return 9, h4 - 2 * off
    return 9, h4


def _global_rows(x: torch.Tensor, b: int, group) -> torch.Tensor:
    """Rows ``[r b, (r + 1) b)`` of the group's ranks' ``x`` joined along
    dim 0 in rank order, r this rank: the rows a rank's ``b`` samples read
    where the reference's reshape crosses samples."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x.contiguous(), group=group)
    r = dist.get_rank(group)
    return torch.cat(parts)[r * b:(r + 1) * b]


def assemble_triplets(r_inputs: torch.Tensor, r_targets: torch.Tensor,
                      gen_outputs: torch.Tensor, gen_flow: torch.Tensor,
                      cfg: TecoConfig, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The real/fake discriminator inputs (train.py:129-199), NCHW.

    Merged (``Dt_mergeDs``, default): 27-channel triplets of [before-warp,
    warped by T_vel, bilinear-upscaled LR], the warped part center-cropped
    by crop_dt and zero-padded back.  Unmerged: the 9-channel warped
    triplet alone at the cropped size.  fake_in carries gradients to the
    generator; detaching is the caller's choice.  With a data-parallel
    ``group`` the batch is this rank's share of the global one; the
    ``bug_parity`` backward flow, whose reshape reads other samples' rows,
    reads them from the global batch."""
    B, T, C, H, W = r_inputs.shape
    H4, W4 = 4 * H, 4 * W
    t_size = 3 * (T // 3)
    n_trip = t_size // 3
    t_batch = B * n_trip

    t_gen = gen_outputs[:, :t_size].reshape(B * t_size, 3, H4, W4)
    t_tgt = r_targets[:, :t_size].reshape(B * t_size, 3, H4, W4)

    # velocity triplet T_vel (train.py:138-158)
    v_pre = gen_flow[:, 0:t_size:3]  # (B, n_trip, 2, H4, W4)
    v_mid = torch.zeros_like(v_pre)
    if cfg.pingpang:
        v_nxt = torch.flip(gen_flow, dims=(1,))[:, 1:t_size:3]
    elif cfg.bug_parity:
        # the reference's "backward flow": the raw-reshaped concat of
        # frames [2::3] and [1::3], first B rows only, upscaled; its
        # reshape splits 2*C = 6 channels into (t_size//3, 2), which only
        # type-checks at t_size//3 == 3
        if n_trip != 3:
            raise ValueError(
                "bug_parity GAN branch requires RNN_N in 9..11 (the "
                "reference's backward-flow reshape at train.py:144 assumes "
                f"t_size//3 == 3; got t_size={t_size})")
        back = torch.cat([r_inputs[:, 2:t_size:3], r_inputs[:, 1:t_size:3]],
                         dim=1).reshape(t_batch, 2 * C, H, W)
        # rows 0:B of the global batch's back; its rows b read sample b // 3
        back = back[0:B] if group is None else _global_rows(back, B, group)
        back_up = upscale_four(back * 4.0)
        v_nxt = preprocess(back_up.reshape(B, n_trip, 2, H4, W4))
    else:
        # intended semantics (any T): the backward pseudo-flow of triplet
        # k from its last frame, as the forward construction
        last = r_inputs[:, 2:t_size:3].reshape(B * n_trip, C, H, W)
        v_nxt = upscale_four(last * 4.0)[:, 0:2].reshape(B, n_trip, 2, H4, W4)

    t_vel = torch.stack([v_pre, v_mid, v_nxt], dim=2)  # (B, n_trip, 3, 2, H4, W4)
    t_vel = t_vel.reshape(B * t_size, H4, W4, 2).detach()  # raw view (train.py:157)

    if cfg.crop_dt < 1.0:
        crop_dt = int(H4 * cfg.crop_dt)
        off = (H4 - crop_dt) // 2
        crop_dt = H4 - off * 2

    def crop(x):
        if cfg.crop_dt >= 1.0:
            return x
        return x[:, :, off:off + crop_dt, off:off + crop_dt]

    def crop_pad(x):
        if cfg.crop_dt >= 1.0:
            return x
        return F.pad(crop(x), (off, off, off, off))

    real_warp = _warp_nchw(t_tgt, t_vel).reshape(t_batch, 9, H4, W4)
    # T_vel.half() (train.py:187)
    fake_vel = round_through_half(t_vel) if cfg.bug_parity else t_vel
    fake_warp = _warp_nchw(t_gen, fake_vel).reshape(t_batch, 9, H4, W4)

    if not cfg.Dt_mergeDs:
        return crop(real_warp), crop(fake_warp)

    before_warp = t_tgt.reshape(t_batch, 9, H4, W4)
    t_input = r_inputs[:, :t_size].reshape(t_batch, 9, H, W)
    input_hi = upscale_four(t_input)
    real_in = torch.cat([before_warp, crop_pad(real_warp), input_hi], dim=1)
    # the reference reuses the *target* before_warp for the fake triplet
    fake_in = torch.cat([before_warp, crop_pad(fake_warp), input_hi], dim=1)
    return real_in, fake_in


def apply_discriminator(disc, params_d: Tensors, batch_stats: Tensors,
                        x_nchw: torch.Tensor, mutable: bool, group=None
                        ) -> Tuple[torch.Tensor, List[torch.Tensor], Tensors]:
    """D on an NCHW input with train-mode batch statistics.  Returns
    (score, layers, stats): ``stats`` is ``batch_stats`` advanced by this
    batch (``0.9 * old + 0.1 * batch``) when ``mutable``, else
    ``batch_stats`` as given.  ``group``: the data-parallel process group,
    whose global batch the statistics are (``models.layers.BatchNorm``)."""
    x = x_nchw.permute(0, 2, 3, 1)
    score, layers, batch = functional_call(disc, params_d, (x,), {"group": group})
    if not mutable:
        return score, layers, batch_stats
    new = {k: BN_MOMENTUM * v + (1.0 - BN_MOMENTUM) * batch[k]
           for k, v in batch_stats.items()}
    return score, layers, new


def d_layer_loss(real_layers, fake_layers, cfg: TecoConfig
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Feature-matching loss over D's 4 intermediate maps (NHWC).  The
    real side is detached; parity mode detaches the fake side too, so the
    term is a pure metric there."""
    losses = []
    total = 0.0
    for i, (rl, fl) in enumerate(zip(real_layers, fake_layers)):
        rl = rl.detach()
        if cfg.bug_parity:
            fl = fl.detach()
        # torch sums dim=3 (width) of NCHW == axis 2 of NHWC
        ll = torch.mean(torch.sum(torch.abs(rl.float() - fl.float()), dim=2))
        losses.append(ll)
        total = total + FIX_RANGE * ll / D_LAYER_NORM[i]
    return total, losses


def vgg_perceptual_loss(vgg_apply, s_gen_nchw: torch.Tensor,
                        s_tgt_nchw: torch.Tensor) -> torch.Tensor:
    """Perceptual loss over the reference's three VGG taps, the fixed
    formulation: ``mean(1 - cos)`` of unit-normalized features.
    ``vgg_apply(images_nhwc, labels) -> {label: features_nhwc}``."""
    gen_feats = vgg_apply(s_gen_nchw.permute(0, 2, 3, 1), VGG_LAYER_LABELS)
    tgt_feats = vgg_apply(s_tgt_nchw.permute(0, 2, 3, 1), VGG_LAYER_LABELS)
    vgg_loss = 0.0
    for name in VGG_LAYER_LABELS:
        vgg_loss = vgg_loss + torch.mean(
            1.0 - torch.sum(gen_feats[name] * tgt_feats[name], dim=3))
    return vgg_loss


def _f32(x: float) -> float:
    """``x`` rounded to float32, the JAX package's scalar arithmetic."""
    return float(torch.tensor(x, dtype=torch.float32))


def tecogan_losses(gen, disc, params_g: Tensors, params_d: Tensors,
                   batch_stats_d: Tensors, r_inputs: torch.Tensor,
                   r_targets: torch.Tensor, step: int, cfg: TecoConfig,
                   vgg_apply=None, group=None):
    """The full TecoGAN objective (train.py:49-348).  Returns (gen_loss,
    aux): aux holds the metrics, the generator outputs and the detached
    D inputs ``real_in`` / ``fake_in``.  ``params_d`` should not require
    grad: D is frozen here, and its running statistics are left as given.
    ``group``: the data-parallel group of D's BN statistics; the loss and
    the metrics are this rank's (engine/train.py reduces them)."""
    if cfg.pingpang:
        r_inputs = pingpang_extend(r_inputs)
        r_targets = pingpang_extend(r_targets)
    B, T, C, H, W = r_inputs.shape
    H4, W4 = 4 * H, 4 * W

    unroll = generator_unroll(gen, params_g, r_inputs, cfg)
    gen_outputs = unroll.gen_outputs
    s_gen = gen_outputs.reshape(B * T, 3, H4, W4)
    s_tgt = r_targets.reshape(B * T, 3, H4, W4)

    metrics: Dict[str, torch.Tensor] = {}
    content_loss = _mean_sum_w(torch.square(s_gen - s_tgt))
    metrics["l2_content_loss"] = content_loss
    gen_loss = content_loss
    metrics["l2_warp_loss"] = unroll.warp_loss

    real_in, fake_in = assemble_triplets(r_inputs, r_targets, gen_outputs,
                                         unroll.gen_flow, cfg, group)
    real_score, real_layers, _ = apply_discriminator(
        disc, params_d, batch_stats_d, real_in, mutable=False, group=group)
    fake_score, fake_layers, _ = apply_discriminator(
        disc, params_d, batch_stats_d, fake_in, mutable=False, group=group)

    if cfg.D_LAYERLOSS:
        sum_layer_loss, layer_losses = d_layer_loss(real_layers, fake_layers, cfg)
        for i, ll in enumerate(layer_losses):
            metrics[f"D_layer_{i}_loss"] = ll
        metrics["D_layer_loss_sum"] = sum_layer_loss

    if cfg.vgg_scaling > 0.0 and vgg_apply is not None:
        vgg_loss = vgg_perceptual_loss(vgg_apply, s_gen, s_tgt)
        gen_loss = gen_loss + cfg.vgg_scaling * vgg_loss
        metrics["vgg_all"] = vgg_loss

    # the reference's aliasing quirk: gen_loss and fnet_loss bind one
    # tensor and += is in place, so the ping-pong and adversarial terms
    # land twice (detached in parity mode, so grads are unaffected)
    alias_mult = 2.0 if cfg.bug_parity else 1.0

    if cfg.pingpang:
        first = gen_outputs[:, 0:cfg.RNN_N - 1]
        last_rev = torch.flip(gen_outputs, dims=(1,))[:, 0:cfg.RNN_N - 1]
        pploss = torch.mean(torch.abs(first - last_rev))
        if cfg.pp_scaling > 0:
            gen_loss = gen_loss + alias_mult * pploss * cfg.pp_scaling
        metrics["PingPang"] = pploss

    eps = cfg.EPS
    fake_for_gen = fake_score.detach() if cfg.bug_parity else fake_score
    t_adversarial_loss = torch.mean(-torch.log(fake_for_gen + eps))
    d_adversarial_loss = torch.mean(-torch.log(fake_score + eps))
    # Global_step += 1 (train.py:52), the ratio in float32
    dt_ratio = min(_f32(cfg.Dt_ratio_max),
                   _f32(_f32(cfg.Dt_ratio_0) + _f32(_f32(cfg.Dt_ratio_add) * float(step + 1))))
    gen_loss = gen_loss + alias_mult * cfg.ratio * t_adversarial_loss
    metrics["t_adversarial_loss"] = t_adversarial_loss
    if cfg.D_LAYERLOSS:
        gen_loss = gen_loss + sum_layer_loss * dt_ratio

    t_discrim_loss = torch.mean(
        -(torch.log(1.0 - fake_score + eps) + torch.log(real_score + eps)))
    t_balance = torch.mean(torch.log(real_score + eps)) + d_adversarial_loss
    tb = 0.99 * t_balance  # the per-step-reinstantiated EMA (train.py:324-327)

    metrics["t_discrim_loss"] = t_discrim_loss
    metrics["t_discrim_real_output"] = torch.mean(real_score)
    metrics["t_discrim_fake_output"] = torch.mean(fake_score)
    metrics["All_loss_Gen"] = gen_loss
    if cfg.bug_parity:
        # the aliased tensor in update_list reads as the final gen loss
        metrics["l2_content_loss_true"] = metrics["l2_content_loss"]
        metrics["l2_content_loss"] = gen_loss
    metrics["t_balance"] = tb
    metrics["Dst_ratio"] = torch.full((), dt_ratio, dtype=torch.float32,
                                      device=gen_loss.device)

    if cfg.bug_parity:
        # one shadow slot forward()'d over the whole update_list in the
        # reference's order: avg_i = 0.99 * x_i + 0.01 * avg_{i-1}
        chain = []
        if cfg.D_LAYERLOSS:
            chain += [f"D_layer_{i}_loss" for i in range(4)] + ["D_layer_loss_sum"]
        chain += ["l2_content_loss", "l2_warp_loss"]
        if "vgg_all" in metrics:
            chain += ["vgg_all"]
        if cfg.pingpang:
            chain += ["PingPang"]
        chain += ["t_adversarial_loss", "t_discrim_loss", "t_discrim_real_output",
                  "t_discrim_fake_output", "All_loss_Gen"]
        shadow = 0.0
        for k in chain:
            shadow = 0.99 * metrics[k] + 0.01 * shadow
            metrics[f"{k}_avg"] = shadow

    aux = {"metrics": metrics, "gen_outputs": gen_outputs,
           "real_in": real_in.detach(), "fake_in": fake_in.detach()}
    return gen_loss, aux


def discriminator_loss(disc, params_d: Tensors, batch_stats_d: Tensors,
                       real_in: torch.Tensor, fake_in: torch.Tensor,
                       cfg: TecoConfig, group=None) -> Tuple[torch.Tensor, Tensors]:
    """The D objective: the log loss on real/fake triplets; the running
    BN statistics advance real, then fake, as the reference's call order
    (train.py:181,199).  Returns (loss, new batch_stats); ``group`` as in
    :func:`tecogan_losses`."""
    real_score, _, stats1 = apply_discriminator(disc, params_d, batch_stats_d,
                                                real_in, mutable=True, group=group)
    fake_score, _, stats2 = apply_discriminator(disc, params_d, stats1,
                                                fake_in, mutable=True, group=group)
    eps = cfg.EPS
    loss = torch.mean(-(torch.log(1.0 - fake_score + eps) + torch.log(real_score + eps)))
    return loss, stats2
