"""Test-time (zero-shot) adaptation of the generator to one clip
(tecogan_tpu/engine/adapt.py).

ZSSR-style internal learning (Shocher et al. 2018): from the clip being
served alone, build LR -> LR/4 training pairs and fine-tune the generator
for a few hundred steps before serving the 4x task.

* internal pairs: HR' = the LR clip, LR' = its antialiased bilinear /4,
  augmented by the 8 flip x time-reversal symmetries;
* serving-scale LR-consistency: ``|| down4(G(lr_clip)) - lr_clip ||^2``
  through the network at the real serving scale.

:func:`lr_consistency_refine` is the post-hoc (no-training) form.

Each step takes the gradient of the two terms in two backward passes
and sums them: the gradient of the JAX package's one objective, with
only one unroll's activations alive at a time.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import TecoConfig
from ..ops.metrics import psnr_per_frame, ssim
from ..ops.resize import resize_bicubic, resize_bilinear_aa
from .losses import generator_unroll
from .state import (Adam, cosine_decay_schedule, float_params, model_defs, resolve_device,
                    train_tensors)


def _augment_windows(clip_thwc: np.ndarray, rnn_n: int) -> np.ndarray:
    """Split a (T, H, W, 3) clip into rnn_n-frame windows (tail window
    end-aligned) and expand each by the 8 flip/time symmetries.

    Returns (N, rnn_n, H, W, 3)."""
    T = clip_thwc.shape[0]
    rnn_n = min(rnn_n, T)
    starts = list(range(0, T - rnn_n + 1, rnn_n))
    if starts[-1] != T - rnn_n:
        starts.append(T - rnn_n)
    out = []
    for s in starts:
        win = clip_thwc[s : s + rnn_n]
        for flip_h in (False, True):
            for flip_v in (False, True):
                v = win
                if flip_h:
                    v = v[:, :, ::-1]
                if flip_v:
                    v = v[:, ::-1]
                out.append(v)
                out.append(v[::-1])  # time reversal
    return np.ascontiguousarray(np.stack(out))


def _device(x, device) -> torch.device:
    """``device`` if named, else the device of the tensor ``x``, else the
    card (``resolve_device``)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _down4(x: torch.Tensor) -> torch.Tensor:
    """(..., h, w) antialiased bilinear /4, the pair builder's degradation."""
    return resize_bilinear_aa(x, x.shape[:-2] + (x.shape[-2] // 4, x.shape[-1] // 4))


def adapt_generator(cfg: TecoConfig, params_g, lr_clip_thwc, steps: int = 1000,
                    learning_rate: float = 1e-4, consistency: float = 2.0,
                    max_batch: int = 16, gen=None, log_every: int = 0,
                    guard: bool = False, holdout_every: int = 5,
                    eval_every: int = 100, device=None,
                    on_step: Optional[Callable[[int, torch.Tensor], None]] = None):
    """Fine-tune ``params_g`` (the flax tree or a float32 ``state_dict``) on
    the clip's own internal statistics.

    lr_clip_thwc: (T, H, W, 3) float [0, 1], numpy or a tensor, H and W
    divisible by 4 (else ``ValueError``).  Runs on ``device``, by default
    the device of the params when they are tensors, else the card
    (``engine.state.resolve_device``: the CPU only when named).  Returns
    the adapted params as a new float32 ``state_dict`` on that device; the
    input is left as it was.  Adam over ``cosine_decay_schedule(
    learning_rate, steps)``; each step a deterministic round-robin batch
    of at most ``max_batch`` internal windows; ``cfg.remat`` recomputes
    each unrolled frame in the backward.  ``on_step(i, loss)`` receives
    each step's loss (a 0-d tensor on the device).

    With ``guard=True``, whole window groups (the 8 augmentations of a
    window) are held out of the training pool: group 0 and every
    ``max(2, holdout_every)``-th group after it (``holdout_every`` is
    clamped to at least 2, so group 1 always trains), keeping group 0 for
    training when every group would be held.  A clip of one
    group validates on its unaugmented window, which it also trains on
    (``holdout_overlaps_train``).  PSNR and SSIM of the /4-scale task on
    the held-out windows (SSIM only when H and W reach its 11-pixel window)
    score the base params and every ``eval_every`` steps; a snapshot is
    kept only if it is at least as good as the base on both, the highest
    PSNR (SSIM breaking ties) winning, else the base params come back.
    Returns ``(params, report)`` then, the report holding the JAX
    package's keys."""
    if cfg.bug_parity:
        # the content-only losses want the real gradient through the
        # recurrence, which bug_parity cuts
        cfg = cfg.replace(bug_parity=False)
    clip = lr_clip_thwc.detach().cpu().numpy() if isinstance(lr_clip_thwc, torch.Tensor) \
        else np.asarray(lr_clip_thwc)
    T, H, W, _ = clip.shape
    if H % 4 or W % 4:
        raise ValueError(f"clip {H}x{W} not /4-divisible for internal pairs")
    first = next(iter(params_g.values()))
    dev = _device(first, device)
    if gen is None:
        gen = model_defs(cfg, device=dev)

    windows = _augment_windows(clip.astype(np.float32), cfg.RNN_N)
    hold_hr = hold_lr = None
    holdout_overlap = False
    if guard:
        n_groups = windows.shape[0] // 8
        hold_g = set(range(0, n_groups, max(2, holdout_every)))
        if len(hold_g) == n_groups:
            hold_g.discard(0)
        if hold_g:
            hold_mask = np.isin(np.repeat(np.arange(n_groups), 8), sorted(hold_g))
            held = windows[hold_mask][::8]  # the unaugmented window of each group
            windows = windows[~hold_mask]
        else:
            held = windows[::8]
            holdout_overlap = True
        hold_hr = torch.from_numpy(np.ascontiguousarray(held.transpose(0, 1, 4, 2, 3))).to(dev)
        hold_lr = _down4(hold_hr)
    hr_pool = torch.from_numpy(np.ascontiguousarray(windows.transpose(0, 1, 4, 2, 3))).to(dev)
    n_pool = hr_pool.shape[0]
    lr_pool = _down4(hr_pool)
    # serving-scale consistency windows: the unaugmented originals
    serve_b = hr_pool[::8][: max(1, max_batch // 8)]

    params = train_tensors(float_params(params_g), dev)
    opt = Adam(0.9, 0.999, 1e-8, 1.0)
    schedule = cosine_decay_schedule(learning_rate, max(steps, 1))
    opt_state = opt.init(params, schedule(0))

    def step(p, o, lr_in, hr_tgt):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        out = generator_unroll(gen, leaves, lr_in, cfg).gen_outputs
        loss = torch.mean(torch.square(out - hr_tgt))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss = loss.detach()
        del out
        if consistency > 0.0:
            sr = generator_unroll(gen, leaves, serve_b, cfg).gen_outputs
            term = consistency * torch.mean(torch.square(_down4(sr) - serve_b))
            more = torch.autograd.grad(term, list(leaves.values()))
            grads = [a + b for a, b in zip(grads, more)]
            loss = loss + term.detach()
        new, o = opt.update(p, dict(zip(leaves, grads)), o, schedule(o.count))
        return new, o, loss

    use_ssim = min(H, W) >= 11  # SSIM's 11x11 VALID window

    @torch.no_grad()
    def holdout_score(p):
        out = generator_unroll(gen, p, hold_lr, cfg).gen_outputs
        out_hwc = out.clamp(0.0, 1.0).reshape((-1,) + out.shape[2:]).permute(0, 2, 3, 1)
        tgt_hwc = hold_hr.reshape((-1,) + hold_hr.shape[2:]).permute(0, 2, 3, 1)
        return (float(torch.mean(psnr_per_frame(tgt_hwc, out_hwc))),
                float(ssim(out_hwc, tgt_hwc)) if use_ssim else 0.0)

    if guard:
        base_psnr, base_ssim = holdout_score(params)
        best = (base_psnr, base_ssim, params, 0)  # (psnr, ssim, params, step)

    batch = min(max_batch, n_pool)
    for i in range(steps):
        if n_pool <= batch:
            lr_in, hr_tgt = lr_pool, hr_pool
        else:  # deterministic round-robin through the pool
            idx = torch.from_numpy((np.arange(batch) + (i * batch) % n_pool) % n_pool).to(dev)
            lr_in, hr_tgt = lr_pool[idx], hr_pool[idx]
        params, opt_state, loss = step(params, opt_state, lr_in, hr_tgt)
        if on_step is not None:
            on_step(i, loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"adapt step {i}: loss {float(loss):.6f}", flush=True)
        if guard and ((i + 1) % eval_every == 0 or i == steps - 1):
            ps, ss = holdout_score(params)
            if log_every:
                print(f"adapt holdout @{i + 1}: psnr {ps:.3f} (base {base_psnr:.3f}) "
                      f"ssim {ss:.4f} (base {base_ssim:.4f})", flush=True)
            # never regress: eligible only if at least the base on both
            if ps >= base_psnr and ss >= base_ssim and (ps, ss) > (best[0], best[1]):
                best = (ps, ss, params, i + 1)
    if guard:
        ps, ss, chosen, at_step = best
        report = {
            "holdout_windows": int(hold_hr.shape[0]),
            "holdout_overlaps_train": holdout_overlap,
            "base_psnr_db": round(base_psnr, 4),
            "base_ssim": round(base_ssim, 5),
            "chosen_psnr_db": round(ps, 4),
            "chosen_ssim": round(ss, 5),
            "chosen_step": at_step,
            "adapted_served": at_step > 0,
        }
        return chosen, report
    return params


def lr_consistency_refine(sr_thwc, lr_thwc, iters: int = 10, step: float = 1.0,
                          device=None) -> torch.Tensor:
    """Post-hoc iterative back-projection: push the SR clip (T, 4H, 4W, C)
    onto the clips consistent with its LR clip (T, H, W, C) under the
    antialiased bilinear degradation: ``iters`` times ``sr = clip(sr +
    step * bicubic_up(lr - down(sr)), 0, 1)``.  Numpy or tensors in; a
    float32 tensor out, on ``device`` (default: the SR clip's device when
    it is a tensor, else the card)."""
    dev = _device(sr_thwc, device)
    sr = torch.as_tensor(sr_thwc).to(dev, torch.float32)
    lr = torch.as_tensor(lr_thwc).to(dev, torch.float32)
    for _ in range(iters):
        down = resize_bilinear_aa(sr, lr.shape)
        sr = torch.clamp(sr + step * resize_bicubic(lr - down, sr.shape), 0.0, 1.0)
    return sr
