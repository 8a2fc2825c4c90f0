#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tecogan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tecogan_tpu_torch/csrc`` (one
``nvcc`` a source, started together) and drives the serving paths a user
calls -- random full-width weights through ``generator_state_dict_from_jax``
into ``build_clip_inference``, ``build_chunked_inference`` and
``build_stream_inference`` -- at 270p -> 1080p, then the train step
(``init_state`` / ``state_from_params`` + ``build_train_step``) at the
paper's config.  Phases:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernels' build time;
3. the ``conv_out_s2d`` kernel against its plain PyTorch version (fp32,
   TF32 off) on the same bf16 inputs and the bf16-rounded weights the
   kernel computes with, at three shapes; at the main path's shape its
   device time (a CUDA graph of back-to-back launches; the wrapper's
   back-to-back time beside it) against its bound, the plain version's
   time and the bf16 library chain's (``F.conv2d`` + sigmoid +
   ``pixel_unshuffle``); then the fp32 route's f32 kernel against the
   plain version in f32 at two shapes, and its time;
4. the full-width generator (16 resblocks, bf16) on a (1, 8, 270, 480, 3)
   clip: output shape, range, both kernels' launch counts, fps, TFLOP/s
   and MFU against the H100's dense bf16 peak;
5. the fused route with the kernels (bf16) against the exact route (fp32)
   on the same weights at a small width: last-frame PSNR above the bar.
   As in the port's tests, the conv kernels are scaled by 2.5 and the LR
   clip drawn in [0, 0.3], so that the output depends on the warp; a
   control, the same route with the warp's feedback replaced by zeros,
   must score below the bar, or the phase could not see the warp;
6. the ``warp_s2d`` kernel against its plain version (fp32) on the same
   bf16 carry at three shapes; at the main shape its device time (as in
   3) against its bound, the plain version's time and
   ``F.grid_sample``'s alone;
7. chunked inference at full width: a uint8 clip of 40 frames in windows
   of 16 with ``out_u8`` and a sink, bit-equal to the one-shot clip; peak
   device memory at 80 frames against 40; fps;
8. streaming inference at full width: 16 frames through ``step_fn``,
   bit-equal to the clip route; per-frame latency;
9. full-width training through ``init_state`` + ``build_train_step`` (the
   default config: B=4, RNN_N=10, crop 32, 16 resblocks, D 4 x 128, bf16;
   random flax-layout weights from seed 0, batches from
   ``synthetic_scene_batch``), with ``bug_parity`` on and off: 3 warm-up
   and 20 timed steps; every loss finite, both models' params moved, the
   D mask counter, ms a step, samples/s, TFLOP/s and MFU from
   ``train_step_macs``, peak device memory;
10. the card against the CPU: 3 steps at the tiny config in fp32 (TF32
   off) from the same weights and batches, ``gen_loss`` within 1e-4
   relative each step and ``d_loss`` at step 0; after step 0 every leaf
   of the state: BN statistics and params within 1e-6, Adam's moments
   within 1e-4 of each leaf's largest element; then bf16 against fp32 on
   the card at full width, step 0's ``gen_loss`` and ``d_loss`` within
   2e-2 relative (about five bf16 unit roundoffs, 2**-8 each);
11. checkpoint resume on the card: the full-width state after step 2
   saved and loaded into a fresh state, every tensor bit-equal; the step
   after the load against the step after the save within 1e-4.

12. int8 (W8A8) serving (``build_quantized_clip_inference``): each int8
   kernel (``int8_conv3x3``, ``int8_up2x``) against its plain version
   (float64 integer sums), bit for bit, at the main path's layer shapes,
   LR 135 x 240 at B=2, 37 x 53 and the edges of the kernels' 2 x 64-pixel
   tiles (W < 64, W = 64k + 1, H = 1, B = 3, Cin != Cout, a residual on
   up2x), and the fp32 route's instantiations at four shapes; at each
   main-path layer shape (as ``tecogan_tpu_torch/tools/int8_layers.py``
   defines them) its device time (a CUDA graph, as in 3) against its
   bound, and two labelled yardsticks that are not the
   same function (PyTorch has no int8 conv): the bf16 cuDNN conv of the
   shape and ``torch._int_mm`` on its im2col GEMM alone (M = B H W,
   K = 9 Cin, N = Cout, s8 x s8 -> s32); ``prepare`` on the full-width
   clip's 8 frames, then the int8 clip: launch counts of all four
   kernels, fps beside the bf16 route's in the same run, the tail's ms a
   frame against the bf16 trunk's, TOP/s and the share of 1979 TOP/s;
   at a small width with phase 5's scaled weights, the int8 clip against
   the bf16 clip above 35 dB; chunked int8 on a uint8 clip bit-equal to
   the one-shot int8 clip.

Phases 9-11 run no hand kernel: training runs cuDNN convs and
``F.grid_sample``, as the JAX train step runs XLA convs and gathers.
In the kernels' JSON record the int8 kernels' times are a frame's: the
sum over the frame's launches at each layer shape (37 and 2).

Phases 7 and 8 hold cuDNN to deterministic algorithms: the transposed
convs' default algorithm may sum in a different order from one call to
the next, and these phases compare paths bit for bit.

Every failed check exits non-zero; there is no CPU path.  The line before
the card's line is the kernels' JSON record; the last line of standard
output is the JSON device record.
"""

import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

FEAT_SHAPES = [(1, 1080, 1920, 64),  # the main path: LR 270 x 480
               (2, 540, 960, 64),    # LR H = 135, odd
               (1, 148, 212, 64)]    # LR 37 x 53, H and W odd
MAX_ERR, MEAN_ERR = 8e-3, 1e-3       # two bf16 ulps at 1.0; mean bar
# (B, H, W) of the LR carry, and the range of prev_lr
WARP_SHAPES = [((1, 270, 480), 0.0, 1.0),    # the main path, served range
               ((2, 135, 240), 0.0, 1.0),
               ((1, 37, 53), -0.5, 0.5)]     # coordinates reach the edges
# one bf16 ulp in [0.5, 1), where deprocess puts every value; mean bar
WARP_MAX_ERR, WARP_MEAN_ERR = 4e-3, 1e-3
CLIP = (1, 8, 270, 480, 3)
SMALL_CLIP = (1, 6, 16, 24, 3)
PSNR_BAR_DB = 40.0
# phase 5: conv kernels scaled and LR clip range, as tests/test_torch_port_cuda.py
KERNEL_GAIN, CLIP_RANGE = 2.5, 0.3
CHUNK_T, CHUNK, LONG_T = 40, 16, 80
STREAM_T = 16
FRAME_BUDGET_MS = 1e3 / 30           # a 30 fps live stream
MEMORY_SLACK = 1.05
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
CARD_CPU_RTOL = 1e-4                 # fp32, TF32 off: summation order only
LEAF_TOL = 1e-6                      # BN statistics and params after a step
BF16_RTOL = 2e-2                     # ~5 bf16 unit roundoffs (2**-8)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12             # dense tensor cores, data sheet
PEAK_F32_FLOPS = 67e12               # CUDA cores, data sheet
# f32 operations of the warp kernel: per HR pixel, two upsampled grid
# values (3 lerps of 3 operations each), their unnormalization (3 each),
# the four bilinear weights (8) and the deprocess of 3 channels (3 each);
# per channel of a tap inside the frame: scale, round, 2 clamps, FMA.
WARP_OPS_PER_PIXEL = 2 * (9 + 3) + 8 + 3 * 3
WARP_OPS_PER_TAP_CHANNEL = 5


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def bound(bytes_moved: float, ops: float, peak: float) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card needs."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def warp_work(carry: torch.Tensor, prev_lr: torch.Tensor) -> tuple:
    """Bytes and f32 operations the warp needs on these inputs: the carry
    taps its samples read inside the frame (each once), prev_lr's R and G
    planes, the feedback written."""
    from tecogan_tpu_torch.ops.warp import pseudo_flow_nchw

    B, H, W, _ = carry.shape
    H4, W4 = 4 * H, 4 * W
    g = pseudo_flow_nchw(prev_lr.permute(0, 3, 1, 2))
    ix = torch.floor(((g[..., 0] + 1) * W4 - 1) / 2)
    iy = torch.floor(((g[..., 1] + 1) * H4 - 1) / 2)
    touched = torch.zeros((B, H4, W4), dtype=torch.bool, device=carry.device)
    b = torch.arange(B, device=carry.device).view(B, 1, 1).expand_as(ix)
    taps = 0
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = ix + dx, iy + dy
            ok = (x >= 0) & (x <= W4 - 1) & (y >= 0) & (y <= H4 - 1)
            taps += int(ok.sum())
            touched[b[ok], y[ok].long(), x[ok].long()] = True
    bytes_moved = int(touched.sum()) * 3 * 2 + B * H * W * 2 * 4 + carry.numel() * 2
    ops = B * H4 * W4 * WARP_OPS_PER_PIXEL + taps * 3 * WARP_OPS_PER_TAP_CHANNEL
    return bytes_moved, ops, taps / (4 * B * H4 * W4)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def state_leaves_apart(got, want) -> dict:
    """How far a training state on the card lies from the CPU's after one
    step, leaf by leaf: BN statistics and params in absolute terms, Adam's
    moments relative to each leaf's largest element.  Adam's first step
    is about sign(g) * lr, so params whose gradient element lies within
    the moments' bar of 0 may step the other way: those are left out of
    ``params``, held to 2 lr, and may be a few per thousand of a leaf."""
    out = {"stats": 0.0, "moments": 0.0, "params": 0.0, "excused": 0, "excused_ok": True,
           "n": len(want.batch_stats_d)}
    for k, b in want.batch_stats_d.items():
        out["stats"] = max(out["stats"], float((got.batch_stats_d[k].cpu() - b).abs().max()))
    for side in ("g", "d"):
        og, ow = getattr(got, f"opt_{side}"), getattr(want, f"opt_{side}")
        out["excused_ok"] &= og.count == ow.count and og.learning_rate == ow.learning_rate
        for name in ("mu", "nu"):
            for k, b in getattr(ow, name).items():
                d = float((getattr(og, name)[k].cpu() - b).abs().max())
                out["moments"] = max(out["moments"], d / max(float(b.abs().max()), 1e-30))
                out["n"] += 1
        for k, b in getattr(want, f"params_{side}").items():
            diff = (getattr(got, f"params_{side}")[k].cpu() - b).abs()
            mu = ow.mu[k].abs()
            free = mu <= CARD_CPU_RTOL * mu.max()
            out["params"] = max(out["params"], float(torch.where(free, 0.0, diff).max()))
            excused = int((free & (diff > LEAF_TOL)).sum())
            out["excused"] += excused
            out["excused_ok"] &= (float(torch.where(free, diff, 0.0).max())
                                  <= 2.0001 * ow.learning_rate
                                  and excused <= max(2, 3e-3 * diff.numel()))
            out["n"] += 1
    return out


def train_phases(dev: torch.device, smi: str) -> None:
    """Phases 9-11: the train step on the card."""
    import tempfile

    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
    from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                                state_from_params)
    from tecogan_tpu_torch.engine.train import build_train_step
    from tecogan_tpu_torch.utils.checkpoint import load_train_state, save_train_state
    from tecogan_tpu_torch.utils.flops import train_mfu

    def weights(cfg, seed):
        g = torch.Generator().manual_seed(seed)
        return (init_generator(cfg, g), *init_discriminator(cfg, g))

    def batches(cfg, n, device):
        out = []
        for i in range(n):
            lr, hr = synthetic_scene_batch(cfg.batch_size, cfg.RNN_N, cfg.crop_size,
                                           seed=i * cfg.batch_size)
            out.append((torch.from_numpy(lr).to(device), torch.from_numpy(hr).to(device)))
        return out

    def moved(a: dict, b: dict) -> bool:
        return any(not torch.equal(a[k], b[k]) for k in a)

    full = TecoConfig(precision="bf16")  # the defaults are the paper's config
    full_batches = batches(full, 4, dev)
    w_full = weights(full, 0)

    # -- 9. full-width training, bug_parity on and off
    for bp in (True, False):
        cfg = full.replace(bug_parity=bp)
        state0 = state_from_params(cfg, *w_full, device=dev)
        step = build_train_step(cfg)
        state, times, d_on = state0, [], 0.0
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            lr, hr = full_batches[i % len(full_batches)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics, gen_out = step(state, lr, hr)
            torch.cuda.synchronize()
            if i >= TRAIN_WARMUP:
                times.append(time.perf_counter() - t0)
            losses = {k: float(v) for k, v in metrics.items() if "loss" in k}
            require(all(np.isfinite(v) for v in losses.values()),
                    f"[9] non-finite loss at step {i}: {losses}")
            d_on += float(metrics["withD_counter"])
        peak = torch.cuda.max_memory_allocated(dev)
        n = TRAIN_WARMUP + TRAIN_STEPS
        require(tuple(gen_out.shape) == (4, 10, 3, 128, 128), f"[9] gen out {tuple(gen_out.shape)}")
        require(moved(state0.params_g, state.params_g), "[9] G params did not move")
        require(moved(state0.params_d, state.params_d) == (d_on > 0),
                f"[9] D params moved {moved(state0.params_d, state.params_d)} "
                f"with {d_on} D updates")
        require(state.step == n and state.opt_d.count == n, "[9] step / Adam count")
        med = statistics.median(times)
        mfu = train_mfu(med * 1e3, 4, 10, 32, bug_parity=bp)
        print(f"[9] train step bug_parity={bp}, B=4 RNN_N=10 crop 32, 16 resblocks, D 4x128, "
              f"bf16: {med * 1e3:.3f} ms a step median (min {min(times) * 1e3:.3f}, max "
              f"{max(times) * 1e3:.3f}, n={len(times)}), {4 / med:.2f} samples/s, "
              f"{mfu['achieved_tflops']:.3f} TFLOP/s of {mfu['train_tflop_per_step']:.4f} "
              f"TFLOP a step, MFU {mfu['mfu']:.4%} of 989 TFLOP/s | D updates {d_on:.0f} of "
              f"{n} | gen_loss {float(metrics['gen_loss']):.6f} d_loss "
              f"{float(metrics['d_loss']):.6f} | peak device memory {peak / 2**30:.3f} GiB | "
              f"{smi}", flush=True)
        del state, state0, step, gen_out

    # -- 10. the card against the CPU (tiny, fp32, TF32 off), then bf16 vs fp32
    tiny = TecoConfig(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                      discrim_channels=16, batch_size=2, precision="fp32")
    w_tiny = weights(tiny, 1)
    tiny_batches = batches(tiny, 3, "cpu")
    runs, first = {}, {}
    for where in (dev, torch.device("cpu")):
        state = state_from_params(tiny, *w_tiny, device=where)
        step = build_train_step(tiny, device=where)
        runs[where.type] = []
        for lr, hr in tiny_batches:
            state, metrics, _ = step(state, lr.to(where), hr.to(where))
            runs[where.type].append((float(metrics["gen_loss"]), float(metrics["d_loss"])))
            first.setdefault(where.type, state)
    for i, ((gg, gd), (cg, cd)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        require(rel(gg, cg) <= CARD_CPU_RTOL, f"[10] gen_loss step {i}: card {gg} cpu {cg}")
    require(rel(runs["cuda"][0][1], runs["cpu"][0][1]) <= CARD_CPU_RTOL,
            f"[10] d_loss step 0: card {runs['cuda'][0][1]} cpu {runs['cpu'][0][1]}")
    worst_g = max(rel(a[0], b[0]) for a, b in zip(runs["cuda"], runs["cpu"]))
    leaves = state_leaves_apart(first["cuda"], first["cpu"])
    require(leaves["stats"] <= LEAF_TOL and leaves["moments"] <= CARD_CPU_RTOL
            and leaves["params"] <= LEAF_TOL and leaves["excused_ok"],
            f"[10] the state after step 0 differs: {leaves}")
    lr, hr = full_batches[0]
    step0 = {}
    for prec in ("bf16", "fp32"):
        cfg = full.replace(precision=prec)
        _, metrics, _ = build_train_step(cfg)(state_from_params(cfg, *w_full, device=dev), lr, hr)
        step0[prec] = (float(metrics["gen_loss"]), float(metrics["d_loss"]))
    bf_g, bf_d = rel(step0["bf16"][0], step0["fp32"][0]), rel(step0["bf16"][1], step0["fp32"][1])
    print(f"[10] card vs CPU, tiny fp32, 3 steps: gen_loss rel {worst_g:.3e} (worst), d_loss "
          f"step 0 rel {rel(runs['cuda'][0][1], runs['cpu'][0][1]):.3e} (bar {CARD_CPU_RTOL}); "
          f"after step 0, {leaves['n']} leaves: BN stats {leaves['stats']:.3e}, params "
          f"{leaves['params']:.3e} (bar {LEAF_TOL}; {leaves['excused']} elements of near-zero "
          f"gradient within 2 lr), Adam moments {leaves['moments']:.3e} of each leaf's largest "
          f"(bar {CARD_CPU_RTOL}) | "
          f"full width bf16 vs fp32 step 0: gen_loss {step0['bf16'][0]:.6f} / "
          f"{step0['fp32'][0]:.6f} rel {bf_g:.3e}, d_loss {step0['bf16'][1]:.6f} / "
          f"{step0['fp32'][1]:.6f} rel {bf_d:.3e} (bar {BF16_RTOL})", flush=True)
    require(bf_g <= BF16_RTOL and bf_d <= BF16_RTOL, "[10] bf16 vs fp32 beyond the bar")

    # -- 11. checkpoint resume on the card
    cfg = full
    step = build_train_step(cfg)
    state = state_from_params(cfg, *w_full, device=dev)
    for i in range(2):
        state, _, _ = step(state, *full_batches[i])
    template = state_from_params(cfg, *weights(cfg, 7), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        save_train_state(tmp, state, epoch=3)
        loaded, epoch = load_train_state(tmp, template)
    tensors = [("params_g", state.params_g, loaded.params_g),
               ("params_d", state.params_d, loaded.params_d),
               ("batch_stats_d", state.batch_stats_d, loaded.batch_stats_d),
               ("opt_g.mu", state.opt_g.mu, loaded.opt_g.mu),
               ("opt_g.nu", state.opt_g.nu, loaded.opt_g.nu),
               ("opt_d.mu", state.opt_d.mu, loaded.opt_d.mu),
               ("opt_d.nu", state.opt_d.nu, loaded.opt_d.nu)]
    for what, a, b in tensors:
        require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
                f"[11] {what} differs after the round trip")
    require((loaded.step, loaded.epoch, epoch) == (2, 3, 3), "[11] step / epoch")
    require((loaded.opt_g.count, loaded.opt_d.count) == (2, 2)
            and loaded.opt_g.learning_rate == state.opt_g.learning_rate
            and loaded.opt_d.learning_rate == state.opt_d.learning_rate, "[11] Adam counts / rates")
    after_save = step(state.replace(epoch=3), *full_batches[2])[1]
    after_load = step(loaded, *full_batches[2])[1]
    r_g = rel(float(after_load["gen_loss"]), float(after_save["gen_loss"]))
    r_d = rel(float(after_load["d_loss"]), float(after_save["d_loss"]))
    n_t = sum(len(a) for _, a, _ in tensors)
    print(f"[11] checkpoint after step 2: {n_t} tensors + counts, step, epoch bit-equal after "
          f"save/load | next step gen_loss rel {r_g:.3e}, d_loss rel {r_d:.3e} "
          f"(bar {CARD_CPU_RTOL}) | {smi}", flush=True)
    require(r_g <= CARD_CPU_RTOL and r_d <= CARD_CPU_RTOL, "[11] step after load differs")


# phase 12 times the int8 tail's layer shapes at 270p -> 1080p (LAYERS of
# tecogan_tpu_torch/tools/int8_layers.py, with its inputs, work counts and
# yardsticks); further shapes the kernels are checked at: B=2 at LR
# 135 x 240, odd H and W, and the edges of the 2 x 64-pixel tiles: W below 64, W = 64k + 1, W not
# a multiple of 64, H = 1, B = 3, Cin != Cout both ways, a residual on up2x
INT8_EXTRA = [(False, (2, 135, 240, 64, 64), True, True), (True, (2, 135, 240, 64, 64), True, False),
              (False, (1, 37, 53, 128, 64), True, True), (True, (1, 37, 53, 128, 128), False, True),
              (False, (1, 5, 40, 64, 64), True, True), (False, (2, 3, 129, 128, 128), False, True),
              (False, (1, 1, 130, 128, 64), True, False), (False, (3, 7, 70, 64, 128), False, True),
              (True, (1, 5, 40, 128, 64), True, True), (True, (2, 1, 65, 64, 128), False, True),
              (True, (3, 4, 129, 64, 64), True, True), (True, (1, 3, 70, 128, 64), False, True)]
# the fp32 route's instantiations, bit-equal too: (transposed, shape, relu, residual)
INT8_F32 = [(False, (1, 270, 480, 64, 64), False, True), (False, (1, 37, 53, 128, 64), True, True),
            (True, (1, 540, 960, 128, 128), True, False), (True, (2, 1, 65, 64, 128), False, True)]
INT8_VS_BF16_DB = 35.0               # tests/test_quant.py:105, the JAX package's bar
INT8_CHUNK_T, INT8_CHUNK = 12, 5


def int8_phase(dev, smi, cfg, model, params, clip, infer, small, small_model, small_sd,
               small_clip, small_bf16, rng) -> list:
    """Phase 12: int8 serving.  Returns the two int8 kernels' records."""
    from tecogan_tpu_torch.engine.fused import first_layer_zero_feedback
    from tecogan_tpu_torch.engine.inference import (build_chunked_inference,
                                                    build_quantized_clip_inference)
    from tecogan_tpu_torch.engine.quant import int8_conv3x3, tail_features_int8
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod
    from tecogan_tpu_torch.tools.int8_layers import (LAYERS, PEAK_INT8_OPS, layer_inputs,
                                                     layer_work, yardsticks)
    from tecogan_tpu_torch.utils.flops import int8_tail_macs_per_frame
    from tecogan_tpu_torch.utils.timing import events_ms, graph_ms, host_issue_ms

    recs = {up: {"name": "int8_up2x" if up else "int8_conv3x3", "route": "cuda",
                 "source": "tecogan_tpu_torch/csrc/int8_conv.cu",
                 "replaces": ("tecogan_tpu/engine/quant.py:152" if up else
                              "tecogan_tpu/engine/quant.py:157"),
                 "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                 "bytes": 0, "ops": 0} for up in (False, True)}
    fns = {False: (qmod.int8_conv3x3_cuda, qmod.int8_conv3x3_reference),
           True: (qmod.int8_up2x_cuda, qmod.int8_up2x_reference)}
    checks = [(up, shape, relu, res) for _, up, shape, relu, res, _ in LAYERS] + INT8_EXTRA
    timed = {(up, shape, relu, res): (name, n) for name, up, shape, relu, res, n in LAYERS}
    for i, (up, shape, relu, residual) in enumerate(checks):
        kernel, plain = fns[up]
        x, inv_s, wq, deq, bias, res = layer_inputs(dev, up, shape, 100 + i)
        res = res if residual else None
        got = kernel(x, inv_s, wq, deq, bias, relu, res)
        want = plain(x, inv_s, wq, deq, bias, relu, res)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == torch.bfloat16,
                f"[12] {recs[up]['name']} {tuple(got.shape)} at {shape}")
        err = float((got.float() - want.float()).abs().max())
        recs[up]["max_abs_err"] = max(recs[up]["max_abs_err"], err)
        line = (f"[12] {recs[up]['name']} {shape} relu={relu} residual={residual}: "
                f"max_abs {err:.3e} against the plain version")
        key = (up, shape, relu, residual)
        if key in timed:
            name, n = timed[key]
            B, H, W, cin, cout = shape
            ms = graph_ms(lambda: kernel(x, inv_s, wq, deq, bias, relu, res), 20)
            plain_ms = events_ms(lambda: plain(x, inv_s, wq, deq, bias, relu, res), 2)
            cudnn_ms, mm_ms = yardsticks(x, wq, bias, up, 20)
            px = B * H * W
            bytes_moved, ops = layer_work(x, got, wq, residual)
            b_ms, b_by = bound(bytes_moved, ops, PEAK_INT8_OPS)
            rec = recs[up]
            rec["ms"] += n * ms
            rec["plain_ms"] += n * plain_ms
            rec["bytes"] += n * bytes_moved
            rec["ops"] += n * ops
            line += (f" | {name} x{n} a frame: kernel {ms:.4f} ms (graph), bound {b_ms:.4f} ms "
                     f"({b_by}; {b_ms / ms:.1%}), {ops / ms / 1e9:.1f} TOP/s | plain {plain_ms:.3f} ms"
                     f" | not the same function: bf16 cuDNN {'conv_transpose2d' if up else 'conv2d'}"
                     f" + bias {cudnn_ms:.4f} ms, torch._int_mm s8 GEMM alone (M {px}, K {9 * cin},"
                     f" N {cout}) {mm_ms:.4f} ms, {ops / mm_ms / 1e9:.1f} TOP/s | {smi}")
        print(line, flush=True)
        require(err == 0.0, f"[12] {recs[up]['name']} differs from its plain version at {shape}")
        del x, wq, deq, bias, res, got, want
    for rec in recs.values():
        rec["bound_ms"], rec["bound_by"] = bound(rec.pop("bytes"), rec.pop("ops"), PEAK_INT8_OPS)
    # the fp32 route's instantiations of both kernels (f32 in and out)
    for i, (up, shape, relu, residual) in enumerate(INT8_F32):
        kernel, plain = fns[up]
        x, inv_s, wq, deq, bias, res = layer_inputs(dev, up, shape, 200 + i, torch.float32)
        res = res if residual else None
        got = kernel(x, inv_s, wq, deq, bias, relu, res)
        want = plain(x, inv_s, wq, deq, bias, relu, res)
        torch.cuda.synchronize()
        line = (f"[12] {recs[up]['name']} fp32 {shape} relu={relu} residual={residual}: "
                f"{'bit-equal' if torch.equal(got, want) else 'DIFFERS'} against the plain version")
        if i == 0:
            ms = graph_ms(lambda: kernel(x, inv_s, wq, deq, bias, relu, res), 20)
            line += f" | kernel {ms:.4f} ms (graph) | {smi}"
        print(line, flush=True)
        require(got.dtype == torch.float32 and torch.equal(got, want),
                f"[12] {recs[up]['name']} fp32 differs from its plain version at {shape}")
        del x, wq, deq, bias, res, got, want

    # the full-width int8 clip after prepare on its 8 frames
    prepare, qinfer = build_quantized_clip_inference(cfg)
    qtail = prepare(model, params, clip, frames=CLIP[1])
    qinfer(model, qtail, clip)  # warm-up
    torch.cuda.synchronize()
    qmod.conv3x3_launch_count = qmod.up2x_launch_count = 0
    kmod.launch_count = wmod.launch_count = 0
    t0 = time.perf_counter()
    out = qinfer(model, qtail, clip)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (qmod.conv3x3_launch_count, qmod.up2x_launch_count, kmod.launch_count,
                wmod.launch_count)
    T = CLIP[1]
    require(tuple(out.shape) == (1, T, 4 * CLIP[2], 4 * CLIP[3], 3)
            and bool(torch.isfinite(out).all())
            and float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
            f"[12] int8 clip {tuple(out.shape)}, range [{float(out.min())}, {float(out.max())}]")
    n = cfg.num_resblock
    require(launches == (T * (2 * n + 5), 2 * T, T, T - 1),
            f"[12] int8_conv3x3 / int8_up2x / conv_out_s2d / warp_s2d launched {launches}")
    recs[False]["launches"], recs[True]["launches"] = launches[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf16_out = infer(model, clip)
    torch.cuda.synchronize()
    bf16_secs = time.perf_counter() - t0
    with torch.inference_mode():
        net = first_layer_zero_feedback(model, clip[:, 0]).contiguous()
        tail_ms = events_ms(lambda: tail_features_int8(model, qtail, net), 10)
        trunk_ms = events_ms(lambda: model.tail_features(net), 10)
        # the host's side: issuing the tail, and one resblock layer's wrapper call
        tail_issue_ms = host_issue_ms(lambda: tail_features_int8(model, qtail, net), 10)
        q = qtail["resblock_0/Conv_0"]
        call_us = host_issue_ms(lambda: int8_conv3x3(net, q["inv_s"], q["wq"], q["deq"],
                                                     q["bias"], True), 200) * 1e3
    tops = 2.0 * int8_tail_macs_per_frame(CLIP[2], CLIP[3], n) / (tail_ms / 1e3) / 1e12
    print(f"[12] int8 clip 270p->1080p T={T} full width, prepare on its {T} frames: "
          f"{T / secs:.3f} fps ({secs * 1e3:.3f} ms), bf16 route {T / bf16_secs:.3f} fps in "
          f"this run | tail {tail_ms:.4f} ms a frame vs the bf16 trunk {trunk_ms:.4f} ms "
          f"(CUDA events, 10 calls); the host issues the tail in {tail_issue_ms:.4f} ms, a "
          f"wrapper call in {call_us:.2f} us | {tops:.3f} TOP/s, {tops * 1e12 / PEAK_INT8_OPS:.3%} of "
          f"1979 TOP/s | int8 vs bf16 clip {psnr(out, bf16_out):.2f} dB (torch's init scale) | "
          f"launches int8_conv3x3 {launches[0]}, int8_up2x {launches[1]}, conv_out_s2d "
          f"{launches[2]}, warp_s2d {launches[3]} | {smi}", flush=True)
    del out, bf16_out, net

    # small width, phase 5's scaled weights: int8 against bf16
    sprep, sinfer = build_quantized_clip_inference(small)
    small_q = sinfer(small_model, sprep(small_model, small_sd, small_clip, frames=4), small_clip)
    db = psnr(small_q, small_bf16)
    print(f"[12] small width, kernels x{KERNEL_GAIN}: int8 vs bf16 clip {db:.2f} dB "
          f"(bar {INT8_VS_BF16_DB} dB)", flush=True)
    require(db > INT8_VS_BF16_DB, f"[12] int8 vs bf16 {db:.2f} dB")

    # chunked int8 on a uint8 clip == the one-shot int8 clip
    torch.backends.cudnn.deterministic = True
    u8 = rng.integers(0, 256, (1, INT8_CHUNK_T, *CLIP[2:]), dtype=np.uint8)
    want = qinfer(model, qtail, torch.from_numpy(u8).to(dev)).cpu()
    windows = []
    build_chunked_inference(cfg)(model, u8, chunk=INT8_CHUNK, sink=windows.append, qtail=qtail)
    torch.backends.cudnn.deterministic = False
    require(torch.equal(torch.cat(windows, dim=1), want),
            "[12] chunked int8 differs from the one-shot int8 clip")
    print(f"[12] chunked int8, u8 T={INT8_CHUNK_T} chunk {INT8_CHUNK}, windows "
          f"{[w.shape[1] for w in windows]}: bit-equal to the one-shot int8 clip", flush=True)
    return [recs[False], recs[True]]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is visible")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine.fused import (
        conv_out_params, conv_out_s2d, fused_first_frame_s2d, fused_first_layer,
        s2d_to_frame)
    from tecogan_tpu_torch.engine.inference import (
        build_chunked_inference, build_clip_inference, build_stream_inference)
    from tecogan_tpu_torch.engine.state import init_generator, model_defs
    from tecogan_tpu_torch.ops.image import transfer_to_uint8
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod
    from tecogan_tpu_torch.ops.space import depth_to_space
    from tecogan_tpu_torch.ops.warp import pseudo_flow_nchw
    from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax
    from tecogan_tpu_torch.utils.flops import (H100_PEAK_BF16_FLOPS,
                                               generator_macs_per_frame)
    from tecogan_tpu_torch.utils.timing import card, events_ms, graph_ms

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()

    # -- 1. the card
    print(smi)
    print(f"[1] card: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)

    # -- 2. build: one nvcc a source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        logs = dict(zip(("conv_out_s2d", "warp_s2d", "int8_conv"),
                        pool.map(lambda m: m.build(), (kmod, wmod, qmod))))
    print(f"[2] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"    {name}: " + " | ".join(ptxas), flush=True)

    def reset_counts():
        kmod.launch_count = wmod.launch_count = 0

    # -- 3. conv_out_s2d against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    weight = torch.randn((3, 3, 64, 3), generator=gen, device=dev) * 0.05
    bias = torch.randn((3,), generator=gen, device=dev) * 0.1
    conv = {"name": "conv_out_s2d", "route": "cuda",
            "source": "tecogan_tpu_torch/csrc/conv_out_s2d.cu",
            "replaces": "tecogan_tpu/ops/pallas/conv_out_s2d.py:176",
            "max_abs_err": 0.0}
    for shape in FEAT_SHAPES:
        feat = torch.rand(shape, generator=gen, device=dev).bfloat16()
        feat32 = feat.float()
        # the kernel rounds its weights to bf16, as the JAX route does
        ref = kmod.conv_out_s2d_reference(feat32, weight.bfloat16().float(), bias)
        got = kmod.conv_out_s2d_cuda(feat, weight, bias)
        torch.cuda.synchronize()
        require(tuple(got.shape) == tuple(ref.shape),
                f"kernel shape {tuple(got.shape)} at {shape}")
        err = (got.float() - ref).abs()
        mx, mean = float(err.max()), float(err.mean())
        conv["max_abs_err"] = max(conv["max_abs_err"], mx)
        line = f"[3] conv_out_s2d {shape}: max_abs {mx:.3e} mean_abs {mean:.3e}"
        if shape == FEAT_SHAPES[0]:
            conv["ms"] = graph_ms(lambda: kmod.conv_out_s2d_cuda(feat, weight, bias), 50)
            wrapper_ms = events_ms(lambda: kmod.conv_out_s2d_cuda(feat, weight, bias), 50)
            conv["plain_ms"] = events_ms(
                lambda: kmod.conv_out_s2d_reference(feat32, weight, bias), 50)
            conv["library_ms"] = events_ms(
                lambda: kmod.conv_out_s2d_reference(feat, weight, bias), 50)
            conv["bound_ms"], conv["bound_by"] = bound(
                (feat.numel() + got.numel()) * 2, 2.0 * got.numel() * 9 * 64,
                PEAK_BF16_FLOPS)
            line += (f" | kernel {conv['ms']:.4f} ms (graph; wrapper back to back"
                     f" {wrapper_ms:.4f} ms), bound {conv['bound_ms']:.4f} ms"
                     f" ({conv['bound_by']}; {conv['bound_ms'] / conv['ms']:.1%})"
                     f" | plain fp32 {conv['plain_ms']:.4f} ms | library chain bf16"
                     f" {conv['library_ms']:.4f} ms | {smi}")
        print(line, flush=True)
        require(mx <= MAX_ERR and mean <= MEAN_ERR,
                f"kernel vs plain at {shape}: max {mx} mean {mean}")
        del feat, feat32, ref, got, err
    # the fp32 route's kernel: f32 features and weights, against the plain
    # version in f32 (they differ in summation order, then one bf16 rounding)
    for shape in (FEAT_SHAPES[0], FEAT_SHAPES[2]):
        feat32 = torch.rand(shape, generator=gen, device=dev)
        ref = kmod.conv_out_s2d_reference(feat32, weight, bias)
        got = kmod.conv_out_s2d_cuda(feat32, weight, bias)
        torch.cuda.synchronize()
        err = (got.float() - ref).abs()
        mx, mean = float(err.max()), float(err.mean())
        line = f"[3] conv_out_s2d fp32 {shape}: max_abs {mx:.3e} mean_abs {mean:.3e}"
        if shape == FEAT_SHAPES[0]:
            ms = graph_ms(lambda: kmod.conv_out_s2d_cuda(feat32, weight, bias), 20)
            line += f" | kernel {ms:.4f} ms (graph) | {smi}"
        print(line, flush=True)
        require(tuple(got.shape) == tuple(ref.shape) and got.dtype == torch.bfloat16
                and mx <= MAX_ERR and mean <= MEAN_ERR,
                f"fp32 kernel vs plain at {shape}: max {mx} mean {mean}")
        del feat32, ref, got, err

    # -- 4. the full-width serving path
    cfg = TecoConfig(num_resblock=16, precision="bf16", bug_parity=False,
                     use_pallas=True, warp_group=4)
    params = init_generator(cfg, torch.Generator().manual_seed(0))
    model = model_defs(cfg, device=dev)
    model.load_state_dict(generator_state_dict_from_jax(params))
    model.eval()
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.random(CLIP, np.float32)).to(dev)
    infer = build_clip_inference(cfg)
    infer(model, clip)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = infer(model, clip)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (kmod.launch_count, wmod.launch_count)
    T = CLIP[1]
    require(tuple(out.shape) == (1, T, 1080, 1920, 3), f"output {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite output")
    require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")
    require(launches == (T, T - 1),
            f"conv_out_s2d / warp_s2d launched {launches} times for {T} frames")
    conv["launches"] = launches[0]
    fps = T / secs
    tflops = fps * 2.0 * generator_macs_per_frame(CLIP[2], CLIP[3], 16) / 1e12
    print(f"[4] 270p->1080p T={T} full width bf16: {fps:.3f} fps "
          f"({secs * 1e3:.3f} ms a clip), {tflops:.3f} TFLOP/s, MFU "
          f"{tflops * 1e12 / H100_PEAK_BF16_FLOPS:.4%} of 989 TFLOP/s | "
          f"launches conv_out_s2d {launches[0]}, warp_s2d {launches[1]} | {smi}",
          flush=True)
    del out

    # -- 5. fused (kernels, bf16) vs exact (fp32) on the same scaled weights,
    #       and the same fused route with zero feedback as the control
    small = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False,
                       use_pallas=True)
    exact_cfg = small.replace(precision="fp32", use_pallas=False)
    sd = generator_state_dict_from_jax(
        init_generator(small, torch.Generator().manual_seed(1)))
    sd = {k: v * KERNEL_GAIN if k.endswith("weight") else v for k, v in sd.items()}
    fast_model = model_defs(small, device=dev)
    fast_model.load_state_dict(sd)
    exact_model = model_defs(exact_cfg, device=dev)
    exact_model.load_state_dict(sd)
    small_clip = torch.from_numpy(
        rng.random(SMALL_CLIP, np.float32) * np.float32(CLIP_RANGE)).to(dev)
    fast = build_clip_inference(small)(fast_model.eval(), small_clip)
    exact = build_clip_inference(exact_cfg)(exact_model.eval(), small_clip)
    db = psnr(fast[:, -1], exact[:, -1])
    with torch.no_grad():
        carry = fused_first_frame_s2d(fast_model, small_clip[:, 0])
        for t in range(1, SMALL_CLIP[1]):
            net = fused_first_layer(fast_model, small_clip[:, t], torch.zeros_like(carry))
            carry = conv_out_s2d(fast_model.tail_features(net), *conv_out_params(fast_model))
        db_control = psnr(s2d_to_frame(carry).float(), exact[:, -1])
    print(f"[5] fused bf16 (kernels) vs exact fp32, last of {SMALL_CLIP[1]} "
          f"frames: {db:.2f} dB PSNR; control with zero feedback {db_control:.2f} dB "
          f"(bar {PSNR_BAR_DB} dB)", flush=True)
    require(db > PSNR_BAR_DB, f"fused vs exact PSNR {db:.2f} dB")
    require(db_control < PSNR_BAR_DB,
            f"zero-feedback control scores {db_control:.2f} dB: the phase cannot see the warp")

    # -- 6. warp_s2d against its plain version
    warp = {"name": "warp_s2d", "route": "cuda",
            "source": "tecogan_tpu_torch/csrc/warp_s2d.cu",
            "replaces": "tecogan_tpu/ops/pallas/warp_combine.py:90",
            "launches": launches[1], "max_abs_err": 0.0}
    for (B, H, W), lo, hi in WARP_SHAPES:
        carry = torch.rand((B, H, W, 48), generator=gen, device=dev).bfloat16()
        prev_lr = torch.rand((B, H, W, 3), generator=gen, device=dev) * (hi - lo) + lo
        ref = wmod.warp_s2d_feedback_reference(carry, prev_lr)
        got = wmod.warp_s2d_feedback_cuda(carry, prev_lr)
        torch.cuda.synchronize()
        require(tuple(got.shape) == tuple(ref.shape) and got.dtype == torch.bfloat16,
                f"warp kernel {tuple(got.shape)} {got.dtype} at {(B, H, W)}")
        err = (got.float() - ref).abs()
        mx, mean = float(err.max()), float(err.mean())
        warp["max_abs_err"] = max(warp["max_abs_err"], mx)
        line = (f"[6] warp_s2d {(B, H, W)} prev_lr in [{lo}, {hi}]: max_abs "
                f"{mx:.3e} mean_abs {mean:.3e}")
        if (B, H, W) == WARP_SHAPES[0][0]:
            warp["ms"] = graph_ms(lambda: wmod.warp_s2d_feedback_cuda(carry, prev_lr), 50)
            wrapper_ms = events_ms(lambda: wmod.warp_s2d_feedback_cuda(carry, prev_lr), 50)
            warp["plain_ms"] = events_ms(
                lambda: wmod.warp_s2d_feedback_reference(carry, prev_lr), 50)
            q = torch.round(carry.float() * 255).clamp(0, 255) * (1 / 255)
            frame = depth_to_space(q).permute(0, 3, 1, 2).contiguous()
            grid = pseudo_flow_nchw(prev_lr.permute(0, 3, 1, 2))
            warp["library_ms"] = events_ms(lambda: F.grid_sample(
                frame, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False), 50)
            bytes_moved, ops, inside = warp_work(carry, prev_lr)
            warp["bound_ms"], warp["bound_by"] = bound(bytes_moved, ops, PEAK_F32_FLOPS)
            full_ms = (carry.numel() * 2 * 2 + prev_lr.numel() * 4) / HBM_BYTES_PER_S * 1e3
            line += (f" | kernel {warp['ms']:.4f} ms (graph; wrapper back to back"
                     f" {wrapper_ms:.4f} ms), bound {warp['bound_ms']:.4f} ms"
                     f" ({warp['bound_by']}, {bytes_moved / 1e6:.2f} MB, "
                     f"{inside:.1%} of taps inside; {warp['bound_ms'] / warp['ms']:.1%})"
                     f", {full_ms / warp['ms']:.1%} of the {full_ms:.4f} ms floor of"
                     f" whole tensors | plain fp32 {warp['plain_ms']:.4f} ms |"
                     f" F.grid_sample {warp['library_ms']:.4f} ms | {smi}")
            del q, frame, grid
        print(line, flush=True)
        require(mx <= WARP_MAX_ERR and mean <= WARP_MEAN_ERR,
                f"warp kernel vs plain at {(B, H, W)}: max {mx} mean {mean}")
        del carry, prev_lr, ref, got, err

    # -- 7. chunked, full width: u8 in, u8 out through a sink
    torch.backends.cudnn.deterministic = True
    long_clip = rng.integers(0, 256, (1, LONG_T, *CLIP[2:]), dtype=np.uint8)
    clip40 = long_clip[:, :CHUNK_T]
    want = transfer_to_uint8(infer(model, torch.from_numpy(clip40).to(dev))).cpu()
    torch.cuda.synchronize()
    chunked = build_chunked_inference(cfg, out_u8=True)
    windows = []
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    chunked(model, clip40, chunk=CHUNK, sink=windows.append)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = (kmod.launch_count, wmod.launch_count)
    peak40 = torch.cuda.max_memory_allocated(dev)
    sizes = [w.shape[1] for w in windows]
    require(sum(sizes) == CHUNK_T and max(sizes) <= CHUNK,
            f"sink windows {sizes} for T={CHUNK_T}, chunk {CHUNK}")
    require(all(w.dtype == torch.uint8 for w in windows), "sink windows not uint8")
    require(torch.equal(torch.cat(windows, dim=1), want),
            "chunked u8 output differs from transfer_to_uint8 of the one-shot clip")
    require(counts == (CHUNK_T, CHUNK_T - 1), f"chunked launches {counts}")
    del want, windows
    frames_seen = []
    torch.cuda.reset_peak_memory_stats(dev)
    chunked(model, long_clip, chunk=CHUNK, sink=lambda w: frames_seen.append(w.shape[1]))
    torch.cuda.synchronize()
    peak80 = torch.cuda.max_memory_allocated(dev)
    require(sum(frames_seen) == LONG_T, f"sink saw {frames_seen}")
    require(peak80 <= MEMORY_SLACK * peak40,
            f"peak device memory {peak80} at T={LONG_T} vs {peak40} at T={CHUNK_T}")
    print(f"[7] chunked T={CHUNK_T} chunk {CHUNK} u8 in/out, sink windows {sizes}: "
          f"bit-equal to one-shot | {CHUNK_T / secs:.3f} fps ({secs * 1e3:.3f} ms) | "
          f"launches conv_out_s2d {counts[0]}, warp_s2d {counts[1]} | peak device "
          f"memory {peak40 / 2**20:.1f} MiB at T={CHUNK_T}, {peak80 / 2**20:.1f} MiB at "
          f"T={LONG_T} | {smi}", flush=True)

    # -- 8. streaming, full width
    frames_in = torch.from_numpy(rng.random((1, STREAM_T, *CLIP[2:]), np.float32))
    want = infer(model, frames_in.to(dev))
    init_fn, step_fn = build_stream_inference(cfg)
    state = init_fn((1, *CLIP[2:]), device=dev)
    torch.cuda.synchronize()
    got, lat_ms = [], []
    reset_counts()
    for t in range(STREAM_T):
        t0 = time.perf_counter()
        state, frame = step_fn(model, state, frames_in[:, t])
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        got.append(frame)
    counts = (kmod.launch_count, wmod.launch_count)
    torch.backends.cudnn.deterministic = False
    require(torch.equal(torch.stack(got, dim=1), want), "stream differs from clip")
    require(counts == (STREAM_T, STREAM_T - 1), f"stream launches {counts}")
    print(f"[8] stream {STREAM_T} frames: bit-equal to the clip route | frame latency "
          f"p50 {statistics.median(lat_ms):.3f} ms, max {max(lat_ms):.3f} ms "
          f"(line {FRAME_BUDGET_MS:.1f} ms) | launches conv_out_s2d {counts[0]}, "
          f"warp_s2d {counts[1]} | {smi}", flush=True)

    train_phases(dev, smi)

    int8_recs = int8_phase(dev, smi, cfg, model, params, clip, infer, small, fast_model, sd,
                           small_clip, fast, rng)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in (conv, warp, *int8_recs)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
