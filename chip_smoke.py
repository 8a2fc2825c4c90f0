#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tecogan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from ``tecogan_tpu_torch/csrc`` (one
``nvcc`` a source, started together) and drives the serving paths a user
calls -- random full-width weights through ``generator_state_dict_from_jax``
into ``build_clip_inference``, ``build_chunked_inference`` and
``build_stream_inference`` -- at 270p -> 1080p, then the train step
(``init_state`` / ``state_from_params`` + ``build_train_step``) at the
paper's config.  Phases:

1. the card (``nvidia-smi`` name and power limit), the torch / CUDA
   versions, and whether ``cv2``, ``imageio`` and ``PIL`` can be imported;
2. the kernels' build time;
3. the ``conv_out_s2d`` kernel against its plain PyTorch version (fp32,
   TF32 off) on the same bf16 inputs and the bf16-rounded weights the
   kernel computes with, at four shapes; at the main path's shape its
   device time (a CUDA graph of back-to-back launches; the wrapper's
   back-to-back time beside it) against its bound, the plain version's
   time and the bf16 library chain's (``F.conv2d`` + sigmoid +
   ``pixel_unshuffle``); then the fp32 route's f32 kernel against the
   plain version in f32 at FEAT_SHAPES 0, 2 and 3, and at the main shape
   its time beside its bound, the plain version's, the f32 library
   chain's with TF32 off and, given ``--parent DIR`` (an earlier tree of
   the repo, e.g. unpacked with ``git archive`` into the git-ignored
   ``chip_tree/``), the earlier tree's f32 kernel's, built beside the
   kernels in phase 2 and held to the same bars;
4. the full-width generator (16 resblocks, bf16) on a (1, 8, 270, 480, 3)
   clip: output shape, range, the hand kernels' launch counts (the bf16
   fused conv kernels' 37 ``bf16_conv3x3`` and 2 ``bf16_up2x`` a frame among
   them), fps, TFLOP/s and MFU against the H100's dense bf16 peak; then
   the fp32 fused route (TF32 off, the f32 kernel's path) on the same
   weights and clip: its launch counts (no bf16 conv kernel), fps and the
   f32 kernel's share of a frame;
5. the fused route with the kernels (bf16) against the exact route (fp32)
   on the same weights at a small width: last-frame PSNR above the bar.
   As in the port's tests, the conv kernels are scaled by 2.5 and the LR
   clip drawn in [0, 0.3], so that the output depends on the warp; a
   control, the same route with the warp's feedback replaced by zeros,
   must score below the bar, or the phase could not see the warp;
6. the ``warp_s2d`` kernel against its plain version (fp32) on the same
   bf16 carry at four shapes; at the main shape its device time (as in
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
   the one-shot int8 clip;
13. adaptation and evaluation: (a) ``adapt_generator`` at the CLI's
   defaults (16 resblocks bf16, 40 frames of 268 x 480, RNN_N 10,
   max_batch 16, consistency 2.0, the guard) for 4 steps, scored by the
   guard at steps 2 and 4: finite losses, moved params, the JAX report's
   keys, ms a step, peak memory, remat off when the reckoned activations
   fit (measured per frame on a 2-frame unroll), else on; (b) the adapted
   params served by the fused bf16 clip and by the int8 clip after
   ``prepare`` on them, the launch counts of all four kernels, and at
   phase 5's scaled small width the adapted int8 clip against the adapted
   bf16 clip above 35 dB; (c) ``lr_consistency_refine`` of the 1080p SR
   clip, 10 iterations: the LR-consistency error falls, its ms; (d)
   ``psnr_per_frame``, ``ssim`` and the VGG-19 ``vgg_perceptual_distance``
   / ``lpips_distance`` between the fused and exact routes' 1080p frames,
   each one's ms; (e) the card against the CPU: tiny fp32 adaptation (3
   guarded steps) losses within 1e-4 relative and base PSNR within 1e-4
   dB, ``ssim`` of two 1080p frames with TF32 on globally within 1e-6, VGG
   end points at 64 x 64 within 1e-4 of each layer's largest; (f) the NHWC
   fused route at ``warp_group`` 2 and 8 bit-equal to the s2d route, and
   at 8 with an odd LR width (the bf16 frame warp) above the 40 dB bar
   against the exact fp32 route;
14. the command line (``tecogan_tpu_torch.cli``) on the card: (a) 3
   synthetic scenes (``variety``, 120 frames of 128 x 128) written to a
   temporary folder; (b) ``cli.main.main`` trains at the paper's config
   (B=4, RNN_N=10, crop 32, 16 resblocks, D 4 x 128, bf16, ``--bug_parity
   False``) for an epoch of 6 steps at 2 steps a dispatch on scenes
   1000-1001, validating on 1002, then resumes for two more epochs: ms a
   step and samples/s as the CLI printed them, peak memory, the
   validation PSNR, the hand kernels' launches (validation's alone), the
   checkpoint pair loaded and the artifacts present; (c) inference in
   dataset mode from that checkpoint at full width (``--crop_size 270``,
   16 LR frames, the fused route): the frames handed to the writer
   bit-equal to ``build_clip_inference`` on ``InferenceDataset``'s clip,
   launches 16 / 15, the mp4 decoded to 16 frames of 1080 x 1080, fps as
   the CLI printed it; (d) ``--quantize int8`` bit-equal to
   ``build_quantized_clip_inference`` after ``prepare`` on the same clip,
   the clip's launches 592 / 32 / 16 / 15 and the calibration's 0 / 0 /
   8 / 7; (e) ``--infer_chunk 8 --transfer_dtype u8`` bit-equal to the
   engine's chunked u8 run; (f) two clips (12 frames of 268 x 268) with
   ``--adapt_steps 2 --quantize int8``: two calibrations, one on each
   clip's adapted params; (g) video mode on a ``cv2``-written mp4,
   bit-equal to the engine on ``load_video_frames``; (h) ``cli.evaluate``
   on (c)'s mp4 against its source frames, and ``cli.live`` on a
   synthetic chess source (16 frames, ``--crop_size 270``): frame latency
   p50 and max, launches;
15. the multi-rank paths (``tecogan_tpu_torch.parallel``), ranks spawned
   by ``parallel.mesh.spawn``; the machine has one card, so every rank
   uses it and no figure here is a multi-card one: (a) NCCL at world 1:
   the spatial fused route on the full-width clip bit-equal to the
   single-device clip in int8, and in bf16 to the single-device fused
   recurrence on the modules' tail (the spatial route keeps cuDNN's convs
   and torch's passes; the single-device route runs the bf16 fused conv
   kernels, within (b)'s bars of it), and a DP train step (paper's
   config, fp32, TF32 off) against the single-process step; (b) 2 and 3
   gloo ranks sharing the card: the spatial fused route in bf16 and int8
   against the single-device clip (max 2e-2, mean 2e-3, PSNR > 40 dB;
   bit-equality printed), at 2 ranks the exact fp32 route (bug_parity)
   within 1e-4, every rank's hand-kernel launches and each kernel's last
   launch on its halo'd block against its plain version (the kernel bars);
   fps (labelled: ranks sharing one card), the all-gathers' ms and MB a
   rank a frame against ``tecogan_tpu/parallel/spatial.py:31-36``'s
   reckoning; at 2 ranks the DP step (B=2 a rank) against the
   single-process step on B=4 in fp32 (``gen_loss`` each step and
   ``d_loss`` at step 0 within 1e-4, the D-balance decisions equal, the
   state the same on both ranks), its ms in bf16, one K=2 call of the
   multi-step, and DP serving and DP int8 serving of 2 streams bit-equal
   to each stream's single-device clip; (c) the tensor-parallel train step
   (``parallel.tp``) on 4 gloo ranks sharing the card: the 1x2 grid at the
   paper's config (bf16) on the first two ranks against the single-process
   bf16 step (``gen_loss`` each step and ``d_loss`` at step 0 within 2e-2),
   then the 2x2 grid at the tiny fp32 config (TF32 off) against the
   single-process step within 1e-4; ms a step, all-gathers, all-reduces
   and MB a rank of a step (labelled: gloo stages them through the host),
   the sharded generator keys, the replicated leaves equal across each
   model group, no hand-kernel launch; (e) the FNet step at the paper's
   config (bf16): 3 steps, ms a step, peak memory, and a tiny fp32 config
   against the CPU within 1e-4; (f) ``--spatial_shards 2`` and
   ``--data_axis 2`` through ``cli.main.main``, clamped to the one card
   with the JAX package's warning;
16. exported serving: the window programs served from a fresh process
   bit-equal to the live chunked loop, the reference-checkpoint converter,
   ``tools/adapt_clip.py`` and CLI train steps with the surrogate VGG-19;
17. the measurement programs (``tecogan_tpu_torch/tools/bench*.py``, the
   JAX repo's ``bench.py`` and ``tools/bench_*.py``) through their
   ``main(argv)`` at the JAX tools' defaults: every record finite, each
   program's launches of the hand kernels the count its routes imply, no ``error`` line at batches 4-32, and each stream of a 4-stream
   clip against it served alone above 40 dB, on weights scaled so that
   the control, every stream fed stream 0's carry, scores below 40 dB
   (phases 3 and 6 hold both kernels to plain at these B = 4 shapes);
18. the bf16 fused conv kernels (``bf16_conv3x3``, ``bf16_up2x``, the bf16
   route's 39 tail convs with their bias, ReLU and skip add): each against
   its plain version (the modules' chain of torch ops, cuDNN's conv and
   torch's passes, on the card) within ``tools/bf16_layers.check``'s bars
   (the f32 sums' order alone: a bf16 ulp a rounding) at the main path's
   nine layer shapes and at the tiles' masked edges; at the nine shapes
   each kernel's time (a CUDA graph) against its bound, the plain chain's
   and cuDNN's conv + bias + ReLU (``tools/bf16_layers.py``); then no
   launch on the fp32 and int8 routes and none in a bf16 train step (the
   bf16 route's launches are counted where it runs: phases 4, 7, 8 and
   13b and phases 15-17's paths).  ``python -m
   tecogan_tpu_torch.tools.bf16_layers`` runs the nine shapes alone.

19. TecoGAN as published (``models.PublishedTecoGAN``): its two kernels,
   ``flow_warp_s2d`` (bit-equal to its plain version: flows within and
   far past the frame, at three shapes) and ``conv_out_bicubic_s2d``
   (against its plain version in f32 on the same bf16 features and
   bf16-rounded weights, within the f32 sums' reordering, at three
   shapes), the carry float32, each at the main shape one
   launch in a CUDA graph of 50 against its byte bound and its plain
   version's time; then the full-width published route (16 resblocks,
   bf16) on a (1, 8, 270, 480, 3) clip: its hand kernels' launches a
   frame, counted by kernel name in a device trace of a clip whose FNet,
   resblocks and ``up`` layers replay as CUDA graphs (1 / 1 / 32 / 2
   after frame 0; FNet on cuDNN), the wrappers' own counts (only the
   launches issued outside a graph) and the graph replays beside them,
   fps, the chunked loop (u8, windows of 3) and the stream step
   bit-equal to the clip, and dwight-foster's clip launching neither new
   kernel.

Phases 9-11, 13a, c-e, 15's train steps (DP and TP) and 17's train programs run no hand kernel: training runs cuDNN convs and
``F.grid_sample``, as the JAX train step runs XLA convs and gathers.
In the kernels' JSON record the int8 and bf16 conv kernels' times are a
frame's: the sum over the frame's launches at each layer shape (37 and 2).

Phases 7, 8, 13f, 14 and 15 hold cuDNN to deterministic algorithms: the
transposed convs' default algorithm may sum in a different order from
one call to the next, and these phases compare paths bit for bit.

Every failed check exits non-zero; there is no CPU path.  The line before
the card's line is the kernels' JSON record (``launches_multi``: each
kernel's launches a rank on phase 15's paths, the TP step's among them); the last line of standard
output is the JSON device record.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

FEAT_SHAPES = [(1, 1080, 1920, 64),  # the main path: LR 270 x 480
               (2, 540, 960, 64),    # LR H = 135, odd
               (1, 148, 212, 64),    # LR 37 x 53, H and W odd
               (4, 1080, 1920, 64)]  # bench_serving's four streams (phase 17)
MAX_ERR, MEAN_ERR = 8e-3, 1e-3       # two bf16 ulps at 1.0; mean bar
# (B, H, W) of the LR carry, and the range of prev_lr
WARP_SHAPES = [((1, 270, 480), 0.0, 1.0),    # the main path, served range
               ((2, 135, 240), 0.0, 1.0),
               ((1, 37, 53), -0.5, 0.5),     # coordinates reach the edges
               ((4, 270, 480), 0.0, 1.0)]    # bench_serving's four streams (phase 17)
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


# phase 13: adaptation and evaluation at full width
ADAPT_T, ADAPT_HW = 40, (268, 480)   # the CLI's adapt_frames; 270p cropped to /4
ADAPT_STEPS, ADAPT_EVAL_EVERY = 4, 2  # the guard scores the base, then at steps 2 and 4
SERVE_T = 8
REFINE_ITERS = 10
VGG_LAYERS = ("vgg_19/conv2_2", "vgg_19/conv3_4", "vgg_19/conv4_4")
SSIM_CARD_CPU_TOL = 1e-6
VGG_CARD_CPU_RTOL = 1e-4
MEMORY_SHARE = 0.75                  # of the card's memory, for the no-remat reckoning


def smooth_clip(T: int, H: int, W: int, seed: int) -> torch.Tensor:
    """(T, H, W, 3) float32 in [0.05, 0.35] on the CPU: a random field at
    1/8 scale, bilinear x8, panning one pixel a frame (content an
    adaptation step can fit, unlike noise)."""
    g = torch.Generator().manual_seed(seed)
    field = torch.rand((1, 3, H // 8 + 2, (W + T) // 8 + 2), generator=g)
    big = F.interpolate(field, scale_factor=8, mode="bilinear", align_corners=False)
    frames = [big[0, :, :H, t:t + W] for t in range(T)]
    return torch.stack(frames).permute(0, 2, 3, 1).contiguous() * 0.3 + 0.05


def adapt_phase(dev, smi, small, small_model, small_sd, small_clip, small_bf16,
                exact_small) -> None:
    """Phase 13: adaptation, its serving through every hand kernel, the
    refine, the metrics and VGG-19, the card against the CPU, and the NHWC
    fused route."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine.adapt import adapt_generator, lr_consistency_refine
    from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                    build_quantized_clip_inference)
    from tecogan_tpu_torch.engine.losses import generator_unroll
    from tecogan_tpu_torch.engine.state import init_generator, model_defs, train_tensors
    from tecogan_tpu_torch.models.vgg import init_vgg, vgg19_features, vgg_model
    from tecogan_tpu_torch.ops.metrics import (lpips_distance, psnr_per_frame, ssim,
                                               vgg_perceptual_distance)
    from tecogan_tpu_torch.ops.resize import resize_bilinear_aa
    from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

    JAX_REPORT_KEYS = {"holdout_windows", "holdout_overlaps_train", "base_psnr_db",
                       "base_ssim", "chosen_psnr_db", "chosen_ssim", "chosen_step",
                       "adapted_served"}

    reset_counts, counts = _reset_counts, _kernel_counts

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # -- 13a. adapt_generator at the CLI's defaults, full width
    cfg = TecoConfig(precision="bf16", bug_parity=False)  # 16 resblocks, RNN_N 10
    H, W = ADAPT_HW
    clip = smooth_clip(ADAPT_T, H, W, seed=13)
    base = train_tensors(generator_state_dict_from_jax(
        init_generator(cfg, torch.Generator().manual_seed(0))), dev)
    # reckon the no-remat memory: the consistency term's two serving
    # windows of RNN_N frames hold their activations until its backward
    # (the internal term's 16 windows at 1/16 the pixels hold about half)
    gen = model_defs(cfg, device=dev)
    probe = clip[:2].permute(0, 3, 1, 2)[None].to(dev)
    leaves = {k: v.detach().requires_grad_() for k, v in base.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = generator_unroll(gen, leaves, probe, cfg.replace(bug_parity=False)).gen_outputs
    torch.cuda.synchronize()
    per_frame = (torch.cuda.max_memory_allocated(dev) - before) / 2
    del out, leaves, probe
    serve_frames = max(1, 16 // 8) * cfg.RNN_N
    reckoned = per_frame * serve_frames
    total = torch.cuda.get_device_properties(dev).total_memory
    remat = reckoned > MEMORY_SHARE * total
    cfg = cfg.replace(remat=remat)
    losses, stamps = [], []

    def on_step(i, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss))

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adapted, report = adapt_generator(cfg, base, clip, steps=ADAPT_STEPS, learning_rate=1e-4,
                                      consistency=2.0, max_batch=16, guard=True,
                                      eval_every=ADAPT_EVAL_EVERY, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    require(len(losses) == ADAPT_STEPS and all(np.isfinite(v) for v in losses),
            f"[13a] adaptation losses {losses}")
    require(set(report) == JAX_REPORT_KEYS, f"[13a] report keys {sorted(report)}")
    require(report["adapted_served"] and report["chosen_step"] > 0,
            f"[13a] the guard kept the base params: {report}")
    require(adapted.keys() == base.keys() and all(v.dtype == torch.float32 for v in adapted.values())
            and any(not torch.equal(adapted[k], base[k]) for k in base),
            "[13a] the adapted params did not move")
    print(f"[13a] adapt_generator, {cfg.num_resblock} resblocks bf16, {ADAPT_T} frames of {H}x{W}, RNN_N "
          f"{cfg.RNN_N}, max_batch 16, consistency 2.0, guard, {ADAPT_STEPS} steps: losses "
          f"{[round(v, 6) for v in losses]} | {statistics.median(step_ms):.1f} ms a step "
          f"(median of steps 1-{ADAPT_STEPS - 1}, guard scoring included; step 0 "
          f"{(stamps[0] - t0) * 1e3:.1f} ms with the pools and the base score), "
          f"{wall:.2f} s in all | remat {'on' if remat else 'off'}: reckoned "
          f"{reckoned / 2**30:.1f} GiB for {serve_frames} serving frames without it "
          f"({per_frame / 2**30:.2f} GiB a frame, measured on a 2-frame unroll) against "
          f"{MEMORY_SHARE:.0%} of {total / 2**30:.1f} GiB | peak device memory "
          f"{peak / 2**30:.2f} GiB | report {report} | {smi}", flush=True)
    del base, gen

    # -- 13b. serve the adapted params: bf16 fused, then int8 after a fresh calibration
    model = model_defs(cfg, device=dev)
    model.load_state_dict(adapted)
    model.eval()
    lr8 = clip[None, :SERVE_T].to(dev)
    infer = build_clip_inference(cfg)
    infer(model, lr8)  # warm-up
    reset_counts()
    fused_out, fused_ms = timed(lambda: infer(model, lr8))
    bf16_counts = counts()
    prepare, qinfer = build_quantized_clip_inference(cfg)
    qtail = prepare(model, adapted, lr8, frames=SERVE_T)
    qinfer(model, qtail, lr8)  # warm-up
    reset_counts()
    q_out, q_ms = timed(lambda: qinfer(model, qtail, lr8))
    q_counts = counts()
    n = cfg.num_resblock
    shape = (1, SERVE_T, 4 * H, 4 * W, 3)
    for name, out in (("bf16", fused_out), ("int8", q_out)):
        require(tuple(out.shape) == shape and bool(torch.isfinite(out).all())
                and float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
                f"[13b] adapted {name} clip {tuple(out.shape)}")
    require(n == 16 and bf16_counts == _fused_launches(SERVE_T, "bf16"),
            f"[13b] bf16 launches {bf16_counts}")
    require(q_counts == _fused_launches(SERVE_T, "int8"), f"[13b] int8 launches {q_counts}")
    # phase 5's scaled small width: adapt, then int8 against bf16 on the adapted params
    small_adapted = adapt_generator(small, small_sd, small_clip[0], steps=2, learning_rate=1e-4,
                                    device=dev)
    small_model.load_state_dict(small_adapted)
    s_bf16 = build_clip_inference(small)(small_model, small_clip)
    sprep, sinfer = build_quantized_clip_inference(small)
    s_int8 = sinfer(small_model, sprep(small_model, small_adapted, small_clip, frames=4),
                    small_clip)
    db = psnr(s_int8, s_bf16)
    print(f"[13b] adapted params served, {SERVE_T} frames {H}x{W} -> {4 * H}x{4 * W}: bf16 "
          f"fused {fused_ms:.3f} ms ({SERVE_T / fused_ms * 1e3:.3f} fps), launches {bf16_counts}; "
          f"int8 after calibrate_clip + quantize_tail on the adapted params {q_ms:.3f} ms "
          f"({SERVE_T / q_ms * 1e3:.3f} fps), launches {q_counts}; int8 vs bf16 "
          f"{psnr(q_out, fused_out):.2f} dB | small width, kernels x{KERNEL_GAIN}, 2 adapt "
          f"steps: int8 vs bf16 {db:.2f} dB (bar {INT8_VS_BF16_DB} dB), moved from the "
          f"unadapted bf16 clip by {psnr(s_bf16, small_bf16):.2f} dB | {smi}", flush=True)
    require(db > INT8_VS_BF16_DB, f"[13b] small adapted int8 vs bf16 {db:.2f} dB")
    small_model.load_state_dict(small_sd)  # phase 13f serves phase 5's weights
    del q_out, qtail

    # -- 13c. post-hoc LR-consistency refine of the 1080p SR clip
    sr, lr = fused_out[0], lr8[0]

    def consistency(x):
        return float(torch.sqrt(torch.mean(torch.square(resize_bilinear_aa(x, lr.shape) - lr))))

    refined, refine_ms = timed(lambda: lr_consistency_refine(sr, lr, iters=REFINE_ITERS))
    c0, c1 = consistency(sr), consistency(refined)
    require(refined.shape == sr.shape and bool(torch.isfinite(refined).all()) and c1 < c0,
            f"[13c] refine: consistency {c0} -> {c1}")
    print(f"[13c] lr_consistency_refine, {REFINE_ITERS} iterations on {tuple(sr.shape)}: "
          f"RMS |down4(sr) - lr| {c0:.6f} -> {c1:.6f}, {refine_ms:.3f} ms | {smi}", flush=True)
    del refined

    # -- 13d. the metrics between the fused and the exact route's 1080p frames
    exact_cfg = cfg.replace(use_pallas=False)
    exact = build_clip_inference(exact_cfg)(model, lr8)[0]
    fused = fused_out[0]
    vgg = vgg_model(init_vgg(torch.Generator().manual_seed(19)), device=dev)
    with torch.inference_mode():
        per_frame_db, psnr_ms = timed(lambda: psnr_per_frame(exact, fused))
        s_val, ssim_ms = timed(lambda: ssim(fused, exact))
        feats, vgg_ms = timed(lambda: [vgg19_features(vgg, x[t:t + 1], VGG_LAYERS)
                                       for x in (fused, exact) for t in range(SERVE_T)])
        fx = {k: torch.cat([f[k] for f in feats[:SERVE_T]]) for k in VGG_LAYERS}
        fy = {k: torch.cat([f[k] for f in feats[SERVE_T:]]) for k in VGG_LAYERS}
        d_vgg, dist_ms = timed(lambda: vgg_perceptual_distance(fx, fy, VGG_LAYERS))
        d_lpips, lpips_ms = timed(lambda: lpips_distance(fx, fy, VGG_LAYERS))
    vals = [float(v) for v in per_frame_db] + [float(s_val), float(d_vgg), float(d_lpips)]
    require(tuple(per_frame_db.shape) == (SERVE_T,) and all(np.isfinite(v) for v in vals)
            and -1.0 <= float(s_val) <= 1.0 and float(d_vgg) >= 0 and float(d_lpips) >= 0,
            f"[13d] metrics {vals}")
    print(f"[13d] fused vs exact route (adapted params, bf16), {SERVE_T} frames {4 * H}x{4 * W}:"
          f" psnr_per_frame mean {float(per_frame_db.mean()):.3f} dB (min "
          f"{float(per_frame_db.min()):.3f}) in {psnr_ms:.3f} ms; ssim {float(s_val):.6f} in "
          f"{ssim_ms:.3f} ms; VGG-19 (seeded weights, published widths) features of "
          f"{2 * SERVE_T} frames to conv4_4 in {vgg_ms:.3f} ms; vgg_perceptual_distance "
          f"{float(d_vgg):.6e} in {dist_ms:.3f} ms; lpips_distance (uniform weights, the "
          f"surrogate) {float(d_lpips):.6e} in {lpips_ms:.3f} ms | {smi}", flush=True)
    del feats, fx, fy, model, adapted

    # -- 13e. the card against the CPU
    tiny = TecoConfig(precision="fp32", num_resblock=1, bug_parity=False, use_pallas=False,
                      crop_size=8, RNN_N=3)
    tiny_params = init_generator(tiny, torch.Generator().manual_seed(0))
    tiny_clip = smooth_clip(9, 24, 24, seed=5)

    def tiny_run(where):
        got = []
        params, report = adapt_generator(tiny, tiny_params, tiny_clip, steps=3,
                                         learning_rate=1e-3, consistency=0.5, guard=True,
                                         eval_every=1, device=where,
                                         on_step=lambda i, loss: got.append(float(loss)))
        require(all(v.device.type == where.type for v in params.values()),
                f"[13e] adaptation on {where} returned params elsewhere")
        return got, report

    (card_l, card_r), (cpu_l, cpu_r) = tiny_run(dev), tiny_run(torch.device("cpu"))
    worst = max(rel(a, b) for a, b in zip(card_l, cpu_l))
    require(len(card_l) == len(cpu_l) == 3 and worst <= CARD_CPU_RTOL,
            f"[13e] adaptation losses card {card_l} cpu {cpu_l}")
    d_base = abs(card_r["base_psnr_db"] - cpu_r["base_psnr_db"])
    require(d_base <= CARD_CPU_RTOL, f"[13e] base PSNR card {card_r} cpu {cpu_r}")
    # SSIM with TF32 left on globally: the filter turns it off itself
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        s_card = float(ssim(fused[:2], exact[:2]))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    s_cpu = float(ssim(fused[:2].cpu(), exact[:2].cpu()))
    require(abs(s_card - s_cpu) <= SSIM_CARD_CPU_TOL, f"[13e] ssim card {s_card} cpu {s_cpu}")
    x64 = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    vgg_cpu = vgg_model(init_vgg(torch.Generator().manual_seed(19)), device="cpu")
    with torch.inference_mode():
        card_f = vgg(x64.to(dev) * 255.0 - 120.0)[1]
        cpu_f = vgg_cpu(x64 * 255.0 - 120.0)[1]
    vgg_worst = max(float((card_f[k].cpu() - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                    for k, v in cpu_f.items())
    require(vgg_worst <= VGG_CARD_CPU_RTOL, f"[13e] VGG features card vs CPU {vgg_worst}")
    print(f"[13e] card vs CPU: adaptation at the tiny fp32 config (TF32 off), 3 guarded steps: "
          f"losses rel {worst:.3e} (worst; bar {CARD_CPU_RTOL}), base PSNR {card_r['base_psnr_db']}"
          f" / {cpu_r['base_psnr_db']} dB (bar {CARD_CPU_RTOL} dB), chosen step "
          f"{card_r['chosen_step']} / {cpu_r['chosen_step']} | ssim on 2 frames of "
          f"{4 * H}x{4 * W} with TF32 on globally {s_card:.9f} / {s_cpu:.9f} (bar "
          f"{SSIM_CARD_CPU_TOL}) | VGG-19 end points at 64x64 (TF32 off): {vgg_worst:.3e} of each "
          f"layer's largest (bar {VGG_CARD_CPU_RTOL}) | {smi}", flush=True)
    del vgg, vgg_cpu, fused, exact, fused_out

    # -- 13f. the NHWC fused route on the card (phase 5's scaled small width),
    #    with cuDNN held to deterministic algorithms for the bit-level compare
    torch.backends.cudnn.deterministic = True
    s2d_out = build_clip_inference(small)(small_model, small_clip)
    lines = []
    for group in (2, 8):
        reset_counts()
        out = build_clip_inference(small.replace(warp_group=group))(small_model, small_clip)
        c = counts()
        require(torch.equal(out, s2d_out), f"[13f] warp_group {group} differs from the s2d route")
        require(c["warp_s2d"] == SMALL_CLIP[1] - 1 and c["conv_out_s2d"] == SMALL_CLIP[1],
                f"[13f] warp_group {group} launches {c}")
        lines.append(f"warp_group {group}: bit-equal to the s2d route, launches {c}")
    odd = small_clip[:, :, :, :SMALL_CLIP[3] - 1].contiguous()  # 4W % 8 == 4
    reset_counts()
    out = build_clip_inference(small.replace(warp_group=8))(small_model, odd)
    c = counts()
    torch.backends.cudnn.deterministic = False
    want = build_clip_inference(small.replace(precision="fp32", use_pallas=False))(exact_small, odd)
    db = psnr(out[:, -1], want[:, -1])
    require(c["warp_s2d"] == 0 and c["conv_out_s2d"] == SMALL_CLIP[1],
            f"[13f] odd width launches {c}")
    print(f"[13f] NHWC fused route, {SMALL_CLIP[1]} frames {SMALL_CLIP[2]}x{SMALL_CLIP[3]}: "
          + "; ".join(lines) + f" | warp_group 8 at LR width {odd.shape[3]} (the bf16 frame "
          f"warp, F.grid_sample): last frame {db:.2f} dB against the exact fp32 route (bar "
          f"{PSNR_BAR_DB} dB), launches {c} | {smi}", flush=True)
    require(db > PSNR_BAR_DB, f"[13f] odd width vs exact {db:.2f} dB")


# phase 14: the command line on the card
CLI_TRAIN_STEPS, CLI_DISPATCH = 6, 2
CLI_LR, CLI_T = 270, 16              # full width: 270 x 270 LR -> 1080 x 1080
CLI_CHUNK = 8
CLI_ADAPT_LR, CLI_ADAPT_T, CLI_ADAPT_STEPS = 268, 12, 2   # /4-divisible for adaptation
LIVE_SOURCE = "synth:class=chess:noise=0.02:size=480x270"


def cli_phase(dev, smi) -> None:
    """Phase 14: train, resume and serve through ``cli.main.main``, then
    ``cli.evaluate`` and ``cli.live``, as a user runs them."""
    import tempfile

    import cv2

    from tecogan_tpu_torch.cli import evaluate, live
    from tecogan_tpu_torch.cli import main as cli
    from tecogan_tpu_torch.config import parse_config
    from tecogan_tpu_torch.data.scenes import InferenceDataset, load_video_frames
    from tecogan_tpu_torch.data.synthetic import (moving_rect_scene,
                                                  write_synthetic_scene_folders)
    from tecogan_tpu_torch.engine import inference as engine_inference
    from tecogan_tpu_torch.engine.inference import (build_chunked_inference,
                                                    build_clip_inference)
    from tecogan_tpu_torch.engine.state import init_state
    from tecogan_tpu_torch.ops import image
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod
    from tecogan_tpu_torch.utils.checkpoint import (has_checkpoint, load_generator_params,
                                                    load_train_state)

    def counts():
        return (qmod.conv3x3_launch_count, qmod.up2x_launch_count, kmod.launch_count,
                wmod.launch_count)

    def run(fn, argv, **kw):
        """``fn(argv)`` with the launch counts set to 0 just before and read
        just after; returns (its stdout, counts, seconds, peak bytes)."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kmod.launch_count = wmod.launch_count = 0
        qmod.conv3x3_launch_count = qmod.up2x_launch_count = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(argv, **kw)
        torch.cuda.synchronize()
        return (buf.getvalue(), counts(), time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev))

    def grab(pattern, text, what):
        found = re.findall(pattern, text)
        require(bool(found), f"[14] no {what} in the CLI's output:\n{text[-2000:]}")
        return found

    # the CLI's writers and the int8 build, recorded (and still run)
    handed, windows, calibrations = [], [], []
    real_save, real_writer = image.save_as_media, image.MediaWriter
    real_build = engine_inference.build_quantized_clip_inference

    def save(frames, path, *a, **kw):
        handed.append(np.array(frames))
        real_save(frames, path, *a, **kw)

    class Writer(real_writer):
        def append(self, frames):
            windows.append(np.array(frames))
            super().append(frames)

    def build_q(cfg):
        prepare, qinfer = real_build(cfg)

        def recorded(model, params, clip, frames=8):
            before = counts()
            qtail = prepare(model, params, clip, frames)
            torch.cuda.synchronize()
            calibrations.append((params, tuple(a - b for a, b in zip(counts(), before))))
            return qtail

        return recorded, qinfer

    image.save_as_media, image.MediaWriter = save, Writer
    engine_inference.build_quantized_clip_inference = build_q
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        # -- 14a. scenes
        t0 = time.perf_counter()
        scenes = os.path.join(tmp, "scenes")
        write_synthetic_scene_folders(scenes, num_scenes=3, frames_per_scene=120, size=128,
                                      variety=True)
        print(f"[14a] 3 synthetic scenes of 120 frames 128x128 (variety) written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        # -- 14b. train, validate, resume
        out = os.path.join(tmp, "train")
        train = ["--mode", "train", "--input_video_dir", scenes, "--str_dir", "1000",
                 "--end_dir", "1001", "--end_dir_val", "1002", "--validate_every", "1",
                 "--output_dir", out, "--summary_dir", os.path.join(out, "summary"),
                 "--bug_parity", "False", "--steps_per_epoch", str(CLI_TRAIN_STEPS),
                 "--steps_per_dispatch", str(CLI_DISPATCH), "--precision", "bf16"]
        template_cfg = parse_config(train)
        for name, extra, epochs in (("train", ["--max_epochs", "1"], 1),
                                    ("resume", ["--max_epochs", "2", "--pre_trained_model",
                                                "True"], 2)):
            text, c, secs, peak = run(cli.main, train + extra)
            steps = grab(r"Epoch steps: (\d+) in [0-9.]+ s, ([0-9.]+) ms a step, ([0-9.]+) "
                         r"samples/s", text, "step time")
            psnrs = [float(v) for v in grab(r"Validation PSNR: ([-0-9.]+) dB", text, "PSNR")]
            require(len(steps) == epochs and all(int(n) == CLI_TRAIN_STEPS for n, _, _ in steps),
                    f"[14b] {name}: epochs / steps {steps}")
            require(name == "train" or "resumed from epoch 0" in text, "[14b] no resume line")
            require(all(np.isfinite(psnrs)) and len(psnrs) == epochs, f"[14b] PSNR {psnrs}")
            require(c == (0, 0, 10 * epochs, 9 * epochs),
                    f"[14b] {name}: validation launches {c} (10 frames an epoch)")
            require(has_checkpoint(out), "[14b] no checkpoint pair")
            state, epoch = load_train_state(out, init_state(template_cfg,
                                                            torch.Generator().manual_seed(0)))
            require(epoch == epochs - 1 and state.step == CLI_TRAIN_STEPS * (1 + 2 * (epochs - 1)),
                    f"[14b] {name}: checkpoint at epoch {epoch}, step {state.step}")
            missing = [a for a in ("gan.gif", "real.gif", "original.gif", "Gan_examples.jpg",
                                   "real_image.jpg", "original_image.jpg",
                                   "summary/train_metrics.jsonl")
                       if not os.path.exists(os.path.join(out, a))]
            require(not missing, f"[14b] missing artifacts {missing}")
            print(f"[14b] cli {name}: B=4 RNN_N=10 crop 32, 16 resblocks, D 4x128, bf16, "
                  f"bug_parity False, {CLI_DISPATCH} steps a dispatch: "
                  + "; ".join(f"epoch {i + 1}: {float(ms):.3f} ms a step, {float(sps):.3f} "
                              f"samples/s" for i, (_, ms, sps) in enumerate(steps))
                  + f" (as the CLI printed them: the epoch's wall time over its steps, input "
                  f"pipeline and first-step warm-up included) | validation PSNR "
                  f"{', '.join(f'{v:.3f}' for v in psnrs)} dB, launches conv_out_s2d {c[2]}, "
                  f"warp_s2d {c[3]} | checkpoint epoch {epoch} step {state.step} loaded, "
                  f"artifacts present | peak device memory {peak / 2**30:.3f} GiB | "
                  f"{secs:.1f} s | {smi}", flush=True)
        del state

        # -- 14c. inference, dataset mode, full width
        g_ckpt = os.path.join(out, "generator.ckpt")
        params = load_generator_params(g_ckpt)
        lr_dir = os.path.join(tmp, "lr", "clip_0000")
        os.makedirs(lr_dir)
        for t in range(CLI_T):
            shutil.copy(os.path.join(scenes, "scene_1001", f"col_high_{t:04d}.png"), lr_dir)
        infer_argv = ["--mode", "inference", "--input_dir_LR", os.path.dirname(lr_dir),
                      "--g_checkpoint", g_ckpt, "--crop_size", str(CLI_LR), "--bug_parity",
                      "False", "--summary_dir", os.path.join(tmp, "summary")]
        cfg = parse_config(infer_argv)
        model = cli._model(cfg, params, dev)
        clip = InferenceDataset(cfg).get_clip(0)
        require(clip.shape == (CLI_T, CLI_LR, CLI_LR, 3), f"[14c] clip {clip.shape}")
        want = build_clip_inference(cfg)(model, torch.from_numpy(clip)[None].to(dev))[0].cpu()
        handed.clear()
        mp4 = os.path.join(tmp, "out_c", "output0.mp4")
        text, c, secs, _ = run(cli.main, infer_argv + ["--output_dir", os.path.dirname(mp4)])
        fps = float(grab(r"\(([0-9.]+) fps\)", text, "fps")[0])
        require(len(handed) == 1 and np.array_equal(handed[0], want.numpy()),
                "[14c] the CLI's frames differ from build_clip_inference")
        require(c == (0, 0, CLI_T, CLI_T - 1), f"[14c] launches {c}")
        cap, n_dec, shape = cv2.VideoCapture(mp4), 0, None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            n_dec, shape = n_dec + 1, frame.shape
        cap.release()
        require(n_dec == CLI_T and shape == (4 * CLI_LR, 4 * CLI_LR, 3),
                f"[14c] mp4 decoded to {n_dec} frames of {shape}")
        print(f"[14c] cli inference, dataset mode, {CLI_T} frames {CLI_LR}x{CLI_LR} -> "
              f"{4 * CLI_LR}x{4 * CLI_LR}, fused bf16: {fps:.1f} fps as the CLI printed it "
              f"({secs:.2f} s for the call, checkpoint load included) | bit-equal to "
              f"build_clip_inference | launches conv_out_s2d {c[2]}, warp_s2d {c[3]} | mp4 "
              f"{n_dec} frames of {shape[1]}x{shape[0]} | {smi}", flush=True)

        # -- 14d. int8
        prepare, qinfer = real_build(cfg)
        qtail = prepare(model, params, clip[None], frames=8)
        want_q = qinfer(model, qtail, torch.from_numpy(clip)[None].to(dev))[0].cpu().numpy()
        handed.clear()
        calibrations.clear()
        text, c, secs, _ = run(cli.main, infer_argv + ["--output_dir", os.path.join(tmp, "out_d"),
                                                      "--quantize", "int8"])
        fps = float(grab(r"\(([0-9.]+) fps\)", text, "fps")[0])
        require(len(handed) == 1 and np.array_equal(handed[0], want_q),
                "[14d] the CLI's int8 frames differ from build_quantized_clip_inference")
        require(len(calibrations) == 1 and calibrations[0][1] == (0, 0, 8, 7),
                f"[14d] calibrations {[k for _, k in calibrations]}")
        clip_c = tuple(a - b for a, b in zip(c, calibrations[0][1]))
        require(clip_c == (37 * CLI_T, 2 * CLI_T, CLI_T, CLI_T - 1),
                f"[14d] the clip's launches {clip_c}")
        print(f"[14d] cli --quantize int8: bit-equal to build_quantized_clip_inference | the "
              f"clip's launches int8_conv3x3 {clip_c[0]}, int8_up2x {clip_c[1]}, conv_out_s2d "
              f"{clip_c[2]}, warp_s2d {clip_c[3]}; the calibration's (8 frames) "
              f"{calibrations[0][1]} | {fps:.1f} fps as the CLI printed it | {smi}", flush=True)

        # -- 14e. chunked, u8 in and out
        want_u8 = build_chunked_inference(cfg, out_u8=True)(
            model, image.transfer_quantize_u8(clip[None]), chunk=CLI_CHUNK)[0].numpy()
        windows.clear()
        text, c, secs, _ = run(cli.main, infer_argv + [
            "--output_dir", os.path.join(tmp, "out_e"), "--infer_chunk", str(CLI_CHUNK),
            "--transfer_dtype", "u8"])
        fps = float(grab(r"\(([0-9.]+) fps\)", text, "fps")[0])
        require([w.shape[0] for w in windows] == [CLI_CHUNK] * (CLI_T // CLI_CHUNK)
                and np.array_equal(np.concatenate(windows), want_u8),
                "[14e] the CLI's u8 windows differ from the engine's chunked u8 run")
        require(c == (0, 0, CLI_T, CLI_T - 1), f"[14e] launches {c}")
        print(f"[14e] cli --infer_chunk {CLI_CHUNK} --transfer_dtype u8: windows "
              f"{[w.shape[0] for w in windows]} bit-equal to build_chunked_inference(out_u8) | "
              f"launches conv_out_s2d {c[2]}, warp_s2d {c[3]} | {fps:.1f} fps | {smi}", flush=True)

        # -- 14f. two adapted clips, int8
        adapt_root = os.path.join(tmp, "adapt")
        for i, scene in enumerate(("scene_1000", "scene_1002")):
            d = os.path.join(adapt_root, f"clip_{i:04d}")
            os.makedirs(d)
            for t in range(CLI_ADAPT_T):
                shutil.copy(os.path.join(scenes, scene, f"col_high_{t:04d}.png"), d)
        calibrations.clear()
        handed.clear()
        text, c, secs, peak = run(cli.main, infer_argv + [
            "--input_dir_LR", adapt_root, "--crop_size", str(CLI_ADAPT_LR), "--output_dir",
            os.path.join(tmp, "out_f"), "--adapt_steps", str(CLI_ADAPT_STEPS), "--quantize",
            "int8"])
        served = grab(r"clip \d: \d+ adapt steps in [0-9.]+s; serving ([^\n]+)", text, "adapt")
        require(len(calibrations) == 2 and calibrations[0][0] is not calibrations[1][0]
                and all(isinstance(next(iter(p.values())), torch.Tensor)
                        for p, _ in calibrations),
                f"[14f] {len(calibrations)} calibrations for 2 adapted clips")
        cal = tuple(sum(k[i] for _, k in calibrations) for i in range(4))
        clip_c = tuple(a - b for a, b in zip(c, cal))
        require(clip_c == (2 * 37 * CLI_ADAPT_T, 2 * 2 * CLI_ADAPT_T, 2 * CLI_ADAPT_T,
                           2 * (CLI_ADAPT_T - 1)) and len(handed) == 2,
                f"[14f] the clips' launches {clip_c}")
        require(all(np.isfinite(h).all() for h in handed), "[14f] non-finite frames")
        print(f"[14f] cli --adapt_steps {CLI_ADAPT_STEPS} --quantize int8, 2 clips of "
              f"{CLI_ADAPT_T} frames {CLI_ADAPT_LR}x{CLI_ADAPT_LR}: 2 calibrations, one on "
              f"the params each clip was served with (adapt_generator's, which are the "
              f"base's when the guard keeps it) | served: {served} | the clips' launches "
              f"{clip_c}, the calibrations' {cal} | {secs:.2f} s, peak device memory "
              f"{peak / 2**30:.3f} GiB | {smi}", flush=True)

        # -- 14g. video mode
        vid = os.path.join(tmp, "in.mp4")
        w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 24, (480, 270))
        for f in moving_rect_scene(CLI_T, 270, 480):
            w.write(cv2.cvtColor((f * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        w.release()
        vclip = load_video_frames(vid, CLI_LR)
        want = build_clip_inference(cfg)(model, torch.from_numpy(vclip)[None].to(dev))[0]
        handed.clear()
        text, c, secs, _ = run(cli.main, infer_argv + [
            "--inferencetype", "video", "--input_dir_LR", vid, "--output_dir",
            os.path.join(tmp, "out_g")])
        require(len(handed) == 1 and np.array_equal(handed[0], want.cpu().numpy()),
                "[14g] video mode differs from build_clip_inference on load_video_frames")
        require(c == (0, 0, CLI_T, CLI_T - 1), f"[14g] launches {c}")
        print(f"[14g] cli video mode, a cv2-written mp4 of {CLI_T} frames 480x270 -> "
              f"{CLI_LR}x{CLI_LR}: bit-equal to build_clip_inference on load_video_frames | "
              f"launches conv_out_s2d {c[2]}, warp_s2d {c[3]} | {smi}", flush=True)

        # -- 14h. evaluate and live
        text, _, secs, _ = run(evaluate.main, ["--sr_dir", mp4, "--hr_dir",
                                               os.path.join(scenes, "scene_1001"),
                                               "--limit_frames", str(CLI_T)])
        agg = json.loads(text.strip().splitlines()[-1])
        require(agg["clips"] == 1 and np.isfinite(agg["psnr_db"]) and 0 < agg["ssim"] <= 1,
                f"[14h] evaluate {agg}")
        stats = {}
        text, c, _, _ = run(lambda a: stats.update(live.main(a)), [
            "--g_checkpoint", g_ckpt, "--source", LIVE_SOURCE, "--no-display", "--frames",
            str(CLI_T), "--crop_size", str(CLI_LR)])
        require(stats.get("frames") == CLI_T and c == (0, 0, CLI_T, CLI_T - 1),
                f"[14h] live {stats}, launches {c}")
        print(f"[14h] cli.evaluate (c)'s mp4 vs its 16 source frames: PSNR {agg['psnr_db']:.3f} "
              f"dB, SSIM {agg['ssim']:.5f} ({secs:.2f} s) | cli.live {LIVE_SOURCE} -> "
              f"{4 * CLI_LR}x{4 * CLI_LR}, {CLI_T} frames: latency p50 "
              f"{stats['latency_p50_ms']:.3f} ms, max {stats['latency_max_ms']:.3f} ms "
              f"(line {FRAME_BUDGET_MS:.1f} ms), {stats['fps']:.1f} fps | launches "
              f"conv_out_s2d {c[2]}, warp_s2d {c[3]} | {smi}", flush=True)
    finally:
        image.save_as_media, image.MediaWriter = real_save, real_writer
        engine_inference.build_quantized_clip_inference = real_build
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 15: the multi-rank paths on the one card
# ---------------------------------------------------------------------------

SPATIAL_T = 8
# bf16 frames of a row-sharded clip against the single-device clip:
# tests/test_spatial.py's bf16 bar (max, mean abs) and the PSNR bar above
SPATIAL_MAX, SPATIAL_MEAN = 2e-2, 2e-3
EXACT_SPATIAL_TOL = 1e-4             # the port's exact bar (tests/test_torch_port_inference.py)
# tecogan_tpu/parallel/spatial.py:31-36 reckons 20-40 MB of collective
# traffic a frame at 1080p (one 12.4 MB and one 1.5 MB all-gather, ~35 halos)
RECKONED_MB = (20.0, 40.0)
DP_TIMED_STEPS = 3
FNET_WARMUP, FNET_STEPS = 1, 3
FNET_TINY = dict(crop_size=16, RNN_N=3, num_resblock=1, batch_size=1, precision="fp32")
TP_STEPS = 2
TP_TINY = dict(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1, discrim_channels=16,
               precision="fp32", batch_size=4)


def _model_on(cfg, params, dev):
    from tecogan_tpu_torch.engine.state import model_defs
    from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

    model = model_defs(cfg, device=dev)
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _kernel_counts():
    from tecogan_tpu_torch.ops.kernels import bf16_conv as bmod
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod

    return {"conv_out_s2d": kmod.launch_count, "warp_s2d": wmod.launch_count,
            "int8_conv3x3": qmod.conv3x3_launch_count, "int8_up2x": qmod.up2x_launch_count,
            "bf16_conv3x3": bmod.conv3x3_launch_count, "bf16_up2x": bmod.up2x_launch_count}


def _reset_counts():
    from tecogan_tpu_torch.ops.kernels import bf16_conv as bmod
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod

    kmod.launch_count = wmod.launch_count = 0
    qmod.conv3x3_launch_count = qmod.up2x_launch_count = 0
    bmod.conv3x3_launch_count = bmod.up2x_launch_count = 0


def _fused_launches(frames: int, tail: str) -> dict:
    """The hand kernels' launches of a fused clip of ``frames`` frames at
    16 resblocks: one ``conv_out_s2d`` a frame, one ``warp_s2d`` a frame
    after the first, and the tail's 37 3x3 and 2 transposed convs a frame
    on the kernels of ``tail`` ('bf16' or 'int8'; 'modules' runs cuDNN)."""
    out = {"conv_out_s2d": frames, "warp_s2d": frames - 1, "int8_conv3x3": 0,
           "int8_up2x": 0, "bf16_conv3x3": 0, "bf16_up2x": 0}
    if tail != "modules":
        out[f"{tail}_conv3x3"], out[f"{tail}_up2x"] = 37 * frames, 2 * frames
    return out


def _recorder():
    """A ``TorchDispatchMode`` (built on first use) that keeps the last
    launch of each hand kernel's custom op (``tecogan_tpu_torch::*``;
    ``int8_conv3x3`` and ``bf16_conv3x3`` with and without their residual
    apart): its inputs and its output.  The launches run and count as
    without it; ``check()`` holds each kept output against its plain
    version on the same inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tecogan_tpu_torch.ops.kernels import bf16_conv as bmod
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod
    from tecogan_tpu_torch.tools import bf16_layers

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.last = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "tecogan_tpu_torch":
                key = func._opname
                if ((key == "int8_conv3x3" and args[6] is not None)
                        or (key == "bf16_conv3x3" and args[4] is not None)):
                    key += "+res"
                self.last[key] = (args, out)
            return out

        @torch.inference_mode()
        def check(self) -> dict:
            """The kernel agreement bars (conv_out_s2d, warp_s2d,
            ``bf16_layers.check``'s for the bf16 convs) or bit-equality
            (int8) for each kept launch."""
            res = {}
            for key, (args, got) in self.last.items():
                bars, within = None, None
                if key.startswith("bf16_"):
                    up = key == "bf16_up2x"
                    plain = bmod.bf16_up2x_reference if up else bmod.bf16_conv3x3_reference
                    want = plain(*args)
                    try:
                        bf16_layers.check(got, want, *args, up)
                        within = True
                    except AssertionError:
                        within = False
                elif key == "conv_out_s2d":
                    feat, k, b = args  # the kernel rounds its weights to bf16
                    want = kmod.conv_out_s2d_reference(feat.float(), k.bfloat16().float(), b)
                    bars = (MAX_ERR, MEAN_ERR)
                elif key == "warp_s2d_feedback":
                    want = wmod.warp_s2d_feedback_reference(*args)
                    bars = (WARP_MAX_ERR, WARP_MEAN_ERR)
                else:
                    plain = (qmod.int8_up2x_reference if key == "int8_up2x"
                             else qmod.int8_conv3x3_reference)
                    want = plain(*args)
                err = (got.float() - want.float()).abs()
                rec = {"rows": args[0].shape[1], "max": float(err.max()),
                       "mean": float(err.mean())}
                if within is not None:
                    rec["ok"] = within
                elif bars is None:
                    rec["ok"] = bool(torch.equal(got, want))
                else:
                    rec["ok"] = rec["max"] <= bars[0] and rec["mean"] <= bars[1]
                res[key] = rec
            torch.cuda.synchronize()
            return res

    return Recorder()


class _GatherClock:
    """``torch.distributed.all_gather`` timed on the host (synchronised on
    both sides, so the collective's own time) with the bytes each rank
    sends and receives; on only while ``on`` is set."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.real = dist, dist.all_gather
        self.ms = self.bytes = 0.0
        self.calls, self.on = 0, False
        dist.all_gather = self.call

    def call(self, tensor_list, tensor, group=None, async_op=False):
        if not self.on:
            return self.real(tensor_list, tensor, group=group, async_op=async_op)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = self.real(tensor_list, tensor, group=group, async_op=async_op)
        torch.cuda.synchronize()
        self.ms += (time.perf_counter() - t0) * 1e3
        self.bytes += tensor.numel() * tensor.element_size() * len(tensor_list)
        self.calls += 1
        return work

    def restore(self):
        self.dist.all_gather = self.real


def _frames_apart(got, want) -> dict:
    d = (got.float() - want.float()).abs()
    return {"max": float(d.max()), "mean": float(d.mean()), "psnr": psnr(got, want),
            "equal": bool(torch.equal(got, want))}


def _modules_tail_clip(cfg, model, clip: torch.Tensor) -> torch.Tensor:
    """The single-device fused clip with the generator tail on the
    modules (cuDNN's convs and torch's bias, ReLU and skip-add passes): the
    tail the spatial route keeps, where the single-device bf16 route runs
    the fused conv kernels."""
    from tecogan_tpu_torch.engine import inference
    from tecogan_tpu_torch.engine.fused import fused_first_frame_s2d, fused_sr_step_s2d

    route = inference._route(cfg)._replace(
        first=fused_first_frame_s2d,
        step=lambda m, carry, prev_lr, cur_lr: fused_sr_step_s2d(
            m, carry, prev_lr, cur_lr, warp_group=cfg.warp_group))
    with torch.inference_mode():
        _, carries = inference._run(route, model, inference._dequant_in(clip))
        return route.frames(carries)


def _spatial_check(dev, mesh, main: bool, exact: bool) -> dict:
    """The spatial fused route (bf16, then int8), and with ``exact`` the
    exact fp32 route (``bug_parity``), on a full-width clip; rank 0 holds
    each against the single-device clip."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                    build_quantized_clip_inference)
    from tecogan_tpu_torch.engine.state import init_generator
    from tecogan_tpu_torch.parallel import (build_spatial_clip_inference,
                                            build_spatial_fused_clip_inference)
    from tecogan_tpu_torch.parallel.dp import calibrate_on_rank0

    cfg = TecoConfig(num_resblock=16, precision="bf16", bug_parity=False, use_pallas=True)
    params = init_generator(cfg, torch.Generator().manual_seed(0))
    model = _model_on(cfg, params, dev)
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.random((1, SPATIAL_T, *CLIP[2:]), np.float32)).to(dev)
    res = {"n": mesh.size}
    infer = build_spatial_fused_clip_inference(cfg, mesh)
    infer(model, clip)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sr = infer(model, clip)
    torch.cuda.synchronize()
    res["fps"] = SPATIAL_T / (time.perf_counter() - t0)
    res["bf16_counts"] = _kernel_counts()
    clock = _GatherClock()
    clock.on = True
    infer(model, clip)
    clock.on = False
    clock.restore()
    res["gather_ms_frame"] = clock.ms / SPATIAL_T
    res["gather_mb_frame"] = clock.bytes / SPATIAL_T / 1e6
    res["gathers_frame"] = clock.calls / SPATIAL_T

    prepare, infer_q = build_quantized_clip_inference(cfg)
    qtail = calibrate_on_rank0(mesh, prepare, model, params, clip, 8)
    infer_sq = build_spatial_fused_clip_inference(cfg, mesh, quantize=True)
    _reset_counts()
    with _recorder() as recorder:
        sq = infer_sq(model, qtail, clip)
        torch.cuda.synchronize()
    res["int8_counts"] = _kernel_counts()
    res["kernels"] = recorder.check()
    if main:
        res["bf16"] = _frames_apart(sr, build_clip_inference(cfg)(model, clip))
        res["bf16_modules"] = _frames_apart(sr, _modules_tail_clip(cfg, model, clip))
        res["int8"] = _frames_apart(sq, infer_q(model, qtail, clip))
    del sr, sq
    if exact:
        ecfg = cfg.replace(precision="fp32", use_pallas=False, bug_parity=True)
        emodel = _model_on(ecfg, params, dev)
        se = build_spatial_clip_inference(ecfg, mesh)(emodel, clip)
        if main:
            res["exact"] = _frames_apart(se, build_clip_inference(ecfg)(emodel, clip))
    return res


def _train_leaves(state) -> dict:
    return {**{f"g/{k}": v for k, v in state.params_g.items()},
            **{f"d/{k}": v for k, v in state.params_d.items()},
            **{f"bn/{k}": v for k, v in state.batch_stats_d.items()}}


def _dp_train_check(dev, mesh, main: bool, steps: int, timed: bool) -> dict:
    """``steps`` DP steps at the paper's config (B=4 global) in fp32 (TF32
    off) from seed-0 weights on synthetic batches; rank 0 runs the
    single-process steps on the global batches and holds the losses, the
    D-balance decisions and the leaves against them (in bf16 the two
    differ by bf16 roundings, which can flip the D-balance gate).  With
    ``timed``: ms a DP step in bf16, the served precision, over
    DP_TIMED_STEPS after a warm-up step, and one K=2 call of
    ``build_dp_multi_train_step``."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
    from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                                state_from_params)
    from tecogan_tpu_torch.engine.train import build_train_step
    from tecogan_tpu_torch.parallel import (build_dp_multi_train_step, build_dp_train_step,
                                            replicate_state, shard_batch, shard_multi_batch)

    cfg = TecoConfig(precision="fp32", bug_parity=False)  # the paper's config, B=4
    g = torch.Generator().manual_seed(0)
    weights = (init_generator(cfg, g), *init_discriminator(cfg, g))
    batches = [synthetic_scene_batch(cfg.batch_size, cfg.RNN_N, cfg.crop_size,
                                     seed=i * cfg.batch_size) for i in range(steps)]
    state = replicate_state(mesh, state_from_params(cfg, *weights, device=dev))
    step = build_dp_train_step(cfg, mesh)
    res = {"losses": [], "withD": []}
    _reset_counts()
    for lr, hr in batches:
        state, m, _ = step(state, *shard_batch(mesh, lr, hr))
        res["losses"].append((float(m["gen_loss"]), float(m["d_loss"])))
        res["withD"].append(float(m["withD_counter"]))
    res["counts"] = _kernel_counts()
    leaves = _train_leaves(state)
    res["digest"] = float(sum(float(v.double().sum()) for v in leaves.values()))
    if main:
        ref = state_from_params(cfg, *weights, device=dev)
        single = build_train_step(cfg, device=dev)
        res["single_losses"], res["single_withD"] = [], []
        for lr, hr in batches:
            ref, m, _ = single(ref, torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev))
            res["single_losses"].append((float(m["gen_loss"]), float(m["d_loss"])))
            res["single_withD"].append(float(m["withD_counter"]))
        want = _train_leaves(ref)
        res["leaf_max_abs"] = max(float((leaves[k] - v).abs().max()) for k, v in want.items())
        res["leaves_equal"] = all(torch.equal(leaves[k], v) for k, v in want.items())
        del ref, want
    if timed:
        cfg = cfg.replace(precision="bf16")
        state = replicate_state(mesh, state_from_params(cfg, *weights, device=dev))
        step = build_dp_train_step(cfg, mesh)
        lr, hr = shard_batch(mesh, *batches[-1])
        state, m, _ = step(state, lr, hr)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            state, m, _ = step(state, lr, hr)
        torch.cuda.synchronize()
        res["ms_step"] = (time.perf_counter() - t0) / DP_TIMED_STEPS * 1e3
        kcfg = cfg.replace(steps_per_dispatch=2)
        lr_k = np.stack([b[0] for b in batches[:2]])
        hr_k = np.stack([b[1] for b in batches[:2]])
        state, mk, _ = build_dp_multi_train_step(kcfg, mesh)(
            state, *shard_multi_batch(mesh, lr_k, hr_k))
        res["multi_losses"] = [float(v) for v in mk["gen_loss"]]
        res["multi_digest"] = float(sum(float(v.double().sum())
                                        for v in _train_leaves(state).values()))
    return res


def _dp_serve_check(dev, mesh, main: bool) -> dict:
    """Two full-width streams, one a rank, through DP serving and DP int8
    serving; rank 0 holds each stream against its single-device clip."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                    build_quantized_clip_inference)
    from tecogan_tpu_torch.engine.state import init_generator
    from tecogan_tpu_torch.parallel import (build_dp_inference, build_dp_quantized_inference,
                                            shard_batch)

    cfg = TecoConfig(num_resblock=16, precision="bf16", bug_parity=False, use_pallas=True)
    params = init_generator(cfg, torch.Generator().manual_seed(0))
    model = _model_on(cfg, params, dev)
    rng = np.random.default_rng(1)
    clips = rng.random((mesh.size, SPATIAL_T, *CLIP[2:]), np.float32)
    streams = shard_batch(mesh, clips)
    res = {}
    _reset_counts()
    sr = build_dp_inference(cfg, mesh)(model, streams)
    torch.cuda.synchronize()
    res["bf16_counts"] = _kernel_counts()
    prepare, infer_q = build_dp_quantized_inference(cfg, mesh)
    qtail = prepare(model, params, torch.from_numpy(clips).to(dev), frames=8)
    _reset_counts()
    sq = infer_q(model, qtail, streams)
    torch.cuda.synchronize()
    res["int8_counts"] = _kernel_counts()
    if main:
        _, single_q = build_quantized_clip_inference(cfg)
        single = build_clip_inference(cfg)
        res["bf16_equal"] = res["int8_equal"] = True
        for b in range(mesh.size):
            one = torch.from_numpy(clips[b:b + 1]).to(dev)
            res["bf16_equal"] &= bool(torch.equal(sr[b:b + 1], single(model, one)))
            res["int8_equal"] &= bool(torch.equal(sq[b:b + 1], single_q(model, qtail, one)))
    return res


def _phase15_rank(dev, out: str, checks: tuple) -> None:
    """One rank of phase 15: ``checks`` in order, every rank alike; each
    rank writes its results as JSON to ``out/r<rank>.json``."""
    import torch.distributed as dist

    from tecogan_tpu_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh(device=dev)
    main = mesh.rank == 0
    res = {"backend": dist.get_backend(), "world": mesh.size}
    for check in checks:
        if check == "spatial":
            res[check] = _spatial_check(dev, mesh, main, exact=mesh.size == 2)
        elif check == "dp_train":
            res[check] = _dp_train_check(dev, mesh, main, steps=2 if mesh.size > 1 else 1,
                                         timed=mesh.size > 1)
        elif check == "dp_serve":
            res[check] = _dp_serve_check(dev, mesh, main)
        dist.barrier()
    with open(os.path.join(out, f"r{mesh.rank}.json"), "w") as f:
        json.dump(res, f)


class _CollectiveCount:
    """``torch.distributed.all_gather`` / ``all_reduce`` calls and the
    bytes this rank receives (the all-gather's gathered parts, the
    all-reduce's tensor) while ``on`` is set."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.gather, self.reduce = dist, dist.all_gather, dist.all_reduce
        self.counts = {"all_gather": 0, "all_reduce": 0}
        self.bytes, self.on = 0, False
        dist.all_gather, dist.all_reduce = self.call_gather, self.call_reduce

    def call_gather(self, tensor_list, tensor, group=None, async_op=False):
        if self.on:
            self.counts["all_gather"] += 1
            self.bytes += tensor.numel() * tensor.element_size() * len(tensor_list)
        return self.gather(tensor_list, tensor, group=group, async_op=async_op)

    def call_reduce(self, tensor, op=None, group=None, async_op=False):
        if self.on:
            self.counts["all_reduce"] += 1
            self.bytes += tensor.numel() * tensor.element_size()
        if op is None:
            return self.reduce(tensor, group=group, async_op=async_op)
        return self.reduce(tensor, op=op, group=group, async_op=async_op)

    def restore(self):
        self.dist.all_gather, self.dist.all_reduce = self.gather, self.reduce


def _tp_check(dev, mesh, main: bool, cfg, steps: int) -> dict:
    """``steps`` TP steps (``parallel.tp``) on ``mesh`` from seed-0 weights on
    synthetic batches; rank 0 runs the single-process steps on the same
    batches first and keeps their losses.  Each rank's losses, ms a step
    (host clock, synchronised), collectives and MB of the last step, hand
    kernel launches, the digests of its replicated leaves and of the
    gathered state, and the sharded generator keys."""
    from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
    from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                                state_from_params)
    from tecogan_tpu_torch.engine.train import build_train_step
    from tecogan_tpu_torch.parallel import (build_tp_train_step, gather_state_tp,
                                            replicate_state, shard_batch, shard_state_tp,
                                            state_shardings)

    g = torch.Generator().manual_seed(0)
    weights = (init_generator(cfg, g), *init_discriminator(cfg, g))
    batches = [synthetic_scene_batch(cfg.batch_size, cfg.RNN_N, cfg.crop_size,
                                     seed=i * cfg.batch_size) for i in range(steps)]
    res = {"losses": [], "ms": []}
    if main:
        ref = state_from_params(cfg, *weights, device=dev)
        single = build_train_step(cfg, device=dev)
        res["single_losses"] = []
        for lr, hr in batches:
            ref, m, _ = single(ref, torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev))
            res["single_losses"].append((float(m["gen_loss"]), float(m["d_loss"])))
        del ref, single
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = shard_state_tp(mesh, replicate_state(mesh, state_from_params(cfg, *weights,
                                                                          device=dev)))
    dims = state_shardings(mesh, state)
    res["sharded_g"] = [k for k, d in dims.params_g.items() if d is not None]
    step = build_tp_train_step(cfg, mesh)
    count = _CollectiveCount()
    _reset_counts()
    try:
        for i, (lr, hr) in enumerate(batches):
            lr, hr = shard_batch(mesh, lr, hr)
            count.on = i == steps - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m, _ = step(state, lr, hr)
            res["losses"].append((float(m["gen_loss"]), float(m["d_loss"])))
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            count.on = False
    finally:
        count.restore()
    res["counts"] = _kernel_counts()
    res["collectives"], res["mb"] = count.counts, count.bytes / 1e6
    res["replicated_digest"] = float(sum(
        float(v.double().sum()) for name in ("params_g", "params_d")
        for k, v in getattr(state, name).items() if getattr(dims, name)[k] is None))
    full = gather_state_tp(mesh, state)
    res["full_digest"] = float(sum(float(v.double().sum())
                                   for v in _train_leaves(full).values()))
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return res


def _tp_rank(dev, out: str, grids: tuple) -> None:
    """One rank of phase 15c: each of ``grids`` ((name, n_data, n_model,
    cfg), the grid on the first ranks) in order; each rank writes its
    results as JSON to ``out/r<rank>.json``."""
    import torch.distributed as dist

    from tecogan_tpu_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    for name, n_data, n_model, cfg in grids:
        mesh = make_mesh(n_data, n_model, device=dev)
        if mesh.member:
            res[name] = _tp_check(dev, mesh, dist.get_rank() == 0, cfg, TP_STEPS)
            res[name]["grid"] = (mesh.rank, mesh.model_rank)
        dist.barrier()
    with open(os.path.join(out, f"r{dist.get_rank()}.json"), "w") as f:
        json.dump(res, f)


def tp_phase(dev, smi) -> dict:
    """Phase 15c: the tensor-parallel train step (``parallel.tp``) on 4 gloo
    ranks sharing the card.  Returns each hand kernel's launches a rank."""
    import tempfile

    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import spawn

    grids = (("1x2", 1, 2, TecoConfig(precision="bf16")), ("2x2", 2, 2, TecoConfig(**TP_TINY)))
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    t0 = time.perf_counter()
    spawn(_tp_rank, 4, device="cuda:0", backend="gloo", init_file=os.path.join(out, "rdzv"),
          args=(out, grids))
    ranks = []
    for r in range(4):
        with open(os.path.join(out, f"r{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    print(f"[15c] 4 ranks over gloo sharing the one card: TP grids 1x2 (paper's config, "
          f"bf16) and 2x2 (tiny, fp32), {time.perf_counter() - t0:.1f} s with the ranks' start",
          flush=True)
    return _tp_report(ranks, smi)


def _tp_report(ranks: list, smi: str) -> dict:
    """Phase 15c's checks and lines from the ranks' results."""
    require(all(r["backend"] == "gloo" and r["world"] == 4 for r in ranks),
            f"[15c] ranks report {[(r['backend'], r['world']) for r in ranks]}")
    launches = {}
    for name, members, bar, what in (("1x2", 2, BF16_RTOL, "the paper's config, bf16"),
                                     ("2x2", 4, CARD_CPU_RTOL, "tiny, fp32, TF32 off")):
        rs = [r[name] for r in ranks[:members]]
        require(all(name not in r for r in ranks[members:]), f"[15c] {name} ran off the grid")
        require([tuple(r["grid"]) for r in rs] == [(i // 2, i % 2) for i in range(members)],
                f"[15c] {name} grid {[r['grid'] for r in rs]}")
        t = rs[0]
        apart = [(rel(a, c), rel(b, d)) for (a, b), (c, d)
                 in zip(t["losses"], t["single_losses"])]
        print(f"[15c] TP step {name} ({what}): losses (gen, d) {t['losses']} vs single-process "
              f"{t['single_losses']} (relative {apart}; bar {bar}: gen_loss each step, d_loss "
              f"at step 0) | ms a step {[round(x, 3) for x in t['ms']]} (rank 0, host clock; "
              f"gloo stages every collective through the host: not a TP speed figure) | "
              f"a step: {t['collectives']['all_gather']} all-gathers, "
              f"{t['collectives']['all_reduce']} all-reduces, {t['mb']:.2f} MB a rank | peak "
              f"{t['peak_gib']:.2f} GiB a rank | hand kernels {t['counts']} | {smi}", flush=True)
        print(f"[15c] TP {name}: sharded generator keys ({len(t['sharded_g'])}): "
              f"{', '.join(t['sharded_g'])}", flush=True)
        require(np.all(np.isfinite(t["losses"])), f"[15c] {name} losses {t['losses']}")
        require(all(r["losses"] == t["losses"] and r["full_digest"] == t["full_digest"]
                    for r in rs), f"[15c] {name}: ranks differ in losses or gathered state")
        require(all(rs[i]["replicated_digest"] == rs[i - i % 2]["replicated_digest"]
                    for i in range(members)),
                f"[15c] {name}: replicated leaves differ across a model group")
        require(all(g <= bar for g, _ in apart) and apart[0][1] <= bar,
                f"[15c] {name} losses against the single-process step: {apart}")
        require("conv_in.weight" in t["sharded_g"] and "conv_out.weight" not in t["sharded_g"],
                f"[15c] {name} sharded keys {t['sharded_g']}")
        for r in rs:
            require(sum(r["counts"].values()) == 0, f"[15c] {name} TP step launched {r['counts']}")
        launches[f"TP train step {name}, a rank"] = t["counts"]
    return launches


def multi_phase(dev, smi) -> dict:
    """Phase 15: the multi-rank paths.  Returns each hand kernel's launches
    a rank on them, for the kernels' record."""
    import tempfile

    from tecogan_tpu_torch.parallel import spawn

    launches = {}
    runs = (("15a", 1, "nccl", ("spatial", "dp_train")),
            ("15b", 2, "gloo", ("spatial", "dp_train", "dp_serve")),
            ("15b", 3, "gloo", ("spatial",)))
    for tag, world, backend, checks in runs:
        out = tempfile.mkdtemp(prefix=f"chip_smoke_{world}_")
        t0 = time.perf_counter()
        spawn(_phase15_rank, world, device="cuda" if backend == "nccl" else "cuda:0",
              backend=backend, init_file=os.path.join(out, "rdzv"), args=(out, checks))
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"r{r}.json")) as f:
                ranks.append(json.load(f))
        shutil.rmtree(out, ignore_errors=True)
        secs = time.perf_counter() - t0
        where = (f"{world} rank{'s' if world > 1 else ''} over {backend} "
                 f"({'one card a rank' if backend == 'nccl' else 'sharing the one card'})")
        print(f"[{tag}] {where}: checks {checks}, {secs:.1f} s with the ranks' start", flush=True)
        main = ranks[0]
        require(all(r["backend"] == backend and r["world"] == world for r in ranks),
                f"[{tag}] ranks report {[(r['backend'], r['world']) for r in ranks]}")

        sp = main["spatial"]
        for route in ("bf16", "int8"):
            d = sp[route]
            line = (f"[{tag}] spatial fused {route}, {world} rank(s) vs the single-device "
                    f"clip, 270x480 -> 1080x1920 T={SPATIAL_T}: max {d['max']:.3e} mean "
                    f"{d['mean']:.3e} PSNR {d['psnr']:.2f} dB, bit-equal {d['equal']}")
            print(line, flush=True)
            if world == 1 and route == "int8":
                require(d["equal"], f"[{tag}] spatial {route} at world 1 is not bit-equal")
            else:
                # the spatial route keeps the modules' bf16 tail; the
                # single-device bf16 route runs the fused conv kernels
                require(d["max"] <= SPATIAL_MAX and d["mean"] <= SPATIAL_MEAN
                        and d["psnr"] > PSNR_BAR_DB, f"[{tag}] spatial {route}: {d}")
        d = sp["bf16_modules"]
        print(f"[{tag}] spatial fused bf16, {world} rank(s) vs the single-device fused clip on "
              f"the modules' tail: max {d['max']:.3e}, bit-equal {d['equal']}", flush=True)
        if world == 1:
            require(d["equal"], f"[{tag}] spatial bf16 at world 1 is not bit-equal to the "
                    "single-device clip on the modules' tail")
        if "exact" in sp:
            d = sp["exact"]
            print(f"[{tag}] spatial exact fp32 (bug_parity), {world} ranks vs the "
                  f"single-device clip: max {d['max']:.3e} (bar {EXACT_SPATIAL_TOL})", flush=True)
            require(d["max"] <= EXACT_SPATIAL_TOL, f"[{tag}] spatial exact: {d}")
        for r, rank in enumerate(ranks):
            s = rank["spatial"]
            # the spatial bf16 route keeps the modules' tail
            want_bf16 = _fused_launches(SPATIAL_T, "modules")
            want_int8 = _fused_launches(SPATIAL_T, "int8")
            require(s["bf16_counts"] == want_bf16 and s["int8_counts"] == want_int8,
                    f"[{tag}] rank {r} launches {s['bf16_counts']} / {s['int8_counts']}")
            bad = {k: v for k, v in s["kernels"].items() if not v["ok"]}
            require(len(s["kernels"]) == 5 and not bad,
                    f"[{tag}] rank {r} kernels on its blocks: {s['kernels']}")
        if world > 1:
            launches[f"spatial int8, {world} ranks, a rank"] = ranks[0]["spatial"]["int8_counts"]
            launches[f"spatial bf16, {world} ranks, a rank"] = ranks[0]["spatial"]["bf16_counts"]
        print(f"[{tag}] spatial, {world} rank(s): hand kernels a rank bf16 "
              f"{sp['bf16_counts']}, int8 {sp['int8_counts']}; each kernel's last launch on "
              "its block against the plain version: " + ", ".join(
                  f"{k} ({v['rows']} rows) max {v['max']:.2e}" for k, v in sp["kernels"].items()),
              flush=True)
        print(f"[{tag}] spatial fused bf16, {world} rank(s) on one card: {sp['fps']:.3f} fps "
              f"({'ranks share one card: not a scaling figure' if world > 1 else 'NCCL'}) | "
              f"all-gathers {sp['gathers_frame']:.0f} a frame, {sp['gather_ms_frame']:.3f} ms "
              f"a frame (host clock, synchronised; gloo stages through the host)"
              f", {sp['gather_mb_frame']:.2f} MB a rank a frame against "
              f"{RECKONED_MB[0]:.0f}-{RECKONED_MB[1]:.0f} MB reckoned at spatial.py:31-36 | {smi}",
              flush=True)

        if "dp_train" in main:
            t = main["dp_train"]
            require(all(rank["dp_train"]["digest"] == t["digest"]
                        and rank["dp_train"]["withD"] == t["withD"] for rank in ranks),
                    f"[{tag}] DP train state differs between ranks")
            apart = [(rel(a, c), rel(b, d)) for (a, b), (c, d)
                     in zip(t["losses"], t["single_losses"])]
            print(f"[{tag}] DP train step, {world} rank(s), B=4 global, fp32 (TF32 off): "
                  f"losses {t['losses']} vs single-process {t['single_losses']} (relative "
                  f"{apart}; bar {CARD_CPU_RTOL}: gen_loss each step, d_loss at step 0, as "
                  f"phase 10); after {len(apart)} step(s) params and BN "
                  f"statistics {t['leaf_max_abs']:.3e} from the single-process state, "
                  f"bit-equal {t['leaves_equal']}; withD {t['withD']} on every rank, "
                  f"single-process {t['single_withD']}; hand kernels {t['counts']}", flush=True)
            # Adam's first step is about sign(g) lr, so a D param whose gradient
            # lies near 0 may step the other way: d_loss is held at step 0 only
            require(all(g <= CARD_CPU_RTOL for g, _ in apart) and apart[0][1] <= CARD_CPU_RTOL,
                    f"[{tag}] DP losses {apart}")
            require(t["withD"] == t["single_withD"], f"[{tag}] D-balance decisions differ")
            require(sum(t["counts"].values()) == 0, f"[{tag}] DP step launched {t['counts']}")
            if world == 1:
                require(t["leaves_equal"] or t["leaf_max_abs"] <= LEAF_TOL,
                        f"[{tag}] DP step at world 1: {t['leaf_max_abs']}")
            if "ms_step" in t:
                require(all(rank["dp_train"]["multi_digest"] == t["multi_digest"]
                            for rank in ranks) and np.all(np.isfinite(t["multi_losses"])),
                        f"[{tag}] K=2 DP steps: {t['multi_losses']}")
                print(f"[{tag}] DP train step, {world} ranks sharing one card (2 samples a "
                      f"rank, bf16): {t['ms_step']:.3f} ms a step (not a scaling figure) | K=2 "
                      f"multi-step losses {t['multi_losses']}, same state on every rank "
                      f"| {smi}", flush=True)
        if "dp_serve" in main:
            s = main["dp_serve"]
            require(s["bf16_equal"] and s["int8_equal"],
                    f"[{tag}] DP serving differs from single-device: {s}")
            for rank in ranks:
                require(rank["dp_serve"]["bf16_counts"] == _fused_launches(SPATIAL_T, "bf16")
                        and rank["dp_serve"]["int8_counts"] == _fused_launches(SPATIAL_T, "int8"),
                        f"[{tag}] DP serving launches {rank['dp_serve']}")
            launches[f"DP serving bf16, {world} ranks, a rank"] = s["bf16_counts"]
            launches[f"DP serving int8, {world} ranks, a rank"] = s["int8_counts"]
            print(f"[{tag}] DP serving, {world} streams one a rank: bf16 and int8 bit-equal "
                  f"to each stream's single-device clip | launches a rank bf16 "
                  f"{s['bf16_counts']}, int8 {s['int8_counts']}", flush=True)
    launches.update(tp_phase(dev, smi))
    fnet_phase(dev, smi)
    cli_multi_phase(dev, smi)
    return launches


def fnet_phase(dev, smi) -> None:
    """Phase 15e: the FNet variant's train step."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
    from tecogan_tpu_torch.engine.fnet_train import build_fnet_train_step

    cfg = TecoConfig(precision="bf16")  # the paper's config: B=4, RNN_N=10, crop 32
    init, step = build_fnet_train_step(cfg, device=dev)
    state = init(torch.Generator().manual_seed(0))
    lr, hr = (torch.from_numpy(a).to(dev) for a in synthetic_scene_batch(
        cfg.batch_size, cfg.RNN_N, cfg.crop_size, seed=0))
    for _ in range(FNET_WARMUP):
        state, m = step(state, lr, hr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    losses, t0 = [], time.perf_counter()
    for _ in range(FNET_STEPS):
        state, m = step(state, lr, hr)
        losses.append((float(m["gen_loss"]), float(m["l2_warp_loss"])))
    secs = (time.perf_counter() - t0) / FNET_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    require(np.all(np.isfinite(losses)), f"[15e] FNet losses {losses}")
    require(sum(_kernel_counts().values()) == 0, f"[15e] FNet step launched {_kernel_counts()}")

    tiny = TecoConfig(**FNET_TINY)
    apart = []
    g = np.random.default_rng(3)
    lr_t = torch.from_numpy(g.random((1, 3, 3, 16, 16), np.float32))
    hr_t = torch.from_numpy(g.random((1, 3, 3, 64, 64), np.float32))
    states = {}
    for where in ("cpu", dev):
        init_t, step_t = build_fnet_train_step(tiny, device=where)
        s = init_t(torch.Generator().manual_seed(1))
        out = []
        for _ in range(3):
            s, mt = step_t(s, lr_t.to(where), hr_t.to(where))
            out.append(float(mt["gen_loss"]))
        states[str(where)] = out
    apart = [rel(a, b) for a, b in zip(states[str(dev)], states["cpu"])]
    print(f"[15e] FNet train step, B=4 RNN_N=10 crop 32, 16 resblocks, bf16: "
          f"{secs * 1e3:.3f} ms a step (mean of {FNET_STEPS} after {FNET_WARMUP} warm-up), "
          f"peak {peak / 2**30:.2f} GiB, losses (gen, warp) {losses} | tiny fp32 (TF32 off) "
          f"card vs CPU, 3 steps: gen_loss relative {apart} (bar {CARD_CPU_RTOL}) | {smi}",
          flush=True)
    require(all(a <= CARD_CPU_RTOL for a in apart), f"[15e] card vs CPU {apart}")


def cli_multi_phase(dev, smi) -> None:
    """Phase 15f: --spatial_shards 2 and --data_axis 2 through the command
    line on the one card: both clamp to it with the JAX package's warning
    and run."""
    import tempfile
    import warnings

    from tecogan_tpu_torch.cli import main as cli
    from tecogan_tpu_torch.data.synthetic import write_synthetic_scene_folders
    from tecogan_tpu_torch.engine.state import init_state
    from tecogan_tpu_torch.utils.checkpoint import save_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli15_")
    try:
        scenes = os.path.join(tmp, "scenes")
        write_synthetic_scene_folders(scenes, num_scenes=2, frames_per_scene=120, size=64)
        tiny = ["--crop_size", "16", "--RNN_N", "10", "--num_resblock", "2",
                "--discrim_resblocks", "1", "--discrim_channels", "16", "--batch_size", "2",
                "--bug_parity", "False"]
        cfg = cli.parse_config(tiny)
        save_train_state(os.path.join(tmp, "ck"), init_state(
            cfg, torch.Generator().manual_seed(0), device=dev), 0)
        argv = {"inference": tiny + ["--mode", "inference", "--input_dir_LR", scenes,
                                     "--g_checkpoint", os.path.join(tmp, "ck", "generator.ckpt"),
                                     "--output_dir", os.path.join(tmp, "inf"),
                                     "--spatial_shards", "2"],
                "train": tiny + ["--mode", "train", "--input_video_dir", scenes, "--str_dir",
                                 "1000", "--end_dir", "1001", "--output_dir",
                                 os.path.join(tmp, "tr"), "--summary_dir",
                                 os.path.join(tmp, "sum"), "--data_axis", "2",
                                 "--steps_per_epoch", "1", "--max_epochs", "1"]}
        for mode, args in argv.items():
            flag = "--spatial_shards" if mode == "inference" else "--data_axis"
            with warnings.catch_warnings(record=True) as caught, \
                    contextlib.redirect_stdout(io.StringIO()):
                warnings.simplefilter("always")
                cli.main(args)
            said = [str(w.message) for w in caught if f"{flag} 2 exceeds" in str(w.message)]
            require(len(said) == 1, f"[15f] {mode}: warnings {[str(w.message) for w in caught]}")
            print(f"[15f] cli {mode} {flag} 2 with {torch.cuda.device_count()} card: "
                  f"'{said[0]}' and ran on it", flush=True)
        require(os.path.exists(os.path.join(tmp, "inf", "output0.mp4")), "[15f] no mp4")
        require(os.path.exists(os.path.join(tmp, "tr", "generator.ckpt")), "[15f] no ckpt")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 16: exported serving windows, the converter, adapt_clip, the surrogate
# ---------------------------------------------------------------------------

EXPORT_T, EXPORT_CHUNK = 40, 16      # head + 2 cont windows, the last padded
EXPORT_RESBLOCKS = 16
ADAPT_T, ADAPT_H, ADAPT_STEPS = 12, 268, 4
CLI16_STEPS = 3
# tools/run_convergence_r5.sh's trainer flags (the data, epochs and the
# supervisor's memory limit aside)
R5_FLAGS = ["--batch_size", "4", "--crop_size", "32", "--RNN_N", "10",
            "--num_resblock", "16", "--discrim_resblocks", "4", "--discrim_channels", "128",
            "--precision", "bf16", "--bug_parity", "False", "--pingpang", "True",
            "--vgg_scaling", "0.2", "--vgg_ckpt", "surrogate", "--checkpoint_every", "2",
            "--validate_every", "4", "--auto_resume", "True", "--queue_thread", "6",
            "--log_every", "50", "--transfer_dtype", "u8"]


def serve_child(spec_path: str) -> None:
    """``python3 chip_smoke.py --serve-exported SPEC``: phase 16's serving
    host, a fresh interpreter importing ``tools/serve_exported.py`` (and so
    ``ops.kernels``) and nothing of ``models`` or ``engine``.  For each run
    of the spec: a warm-up, a timed run with the launch counts set to 0
    just before and read just after, then a run that keeps each op's last
    launch, held against the op's plain version; the SR clip and a JSON
    record go where the spec says."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from tecogan_tpu_torch.tools.serve_exported import load_server

    results = []
    for run in spec["runs"]:
        params = torch.load(run["params"], weights_only=True)
        clip = np.load(run["clip"])
        t0 = time.perf_counter()
        serve = load_server(run["dir"], params, spec["device"], run["quantized"])
        load_s = time.perf_counter() - t0
        serve(clip)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        sr = serve(clip)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = _kernel_counts()
        with _recorder() as rec:
            again = serve(clip)
            torch.cuda.synchronize()
        last = rec.check()
        torch.save(sr, run["out"])
        results.append({"name": run["name"], "load_s": load_s, "secs": secs,
                        "frames": int(clip.shape[1]), "launches": launched, "last": last,
                        "repeat_equal": bool(torch.equal(sr, again))})
    with open(spec["result"], "w") as f:
        json.dump({"runs": results, "modules": sorted(
            m for m in sys.modules if m.startswith("tecogan_tpu_torch"))}, f)


def export_phase(dev, smi) -> dict:
    """Phase 16: (a) the bf16 window programs exported at f32 and u8 wire,
    served from a process with no model code, against the live chunked
    loop; (b) the int8 programs the same way; (c) a reference-layout
    ``generator.pt`` through the converter both ways; (d)
    ``tools/adapt_clip.py``; (e) CLI train steps with the surrogate VGG.
    Returns each kernel's launches on the served paths."""
    import subprocess
    import tempfile

    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine import published
    from tecogan_tpu_torch.engine.inference import (build_chunked_inference,
                                                    build_clip_inference,
                                                    build_quantized_clip_inference,
                                                    window_params)
    from tecogan_tpu_torch.engine.state import init_generator, model_defs
    from tecogan_tpu_torch.tools import export_infer
    from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

    cfg = TecoConfig(num_resblock=EXPORT_RESBLOCKS, precision="bf16", bug_parity=False,
                     use_pallas=True, warp_group=4)
    params = init_generator(cfg, torch.Generator().manual_seed(0))
    model = model_defs(cfg, device=dev)
    model.load_state_dict(generator_state_dict_from_jax(params))
    model.eval()
    rng = np.random.default_rng(16)
    H, W = CLIP[2], CLIP[3]
    clip_f32 = rng.random((1, EXPORT_T, H, W, 3), np.float32)
    clip_u8 = rng.integers(0, 256, (1, EXPORT_T, H, W, 3), dtype=np.uint8)
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    served = {}
    try:
        # -- 16a/b. export: f32 wire (with --check), then u8 wire with int8
        common = ["--height", str(H), "--width", str(W), "--chunk", str(EXPORT_CHUNK),
                  "--num_resblock", str(EXPORT_RESBLOCKS), "--precision", "bf16",
                  "--device", str(dev)]
        calib_dir = os.path.join(tmp, "calib")
        os.makedirs(calib_dir)
        import cv2

        for t in range(8):  # the u8 clip's first 8 frames, as the tool reads them
            cv2.imwrite(os.path.join(calib_dir, f"{t:04d}.png"), clip_u8[0, t, ..., ::-1])
        dirs = {"f32": os.path.join(tmp, "f32"), "u8": os.path.join(tmp, "u8")}
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            man_f32 = export_infer.main(common + ["--out", dirs["f32"], "--check"])
            check_s = time.perf_counter() - t0
            man_u8 = export_infer.main(common + ["--out", dirs["u8"], "--wire", "u8",
                                                 "--quantize", "int8", "--calib_dir", calib_dir])
        text = buf.getvalue()
        require(text.count("check ok: head+cont bit-equal vs live") == 1,
                f"[16a] export --check:\n{text[-2000:]}")
        sizes = {f"{w}/{n}": os.path.getsize(os.path.join(d, n)) // 2**10
                 for w, d in dirs.items() for n in sorted(os.listdir(d)) if n.endswith(".pt2")}
        print(f"[16a] export_infer at chunk {EXPORT_CHUNK}, {H}x{W}, {EXPORT_RESBLOCKS} "
              f"resblocks, bf16: "
              f"torch.export seconds f32 wire {man_f32['export_seconds']}, u8 wire + int8 "
              f"{man_u8['export_seconds']}; f32 export with --check {check_s:.2f} s in all | "
              f"KiB {sizes} | platforms {man_f32['platforms']} | {smi}", flush=True)
        require(man_f32["platforms"] == [dev.type], f"[16a] platforms {man_f32['platforms']}")

        # the live chunked loop, timed; its qtail from the tool's own calibration clip
        prepare, _ = build_quantized_clip_inference(cfg)
        calib = torch.from_numpy(export_infer._calibration_clip(calib_dir, 1, H, W))
        qtail = prepare(model, params, calib, frames=8)
        with np.load(os.path.join(dirs["u8"], "qtail.npz")) as z:
            for layer, q in qtail.items():
                for field, v in q.items():
                    key = f"['{layer}']['{field}']"
                    require((v is None and key not in z.files) or
                            (v is not None and np.array_equal(z[key], v.cpu().numpy())),
                            f"[16b] qtail.npz {key} differs from prepare's")
        live = {}
        for name, clip, out_u8, qt in (("f32", clip_f32, False, None),
                                       ("u8", clip_u8, True, None),
                                       ("int8", clip_u8, True, qtail)):
            chunked = build_chunked_inference(cfg, out_u8=out_u8)
            chunked(model, clip, chunk=EXPORT_CHUNK, qtail=qt)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            live[name] = (chunked(model, clip, chunk=EXPORT_CHUNK, qtail=qt),
                          time.perf_counter() - t0)

        # the serving host: a fresh interpreter with no model code
        p = {k: v.cpu() for k, v in window_params(model).items()}
        torch.save(p, os.path.join(tmp, "params.pt"))
        np.save(os.path.join(tmp, "clip_f32.npy"), clip_f32)
        np.save(os.path.join(tmp, "clip_u8.npy"), clip_u8)
        runs = [{"name": n, "dir": dirs[d], "clip": os.path.join(tmp, f"clip_{c}.npy"),
                 "quantized": q, "params": os.path.join(tmp, "params.pt"),
                 "out": os.path.join(tmp, f"sr_{n}.pt")}
                for n, d, c, q in (("f32", "f32", "f32", False), ("u8", "u8", "u8", False),
                                   ("int8", "u8", "u8", True))]
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"runs": runs, "result": os.path.join(tmp, "result.json"),
                       "device": str(dev)}, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-exported",
                               spec], capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"[16] serving process exited {proc.returncode}:\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(os.path.join(tmp, "result.json")) as f:
            result = json.load(f)
        mods = result["modules"]
        require(not any(".models" in m or ".engine" in m for m in mods),
                f"[16] the serving process imported {mods}")
        padded = -(-EXPORT_T // EXPORT_CHUNK) * EXPORT_CHUNK  # frames the programs run
        for rec in result["runs"]:
            name = rec["name"]
            got = torch.load(os.path.join(tmp, f"sr_{name}.pt"))
            want, live_s = live[name]
            tag = "16b" if name == "int8" else "16a"
            require(tuple(got.shape) == (1, EXPORT_T, 4 * H, 4 * W, 3),
                    f"[{tag}] {name}: served {tuple(got.shape)}")
            require(torch.equal(got, want), f"[{tag}] {name}: served windows differ from the "
                    f"live chunked loop (max {float((got.float() - want.float()).abs().max())})")
            require(rec["repeat_equal"], f"[{tag}] {name}: a second run differs")
            c = rec["launches"]
            want_c = _fused_launches(padded, "int8" if name == "int8" else "bf16")
            require(c == want_c, f"[{tag}] {name}: launches {c}, want {want_c}")
            # conv_out_s2d, warp_s2d, the 3x3 conv with and without its
            # residual, the transposed conv
            bad = {op: v for op, v in rec["last"].items() if not v["ok"]}
            require(len(rec["last"]) == 5 and not bad,
                    f"[{tag}] {name}: last launches vs plain {rec['last']}")
            served[name] = c
            print(f"[{tag}] served {name} ({'u8' if name != 'f32' else 'f32'} wire"
                  f"{', int8 tail' if name == 'int8' else ''}) from a process importing "
                  f"{len(mods)} tecogan_tpu_torch modules, none of models/engine: "
                  f"{EXPORT_T} frames bit-equal to the live chunked loop | launches {c} "
                  f"({EXPORT_T} frames served + {padded - EXPORT_T} padding) | last launches "
                  f"vs plain {rec['last']} | served {EXPORT_T / rec['secs']:.3f} fps "
                  f"({rec['secs'] * 1e3:.3f} ms, {rec['secs'] * 1e3 / padded:.3f} ms a frame "
                  f"run), live chunked {EXPORT_T / live_s:.3f} fps ({live_s * 1e3:.3f} ms, "
                  f"{live_s * 1e3 / EXPORT_T:.3f} ms a frame run), programs loaded in "
                  f"{rec['load_s']:.2f} s | {smi}", flush=True)
        print(f"[16] serving process: {child_s:.1f} s in all", flush=True)
        del live, qtail

        # -- 16c. the converter: .ckpt -> reference .pt -> .ckpt, served
        from tecogan_tpu_torch.tools import convert_torch_ckpt
        from tecogan_tpu_torch.utils.checkpoint import (load_generator_params,
                                                        save_generator_params)

        ckpt = os.path.join(tmp, "g.ckpt")
        save_generator_params(ckpt, params)
        with contextlib.redirect_stdout(io.StringIO()):
            nres = ["--num_resblock", str(EXPORT_RESBLOCKS)]
            convert_torch_ckpt.main(["--reverse", ckpt, "--arch", "generator",
                                     "--out", os.path.join(tmp, "generator.pt"), *nres])
            convert_torch_ckpt.main(["--torch", os.path.join(tmp, "generator.pt"),
                                     "--arch", "generator", "--out", os.path.join(tmp, "g2.ckpt"),
                                     *nres])
        ref_sd = torch.load(os.path.join(tmp, "generator.pt"), weights_only=False)
        require(sorted(ref_sd) == ["epoch", "model_state_dict"] and
                "conv_trans.4.weight" in ref_sd["model_state_dict"] and
                f"resids.{EXPORT_RESBLOCKS - 1}.2.weight" in ref_sd["model_state_dict"],
                f"[16c] reference keys {sorted(ref_sd['model_state_dict'])[:5]}")
        back = model_defs(cfg, device=dev)
        back.load_state_dict(generator_state_dict_from_jax(
            load_generator_params(os.path.join(tmp, "g2.ckpt"))))
        clip8 = torch.from_numpy(clip_f32[:, :CLIP[1]]).to(dev)
        infer = build_clip_inference(cfg)
        want = infer(model, clip8)
        _reset_counts()
        got = infer(back.eval(), clip8)
        torch.cuda.synchronize()
        c = _kernel_counts()
        require(torch.equal(got, want), "[16c] the converted checkpoint serves other frames")
        require(c["conv_out_s2d"] == CLIP[1] and c["warp_s2d"] == CLIP[1] - 1,
                f"[16c] launches {c}")
        print(f"[16c] .ckpt -> reference generator.pt ({len(ref_sd['model_state_dict'])} "
              f"tensors) -> .ckpt: the fused clip (T={CLIP[1]}) bit-equal to the source "
              f"params' | launches {c}", flush=True)
        del model, back, want, got
        torch.cuda.empty_cache()

        adapt_clip_phase(dev, smi, tmp, ckpt)
        cli_vgg_phase(dev, smi, tmp)
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    return served


def adapt_clip_phase(dev, smi, tmp: str, ckpt: str) -> None:
    """Phase 16d: ``tools/adapt_clip.py`` on the card at full generator
    width on a synthetic 268 x 480 clip (adaptation's internal pairs need
    H and W divisible by 4) with its 1072 x 1920 ground truth."""
    import cv2

    from tecogan_tpu_torch.data.synthetic import moving_rect_scene
    from tecogan_tpu_torch.tools import adapt_clip
    from tecogan_tpu_torch.utils.checkpoint import load_flat, load_generator_params

    hr = moving_rect_scene(num_frames=ADAPT_T, height=4 * ADAPT_H, width=4 * CLIP[3], seed=5)
    for name, frames in (("lr", np.stack([cv2.resize(f, (CLIP[3], ADAPT_H),
                                                     interpolation=cv2.INTER_AREA) for f in hr])),
                         ("gt", hr)):
        os.makedirs(os.path.join(tmp, name))
        for t, f in enumerate(frames):
            cv2.imwrite(os.path.join(tmp, name, f"{t:04d}.png"),
                        np.clip(np.rint(f * 255.0), 0, 255).astype(np.uint8)[..., ::-1])
    out_ckpt, out_sr = os.path.join(tmp, "adapted.ckpt"), os.path.join(tmp, "sr.mp4")
    scores = os.path.join(tmp, "scores.json")
    _reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = adapt_clip.main(["--input", os.path.join(tmp, "lr"), "--g_checkpoint", ckpt,
                               "--steps", str(ADAPT_STEPS), "--out_ckpt", out_ckpt,
                               "--out_sr", out_sr, "--gt", os.path.join(tmp, "gt"),
                               "--json_out", scores, "--num_resblock", str(EXPORT_RESBLOCKS),
                               "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = _kernel_counts()
    flat, _ = load_flat(out_ckpt)
    adapted = load_generator_params(out_ckpt)
    source = load_generator_params(ckpt)
    same_tree = (flat and all(k.startswith("model_state_dict//") for k in flat) and
                 {k: v.shape for k, v in adapted.items() if not isinstance(v, dict)} ==
                 {k: v.shape for k, v in source.items() if not isinstance(v, dict)})
    sr, rec = res["sr"], res["score"]
    with open(scores) as f:
        recorded = json.load(f)["records"]["ours_adapted"]
    require(bool(same_tree), "[16d] the adapted .ckpt is not the JAX loader's layout")
    require(sr.shape == (ADAPT_T, 4 * ADAPT_H, 4 * CLIP[3], 3) and np.isfinite(sr).all(),
            f"[16d] SR clip {sr.shape}")
    require(os.path.getsize(out_sr) > 0 and recorded == rec and np.isfinite(rec["psnr_db"]),
            f"[16d] outputs {rec} {recorded}")
    require(c["conv_out_s2d"] == ADAPT_T and c["warp_s2d"] == ADAPT_T - 1,
            f"[16d] serving launches {c}")
    losses = re.findall(r"adapt step \d+: loss ([-0-9.e]+)", buf.getvalue())
    require(losses and all(np.isfinite(float(v)) for v in losses), f"[16d] losses {losses}")
    print(f"[16d] tools/adapt_clip.py, {ADAPT_STEPS} steps on {ADAPT_T} frames of "
          f"{ADAPT_H}x{CLIP[3]}, {EXPORT_RESBLOCKS} resblocks bf16: {secs:.2f} s in all "
          f"(serving and scoring inside) | losses {losses} | guard {res['report']} | score "
          f"{rec} | launches {c} | the .ckpt read back in the JAX loader's layout | {smi}",
          flush=True)


def cli_vgg_phase(dev, smi, tmp: str) -> None:
    """Phase 16e: CLI train steps at run_convergence_r5.sh's flags with the
    surrogate VGG-19, whose weights on the card hash to the JAX package's."""
    from tecogan_tpu_torch.cli import main as cli
    from tecogan_tpu_torch.data.synthetic import write_synthetic_scene_folders
    from tecogan_tpu_torch.models import vgg
    from tecogan_tpu_torch.utils.convert import vgg_params_to_jax

    scenes = os.path.join(tmp, "scenes")
    write_synthetic_scene_folders(scenes, num_scenes=3, frames_per_scene=120, size=144,
                                  variety=True)
    built = []
    real_vgg_model = vgg.vgg_model

    def recorded(*a, **kw):
        built.append(real_vgg_model(*a, **kw))
        return built[-1]

    vgg.vgg_model = recorded
    out = os.path.join(tmp, "r5")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["--mode", "train", "--input_video_dir", scenes, "--str_dir", "1000",
                      "--end_dir", "1001", "--end_dir_val", "1002", *R5_FLAGS,
                      "--max_epochs", "1", "--steps_per_epoch", str(CLI16_STEPS),
                      "--output_dir", out, "--summary_dir", os.path.join(out, "summary")])
    finally:
        vgg.vgg_model = real_vgg_model
    text = buf.getvalue()
    require(len(built) == 1 and next(built[0].parameters()).device == dev,
            f"[16e] VGG models built {len(built)}")
    digest = vgg.params_sha256(vgg_params_to_jax(built[0].state_dict()))
    require(digest == vgg.SURROGATE_SHA256,
            f"[16e] the card's surrogate VGG-19 hashes to {digest}, the CPU's to "
            f"{vgg.SURROGATE_SHA256}")
    require("fixed-seed SURROGATE weights" in text, "[16e] no surrogate line")
    steps = re.findall(r"Epoch steps: (\d+) in [0-9.]+ s, ([0-9.]+) ms a step", text)
    g = [float(v) for v in re.findall(r"Generator loss is: ([-0-9.e]+|nan|inf)", text)]
    d = [float(v) for v in re.findall(r"Discriminator loss is: ([-0-9.e]+|nan|inf)", text)]
    require(steps and int(steps[0][0]) == CLI16_STEPS, f"[16e] steps {steps}:\n{text[-2000:]}")
    require(g and d and np.isfinite(g + d).all(), f"[16e] losses {g} {d}")
    print(f"[16e] cli.main train at run_convergence_r5.sh's flags (--vgg_scaling 0.2 "
          f"--vgg_ckpt surrogate), {CLI16_STEPS} steps: {float(steps[0][1]):.3f} ms a step "
          f"(the CLI's figure) | gen loss {g}, D loss {d} | VGG-19 on the card sha256 "
          f"{digest} = the JAX surrogate's | {smi}", flush=True)


BENCH_STREAMS = 4                    # phase 17: the B-stream agreement's batch
# phase 17's weights for the B-stream agreement: the seed-0 draw at torch's
# init scale ignores its feedback (a stream fed another's carry scores
# inf dB against it alone), and x2.5 (phase 5's, at 2 resblocks) clamps most
# of the 16-resblock output; x2 (exact in bf16) leaves a few percent
# clamped and the crossed-carry control far below the bar
STREAMS_GAIN = 2.0


def _finite_records(records: list, what: str) -> None:
    for rec in records:
        bad = [k for k, v in rec.items() if isinstance(v, float) and not np.isfinite(v)]
        require(not bad, f"[17] {what}: non-finite {bad} in {rec}")


def _clip_launches(clips: list) -> dict:
    """The hand kernels' launches of fused clips at 16 resblocks, ``(frames,
    runs, tail)`` at a time (``_fused_launches``'s a run, whatever the
    batch)."""
    out = dict.fromkeys(_fused_launches(1, "modules"), 0)
    for t, n, tail in clips:
        for k, v in _fused_launches(t, tail).items():
            out[k] += v * n
    return out


def _crossed_carry_clip(model, clip: torch.Tensor) -> torch.Tensor:
    """Phase 17's control: the fused route with every stream's feedback
    warped from stream 0's carry, what a kernel that read another stream's
    carry would serve."""
    from tecogan_tpu_torch.engine.fused import (conv_out_params, conv_out_s2d,
                                                fused_first_frame_s2d, fused_first_layer,
                                                s2d_to_frame, warp_s2d_feedback)

    with torch.inference_mode():
        carry = fused_first_frame_s2d(model, clip[:, 0])
        frames = [s2d_to_frame(carry).float()]
        for t in range(1, clip.shape[1]):
            crossed = carry[:1].expand_as(carry).contiguous()
            feedback = warp_s2d_feedback(crossed, clip[:, t - 1].contiguous())
            net = fused_first_layer(model, clip[:, t], feedback)
            carry = conv_out_s2d(model.tail_features(net), *conv_out_params(model))
            frames.append(s2d_to_frame(carry).float())
    return torch.stack(frames, dim=1)


def bench_phase(dev, smi) -> dict:
    """Phase 17: the five measurement programs (``tecogan_tpu_torch/tools/
    bench*.py``) in-process through their ``main(argv)`` at the JAX tools'
    defaults, with torch's default TF32 switches (``bench_train`` turns
    TF32 off for its fp32 modes itself).  Each prints its records (the
    card's name and power limit in each); every value finite, each
    program's hand-kernel launches the count its routes imply (the warm-up
    run and the timed ones; ``prepare``'s calibration 8 / 7), no ``error``
    line at batches 4-32.  Then the B-stream agreement, on the benchmark's
    model with its weights x``STREAMS_GAIN`` and a clip in [0,
    ``CLIP_RANGE``) (phase 5's reasons): each stream of a (4, 8, 270, 480,
    3) clip against the same stream served alone, PSNR above the 40 dB bar
    (bit-equality printed), one launch a frame for the batch; and the
    control, every stream fed stream 0's carry, below the bar on every
    other stream, or the check could not see a crossed carry.  Returns each
    program's launches."""
    from tecogan_tpu_torch.engine.inference import build_clip_inference
    from tecogan_tpu_torch.tools import (bench, bench_quant, bench_serving, bench_train,
                                         bench_train_scaling)

    for key in ("BENCH_FRAMES", "BENCH_REPS", "BENCH_INT8", "BENCH_TRAIN_REPS"):
        os.environ.pop(key, None)  # the programs' defaults, which the counts below assume
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    torch.backends.cudnn.deterministic = False
    runs = bench.REPS + 1  # the warm-up and the timed runs
    # a clip of each route, and prepare's calibration between them
    # (calibration runs the modules' tail)
    one_clip = _clip_launches([(bench.FRAMES, runs, "bf16"), (bench.CALIB_FRAMES, 1, "modules"),
                               (bench.FRAMES, runs, "int8")])
    programs = (
        ("bench", bench.main, one_clip),
        ("bench_serving", bench_serving.main, _clip_launches(
            [(bench_serving.stream_frames(bench.FRAMES, b), runs, "bf16")
             for b in bench_serving.BATCHES])),
        ("bench_quant", bench_quant.main, one_clip),
        ("bench_train", bench_train.main, _clip_launches([])),
        ("bench_train_scaling", bench_train_scaling.main, _clip_launches([])),
    )
    launches, records = {}, {}
    try:
        for name, main_fn, want in programs:
            _reset_counts()
            t0 = time.perf_counter()
            out = main_fn([])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches[name] = _kernel_counts()
            records[name] = out if isinstance(out, list) else [out]
            _finite_records(records[name], name)
            print(f"[17] {name}: {len(records[name])} record(s) in {secs:.1f} s | launches "
                  f"{launches[name]} | {smi}", flush=True)
            require(launches[name] == want,
                    f"[17] {name} launched {launches[name]}, its routes imply {want}")
            torch.cuda.empty_cache()
        errors = [r for r in records["bench_train_scaling"] if "error" in r]
        require(not errors and [r["batch"] for r in records["bench_train_scaling"]]
                == list(bench_train_scaling.BATCHES),
                f"[17] bench_train_scaling: {records['bench_train_scaling']}")
        require(all(r["card"] == smi for rs in records.values() for r in rs),
                "[17] a record names another card")

        cfg = bench.bench_config()
        model, _ = bench.serving_model(cfg, dev)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("weight"):
                    p.mul_(STREAMS_GAIN)
        clip = bench.lr_clip(np.random.default_rng(17), (BENCH_STREAMS, 8, *CLIP[2:]), dev)
        clip = clip * CLIP_RANGE
        _reset_counts()
        agree = bench_serving.streams_alone(cfg, model, clip)
        got = _kernel_counts()
        want = _clip_launches([(8, 1, "bf16"), (8, BENCH_STREAMS, "bf16")])
        infer = build_clip_inference(cfg)
        crossed = _crossed_carry_clip(model, clip)
        control_db = [psnr(crossed[b:b + 1], infer(model, clip[b:b + 1]))
                      for b in range(1, BENCH_STREAMS)]
        out = infer(model, clip[:1])
        clamped = float(((out == 0) | (out == 1)).float().mean())
        print(f"[17] each stream of a ({BENCH_STREAMS}, 8, 270, 480, 3) clip against it "
              f"served alone, weights x{STREAMS_GAIN}, clip in [0, {CLIP_RANGE}): "
              f"bit-equal {agree['bit_equal']}, max_abs {agree['max_abs']:.3e}, lowest "
              f"PSNR {agree['min_psnr_db']:.2f} dB (bar {PSNR_BAR_DB} dB); control, every "
              f"stream fed stream 0's carry: streams 1-{BENCH_STREAMS - 1} at "
              f"{', '.join(f'{db:.2f}' for db in control_db)} dB | {clamped:.2%} of "
              f"stream 0's output clamped | launches {got} | {smi}", flush=True)
        require(agree["min_psnr_db"] > PSNR_BAR_DB,
                f"[17] a stream of the batch differs from it alone: {agree}")
        require(max(control_db) < PSNR_BAR_DB,
                f"[17] crossed-carry control scores {control_db} dB: the check cannot "
                "see a stream fed another's carry")
        require(got == want, f"[17] the B-stream check launched {got}, expected {want}")
        del model, clip, crossed, out
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    torch.cuda.empty_cache()
    return launches


def conv_f32_phase(dev, smi, gen, weight, bias, earlier=None) -> dict:
    """Phase 3's second half: the fp32 route's kernel (f32 features, the f32
    weights as they are) against the plain version in f32 at FEAT_SHAPES
    0, 2 and 3: they differ in summation order, then one bf16 rounding.
    At the main shape its device time (a CUDA graph of 50 launches) beside
    its bound, the plain version's time (the chain and the cast to bf16),
    the f32 library chain's with TF32 off, and, where ``earlier`` (the
    library built from an earlier tree's ``conv_out_s2d.cu``) is given,
    that design's, held to the same bars.  Returns the kernel's record
    but its launches."""
    import ctypes

    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.utils.timing import events_ms, graph_ms

    rec = {"name": "conv_out_s2d_f32", "route": "cuda",
           "source": "tecogan_tpu_torch/csrc/conv_out_s2d.cu",
           "replaces": "tecogan_tpu/ops/pallas/conv_out_s2d.py:176", "max_abs_err": 0.0}
    if earlier is not None:
        earlier.conv_out_s2d_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                                + [ctypes.c_void_p])
        earlier.conv_out_s2d_launch.restype = ctypes.c_int

    def errors(got, ref):
        err = (got.float() - ref).abs()
        return float(err.max()), float(err.mean())

    for shape in (FEAT_SHAPES[0], FEAT_SHAPES[2], FEAT_SHAPES[3]):
        feat32 = torch.rand(shape, generator=gen, device=dev)
        ref = kmod.conv_out_s2d_reference(feat32, weight, bias)
        got = kmod.conv_out_s2d_cuda(feat32, weight, bias)
        torch.cuda.synchronize()
        require(tuple(got.shape) == tuple(ref.shape) and got.dtype == torch.bfloat16,
                f"fp32 kernel {tuple(got.shape)} {got.dtype} at {shape}")
        mx, mean = errors(got, ref)
        rec["max_abs_err"] = max(rec["max_abs_err"], mx)
        line = f"[3] conv_out_s2d fp32 {shape}: max_abs {mx:.3e} mean_abs {mean:.3e}"
        if shape == FEAT_SHAPES[0]:
            rec["ms"] = graph_ms(lambda: kmod.conv_out_s2d_cuda(feat32, weight, bias), 50)
            rec["plain_ms"] = events_ms(lambda: kmod.conv_out_s2d_reference(
                feat32, weight, bias).to(torch.bfloat16), 20)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False  # the same function as the kernel's
            try:
                rec["library_ms"] = events_ms(
                    lambda: kmod.conv_out_s2d_reference(feat32, weight, bias), 20)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            rec["bound_ms"], rec["bound_by"] = bound(
                feat32.numel() * 4 + got.numel() * 2, 2.0 * got.numel() * 9 * 64,
                PEAK_F32_FLOPS)
            line += (f" | kernel {rec['ms']:.4f} ms (graph), bound {rec['bound_ms']:.4f} ms"
                     f" ({rec['bound_by']}; {rec['bound_ms'] / rec['ms']:.1%}) | plain fp32"
                     f" {rec['plain_ms']:.4f} ms | library chain f32, TF32 off"
                     f" {rec['library_ms']:.4f} ms")
            if earlier is None:
                line += " | earlier design: not measured (no --parent tree)"
            else:
                old = torch.empty_like(got)

                def launch_earlier():
                    err = earlier.conv_out_s2d_launch(
                        feat32.data_ptr(), weight.data_ptr(), bias.data_ptr(), old.data_ptr(),
                        shape[0], shape[1] // 4, shape[2] // 4, 1,
                        torch.cuda.current_stream().cuda_stream)
                    require(err == 0, f"earlier f32 kernel: CUDA error {err}")

                launch_earlier()
                torch.cuda.synchronize()
                omx, omean = errors(old, ref)
                require(omx <= MAX_ERR and omean <= MEAN_ERR,
                        f"earlier f32 kernel vs plain: max {omx} mean {omean}")
                rec["earlier_ms"] = graph_ms(launch_earlier, 50)
                line += (f" | earlier design {rec['earlier_ms']:.4f} ms (graph; max_abs"
                         f" {omx:.3e})")
            line += f" | {smi}"
        print(line, flush=True)
        require(mx <= MAX_ERR and mean <= MEAN_ERR,
                f"fp32 kernel vs plain at {shape}: max {mx} mean {mean}")
        del feat32, ref, got
    return rec


# phase 18's masked edges of the bf16 kernels' tiles (2 rows, or 1 for
# up2x at Cin 128, by 64 columns): (transposed, B, H, W, Cin, Cout, bias,
# relu, residual), W below 64, W = 64k + 1, H = 1, B = 3, Cin != Cout
BF16_EDGE_SHAPES = [(False, 2, 135, 240, 64, 64, True, True, True),
                    (False, 1, 37, 53, 128, 64, True, True, True),
                    (False, 1, 5, 40, 64, 64, True, False, True),
                    (False, 2, 3, 129, 128, 128, False, False, True),
                    (False, 1, 1, 130, 128, 64, True, True, False),
                    (False, 3, 7, 70, 64, 128, False, True, True),
                    (True, 2, 37, 53, 64, 64, True, True, True),
                    (True, 1, 5, 40, 128, 64, True, True, True),
                    (True, 2, 1, 65, 64, 128, False, False, True),
                    (True, 3, 4, 129, 64, 64, True, False, True)]


def bf16_conv_phase(dev, smi) -> list:
    """Phase 18 (see the module's docstring); returns the two kernels'
    records, their times a frame's (the launches are set by the caller)."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                    build_quantized_clip_inference)
    from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                                state_from_params)
    from tecogan_tpu_torch.engine.train import build_train_step
    from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
    from tecogan_tpu_torch.ops.kernels import bf16_conv as bmod
    from tecogan_tpu_torch.tools import bf16_layers

    recs = {up: {"name": "bf16_up2x" if up else "bf16_conv3x3", "route": "cuda",
                 "source": "tecogan_tpu_torch/csrc/bf16_conv.cu",
                 "replaces": ("cuDNN's conv + torch's bias, ReLU and skip-add passes, for "
                              "tecogan_tpu/models/generator.py's XLA convs"),
                 "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "bound_by": [], "library_ms": 0.0, "layers": []} for up in (False, True)}
    for i, (up, B, H, W, cin, cout, bias, relu, residual) in enumerate(BF16_EDGE_SHAPES):
        x, w, b, res = bf16_layers.layer_inputs(dev, up, (B, H, W, cin, cout), 300 + i, bias)
        res = res if residual else None
        kernel, plain = ((bmod.bf16_up2x_cuda, bmod.bf16_up2x_reference) if up else
                         (bmod.bf16_conv3x3_cuda, bmod.bf16_conv3x3_reference))
        got = kernel(x, w, b, relu, res)
        torch.cuda.synchronize()
        rec = bf16_layers.check(got, plain(x, w, b, relu, res), x, w, b, relu, res, up)
        recs[up]["max_abs_err"] = max(recs[up]["max_abs_err"], rec["max_abs_err"])
        print(f"[18] {recs[up]['name']} {(B, H, W, cin, cout)} bias {bias} relu {relu} "
              f"residual {residual}: max gap {rec['max_abs_err']:.3e}, "
              f"{rec['differ_share']:.3%} differ from plain (within the bars)", flush=True)
    rows = bf16_layers.measure(dev)
    for r in rows:
        print(f"[18] {r['layer']} {tuple(r['shape'])} x{r['launches_a_frame']}: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.1%}) | plain chain {r['plain_ms']:.4f} ms | cuDNN conv "
              f"+ bias + ReLU {r['cudnn_bias_relu_ms']:.4f} ms | max gap {r['max_abs_err']:.3e}, "
              f"{r['differ_share']:.3%} differ | {smi}", flush=True)
        rec, n = recs[r["kernel"] == "bf16_up2x"], r["launches_a_frame"]
        for key, src in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                         ("library_ms", "cudnn_bias_relu_ms")):
            rec[key] += r[src] * n
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        rec["bound_by"] = sorted(set(rec["bound_by"]) | {r["bound_by"]})
        rec["layers"].append(r)
    print(f"[18] {bf16_layers.summary(rows)} | {smi}", flush=True)
    for rec in recs.values():
        rec["bound_by"] = " and ".join(rec["bound_by"])

    cfg = TecoConfig(num_resblock=16, precision="fp32", bug_parity=False, use_pallas=True)
    params = init_generator(cfg, torch.Generator().manual_seed(0))
    clip = torch.from_numpy(np.random.default_rng(0).random((1, 3, 12, 20, 3), np.float32))
    routes = {}
    _reset_counts()
    build_clip_inference(cfg)(_model_on(cfg, params, dev), clip.to(dev))
    routes["fp32 fused, 3 frames"] = _kernel_counts()
    q16 = cfg.replace(precision="bf16")
    model = _model_on(q16, params, dev)
    prepare, qinfer = build_quantized_clip_inference(q16)
    qtail = prepare(model, params, clip, frames=2)
    _reset_counts()
    qinfer(model, qtail, clip.to(dev))
    routes["int8, 3 frames"] = _kernel_counts()
    train = TecoConfig(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                       discrim_channels=16, batch_size=2, precision="bf16")
    g = torch.Generator().manual_seed(0)
    state = state_from_params(train, init_generator(train, g), *init_discriminator(train, g),
                              device=dev)
    lr, hr = synthetic_scene_batch(2, 9, 8, seed=0)
    _reset_counts()
    build_train_step(train, device=dev)(state, torch.from_numpy(lr), torch.from_numpy(hr))
    torch.cuda.synchronize()
    routes["bf16 train step"] = _kernel_counts()
    print(f"[18] launches: {routes}", flush=True)
    require(routes == {"fp32 fused, 3 frames": _fused_launches(3, "modules"),
                       "int8, 3 frames": _fused_launches(3, "int8"),
                       "bf16 train step": dict.fromkeys(_fused_launches(1, "modules"), 0)},
            f"[18] launches {routes}")
    return [recs[False], recs[True]]


# phase 19: TecoGAN as published.  (B, H, W) of the LR carry and the flow's
# range in LR pixels (far past the frame: every sample clamps at an edge)
FLOW_SHAPES = [((1, 270, 480), 6.0), ((2, 135, 240), 3.0), ((1, 37, 53), 40.0)]
BICUBIC_SHAPES = [(1, 1080, 1920, 64), (2, 540, 960, 64), (1, 148, 212, 64)]
# the skip layer's bar: its f32 sums of 9 * 64 products and the skip's 16
# taps in another order than cuDNN's (TF32 off), each order within 590 *
# 2**-24 of the sum of the terms' magnitudes, so a gap of at most 2**-13 of
# that sum (the plain version on the magnitudes), plus 1e-6
BICUBIC_RTOL, BICUBIC_ATOL = 2.0 ** -13, 1e-6
PUBLISHED_T, PUBLISHED_CHUNK = 8, 3


def _published_weights(model, g: torch.Generator) -> None:
    """Weights as the benchmark draws them for TecoGAN as published: each
    conv kernel uniform in (-b, b), b = 1 / sqrt(9 * C_in), times 2.25 in
    FNet and 1.3 in the generator (its configuration's gains); the biases
    zero."""
    with torch.no_grad():
        for name, t in model.named_parameters():
            if t.dim() != 4:
                t.zero_()
                continue
            fan = 9 * t.shape[0 if name.endswith(("up1.weight", "up2.weight")) else 1]
            gain = 2.25 if name.startswith("fnet.") else 1.3
            t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * fan ** -0.5 * gain)
    model.eval()


def _published_kernel(name: str):
    """The published route's hand kernel that a device trace's kernel
    ``name`` is (by the sources' ``__global__`` names), or None."""
    if "dense_flow_warp_kernel" in name:
        return "flow_warp_s2d"
    if "conv_out_bicubic_kernel" in name:
        return "conv_out_bicubic_s2d"
    if "bf16_conv_kernel" in name:
        up = re.search(r"bf16_conv_kernel\s*<[^>]*\btrue\b|bf16_conv_kernelI.*Lb1E", name)
        return "bf16_up2x" if up else "bf16_conv3x3"
    return None


def _traced_hand_launches(fn) -> tuple:
    """``fn()`` under the profiler: ({hand kernel: launches} counted by
    kernel name in the device trace, CUDA graphs' kernels included, and
    the kernel names matched)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"flow_warp_s2d": 0, "conv_out_bicubic_s2d": 0, "bf16_conv3x3": 0, "bf16_up2x": 0}
    names = set()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = _published_kernel(ev.name())
        if kind is not None:
            counts[kind] += 1
            names.add(ev.name())
    return counts, sorted(names)


def published_phase(dev, smi) -> list:
    """Phase 19 (see the module's docstring); returns the two kernels'
    records."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine import published
    from tecogan_tpu_torch.engine.inference import (build_chunked_inference,
                                                    build_clip_inference,
                                                    build_stream_inference)
    from tecogan_tpu_torch.engine.state import init_generator, published_model_defs
    from tecogan_tpu_torch.ops.image import transfer_to_uint8
    from tecogan_tpu_torch.ops.kernels import bf16_conv as bmod
    from tecogan_tpu_torch.ops.kernels import conv_out_bicubic_s2d as cbmod
    from tecogan_tpu_torch.ops.kernels import flow_warp_s2d as fwmod
    from tecogan_tpu_torch.utils.timing import graph_ms

    gen = torch.Generator(device=dev).manual_seed(19)
    warp = {"name": "flow_warp_s2d", "route": "cuda",
            "source": "tecogan_tpu_torch/csrc/flow_warp_s2d.cu",
            "replaces": "TecoGAN's upscale_four + dense_image_warp + space_to_depth",
            "max_abs_err": 0.0}
    for (B, H, W), reach in FLOW_SHAPES:
        carry = torch.rand((B, H, W, 48), generator=gen, device=dev)
        flow = (torch.rand((B, H, W, 2), generator=gen, device=dev) * 2 - 1) * reach
        got = fwmod.flow_warp_s2d_cuda(flow, carry)
        ref = fwmod.flow_warp_s2d_reference(flow, carry).bfloat16()
        err = (got.float() - ref.float()).abs().max().item()
        warp["max_abs_err"] = max(warp["max_abs_err"], err)
        print(f"[19] flow_warp_s2d {(B, H, W)} flow +-{reach}: max gap to plain {err:.3e}",
              flush=True)
        require(err == 0.0, f"[19] flow_warp_s2d {(B, H, W)} differs from plain by {err}")
    (B, H, W), reach = FLOW_SHAPES[0]
    carry = torch.rand((B, H, W, 48), generator=gen, device=dev)
    flow = (torch.rand((B, H, W, 2), generator=gen, device=dev) * 2 - 1) * reach
    warp["bytes"] = float(B * H * W * (2 * 4 + 48 * 4 + 48 * 2))
    warp["bound_ms"] = warp["bytes"] / HBM_BYTES_PER_S * 1e3
    warp["bound_by"] = "bytes"
    warp["ms"] = graph_ms(lambda: fwmod.flow_warp_s2d_cuda(flow, carry), 50)
    warp["plain_ms"] = graph_ms(lambda: fwmod.flow_warp_s2d_reference(flow, carry), 5)
    print(f"[19] flow_warp_s2d {(B, H, W)}: kernel {warp['ms']:.4f} ms, bound "
          f"{warp['bound_ms']:.4f} ms ({warp['bound_ms'] / warp['ms']:.1%}), plain "
          f"{warp['plain_ms']:.4f} ms | {smi}", flush=True)

    conv = {"name": "conv_out_bicubic_s2d", "route": "cuda",
            "source": "tecogan_tpu_torch/csrc/conv_out_bicubic_s2d.cu",
            "replaces": "TecoGAN's conv_out + bicubic_four + space_to_depth",
            "max_abs_err": 0.0}
    weight = torch.randn((3, 3, 64, 3), generator=gen, device=dev) * 0.05
    bias = torch.randn((3,), generator=gen, device=dev) * 0.1
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 sums
    for shape in BICUBIC_SHAPES:
        B, H4, W4, _ = shape
        feat = torch.rand(shape, generator=gen, device=dev).bfloat16()
        lr = torch.rand((B, H4 // 4, W4 // 4, 3), generator=gen, device=dev)
        got = cbmod.conv_out_bicubic_s2d_cuda(feat, weight, bias, lr)
        ref = cbmod.conv_out_bicubic_s2d_reference(feat, weight, bias, lr)
        size = cbmod.conv_out_bicubic_s2d_reference(feat.abs(), weight.abs(), bias.abs(), lr)
        gap = (got - ref).abs()
        err = gap.max().item()
        over = (gap > size * BICUBIC_RTOL + BICUBIC_ATOL).sum().item()
        conv["max_abs_err"] = max(conv["max_abs_err"], err)
        print(f"[19] conv_out_bicubic_s2d {shape}: max gap to plain {err:.3e}, "
              f"{over} values past the bar", flush=True)
        require(over == 0, f"[19] conv_out_bicubic_s2d {shape}: {over} values past the bar")
    torch.backends.cudnn.allow_tf32 = tf32
    B, H4, W4, _ = BICUBIC_SHAPES[0]
    feat = torch.rand(BICUBIC_SHAPES[0], generator=gen, device=dev).bfloat16()
    lr = torch.rand((B, H4 // 4, W4 // 4, 3), generator=gen, device=dev)
    conv["bytes"] = float(feat.numel() * 2 + lr.numel() * 4 + (9 * 64 * 3 + 3) * 4
                          + B * H4 * W4 // 16 * 48 * 4)
    conv["bound_ms"] = conv["bytes"] / HBM_BYTES_PER_S * 1e3
    conv["bound_by"] = "bytes"
    conv["ms"] = graph_ms(lambda: cbmod.conv_out_bicubic_s2d_cuda(feat, weight, bias, lr), 50)
    conv["plain_ms"] = graph_ms(
        lambda: cbmod.conv_out_bicubic_s2d_reference(feat, weight, bias, lr), 5)
    print(f"[19] conv_out_bicubic_s2d {BICUBIC_SHAPES[0]}: kernel {conv['ms']:.4f} ms, bound "
          f"{conv['bound_ms']:.4f} ms ({conv['bound_ms'] / conv['ms']:.1%}), plain "
          f"{conv['plain_ms']:.4f} ms | {smi}", flush=True)

    # the full-width published route
    cfg = TecoConfig(num_resblock=16, precision="bf16")
    model = published_model_defs(cfg, device=dev)
    g = torch.Generator().manual_seed(19)
    _published_weights(model, g)
    clip = (torch.rand((1, PUBLISHED_T, 270, 480, 3), generator=g) * 76).to(torch.uint8)
    torch.backends.cudnn.deterministic = True  # FNet's convs: the same sums every call
    counts = {}

    def reset():
        fwmod.launch_count = cbmod.launch_count = 0
        bmod.conv3x3_launch_count = bmod.up2x_launch_count = 0

    def read():
        return {"flow_warp_s2d": fwmod.launch_count,
                "conv_out_bicubic_s2d": cbmod.launch_count,
                "bf16_conv3x3": bmod.conv3x3_launch_count, "bf16_up2x": bmod.up2x_launch_count}

    infer = build_clip_inference(cfg)
    out = infer(model, clip.to(dev))  # eager, then each graph captured
    torch.cuda.synchronize()
    reset()
    published.replay_count.clear()
    t0 = time.perf_counter()
    out = infer(model, clip.to(dev))
    torch.cuda.synchronize()
    fps = PUBLISHED_T / (time.perf_counter() - t0)
    counts["clip, wrappers"] = read()
    counts["clip, graph replays"] = dict(published.replay_count)
    want = {"flow_warp_s2d": PUBLISHED_T - 1, "conv_out_bicubic_s2d": PUBLISHED_T,
            "bf16_conv3x3": 0, "bf16_up2x": 0}
    require(counts["clip, wrappers"] == want,
            f"[19] published clip's wrappers counted {counts['clip, wrappers']}, want {want}")
    replays = {"fnet": PUBLISHED_T - 1, "resblocks": PUBLISHED_T, "upsample": PUBLISHED_T}
    require(counts["clip, graph replays"] == replays,
            f"[19] published clip replayed {counts['clip, graph replays']}, want {replays}")
    counts["clip, device trace"], names = _traced_hand_launches(lambda: infer(model, clip.to(dev)))
    want = {"flow_warp_s2d": PUBLISHED_T - 1, "conv_out_bicubic_s2d": PUBLISHED_T,
            "bf16_conv3x3": 32 * PUBLISHED_T, "bf16_up2x": 2 * PUBLISHED_T}
    require(counts["clip, device trace"] == want,
            f"[19] published clip's trace holds {counts['clip, device trace']} ({names}), "
            f"want {want}")
    u8 = transfer_to_uint8(out).cpu()
    sat = ((u8 == 0) | (u8 == 255)).float().mean().item()
    chunked = build_chunked_inference(cfg, out_u8=True)(model, clip, chunk=PUBLISHED_CHUNK)
    require(torch.equal(chunked, u8), "[19] chunked published clip differs from the clip")
    init_fn, step_fn = build_stream_inference(cfg)
    state = init_fn((1, 270, 480, 3), device=dev)
    frames = []
    for t in range(PUBLISHED_T):
        state, sr = step_fn(model, state, clip[:, t])
        frames.append(sr)
    require(torch.equal(torch.stack(frames, 1), out), "[19] published stream differs from the clip")
    # a parameter replaced after the capture: the next call captures anew
    # (a stale graph would serve the old weights' frames)
    model.generator.up2.weight = torch.nn.Parameter(model.generator.up2.weight.detach() * 0.5)
    moved = infer(model, clip.to(dev))
    again = infer(model, clip.to(dev))
    require(not torch.equal(moved, out) and torch.equal(again, moved),
            "[19] the published route's graphs did not follow a replaced parameter")
    # dwight-foster's bf16 clip launches neither of the published kernels
    df_cfg = TecoConfig(num_resblock=16, precision="bf16", bug_parity=False, use_pallas=True)
    df = _model_on(df_cfg, init_generator(df_cfg, torch.Generator().manual_seed(0)), dev)
    reset()
    build_clip_inference(df_cfg)(df, clip[:, :3].to(dev))
    torch.cuda.synchronize()
    counts["dwight-foster clip, 3 frames"] = read()
    require(counts["dwight-foster clip, 3 frames"]["flow_warp_s2d"] == 0
            and counts["dwight-foster clip, 3 frames"]["conv_out_bicubic_s2d"] == 0,
            f"[19] dwight-foster's clip launched {counts['dwight-foster clip, 3 frames']}")
    torch.backends.cudnn.deterministic = False
    print(f"[19] published route, 16 resblocks, {PUBLISHED_T} frames of 270x480: {fps:.2f} fps, "
          f"{sat:.3%} of u8 values at 0 or 255; chunked (windows of {PUBLISHED_CHUNK}, u8) "
          f"and stream bit-equal to the clip; launches {counts} | {smi}", flush=True)
    for rec in (warp, conv):
        rec["launches"] = counts["clip, device trace"][rec["name"]]
        rec["library_ms"] = None
    return [warp, conv]


def main(parent=None) -> None:
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
    from tecogan_tpu_torch.ops.kernels import bf16_conv as bmod
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod
    from tecogan_tpu_torch.ops.kernels._build import load as load_source
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
    found = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "imageio", "PIL")}
    print(f"[1] image I/O modules importable: {found}", flush=True)

    # -- 2. build: one nvcc a source, started together
    from tecogan_tpu_torch.ops.kernels import conv_out_bicubic_s2d as cbmod
    from tecogan_tpu_torch.ops.kernels import flow_warp_s2d as fwmod

    jobs = {"conv_out_s2d": kmod.build, "warp_s2d": wmod.build, "int8_conv": qmod.build,
            "bf16_conv": bmod.build, "flow_warp_s2d": fwmod.build,
            "conv_out_bicubic_s2d": cbmod.build}
    if parent is not None:  # the earlier f32 design, timed in phase 3
        jobs["conv_out_s2d (earlier tree)"] = lambda: load_source(
            pathlib.Path(parent) / "tecogan_tpu_torch" / "csrc" / "conv_out_s2d.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda build: build(), jobs.values())))
    earlier = None
    if parent is not None:
        earlier, logs["conv_out_s2d (earlier tree)"] = logs["conv_out_s2d (earlier tree)"]
    print(f"[2] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"    {name}: " + " | ".join(ptxas), flush=True)

    def reset_counts():
        kmod.launch_count = wmod.launch_count = 0
        bmod.conv3x3_launch_count = bmod.up2x_launch_count = 0

    def counts():
        """conv_out_s2d, warp_s2d, bf16_conv3x3 and bf16_up2x launches."""
        return (kmod.launch_count, wmod.launch_count, bmod.conv3x3_launch_count,
                bmod.up2x_launch_count)

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
    conv32 = conv_f32_phase(dev, smi, gen, weight, bias, earlier)

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
    launches = counts()
    T = CLIP[1]
    require(tuple(out.shape) == (1, T, 1080, 1920, 3), f"output {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite output")
    require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")
    require(launches == (T, T - 1, 37 * T, 2 * T),
            f"conv_out_s2d / warp_s2d / bf16_conv3x3 / bf16_up2x launched {launches} times "
            f"for {T} frames")
    conv["launches"] = launches[0]
    fps = T / secs
    tflops = fps * 2.0 * generator_macs_per_frame(CLIP[2], CLIP[3], 16) / 1e12
    print(f"[4] 270p->1080p T={T} full width bf16: {fps:.3f} fps "
          f"({secs * 1e3:.3f} ms a clip), {tflops:.3f} TFLOP/s, MFU "
          f"{tflops * 1e12 / H100_PEAK_BF16_FLOPS:.4%} of 989 TFLOP/s | "
          f"launches conv_out_s2d {launches[0]}, warp_s2d {launches[1]}, bf16_conv3x3 "
          f"{launches[2]}, bf16_up2x {launches[3]} | {smi}", flush=True)
    del out

    # the fp32 fused route (the precision reference, TF32 off) on the same
    # weights and clip: the f32 kernel's path, and its share of a frame
    cfg32 = TecoConfig(num_resblock=16, precision="fp32", bug_parity=False, use_pallas=True)
    model32 = model_defs(cfg32, device=dev)
    model32.load_state_dict(generator_state_dict_from_jax(params))
    model32.eval()
    infer32 = build_clip_inference(cfg32)
    infer32(model32, clip)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = infer32(model32, clip)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches32 = counts()
    require(tuple(out.shape) == (1, T, 1080, 1920, 3) and out.dtype == torch.float32,
            f"fp32 output {tuple(out.shape)} {out.dtype}")
    require(bool(torch.isfinite(out).all()), "non-finite fp32 output")
    require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "fp32 output outside [0, 1]")
    require(launches32 == (T, T - 1, 0, 0),
            f"fp32 route: conv_out_s2d / warp_s2d / bf16_conv3x3 / bf16_up2x launched "
            f"{launches32} times for {T} frames")
    conv32["launches"] = launches32[0]
    frame_ms = secs * 1e3 / T
    print(f"[4] 270p->1080p T={T} full width fp32 fused (TF32 off): {T / secs:.3f} fps "
          f"({secs * 1e3:.3f} ms a clip) | launches conv_out_s2d (f32 kernel) "
          f"{launches32[0]}, warp_s2d {launches32[1]} | the f32 kernel {conv32['ms']:.4f} ms "
          f"(phase 3), {conv32['ms'] / frame_ms:.3%} of a frame's {frame_ms:.3f} ms | {smi}",
          flush=True)
    del out, model32, infer32

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
    chunk_counts = counts()
    peak40 = torch.cuda.max_memory_allocated(dev)
    sizes = [w.shape[1] for w in windows]
    require(sum(sizes) == CHUNK_T and max(sizes) <= CHUNK,
            f"sink windows {sizes} for T={CHUNK_T}, chunk {CHUNK}")
    require(all(w.dtype == torch.uint8 for w in windows), "sink windows not uint8")
    require(torch.equal(torch.cat(windows, dim=1), want),
            "chunked u8 output differs from transfer_to_uint8 of the one-shot clip")
    require(chunk_counts == (CHUNK_T, CHUNK_T - 1, 37 * CHUNK_T, 2 * CHUNK_T),
            f"chunked launches {chunk_counts}")
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
          f"launches (conv_out_s2d, warp_s2d, bf16_conv3x3, bf16_up2x) {chunk_counts} | "
          f"peak device "
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
    stream_counts = counts()
    torch.backends.cudnn.deterministic = False
    require(torch.equal(torch.stack(got, dim=1), want), "stream differs from clip")
    require(stream_counts == (STREAM_T, STREAM_T - 1, 37 * STREAM_T, 2 * STREAM_T),
            f"stream launches {stream_counts}")
    print(f"[8] stream {STREAM_T} frames: bit-equal to the clip route | frame latency "
          f"p50 {statistics.median(lat_ms):.3f} ms, max {max(lat_ms):.3f} ms "
          f"(line {FRAME_BUDGET_MS:.1f} ms) | launches (conv_out_s2d, warp_s2d, "
          f"bf16_conv3x3, bf16_up2x) {stream_counts} | {smi}", flush=True)

    train_phases(dev, smi)

    int8_recs = int8_phase(dev, smi, cfg, model, params, clip, infer, small, fast_model, sd,
                           small_clip, fast, rng)
    del model, clip, infer
    adapt_phase(dev, smi, small, fast_model, sd, small_clip, fast, exact_model)
    cli_phase(dev, smi)
    del fast_model, exact_model, fast
    torch.cuda.empty_cache()
    multi = multi_phase(dev, smi)
    exported = export_phase(dev, smi)
    benched = bench_phase(dev, smi)
    bf16_recs = bf16_conv_phase(dev, smi)
    published_recs = published_phase(dev, smi)
    # the bf16 fused conv kernels' launches: the full-width bf16 clip's (phase 4)
    bf16_recs[0]["launches"], bf16_recs[1]["launches"] = launches[2], launches[3]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    records = [{k: rec[k] for k in keys} for rec in (conv, warp, *int8_recs)]
    records += [{k: rec[k] for k in keys + ("layers",)} for rec in bf16_recs]
    for rec in records:  # phase 15's paths: each kernel's launches a rank
        rec["launches_multi"] = {path: counts[rec["name"]] for path, counts in multi.items()}
        rec["launches_exported"] = {path: counts[rec["name"]] for path, counts in exported.items()}
        rec["launches_bench"] = {prog: counts[rec["name"]] for prog, counts in benched.items()}
    records += [{k: rec[k] for k in keys} for rec in published_recs]  # phase 19's route only
    # the fp32 route's kernel: its launches are the fp32 clip's (phase 4);
    # phases 15-17 serve bf16 and int8
    records.insert(1, {k: conv32[k] for k in keys + ("earlier_ms",) if k in conv32})
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-exported":
        serve_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--parent":
        main(parent=sys.argv[2])
    else:
        main()
