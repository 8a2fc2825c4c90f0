#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tecogan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tecogan_tpu_torch/csrc`` (one
``nvcc`` a source, started together) and drives the serving paths a user
calls -- random full-width weights through ``generator_state_dict_from_jax``
into ``build_clip_inference``, ``build_chunked_inference`` and
``build_stream_inference`` -- at 270p -> 1080p.  Phases:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernels' build time;
3. the ``conv_out_s2d`` kernel against its plain PyTorch version (fp32,
   TF32 off) on the same bf16 inputs and the bf16-rounded weights the
   kernel computes with, at three shapes; at the main path's shape its
   device time (a CUDA graph of back-to-back launches; the wrapper's
   back-to-back time beside it) against its bound, the plain version's
   time and the bf16 library chain's (``F.conv2d`` + sigmoid +
   ``pixel_unshuffle``);
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
   bit-equal to the clip route; per-frame latency.

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
    with ThreadPoolExecutor(2) as pool:
        logs = dict(zip(("conv_out_s2d", "warp_s2d"),
                        pool.map(lambda m: m.build(), (kmod, wmod))))
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
    del out, clip

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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in (conv, warp)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
