#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tecogan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``tecogan_tpu_torch/csrc`` and drives
the serving path a user calls -- random full-width weights through
``generator_state_dict_from_jax`` into ``build_clip_inference`` -- on a
270p -> 1080p clip.  Phases:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel's build time;
3. the ``conv_out_s2d`` kernel against its plain PyTorch version (fp32,
   TF32 off) on the same bf16 inputs at three shapes, with its time beside
   the plain bf16 version's at the main path's shape;
4. the full-width generator (16 resblocks, bf16) on a (1, 8, 270, 480, 3)
   clip: output shape, range, the kernel's launch count, fps, TFLOP/s and
   MFU against the H100's dense bf16 peak;
5. the fused route with the kernel (bf16) against the exact route (fp32)
   on the same weights at a small width: last-frame PSNR.

Every failed check exits non-zero; there is no CPU path.  The last line
of standard output is the JSON device record.
"""

import json
import os
import sys
import time

import numpy as np
import torch

FEAT_SHAPES = [(1, 1080, 1920, 64),  # the main path: LR 270 x 480
               (2, 540, 960, 64),    # LR H = 135, odd
               (1, 148, 212, 64)]    # LR 37 x 53, H and W odd
MAX_ERR, MEAN_ERR = 8e-3, 1e-3       # two bf16 ulps at 1.0; mean bar
CLIP = (1, 8, 270, 480, 3)
SMALL_CLIP = (1, 6, 16, 24, 3)
PSNR_BAR_DB = 40.0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is visible")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tecogan_tpu.config import TecoConfig
    from tecogan_tpu_torch.engine.inference import build_clip_inference
    from tecogan_tpu_torch.engine.state import init_generator, model_defs
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax
    from tecogan_tpu_torch.utils.flops import (H100_PEAK_BF16_FLOPS,
                                               generator_macs_per_frame)
    from tecogan_tpu_torch.utils.timing import card, events_ms

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()

    # -- 1. the card
    print(smi)
    print(f"[1] card: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)

    # -- 2. build
    t0 = time.perf_counter()
    log = kmod.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2] build: {time.perf_counter() - t0:.1f} s | "
          + " | ".join(ptxas), flush=True)

    # -- 3. the kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    weight = torch.randn((3, 3, 64, 3), generator=gen, device=dev) * 0.05
    bias = torch.randn((3,), generator=gen, device=dev) * 0.1
    max_err = 0.0
    kernel_ms = plain_ms = None
    for shape in FEAT_SHAPES:
        feat = torch.rand(shape, generator=gen, device=dev).bfloat16()
        ref = kmod.conv_out_s2d_reference(feat.float(), weight, bias)
        got = kmod.conv_out_s2d_cuda(feat, weight, bias)
        torch.cuda.synchronize()
        require(tuple(got.shape) == tuple(ref.shape),
                f"kernel shape {tuple(got.shape)} at {shape}")
        err = (got.float() - ref).abs()
        mx, mean = float(err.max()), float(err.mean())
        max_err = max(max_err, mx)
        line = f"[3] conv_out_s2d {shape}: max_abs {mx:.3e} mean_abs {mean:.3e}"
        if shape == FEAT_SHAPES[0]:
            kernel_ms = events_ms(lambda: kmod.conv_out_s2d_cuda(feat, weight, bias), 50)
            plain_ms = events_ms(
                lambda: kmod.conv_out_s2d_reference(feat, weight, bias), 50)
            floor_ms = (feat.numel() + got.numel()) * 2 / HBM_BYTES_PER_S * 1e3
            line += (f" | kernel {kernel_ms:.4f} ms ({floor_ms / kernel_ms:.1%} of"
                     f" the {floor_ms:.4f} ms bytes floor) | plain bf16"
                     f" {plain_ms:.4f} ms ({floor_ms / plain_ms:.1%}) | {smi}")
        print(line, flush=True)
        require(mx <= MAX_ERR and mean <= MEAN_ERR,
                f"kernel vs plain at {shape}: max {mx} mean {mean}")
        del feat, ref, got, err

    # -- 4. the full-width serving path
    cfg = TecoConfig(num_resblock=16, precision="bf16", bug_parity=False,
                     use_pallas=True, warp_group=4)
    params = init_generator(cfg, torch.Generator().manual_seed(0))
    model = model_defs(cfg).to(dev)
    model.load_state_dict(generator_state_dict_from_jax(params))
    model.eval()
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.random(CLIP, np.float32)).to(dev)
    infer = build_clip_inference(cfg)
    infer(model, clip)  # warm-up
    torch.cuda.synchronize()
    kmod.launch_count = 0
    t0 = time.perf_counter()
    out = infer(model, clip)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kmod.launch_count
    T = CLIP[1]
    require(tuple(out.shape) == (1, T, 1080, 1920, 3), f"output {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite output")
    require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")
    require(launches == T, f"kernel launched {launches} times for {T} frames")
    fps = T / secs
    tflops = fps * 2.0 * generator_macs_per_frame(CLIP[2], CLIP[3], 16) / 1e12
    print(f"[4] 270p->1080p T={T} full width bf16: {fps:.3f} fps "
          f"({secs * 1e3:.3f} ms a clip), {tflops:.3f} TFLOP/s, MFU "
          f"{tflops * 1e12 / H100_PEAK_BF16_FLOPS:.4%} of 989 TFLOP/s | "
          f"conv_out_s2d launches {launches} | {smi}", flush=True)
    del out, clip, model

    # -- 5. fused (kernel, bf16) vs exact (fp32) on the same weights
    small = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False,
                       use_pallas=True)
    exact_cfg = small.replace(precision="fp32", use_pallas=False)
    sd = generator_state_dict_from_jax(
        init_generator(small, torch.Generator().manual_seed(1)))
    fast_model = model_defs(small).to(dev)
    fast_model.load_state_dict(sd)
    exact_model = model_defs(exact_cfg).to(dev)
    exact_model.load_state_dict(sd)
    small_clip = torch.from_numpy(rng.random(SMALL_CLIP, np.float32)).to(dev)
    fast = build_clip_inference(small)(fast_model.eval(), small_clip)
    exact = build_clip_inference(exact_cfg)(exact_model.eval(), small_clip)
    db = psnr(fast[:, -1], exact[:, -1])
    print(f"[5] fused bf16 (kernel) vs exact fp32, last of {SMALL_CLIP[1]} "
          f"frames: {db:.2f} dB PSNR", flush=True)
    require(db > PSNR_BAR_DB, f"fused vs exact PSNR {db:.2f} dB")

    print(json.dumps({"kernels": [{
        "name": "conv_out_s2d", "route": "cuda",
        "source": "tecogan_tpu_torch/csrc/conv_out_s2d.cu",
        "replaces": "tecogan_tpu/ops/pallas/conv_out_s2d.py:176",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
