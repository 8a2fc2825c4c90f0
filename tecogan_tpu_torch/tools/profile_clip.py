"""Where the time of the port's 270p -> 1080p serving path goes, on one GPU.

    python -m tecogan_tpu_torch.tools.profile_clip [--out profile_clip.json]

With the full-width generator (16 resblocks, bf16, random weights from
seed 0) on a (1, 8, 270, 480, 3) clip it measures:

* clip time over 10 runs after a warm-up (host clock around
  ``torch.cuda.synchronize()``, tracing off): fps median, min and max;
* one clip under ``torch.profiler``: summed kernel time (device busy
  share of the untraced median clip time) and kernel time by name;
* one recurrent frame step split into its layers with CUDA events, each
  the mean of 10 launches: the ``warp_s2d`` kernel (pseudo-flow, u8
  sample, deprocess and s2d pack in one), the first layer (``conv_in``
  over [lr || feedback]), the trunk (``tail_features``, cuDNN), the
  ``conv_out_s2d`` kernel, the whole step, and the clip's closing
  s2d -> frame assembly.

Fails without a GPU; prints one line a measurement and writes them all as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from ..config import TecoConfig
from ..engine.fused import (conv_out_params, conv_out_s2d, fused_first_frame_s2d,
                            fused_first_layer, fused_sr_step_s2d, s2d_to_frame,
                            warp_s2d_feedback)
from ..engine.inference import build_clip_inference
from ..engine.state import init_generator, model_defs
from ..utils.convert import generator_state_dict_from_jax
from ..utils.flops import H100_PEAK_BF16_FLOPS, generator_macs_per_frame
from ..utils.timing import card, events_ms

H, W = 270, 480
FRAMES, REPS, SEED = 8, 10, 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_clip needs a CUDA GPU; none is visible")
    dev = torch.device("cuda", 0)
    smi = card()
    rec = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "frames": FRAMES, "reps": REPS, "seed": SEED}

    cfg = TecoConfig(num_resblock=16, precision="bf16", bug_parity=False,
                     use_pallas=True)
    model = model_defs(cfg, device=dev)
    model.load_state_dict(generator_state_dict_from_jax(
        init_generator(cfg, torch.Generator().manual_seed(SEED))))
    model.eval()
    rng = np.random.default_rng(SEED)
    clip = torch.from_numpy(
        rng.random((1, FRAMES, H, W, 3), np.float32)).to(dev)
    infer = build_clip_inference(cfg)

    # -- clip time, tracing off
    infer(model, clip)
    torch.cuda.synchronize()
    secs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        infer(model, clip)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    fps = [FRAMES / s for s in secs]
    flop = 2.0 * generator_macs_per_frame(H, W, 16)
    rec["clip_ms"] = {"median": med * 1e3, "min": min(secs) * 1e3,
                      "max": max(secs) * 1e3, "n": len(secs)}
    rec["fps"] = {"median": FRAMES / med, "min": min(fps), "max": max(fps)}
    rec["tflops_median"] = FRAMES / med * flop / 1e12
    rec["mfu_median"] = FRAMES / med * flop / H100_PEAK_BF16_FLOPS
    print(f"clip: {rec['clip_ms']} ms -> fps {rec['fps']}, "
          f"{rec['tflops_median']:.3f} TFLOP/s, MFU {rec['mfu_median']:.4%} | {smi}",
          flush=True)

    # -- one traced clip: kernel time by name
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(model, clip)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    # device-side events only: the aten ops on the CPU side report the same
    # kernel time again as their own
    kernels = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    rec["traced_clip_ms"] = traced * 1e3
    rec["device_busy_ms"] = busy_us / 1e3
    rec["device_busy_share"] = busy_us / 1e3 / (med * 1e3)
    rec["kernels"] = [{"name": n, "ms": us / 1e3, "count": c}
                      for n, us, c in kernels[:25]]
    print(f"profiler: kernels {busy_us / 1e3:.3f} ms busy in a traced clip of "
          f"{traced * 1e3:.3f} ms; busy share of the untraced median "
          f"{rec['device_busy_share']:.4f}", flush=True)
    for k in rec["kernels"][:12]:
        print(f"  {k['ms']:9.3f} ms x{k['count']:<5d} {k['name'][:110]}", flush=True)

    # -- one frame step, layer by layer
    with torch.inference_mode():
        prev_lr, cur_lr = clip[:, 0], clip[:, 1]
        carry = fused_first_frame_s2d(model, prev_lr)
        feedback = warp_s2d_feedback(carry, prev_lr)
        net = fused_first_layer(model, cur_lr, feedback)
        feat = model.tail_features(net)
        w_out = conv_out_params(model)
        stack = torch.stack([carry] * FRAMES, dim=1)
        layers = {
            "warp": lambda: warp_s2d_feedback(carry, prev_lr),
            "first_layer": lambda: fused_first_layer(model, cur_lr, feedback),
            "trunk": lambda: model.tail_features(net),
            "conv_out_s2d": lambda: conv_out_s2d(feat, *w_out),
            "step": lambda: fused_sr_step_s2d(model, carry, prev_lr, cur_lr),
            "clip_assembly": lambda: s2d_to_frame(stack).to(
                torch.float32, memory_format=torch.contiguous_format),
        }
        rec["layer_ms"] = {k: events_ms(fn, REPS) for k, fn in layers.items()}
    print("layers (ms, CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["layer_ms"].items()) + f" | {smi}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
