"""A/B of the int8 (W8A8) tail against the bf16 fused route (the JAX
repo's ``tools/bench_quant.py``) on the 270p -> 1080p recurrent inference
benchmark, with the quantization's quality cost: the int8 output's PSNR
against the bf16 output.

    python -m tecogan_tpu_torch.tools.bench_quant [--g_checkpoint ckpt]
        [--frames 32] [--height 270] [--width 480] [--reps 3]

``bench.py``'s model, clip and timing (``tecogan_tpu_torch/tools/bench.py``).
``--g_checkpoint`` reads a generator ``.ckpt`` of the JAX package's
format (``utils.checkpoint.load_generator_params``); without it the
weights are the seed-0 draw.  ``prepare`` calibrates on the clip's first
8 frames.  The PSNR is of the whole clip, the mean square in float64.

Prints one JSON line, numbers unrounded: ``metric``, ``fps_bf16``,
``fps_int8``, ``speedup``, ``int8_vs_bf16_psnr_db``, ``checkpoint`` (the
path, or ``"random-init"``) and ``card`` (as ``bench.py``).  Without a
GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Optional

import numpy as np

from ..config import TecoConfig
from ..engine.inference import build_clip_inference, build_quantized_clip_inference
from ..engine.state import resolve_device
from ..utils.checkpoint import load_generator_params
from .bench import (CALIB_FRAMES, FRAMES, H, REPS, SEED, W, bench_config, device_name,
                    lr_clip, serving_model, timed)

MSE_FLOOR = 1e-12


def run(cfg: TecoConfig, device=None, g_checkpoint: Optional[str] = None, h: int = H,
        w: int = W, frames: int = FRAMES, reps: int = REPS) -> dict:
    """The record of one A/B run on ``device`` (default: the card)."""
    dev = resolve_device(device)
    params = load_generator_params(g_checkpoint) if g_checkpoint else None
    model, params = serving_model(cfg, dev, params)
    clip = lr_clip(np.random.default_rng(SEED), (1, frames, h, w, 3), dev)
    infer = build_clip_inference(cfg)
    sr_bf16, dt = timed(lambda: infer(model, clip), reps, dev)
    prepare, infer_q = build_quantized_clip_inference(cfg)
    qtail = prepare(model, params, clip, frames=CALIB_FRAMES)
    sr_q, dt_q = timed(lambda: infer_q(model, qtail, clip), reps, dev)
    mse = float((sr_q.double() - sr_bf16.double()).square().mean())
    return {"metric": "int8_vs_bf16_270p_to_1080p",
            "fps_bf16": frames / dt, "fps_int8": frames / dt_q, "speedup": dt / dt_q,
            "int8_vs_bf16_psnr_db": 10 * math.log10(1.0 / max(mse, MSE_FLOOR)),
            "checkpoint": g_checkpoint or "random-init", "card": device_name(dev)}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--g_checkpoint", default=None)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    record = run(bench_config(), g_checkpoint=args.g_checkpoint, h=args.height,
                 w=args.width, frames=args.frames, reps=args.reps)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
