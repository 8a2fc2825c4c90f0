"""Batched multi-stream serving benchmark (the JAX repo's
``tools/bench_serving.py``): aggregate fps of B concurrent 270p -> 1080p
recurrent streams on one GPU.

    python -m tecogan_tpu_torch.tools.bench_serving [B ...]   (default: 1 2 4)

``bench.py``'s model, route and timing (``tecogan_tpu_torch/tools/bench.py``)
on a (B, Tb, 270, 480, 3) clip, ``Tb = max(8, T // B)`` (the live f32
output stays bounded: fewer frames at higher B), the clips drawn in turn
from one ``np.random.default_rng(0)``.  ``BENCH_FRAMES`` (T, 32) and
``BENCH_REPS`` (3) as the JAX tool reads them.  The hand kernels serve
the B streams in one launch a frame: one ``conv_out_s2d`` a frame and one
``warp_s2d`` a frame after the first, whatever B.

Prints one JSON line per batch size, numbers unrounded: ``metric``
``"serving_aggregate_fps"``, ``batch``, ``frames``, ``value`` (B Tb frames
a second), ``unit`` ``"fps/gpu"``, ``per_stream_ms_per_frame`` and
``card`` (as ``bench.py``).  Without a GPU it raises.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import TecoConfig
from ..engine.inference import build_clip_inference
from ..engine.state import resolve_device
from .bench import (FRAMES, H, REPS, SEED, UNIT, W, check_shape, bench_config,
                    device_name, lr_clip, serving_model, timed)

BATCHES = (1, 2, 4)


def stream_frames(frames: int, batch: int) -> int:
    """Frames a stream at ``batch`` streams (the JAX tool's ``Tb``)."""
    return max(8, frames // batch)


def run(cfg: TecoConfig, device=None, batches=BATCHES, h: int = H, w: int = W,
        frames: int = FRAMES, reps: int = REPS) -> Iterator[dict]:
    """One record a batch size, as each is measured, on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    model, _ = serving_model(cfg, dev)
    infer = build_clip_inference(cfg)
    rng = np.random.default_rng(SEED)
    name = device_name(dev)
    for b in batches:
        tb = stream_frames(frames, b)
        clip = lr_clip(rng, (b, tb, h, w, 3), dev)
        out, dt = timed(lambda: infer(model, clip), reps, dev)
        check_shape(out, b, tb, h, w)
        del out, clip
        yield {"metric": "serving_aggregate_fps", "batch": b, "frames": tb,
               "value": b * tb / dt, "unit": UNIT,
               "per_stream_ms_per_frame": dt / tb * 1e3, "card": name}


def streams_alone(cfg: TecoConfig, model, clip: torch.Tensor) -> dict:
    """Each stream of ``clip`` (B, T, H, W, 3) served in the batch against
    the same stream served alone: whether every stream is bit-equal, the
    largest absolute difference and the lowest PSNR (dB, of the whole
    stream; inf where equal)."""
    infer = build_clip_inference(cfg)
    batched = infer(model, clip)
    equal, max_abs, min_db = True, 0.0, math.inf
    for b in range(clip.shape[0]):
        alone = infer(model, clip[b:b + 1])
        diff = (batched[b:b + 1] - alone).double()
        equal = equal and bool(torch.equal(batched[b:b + 1], alone))
        max_abs = max(max_abs, float(diff.abs().max()))
        mse = float(diff.square().mean())
        min_db = min(min_db, math.inf if mse == 0.0 else 10 * math.log10(1.0 / mse))
    return {"bit_equal": equal, "max_abs": max_abs, "min_psnr_db": min_db}


def main(argv: Optional[list] = None) -> list:
    args = sys.argv[1:] if argv is None else argv
    records = []
    for rec in run(bench_config(), batches=[int(a) for a in args] or list(BATCHES),
                   frames=int(os.environ.get("BENCH_FRAMES", str(FRAMES))),
                   reps=int(os.environ.get("BENCH_REPS", str(REPS)))):
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
