"""The headline benchmark (the JAX repo's ``bench.py``): recurrent 4x VSR
inference throughput, 270p -> 1080p, on one GPU.

    python -m tecogan_tpu_torch.tools.bench

The measured program is the full recurrent pipeline a frame -- the
``warp_s2d`` kernel (pseudo-flow, warp of the previous 1080p SR frame,
space-to-depth feedback), the first layer, the trunk and the
``conv_out_s2d`` kernel -- through ``engine.inference.build_clip_inference``
on the fused bf16 route (16 resblocks, ``bug_parity`` off), random weights
from seed 0 (``engine.state.init_generator``; speed does not depend on the
draw) on a (1, T, 270, 480, 3) clip from ``np.random.default_rng(0)``.
Then the int8 (W8A8) serving route: ``build_quantized_clip_inference``'s
``prepare`` on the clip's first 8 frames and its clip, the int8 kernels in
the tail.  An int8 failure fails the run.

Each clip runs once at the timed shape to warm up, then ``reps`` times;
the time is the host clock around them, ending in
``torch.cuda.synchronize()``.  The environment sets what the JAX bench's
does: ``BENCH_FRAMES`` (T, 32), ``BENCH_REPS`` (3) and ``BENCH_INT8``
(``0`` skips the int8 route).

Prints one JSON line, numbers unrounded: ``metric``, ``value`` (fps),
``unit`` ``"fps/gpu"``, ``gen_tflop_per_frame``, ``achieved_tflops`` and
``mfu`` (``utils.flops.inference_mfu`` against the H100's 989 TFLOP/s
bf16 dense peak), ``fps_int8_serving``, ``int8_speedup`` and ``card``
(``nvidia-smi``'s name and power limit; ``"cpu"`` for a CPU run, whose
times are the CPU's).  Without a GPU it raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import TecoConfig
from ..engine.inference import build_clip_inference, build_quantized_clip_inference
from ..engine.state import init_generator, model_defs, resolve_device
from ..utils.convert import generator_state_dict_from_jax
from ..utils.flops import inference_mfu
from ..utils.timing import card

H, W = 270, 480
FRAMES, REPS, SEED = 32, 3, 0
CALIB_FRAMES = 8
METRIC = "recurrent_4x_vsr_inference_270p_to_1080p"
UNIT = "fps/gpu"


def bench_config() -> TecoConfig:
    """The benchmark's configuration (the JAX bench's)."""
    return TecoConfig(precision="bf16", num_resblock=16, bug_parity=False)


def device_name(dev: torch.device) -> str:
    """The card's name and power limit, or ``"cpu"``."""
    return card() if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serving_model(cfg: TecoConfig, dev: torch.device, params=None):
    """``(model, params)``: the serving generator on ``dev`` holding
    ``params`` (a flax tree), by default the seed-0 draw."""
    if params is None:
        params = init_generator(cfg, torch.Generator().manual_seed(SEED))
    model = model_defs(cfg, device=dev)
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval(), params


def lr_clip(rng: np.random.Generator, shape, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(rng.random(shape, np.float32)).to(dev)


def timed(fn, reps: int, dev: torch.device):
    """``(out, seconds a call)``: ``fn()`` once to warm up, then ``reps``
    calls on the host clock, ending in a synchronise."""
    out = fn()
    sync(dev)
    del out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) / reps


def check_shape(out: torch.Tensor, b: int, t: int, h: int, w: int) -> None:
    if tuple(out.shape) != (b, t, 4 * h, 4 * w, 3):
        raise RuntimeError(f"output shape {tuple(out.shape)}, expected {(b, t, 4 * h, 4 * w, 3)}")


def run(cfg: TecoConfig, device=None, h: int = H, w: int = W, frames: int = FRAMES,
        reps: int = REPS, int8: bool = True) -> dict:
    """The record of one benchmark run of ``cfg`` on ``device`` (default:
    the card) at LR ``h`` x ``w``, ``frames`` frames."""
    dev = resolve_device(device)
    model, params = serving_model(cfg, dev)
    clip = lr_clip(np.random.default_rng(SEED), (1, frames, h, w, 3), dev)
    infer = build_clip_inference(cfg)
    out, dt = timed(lambda: infer(model, clip), reps, dev)
    check_shape(out, 1, frames, h, w)
    del out
    fps = frames / dt
    acc = inference_mfu(fps, h, w, cfg.num_resblock)
    record = {"metric": METRIC, "value": fps, "unit": UNIT,
              "gen_tflop_per_frame": acc["gen_tflop_per_frame"],
              "achieved_tflops": acc["achieved_tflops"], "mfu": acc["mfu"]}
    if int8:
        prepare, infer_q = build_quantized_clip_inference(cfg)
        qtail = prepare(model, params, clip, frames=CALIB_FRAMES)
        out, dt_q = timed(lambda: infer_q(model, qtail, clip), reps, dev)
        check_shape(out, 1, frames, h, w)
        del out
        record["fps_int8_serving"] = frames / dt_q
        record["int8_speedup"] = dt / dt_q
    record["card"] = device_name(dev)
    return record


def main(argv: Optional[list] = None) -> dict:
    del argv  # the JAX bench takes no arguments
    record = run(bench_config(),
                 frames=int(os.environ.get("BENCH_FRAMES", str(FRAMES))),
                 reps=int(os.environ.get("BENCH_REPS", str(REPS))),
                 int8=os.environ.get("BENCH_INT8", "1") != "0")
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
