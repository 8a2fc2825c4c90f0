"""Training-throughput benchmark (the JAX repo's ``tools/bench_train.py``):
the reference's config, batch 4, crop 32, RNN_N 10, 16 resblocks, D
4 x 128, on one GPU.

    python -m tecogan_tpu_torch.tools.bench_train

Three modes through ``engine.state.init_state`` (seed 0) and
``engine.train.build_train_step``: ``train_parity`` (the reference-exact
step, ``bug_parity`` on, fp32), ``train_fixed_bptt`` (the fixed-semantics
full-BPTT step, fp32) and ``train_fixed_bptt_bf16``.  The fp32 modes run
with TF32 off (cuDNN and matmuls, ``ops.precision.full_f32``), as the
port's fp32 checks do: fp32
means float32 arithmetic.  One batch from ``np.random.default_rng(0)`` on
the device; a step to warm up, then ``BENCH_TRAIN_REPS`` (5) steps on the
host clock, ending in a synchronise.

Prints one JSON line per mode, numbers unrounded: ``metric`` (the mode),
``value`` (ms a step), ``unit`` ``"ms/step"``, ``steps_per_s``,
``train_tflop_per_step``, ``achieved_tflops`` and ``mfu``
(``utils.flops.train_mfu`` against the H100's 989 TFLOP/s bf16 dense
peak, for every mode) and ``card`` (as ``bench.py``).  Without a GPU it
raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import TecoConfig
from ..engine.state import init_state, resolve_device
from ..engine.train import build_train_step
from ..ops.precision import full_f32
from ..utils.flops import train_mfu
from .bench import SEED, device_name, sync

REPS = 5
MODES = (("train_parity", dict(bug_parity=True, precision="fp32")),
         ("train_fixed_bptt", dict(bug_parity=False, precision="fp32")),
         ("train_fixed_bptt_bf16", dict(bug_parity=False, precision="bf16")))


def train_config() -> TecoConfig:
    """The benchmark's configuration (the JAX tool's); the modes set
    ``bug_parity`` and ``precision``."""
    return TecoConfig(crop_size=32, RNN_N=10, num_resblock=16, batch_size=4)


def train_batch(cfg: TecoConfig, rng: np.random.Generator, dev: torch.device):
    """(lr, hr): (B, RNN_N, 3, crop, crop) and 4x, float32 in [0, 1)."""
    b, t, c = cfg.batch_size, cfg.RNN_N, cfg.crop_size
    lr = torch.from_numpy(rng.random((b, t, 3, c, c), np.float32)).to(dev)
    hr = torch.from_numpy(rng.random((b, t, 3, 4 * c, 4 * c), np.float32)).to(dev)
    return lr, hr


def timed_steps(cfg: TecoConfig, step, dev: torch.device, lr, hr, reps: int) -> float:
    """Seconds a step of ``step`` from a fresh seed-0 state: one step to
    warm up, then ``reps`` on the host clock."""
    state = init_state(cfg, torch.Generator().manual_seed(SEED), device=dev)
    state, _, _ = step(state, lr, hr)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        state, _, _ = step(state, lr, hr)
    sync(dev)
    return (time.perf_counter() - t0) / reps


def run(cfg: TecoConfig, device=None, reps: int = REPS) -> Iterator[dict]:
    """One record a mode, as each is measured, on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    lr, hr = train_batch(cfg, np.random.default_rng(SEED), dev)
    name = device_name(dev)
    for mode, kw in MODES:
        mcfg = cfg.replace(**kw)
        with full_f32() if mcfg.precision == "fp32" else contextlib.nullcontext():
            dt = timed_steps(mcfg, build_train_step(mcfg, device=dev), dev, lr, hr, reps)
        acc = train_mfu(1e3 * dt, mcfg.batch_size, mcfg.RNN_N, mcfg.crop_size,
                        mcfg.num_resblock, mcfg.discrim_resblocks, mcfg.discrim_channels,
                        pingpang=mcfg.pingpang, bug_parity=mcfg.bug_parity)
        yield {"metric": mode, "value": 1e3 * dt, "unit": "ms/step", "steps_per_s": 1.0 / dt,
               "train_tflop_per_step": acc["train_tflop_per_step"],
               "achieved_tflops": acc["achieved_tflops"], "mfu": acc["mfu"], "card": name}


def main(argv: Optional[list] = None) -> list:
    del argv  # the JAX tool takes no arguments
    records = []
    for rec in run(train_config(), reps=int(os.environ.get("BENCH_TRAIN_REPS", str(REPS)))):
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
