"""Batch scaling of the convergence run's train step (the JAX repo's
``tools/bench_train_scaling.py``) on one GPU.

    python -m tecogan_tpu_torch.tools.bench_train_scaling [--crop 32]
        [--batches 4 8 16 32] [--reps 5]

The step of the convergence config: fixed semantics (``bug_parity``
off), bf16, ping-pong, the VGG-19 perceptual loss at ``vgg_scaling`` 0.2
with the surrogate weights (``models.vgg.load_vgg_params("surrogate")``,
the JAX package's bit for bit), RNN_N 10, 16 resblocks, D 4 x 128; at
each batch size a fresh seed-0 state (``engine.state.init_state``) and
step, one batch drawn in turn from one ``np.random.default_rng(0)``, a
step to warm up, then ``--reps`` steps on the host clock, ending in a
synchronise.  A batch that runs out of device memory
(``torch.cuda.OutOfMemoryError``) prints an ``error`` line and the run
goes on; any other exception propagates.

Prints one JSON line per batch size, numbers unrounded: ``metric``
``"train_step_convergence_cfg"``, ``batch``, ``crop``, ``ms_per_step``,
``samples_per_sec``, ``train_tflop_per_step`` and ``train_mfu``
(``utils.flops.train_mfu`` against the H100's 989 TFLOP/s bf16 dense
peak; the VGG loss not counted, as in the JAX tool),
``max_memory_allocated_gib`` (the batch's peak, None on the CPU) and
``card`` (as ``bench.py``).  Without a GPU it raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import TecoConfig
from ..engine.state import resolve_device
from ..engine.train import build_train_step
from ..models.vgg import load_vgg_params, make_vgg_apply, vgg_model
from ..utils.flops import train_mfu
from .bench import SEED, device_name
from .bench_train import REPS, timed_steps, train_batch

CROP = 32
BATCHES = (4, 8, 16, 32)


def scaling_config(crop: int = CROP) -> TecoConfig:
    """The convergence step's configuration (the JAX tool's); the run sets
    ``batch_size``."""
    return TecoConfig(crop_size=crop, RNN_N=10, num_resblock=16, precision="bf16",
                      bug_parity=False, pingpang=True, vgg_scaling=0.2,
                      vgg_ckpt="surrogate")


def _seconds_a_step(cfg: TecoConfig, vgg_apply, rng, dev, reps: int) -> float:
    lr, hr = train_batch(cfg, rng, dev)
    step = build_train_step(cfg, vgg_apply=vgg_apply, device=dev)
    return timed_steps(cfg, step, dev, lr, hr, reps)


def run(cfg: TecoConfig, device=None, batches=BATCHES, reps: int = REPS) -> Iterator[dict]:
    """One record a batch size, as each is measured, on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    vgg_apply = make_vgg_apply(vgg_model(load_vgg_params(cfg.vgg_ckpt), device=dev))
    rng = np.random.default_rng(SEED)
    name = device_name(dev)
    on_card = dev.type == "cuda"
    for b in batches:
        bcfg = cfg.replace(batch_size=b)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            dt = _seconds_a_step(bcfg, vgg_apply, rng, dev, reps)
            error = None
        except torch.cuda.OutOfMemoryError as e:
            error = repr(e)[:200]
        if error is not None:  # the failed batch's tensors died with its frames
            if on_card:
                torch.cuda.empty_cache()
            yield {"batch": b, "crop": cfg.crop_size, "error": error, "card": name}
            continue
        acc = train_mfu(1e3 * dt, b, cfg.RNN_N, cfg.crop_size, cfg.num_resblock,
                        cfg.discrim_resblocks, cfg.discrim_channels,
                        pingpang=cfg.pingpang, bug_parity=cfg.bug_parity)
        yield {"metric": "train_step_convergence_cfg", "batch": b, "crop": cfg.crop_size,
               "ms_per_step": dt * 1e3, "samples_per_sec": b / dt,
               "train_tflop_per_step": acc["train_tflop_per_step"],
               "train_mfu": acc["mfu"],
               "max_memory_allocated_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                                            if on_card else None),
               "card": name}


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", type=int, default=CROP)
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    records = []
    for rec in run(scaling_config(args.crop), batches=args.batches, reps=args.reps):
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
