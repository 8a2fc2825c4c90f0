"""How far the discriminator's float32 gradients on the GPU lie from a
float64 run, by input distribution, batch and layout.

    python -m tecogan_tpu_torch.tools.grad_precision [--out grad_precision.json]

The gradient of ``discriminator_loss`` with respect to every D param at
the tiny config (D 1 x 16, 27 x 32 x 32 inputs), TF32 off, for real and
fake inputs drawn N(0, 1) or U(0, 1) at batch 2 and 6, with the params
channels_last (as the train step holds them on the card) and NCHW, each
with and without ``cudnn.deterministic``; the CPU's float32 run beside
them.  Each line gives the leaves farthest off the float64 run, as the
largest difference over the leaf's largest element, and the cuDNN
weight-grad kernels of one channels_last backward at the first setting.

Fails without a GPU; prints one line a setting and writes them all as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import TecoConfig
from ..engine.losses import discriminator_loss
from ..engine.state import init_discriminator, init_generator, train_model_defs
from ..utils.convert import discriminator_state_dict_from_jax
from ..utils.timing import card

CFG = TecoConfig(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                 discrim_channels=16, batch_size=2, precision="fp32")
SEED = 3


def grads(params, stats, dev, dtype, fmt, batch: int, dist: str) -> dict:
    rng = np.random.default_rng(SEED)
    draw = ((lambda: rng.standard_normal((batch, 27, 32, 32)).astype(np.float32))
            if dist == "normal" else (lambda: rng.random((batch, 27, 32, 32), np.float32)))
    real, fake = draw(), draw()
    disc = train_model_defs(CFG, device=dev)[1]
    pd, sd = discriminator_state_dict_from_jax(params, stats)
    pd = {k: v.to(dev, dtype, memory_format=fmt if v.dim() == 4 else torch.preserve_format)
          .requires_grad_() for k, v in pd.items()}
    sd = {k: v.to(dev, dtype) for k, v in sd.items()}
    loss, _ = discriminator_loss(disc, pd, sd, torch.from_numpy(real).to(dev, dtype),
                                 torch.from_numpy(fake).to(dev, dtype), CFG)
    return {k: g.double().cpu() for k, g in zip(pd, torch.autograd.grad(loss, list(pd.values())))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_precision needs a CUDA GPU; none is visible")
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    smi = card()
    # the draw of the cuda tests' discriminator: the generator's first
    gen = torch.Generator().manual_seed(1)
    init_generator(CFG, gen)
    params, stats = init_discriminator(CFG, gen)
    rec = {"card": smi, "torch": torch.__version__, "cudnn": torch.backends.cudnn.version(),
           "runs": []}
    settings = (("cpu nchw", cpu, torch.contiguous_format, False),
                ("card channels_last", cuda, torch.channels_last, False),
                ("card nchw", cuda, torch.contiguous_format, False),
                ("card channels_last deterministic", cuda, torch.channels_last, True),
                ("card nchw deterministic", cuda, torch.contiguous_format, True))
    for dist in ("normal", "uniform"):
        for batch in (2, 6):
            ref = grads(params, stats, cpu, torch.float64, torch.contiguous_format, batch, dist)
            for name, dev, fmt, det in settings:
                torch.backends.cudnn.deterministic = det
                got = grads(params, stats, dev, torch.float32, fmt, batch, dist)
                torch.backends.cudnn.deterministic = False
                errs = sorted(((float((got[k] - ref[k]).abs().max() / ref[k].abs().max()), k)
                               for k in ref), reverse=True)
                rec["runs"].append({"inputs": dist, "batch": batch, "setting": name,
                                    "worst": [{"leaf": k, "rel": e} for e, k in errs[:5]]})
                print(f"{dist} batch {batch} {name}: "
                      + " ".join(f"{k} {e:.3e}" for e, k in errs[:3]) + f" | {smi}", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grads(params, stats, cuda, torch.float32, torch.channels_last, 2, "normal")
        torch.cuda.synchronize()
    rec["wgrad_kernels"] = sorted({e.key[:160] for e in prof.key_averages()
                                   if "wgrad" in e.key.lower()})
    for name in rec["wgrad_kernels"]:
        print(f"  weight-grad kernel: {name}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
