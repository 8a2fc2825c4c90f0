"""Where the time of the port's train step goes, on one GPU.

    python -m tecogan_tpu_torch.tools.profile_train [--out profile_train.json]

At the default config (B=4, RNN_N=10, crop 32, 16 resblocks, D 4 x 128,
bf16; random flax-layout weights from seed 0, batches from
``synthetic_scene_batch``), for ``bug_parity`` on and off, it measures:

* the step time over 10 steps after 3 warm-up steps (host clock around
  a step ending in ``torch.cuda.synchronize()``, tracing off): median,
  min and max, and samples/s, TFLOP/s and MFU from ``train_step_macs``;
* 3 steps under ``torch.profiler``: the summed kernel time a step
  (device-side events only) and its share of the untraced median step
  (busy share; as ``profile_clip``) and of the traced steps, which the
  tracer slows on the host;
  kernel time by kind (cuDNN conv forward, data grad and weight grad,
  elementwise, reductions, ``grid_sample``, copies, the Adam
  ``multi_tensor_apply`` kernels, ...) and by name; and the train step's
  phases (the ``teco.*`` spans of ``engine/train.py``: the generator
  objective, its backward, the D step, Adam), each with its host time
  and the device time of the kernels launched inside it.  Backward
  kernels are launched from autograd's own thread, outside the spans, so
  ``gen_backward`` shows host time only and ``disc_step`` its forward's
  kernels;
* the host time that ``torch.func.functional_call`` adds to one call of
  each model (the train step rebinds the state's params on every
  generator frame and every discriminator pass): ``functional_call`` on
  a copy of the model whose forward returns its input, less a plain call
  of that copy, so that no kernel runs; beside it, the host time of one
  real forward at a batch of one, where the host sets the time.

Fails without a GPU; prints one line a measurement and writes them all as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from ..config import TecoConfig
from ..data.synthetic import synthetic_scene_batch
from ..engine.losses import d_input_spec
from ..engine.state import init_state, train_model_defs
from ..engine.train import build_train_step
from ..utils.flops import train_mfu
from ..utils.timing import card

WARMUP, STEPS, TRACED, SEED = 3, 10, 3, 0
REBIND_CALLS, REBIND_ROUNDS = 100, 5
SPANS = ("teco.gen_objective", "teco.gen_backward", "teco.disc_step", "teco.adam")
# (kind, substrings of the kernel name), first match wins
KINDS = (
    ("conv weight grad (cuDNN)", ("wgrad",)),
    ("conv data grad / transposed conv (cuDNN)", ("dgrad",)),
    ("conv forward (cuDNN)", ("fprop", "conv")),
    ("matmul", ("gemm",)),
    ("grid_sample", ("grid_sampler",)),
    ("bilinear upsample", ("upsample",)),
    ("Adam (multi_tensor_apply)", ("multi_tensor_apply",)),
    ("reductions (BN statistics, sums, means)", ("reduce_kernel", "reduce")),
    ("copies, casts, layout", ("copy", "cat", "nchwToNhwc", "nhwcToNchw",
                               "nhwcAddPadding", "transpose")),
    ("elementwise (bias, activations, losses, BN apply)", ("elementwise", "Functor")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def _host_us(fn) -> float:
    """Median over rounds of the wall time of one call, ``REBIND_CALLS``
    calls back to back ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(REBIND_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(REBIND_CALLS):
            fn()
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / REBIND_CALLS * 1e6)
    return statistics.median(rounds)


def rebind_cost(cfg: TecoConfig, state, dev: torch.device) -> dict:
    """Host microseconds that ``functional_call``'s rebinding of the params
    adds to a call, for each model, and what that makes a step: one
    generator call a frame, four discriminator passes."""
    from torch.func import functional_call

    d_ch, d_hw = d_input_spec(cfg)
    x_g = torch.rand((1, 8, 8, 51), device=dev)
    x_d = torch.rand((1, d_hw, d_hw, d_ch), device=dev)
    rec = {}
    with torch.no_grad():
        for i, (name, params, x) in enumerate((("generator", state.params_g, x_g),
                                              ("discriminator", state.params_d, x_d))):
            model = train_model_defs(cfg, device=dev)[i]
            forward_us = _host_us(lambda: functional_call(model, params, (x,)))
            model.forward = lambda inp: inp  # the same params, no kernels
            rebound = _host_us(lambda: functional_call(model, params, (x,)))
            plain = _host_us(lambda: model(x))
            rec[name] = {"params": len(params), "forward_us": forward_us,
                         "rebind_us": rebound - plain}
    frames = cfg.RNN_N * (2 if cfg.pingpang else 1) - (1 if cfg.pingpang else 0)
    rec["rebind_ms_per_step"] = (frames * rec["generator"]["rebind_us"]
                                 + 4 * rec["discriminator"]["rebind_us"]) / 1e3
    return rec


def profile(cfg: TecoConfig, dev: torch.device, smi: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    state = init_state(cfg, torch.Generator().manual_seed(SEED), device=dev)
    batches = []
    for i in range(4):
        lr, hr = synthetic_scene_batch(cfg.batch_size, cfg.RNN_N, cfg.crop_size,
                                       seed=i * cfg.batch_size)
        batches.append((torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)))
    step = build_train_step(cfg, device=dev)

    secs = []
    for i in range(WARMUP + STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, _ = step(state, *batches[i % len(batches)])
        torch.cuda.synchronize()
        if i >= WARMUP:
            secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    mfu = train_mfu(med * 1e3, cfg.batch_size, cfg.RNN_N, cfg.crop_size,
                    cfg.num_resblock, cfg.discrim_resblocks, cfg.discrim_channels,
                    cfg.pingpang, cfg.bug_parity)
    rec = {"bug_parity": cfg.bug_parity,
           "step_ms": {"median": med * 1e3, "min": min(secs) * 1e3,
                       "max": max(secs) * 1e3, "n": len(secs)},
           "samples_per_s": cfg.batch_size / med, **mfu}
    print(f"bug_parity={cfg.bug_parity}: step {rec['step_ms']} ms, "
          f"{rec['samples_per_s']:.2f} samples/s, {mfu['achieved_tflops']:.3f} "
          f"TFLOP/s, MFU {mfu['mfu']:.4%} | {smi}", flush=True)

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TRACED):
            state, _, _ = step(state, *batches[i % len(batches)])
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side events only: the aten ops on the CPU side report the same
    # kernel time again as their own
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(k[1] for k in kernels)
    by_kind: dict = {}
    for name, us, count in kernels:
        k = by_kind.setdefault(kind_of(name), {"ms": 0.0, "launches": 0})
        k["ms"] += us / 1e3 / TRACED
        k["launches"] += count // TRACED
    # a span's device time: the kernels launched inside it, children included
    spans = {e.key: {"host_ms": e.cpu_time_total / 1e3 / TRACED,
                     "device_ms": e.device_time_total / 1e3 / TRACED}
             for e in events if e.key in SPANS}
    rec.update({
        "traced_step_ms": traced * 1e3 / TRACED,
        "device_busy_ms_per_step": busy_us / 1e3 / TRACED,
        "device_busy_share": busy_us / 1e3 / TRACED / (med * 1e3),
        "traced_busy_share": busy_us / 1e6 / traced,
        "launches_per_step": sum(k[2] for k in kernels) // TRACED,
        "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]["ms"])),
        "spans": spans,
        "kernels": [{"name": n, "ms_per_step": us / 1e3 / TRACED, "count": c // TRACED}
                    for n, us, c in sorted(kernels, key=lambda k: -k[1])[:30]],
    })
    print(f"  traced step {rec['traced_step_ms']:.3f} ms, kernels "
          f"{rec['device_busy_ms_per_step']:.3f} ms a step ({rec['launches_per_step']} "
          f"launches), busy share {rec['device_busy_share']:.4f} of the untraced "
          f"median step, {rec['traced_busy_share']:.4f} of the traced", flush=True)
    for kind, v in rec["by_kind"].items():
        print(f"  {v['ms']:9.3f} ms x{v['launches']:<6d} {kind}", flush=True)
    for name, v in spans.items():
        print(f"  span {name}: host {v['host_ms']} ms, device {v['device_ms']} ms",
              flush=True)
    for k in rec["kernels"][:12]:
        print(f"  {k['ms_per_step']:9.3f} ms x{k['count']:<5d} {k['name'][:100]}", flush=True)
    rec["rebind"] = rebind_cost(cfg, state, dev)
    for name in ("generator", "discriminator"):
        r = rec["rebind"][name]
        print(f"  functional_call on the {name} ({r['params']} params): rebinding "
              f"{r['rebind_us']:.1f} us a call; a forward at batch 1 "
              f"{r['forward_us']:.1f} us", flush=True)
    print(f"  rebinding a step: {rec['rebind']['rebind_ms_per_step']:.3f} ms", flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA GPU; none is visible")
    dev = torch.device("cuda", 0)
    smi = card()
    rec = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "seed": SEED, "warmup": WARMUP, "steps": STEPS, "traced": TRACED,
           "runs": [profile(TecoConfig(precision="bf16", bug_parity=bp), dev, smi)
                    for bp in (True, False)]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
