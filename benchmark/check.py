"""The check of ``correct``: what the window served against the plain
reference of the configuration's architecture
(``benchmark/architectures/<name>/``, through ``hooks``, ``run_clip``,
``frame`` and ``carry_to_frame``), run once the window has closed and the
program's weights are freed.  Every number is a gap in uint8 levels
of the served 1080p frames, so lower is better, and each has a limit of
its own (``benchmark/limits/<cell>.json``, with the readings it was set
from).

* Archive traffic: the last clip that completed inside the window.  The
  reference runs the clip's whole recurrence from its frame 0, free, from
  the benchmark's own inputs and weights alone, and is compared on every
  frame of three of its windows of 16: the two around a window seam drawn
  from the seed and the clip's last.  ``frame_mae_worst``: the largest
  mean |gap| of a frame; ``far8_pct_worst``: the largest share (%) of a
  frame's values off by more than 8 levels.
* Live traffic: a free reference over every stream would take several
  times the window, so it follows the program step by step from the
  program's own carry: frames drawn from the seed in the last third of
  the window, each computed by the reference from the carry the program
  held before it (``step_mae_worst``, ``step_far8_pct_worst``).  The two
  stages that this skips are checked by themselves: the start, each
  stream's first frames (served before the window opens) against the
  reference's free recurrence from frame 0 (``start_mae_worst``), and
  the handoff: the carry each checked step leaves is the frame it served
  (``handoff_mae_worst``, the mean |gap| between the two; the served
  frame is the carry converted, so this is exact).

``numbers(..., control=True)`` puts the architecture's control (its
``hooks(..., control=True)``) in the program's place and reads the same
numbers of its frames.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.frames import dequant, exact_float32, to_u8

FAR = 8


def gap(served: torch.Tensor, want: torch.Tensor):
    """(mean |gap|, % of values off by more than FAR levels)."""
    d = (served.to(torch.int16) - want.to(torch.int16)).abs()
    return float(d.float().mean()), float((d > FAR).float().mean()) * 100.0


@torch.no_grad()
def numbers(arch, mode: str, cfg: dict, tr: dict, params, calib, data, run, warm, device,
            control: bool = False) -> Dict[str, float]:
    exact_float32()
    hooks = arch.hooks(cfg, params, calib, False)
    if control:
        c_hooks = arch.hooks(cfg, params, calib, True)
    out: Dict[str, float] = {}
    if mode == "archive":
        out = {"frame_mae_worst": 0.0, "far8_pct_worst": 0.0}
        clip = run["check_clip"]
        if not clip or not clip["windows"]:
            return {k: math.inf for k in out}
        chunk = tr["chunk"]
        lr = data["pool"][clip["index"] % len(data["pool"])][None].to(device)
        keep = {w * chunk + i for w, host in clip["windows"].items()
                for i in range(host.shape[1])}
        want = arch.run_clip(params, cfg, lr, hooks, keep=keep)
        if control:
            served = arch.run_clip(params, cfg, lr, c_hooks, keep=keep)
        else:
            served = ((t, clip["windows"][t // chunk][:, t % chunk].to(device))
                      for t in sorted(keep))
        for (t, w_u8), (t2, s_u8) in zip(want, served):
            if t != t2:
                raise RuntimeError(f"reference frame {t} against served frame {t2}")
            mae, far = gap(s_u8, w_u8)
            out["frame_mae_worst"] = max(out["frame_mae_worst"], mae)
            out["far8_pct_worst"] = max(out["far8_pct_worst"], far)
        return out

    out = {"start_mae_worst": 0.0, "step_mae_worst": 0.0, "step_far8_pct_worst": 0.0,
           "handoff_mae_worst": 0.0}
    streams = data["streams"]
    for k, s in enumerate(streams):
        first = s["frames"][None, :tr["warm_frames"]].to(device)
        want = arch.run_clip(params, cfg, first, hooks)
        if control:
            served = arch.run_clip(params, cfg, first, c_hooks)
        else:
            served = enumerate(x.to(device) for x in warm[k]["served"])
        for (_, w_u8), (_, s_u8) in zip(want, served):
            out["start_mae_worst"] = max(out["start_mae_worst"], gap(s_u8, w_u8)[0])
    if len(run["kept"]) < sum(len(s["check"]) for s in streams):
        out["step_mae_worst"] = math.inf
    for (k, j), rec in sorted(run["kept"].items()):
        frames = streams[k]["frames"]
        lr = dequant(frames[j][None].to(device))
        prev_lr = dequant(frames[j - 1][None].to(device))
        carry = arch.carry_to_frame(rec["before"])
        want = to_u8(arch.frame(params, cfg, lr, carry, prev_lr, hooks))
        if control:
            served = to_u8(arch.frame(params, cfg, lr, carry, prev_lr, c_hooks))
            handoff = 0.0
        else:
            served = rec["served"].to(device)
            left = to_u8(arch.carry_to_frame(rec["after"]))
            handoff = gap(left, served)[0]
        mae, far = gap(served, want)
        out["step_mae_worst"] = max(out["step_mae_worst"], mae)
        out["step_far8_pct_worst"] = max(out["step_far8_pct_worst"], far)
        out["handoff_mae_worst"] = max(out["handoff_mae_worst"], handoff)
    return out


def run(arch, mode: str, cfg: dict, tr: dict, lim: dict, params, calib, data, run_, warm,
        device) -> list:
    """The numbers compared, each with its limit."""
    got = numbers(arch, mode, cfg, tr, params, calib, data, run_, warm, device)
    return [{"name": k, "value": v, "limit": lim[k]["limit"]} for k, v in got.items()]
