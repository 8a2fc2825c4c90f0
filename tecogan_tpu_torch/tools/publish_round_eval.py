"""Publish a convergence run's evidence as one JSON artifact
(tools/publish_round_eval.py on the port).

    python -m tecogan_tpu_torch.tools.publish_round_eval --run_dir <run> \\
        --scene_dir <scenes> --out <file.json> [--device cuda]

From a run directory of ``cli.main --mode train`` (its ``generator.ckpt``
and ``summary/train_metrics.jsonl``) and the scene directory of
``tools.gen_scenes_r4``:

* the held-out evaluation: ``cli.evaluate`` of the run's generator on the
  held-out scenes (``--eval_scenes``, linked under ``<run>/_eval_scenes``;
  LR and HR each resized from the source frame, ``--limit_frames`` frames
  a clip, ``--vgg_ckpt surrogate``), and the bicubic-4x anchor of each
  scene under the same protocol;
* every ``val_psnr_db`` record of the JSONL by epoch (an epoch logged
  twice, as a resumed run does, becomes a list);
* the run's context: its epochs, steps and wall time, the median wall ms
  a step from consecutive records (restarts, where the wall clock resets,
  dropped) and the wall-clock MFU of ``--train_tflop_per_step`` against
  the H100's dense bf16 peak (``utils.flops.H100_PEAK_BF16_FLOPS``).

Runs on the card unless ``--device`` names another.  Writes only
``--out`` and, in the run directory, the scene links and ``_heldout.json``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def bicubic_anchor(scene_dir: str, crop: int, frames: int, device) -> dict:
    """PSNR (mean of frames) and SSIM of the bicubic-4x-upscaled LR against
    the HR, each resized from the scene's frames as ``cli.evaluate`` does."""
    import cv2

    from ..cli.evaluate import _load_frames
    from ..ops.metrics import psnr_per_frame, ssim

    src = _load_frames(scene_dir)[:frames]
    hr = np.stack([cv2.resize(f, (crop * 4, crop * 4)) for f in src])
    lr = np.stack([cv2.resize(f, (crop, crop)) for f in src])
    up = np.stack([cv2.resize(f, (crop * 4, crop * 4), interpolation=cv2.INTER_CUBIC)
                   for f in lr])
    hr, up = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
              for a in (hr, up))
    return {"psnr_db": float(torch.mean(psnr_per_frame(hr, up))),
            "ssim": float(ssim(up, hr))}


def val_trajectory(jsonl: str):
    """``({"epoch<n>": dB or [dB, ...]}, the last record)``: every
    ``val_psnr_db`` record, rounded to 3 decimals, by its 1-based epoch."""
    traj, last = {}, {}
    with open(jsonl) as f:
        for line in f:
            rec = json.loads(line)
            if "val_psnr_db" in rec:
                key = f"epoch{rec['epoch'] + 1}"
                val = round(float(rec["val_psnr_db"]), 3)
                if key in traj:
                    prev = traj[key]
                    traj[key] = (prev if isinstance(prev, list) else [prev]) + [val]
                else:
                    traj[key] = val
            last = rec
    return traj, last


def wall_ms_per_step(jsonl: str):
    """The median wall ms a step over consecutive records that carry
    ``wall_time`` and ``step``; a pair where either goes back (a restart)
    is dropped.  None without such a pair."""
    deltas = []
    prev_wall = prev_step = None
    with open(jsonl) as f:
        for line in f:
            rec = json.loads(line)
            if "wall_time" not in rec or "step" not in rec:
                continue
            if (prev_wall is not None and rec["wall_time"] > prev_wall
                    and rec["step"] > prev_step):
                deltas.append((rec["wall_time"] - prev_wall) / (rec["step"] - prev_step))
            prev_wall, prev_step = rec["wall_time"], rec["step"]
    return float(np.median(deltas) * 1000.0) if deltas else None


def main(argv=None) -> dict:
    from ..engine.state import resolve_device
    from ..utils.flops import H100_PEAK_BF16_FLOPS

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--scene_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--eval_scenes", default="2100,2101,2102")
    p.add_argument("--crop_size", type=int, default=64)
    p.add_argument("--limit_frames", type=int, default=40)
    p.add_argument("--num_resblock", type=int, default=16)
    p.add_argument("--context_note", default="")
    p.add_argument("--train_tflop_per_step", type=float, default=3.297,
                   help="analytic TFLOP an optimizer step for the run's config "
                        "(utils/flops.py train_step_macs * 2; default: the convergence "
                        "config, batch 4, crop 32, RNN 10, ping-pong, fixed semantics)")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    from ..cli import evaluate as ev

    dev = resolve_device(args.device)
    scenes = [f"scene_{int(s):04d}" for s in args.eval_scenes.split(",")]
    hold = os.path.join(args.run_dir, "_eval_scenes")
    os.makedirs(hold, exist_ok=True)
    for s in scenes:
        dst = os.path.join(hold, s)
        if not os.path.exists(dst):
            os.symlink(os.path.join(os.path.abspath(args.scene_dir), s), dst)

    ckpt_path = os.path.join(args.run_dir, "generator.ckpt")
    tmp_json = os.path.join(args.run_dir, "_heldout.json")
    ev.main(["--g_checkpoint", ckpt_path, "--input_dir_HR", hold,
             "--crop_size", str(args.crop_size), "--num_resblock", str(args.num_resblock),
             "--limit_frames", str(args.limit_frames), "--bug_parity", "false",
             "--vgg_ckpt", "surrogate", "--json_out", tmp_json], device=dev)
    with open(tmp_json) as f:
        heldout = json.load(f)

    jsonl = os.path.join(args.run_dir, "summary", "train_metrics.jsonl")
    traj, last = val_trajectory(jsonl)
    ms_per_step = wall_ms_per_step(jsonl)
    train_mfu = (args.train_tflop_per_step * 1e12 / (ms_per_step / 1000.0)
                 / H100_PEAK_BF16_FLOPS if ms_per_step else None)

    anchors = {s: bicubic_anchor(os.path.join(args.scene_dir, s), args.crop_size,
                                 args.limit_frames, dev) for s in scenes}
    anchors["aggregate_psnr_db"] = float(np.mean([a["psnr_db"] for a in anchors.values()]))

    from ..utils.checkpoint import load_flat

    _, ckpt_meta = load_flat(ckpt_path)
    out = {
        "records": heldout["records"],
        "aggregate": heldout["aggregate"],
        "validation_psnr_trajectory_db": traj,
        "heldout_bicubic4x": anchors,
        "context": {
            "run_dir": args.run_dir,
            "scored_checkpoint": ckpt_path,
            "scored_checkpoint_epoch": int(ckpt_meta.get("epoch", -1)),
            "final_epoch": int(last.get("epoch", -1)) + 1,
            "final_step": int(last.get("step", -1)),
            "train_wall_s": round(float(last.get("wall_time", 0.0)), 1),
            "median_ms_per_step_wall": round(ms_per_step, 1) if ms_per_step else None,
            "train_mfu_wall": round(train_mfu, 4) if train_mfu else None,
            "train_mfu_peak_tflops": H100_PEAK_BF16_FLOPS / 1e12,
            "train_tflop_per_step": args.train_tflop_per_step,
            "eval_device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else str(dev)),
            "protocol": (
                "unified train/eval degradation; LR and HR each bilinear-resized from "
                f"the source frame; {args.limit_frames} frames/clip; eval scenes "
                f"{args.eval_scenes} held out from training"),
            "note": args.context_note,
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
