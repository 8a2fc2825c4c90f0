"""Adapt the generator to ONE clip (ZSSR-style test-time training), then
serve and optionally score it.

    python -m tecogan_tpu_torch.tools.adapt_clip --input clip.gif \\
        --g_checkpoint gen.ckpt --steps 1000 --out_ckpt adapted.ckpt \\
        --out_sr sr.mp4 [--gt hr.gif --json_out scores.json]

The JAX package's ``tools/adapt_clip.py`` on the port, with its flags and
outputs: ``engine.adapt.adapt_generator`` with the guard on internal
LR -> LR/4 pairs of the clip (at most ``--frames`` of them) plus the
serving-scale LR-consistency term; the adapted params written as a
generator ``.ckpt`` (``--out_ckpt``, which both packages load); the whole
clip served by ``build_clip_inference`` at bf16 with ``bug_parity`` off
(the fused route); ``--refine`` back-projection iterations; the SR clip
written as media (``--out_sr``); PSNR and SSIM against ``--gt``
(``cli.evaluate.score_pair``), appended to ``--json_out`` under
``ours_adapted[_<record_suffix>]``.  Runs on the card unless ``--device``
names another.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def load_clip(path: str, frames: int = 0) -> np.ndarray:
    """(T, H, W, 3) float32 [0, 1] from a gif, a video file or a folder of
    png / jpg frames (sorted by name); the first ``frames`` when > 0."""
    if os.path.isdir(path):
        from ..data.scenes import _load_png

        clip = np.stack([_load_png(os.path.join(path, n)) for n in sorted(os.listdir(path))
                         if n.lower().endswith((".png", ".jpg", ".jpeg"))])
    else:
        from ..cli.evaluate import _load_frames

        clip = _load_frames(path)
    return clip[:frames] if frames else clip


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="LR clip (gif/mp4/dir)")
    p.add_argument("--g_checkpoint", required=True)
    p.add_argument("--num_resblock", type=int, default=16)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--consistency", type=float, default=2.0)
    p.add_argument("--frames", type=int, default=40,
                   help="cap frames used for internal pairs (0 = all)")
    p.add_argument("--out_ckpt", default="", help="save adapted params")
    p.add_argument("--out_sr", default="", help="write the SR clip")
    p.add_argument("--refine", type=int, default=0,
                   help="post-hoc back-projection iters on the SR output")
    p.add_argument("--gt", default="", help="score SR against this HR clip")
    p.add_argument("--json_out", default="", help="append scores to JSON")
    p.add_argument("--record_suffix", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def main(argv=None) -> dict:
    """Runs the tool; returns ``{"report", "sr", "score"}`` (the guard's
    report, the served SR clip (T, 4H, 4W, 3) float32 numpy, the scores
    or None) for callers in Python."""
    args = build_parser().parse_args(argv)

    from ..config import TecoConfig
    from ..engine.adapt import adapt_generator, lr_consistency_refine
    from ..engine.inference import build_clip_inference
    from ..engine.state import float_params, model_defs, resolve_device
    from ..utils.checkpoint import load_generator_params, save_generator_params

    dev = resolve_device(args.device)
    cfg = TecoConfig(num_resblock=args.num_resblock, precision="bf16", bug_parity=False)
    params = load_generator_params(args.g_checkpoint)

    clip = load_clip(args.input)
    print(f"clip: {clip.shape[0]} frames {clip.shape[1]}x{clip.shape[2]}")
    adapted, report = adapt_generator(
        cfg, params, clip[: args.frames] if args.frames else clip,
        steps=args.steps, learning_rate=args.lr, consistency=args.consistency,
        log_every=max(args.steps // 8, 1), guard=True, device=dev)
    print("guard report:", report)
    if args.out_ckpt:
        save_generator_params(args.out_ckpt, adapted)
        print(f"adapted params -> {args.out_ckpt}")

    model = model_defs(cfg, device=dev)
    model.load_state_dict(float_params(adapted))
    sr = build_clip_inference(cfg)(model.eval(), torch.from_numpy(clip)[None].to(dev))[0]
    if args.refine:
        sr = lr_consistency_refine(sr, clip, iters=args.refine, device=dev)
    sr = sr.cpu().numpy()
    if args.out_sr:
        from ..ops.image import save_as_media

        save_as_media(sr, args.out_sr)
        print(f"SR clip -> {args.out_sr}")

    rec = None
    if args.gt:
        from ..cli.evaluate import score_pair

        rec = score_pair(sr, load_clip(args.gt), device=dev)
        print("score:", rec)
        if args.json_out:
            data = {"records": {}, "context": {}}
            if os.path.exists(args.json_out):
                with open(args.json_out) as f:
                    data = json.load(f)
            key = "ours_adapted" + (f"_{args.record_suffix}" if args.record_suffix else "")
            data.setdefault("records", {})[key] = rec
            data.setdefault("context", {})[key] = {
                "steps": args.steps, "lr": args.lr, "consistency": args.consistency,
                "refine": args.refine, "checkpoint": args.g_checkpoint,
            }
            with open(args.json_out, "w") as f:
                json.dump(data, f, indent=2)
            print(f"scores appended -> {args.json_out}")
    return {"report": report, "sr": sr, "score": rec}


if __name__ == "__main__":
    main()
