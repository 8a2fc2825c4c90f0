"""Quality evaluation (tecogan_tpu/cli/evaluate.py) on the port.

Modes:
  * --sr_dir vs --hr_dir: per-frame PSNR / SSIM (+ the VGG distances with
    --vgg_ckpt) between two frame folders or two media files;
  * --g_checkpoint + --input_dir_HR: run the model on LR-downscaled HR
    scenes and score SR against the HR.

Prints one JSON line per clip and an aggregate line.  Runs on the card
(``main(argv, device=)`` takes another device from Python).

Usage:
  python -m tecogan_tpu_torch.cli.evaluate --g_checkpoint g.ckpt \\
      --input_dir_HR <scene_root> [--crop_size 64] [--limit_frames 40]
  python -m tecogan_tpu_torch.cli.evaluate --sr_dir out/ --hr_dir gt/
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _load_frames(path: str) -> np.ndarray:
    """A media file or a directory of frames -> (T, H, W, 3) float32 [0,1]."""
    import cv2

    if os.path.isdir(path):
        from ..data.scenes import _load_png

        return np.stack([_load_png(os.path.join(path, n)) for n in sorted(os.listdir(path))])
    if path.lower().endswith(".gif"):
        from ..ops.image import read_gif

        return read_gif(path).astype(np.float32) / 255.0
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)
    cap.release()
    return np.stack(frames)


def score_pair(sr: np.ndarray, hr: np.ndarray, vgg_params=None, lpips_lin=None,
               device=None) -> dict:
    """PSNR (mean of frames, and pooled), SSIM and, with ``vgg_params`` (the
    flax VGG-19 tree), the VGG and LPIPS-form distances of the first
    ``min(len)`` frames, on ``device`` (default: the card)."""
    from ..engine.state import resolve_device
    from ..ops.metrics import (lpips_distance, psnr, psnr_per_frame, ssim,
                               vgg_perceptual_distance)

    dev = resolve_device(device)
    T = min(len(sr), len(hr))
    sr = torch.from_numpy(np.ascontiguousarray(sr[:T], np.float32)).to(dev)
    hr = torch.from_numpy(np.ascontiguousarray(hr[:T], np.float32)).to(dev)
    out = {
        "frames": int(T),
        "psnr_db": float(torch.mean(psnr_per_frame(hr, sr))),
        "psnr_global_db": float(psnr(hr, sr)),
        "ssim": float(ssim(sr, hr)),
    }
    if vgg_params is not None:
        from ..models.vgg import vgg19_features, vgg_model

        layers = ("vgg_19/conv2_2", "vgg_19/conv3_4", "vgg_19/conv4_4")
        model = vgg_model(vgg_params, device=dev)
        with torch.no_grad():
            fx = vgg19_features(model, sr, deep_list=layers)
            fy = vgg19_features(model, hr, deep_list=layers)
        out["vgg_dist"] = float(vgg_perceptual_distance(fx, fy, layers))
        # without the learned per-channel weights (--lpips_lin) the
        # uniform-weight result is named lpips_surrogate
        key = "lpips" if lpips_lin else "lpips_surrogate"
        out[key] = float(lpips_distance(fx, fy, layers, lin_weights=lpips_lin))
    return out


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sr_dir", default=None)
    p.add_argument("--hr_dir", default=None)
    p.add_argument("--g_checkpoint", default=None)
    p.add_argument("--input_dir_HR", default=None)
    p.add_argument("--crop_size", type=int, default=64, help="LR size for model eval (HR = 4x)")
    p.add_argument("--num_resblock", type=int, default=16)
    p.add_argument("--limit_frames", type=int, default=-1)
    p.add_argument("--limit_clips", type=int, default=-1)
    p.add_argument("--degradation", choices=["bilinear", "area"], default="bilinear",
                   help="LR kernel for model eval: bilinear is the training pairing "
                        "(data/scenes.py), area the cv2 INTER_AREA kernel")
    p.add_argument("--vgg_ckpt", default=None,
                   help="a converted VGG-19 .ckpt, or 'surrogate' for the JAX package's "
                        "fixed-seed weights")
    p.add_argument("--lpips_lin", default=None,
                   help="npz of layer-name -> per-channel LPIPS linear weights; without "
                        "it lpips is reported as lpips_surrogate (uniform weights)")
    p.add_argument("--json_out", default=None, help="also write all records to this JSON file")
    p.add_argument("--bug_parity", default=True, type=lambda v: v in ("1", "true", "True"))
    args = p.parse_args(argv)

    vgg_params = None
    if args.vgg_ckpt:
        from ..models.vgg import load_vgg_params

        vgg_params = load_vgg_params(args.vgg_ckpt)
    lpips_lin = None
    if args.lpips_lin:
        with np.load(args.lpips_lin) as z:
            lpips_lin = {k: z[k] for k in z.files}

    results = []
    if args.sr_dir and args.hr_dir:
        sr, hr = _load_frames(args.sr_dir), _load_frames(args.hr_dir)
        if args.limit_frames > 0:
            sr, hr = sr[: args.limit_frames], hr[: args.limit_frames]
        if sr.shape[1:3] != hr.shape[1:3]:
            import cv2

            hr = np.stack([cv2.resize(f, (sr.shape[2], sr.shape[1])) for f in hr])
        rec = {"clip": "pair", **score_pair(sr, hr, vgg_params, lpips_lin, device)}
        print(json.dumps(rec))
        results.append(rec)
    elif args.g_checkpoint and args.input_dir_HR:
        import cv2

        from ..config import TecoConfig
        from ..engine.inference import build_clip_inference
        from ..engine.state import model_defs, resolve_device
        from ..utils.checkpoint import load_generator_params
        from ..utils.convert import generator_state_dict_from_jax

        dev = resolve_device(device)
        cfg = TecoConfig(crop_size=args.crop_size, num_resblock=args.num_resblock,
                         bug_parity=args.bug_parity)
        model = model_defs(cfg, device=dev)
        model.load_state_dict(generator_state_dict_from_jax(
            load_generator_params(args.g_checkpoint)))
        model.eval()
        infer = build_clip_inference(cfg)
        clips = sorted(os.listdir(args.input_dir_HR))
        if args.limit_clips > 0:
            clips = clips[: args.limit_clips]
        interp = cv2.INTER_LINEAR if args.degradation == "bilinear" else cv2.INTER_AREA
        hr_size = args.crop_size * 4
        for name in clips:
            src = _load_frames(os.path.join(args.input_dir_HR, name))
            if args.limit_frames > 0:
                src = src[: args.limit_frames]
            # LR and HR each resize the source frame (the training pairing)
            hr = np.stack([cv2.resize(f, (hr_size, hr_size)) for f in src])
            lr = np.stack([cv2.resize(f, (args.crop_size, args.crop_size),
                                      interpolation=interp) for f in src])
            sr = infer(model, torch.from_numpy(lr)[None].to(dev))[0].cpu().numpy()
            rec = {"clip": name, **score_pair(sr, hr, vgg_params, lpips_lin, dev)}
            print(json.dumps(rec))
            results.append(rec)
    else:
        raise SystemExit("need either (--sr_dir and --hr_dir) or "
                         "(--g_checkpoint and --input_dir_HR)")

    if not results:
        raise SystemExit("no clips scored (check --input_dir_HR contents)")
    agg = {"clip": "__aggregate__", "clips": len(results)}
    for key in ("psnr_db", "psnr_global_db", "ssim", "vgg_dist", "lpips", "lpips_surrogate"):
        if all(key in r for r in results):
            agg[key] = float(np.mean([r[key] for r in results]))
    print(json.dumps(agg))
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump({"records": results, "aggregate": agg}, f, indent=1)
    return agg


if __name__ == "__main__":
    main()
