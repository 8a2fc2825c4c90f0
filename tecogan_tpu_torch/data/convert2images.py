"""Convert local videos into training scene folders
(tecogan_tpu/data/convert2images.py; reference data/convert2images.py),
``cv2`` only.

Chunks every video under --video_dir into 120-frame scenes written as
``<output_dir>/scene_%04d/col_high_%04d.png``, the layout the training
dataset scans, optionally downscaled (the reference's half-res prep).

Usage:
  python -m tecogan_tpu_torch.data.convert2images --video_dir <dir> \
      --output_dir TrainingDataPath [--start_index 1000] [--scale 0.5] \
      [--frames_per_scene 120] [--max_scenes -1]
"""

from __future__ import annotations

import argparse
import os
from typing import List


def list_videos(video_dir: str) -> List[str]:
    exts = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".mpg", ".mpeg")
    out = []
    for root, _, files in os.walk(video_dir):
        for f in sorted(files):
            if f.lower().endswith(exts):
                out.append(os.path.join(root, f))
    return out


def convert_video(
    path: str,
    output_dir: str,
    scene_index: int,
    frames_per_scene: int = 120,
    scale: float = 0.5,
    prefix: str = "scene",
    min_size: int = 128,
) -> int:
    """Write consecutive 120-frame scenes from one video; returns the next
    free scene index (convert2images.py:80-97 behavior)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        print(f"skip (cannot open): {path}")
        return scene_index

    buf = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if scale != 1.0:
            frame = cv2.resize(
                frame, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA
            )
        if min(frame.shape[:2]) < min_size:
            print(f"skip (too small after scale): {path}")
            cap.release()
            return scene_index
        buf.append(frame)
        if len(buf) == frames_per_scene:
            d = os.path.join(output_dir, f"{prefix}_{scene_index:04d}")
            os.makedirs(d, exist_ok=True)
            for i, f in enumerate(buf):
                cv2.imwrite(
                    os.path.join(d, f"col_high_{i:04d}.png"),
                    cv2.cvtColor(f, cv2.COLOR_RGB2BGR),
                )
            print(f"wrote {d} ({frames_per_scene} frames)")
            scene_index += 1
            buf = []
    cap.release()
    return scene_index


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--output_dir", default="TrainingDataPath")
    p.add_argument("--start_index", type=int, default=1000)
    p.add_argument("--frames_per_scene", type=int, default=120)
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--prefix", default="scene")
    p.add_argument("--max_scenes", type=int, default=-1)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    idx = args.start_index
    for v in list_videos(args.video_dir):
        if args.max_scenes > 0 and idx - args.start_index >= args.max_scenes:
            break
        idx = convert_video(
            v, args.output_dir, idx, args.frames_per_scene, args.scale, args.prefix
        )
    print(f"done: {idx - args.start_index} scenes")


if __name__ == "__main__":
    main()
