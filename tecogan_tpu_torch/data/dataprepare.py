"""Dataset preparation (tecogan_tpu/data/dataprepare.py; reference
dataprepare.py), offline: ``--synthetic N`` writes N procedural scenes
(``data/synthetic.py``) in the training layout, and ``extract_scenes``
cuts half-resolution 120-frame scenes from a local video (or, when it
cannot be opened, from the procedural chess capture).  Downloading the
reference's video list is not part of the port: without ``--synthetic``
the command says so and exits 1.

Usage:
  python -m tecogan_tpu_torch.data.dataprepare --synthetic 4 \\
      [--disk_path TrainingDataPath] [--start_id 1000] [--duration 120]
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys


def tee_log(log_dir: str):
    """Mirror stdout to log/logfile_mmddHHMM.txt (dataprepare.py:77-91);
    returns the log's path."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%m%d%H%M")
    path = os.path.join(log_dir, f"logfile_{stamp}.txt")
    log_f = open(path, "a", encoding="utf-8")

    class Tee:
        def __init__(self, *streams):
            self.streams = streams

        def write(self, data):
            for s in self.streams:
                s.write(data)

        def flush(self):
            for s in self.streams:
                s.flush()

    sys.stdout = Tee(sys.__stdout__, log_f)
    return path


def extract_scenes(video_path: str, starts, out_dir: str, scene_index: int,
                   frames_per_scene: int = 120, synth_fallback: bool = True) -> int:
    """Cut half-res scenes of ``frames_per_scene`` frames at each start
    frame; returns the next free scene index.  A source that cannot be
    opened falls back to the procedural chess capture."""
    import cv2

    from .capture import DEFAULT_FALLBACK, create_capture

    for start in starts:
        cap = create_capture(video_path, DEFAULT_FALLBACK if synth_fallback else None)
        if cap is None or not cap.isOpened():
            print(f"cannot open {video_path}; scene skipped")
            continue
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        d = os.path.join(out_dir, f"scene_{scene_index:04d}")
        os.makedirs(d, exist_ok=True)
        ok = True
        for i in range(frames_per_scene):
            ret, frame = cap.read()
            if not ret:
                ok = False
                break
            frame = cv2.resize(frame, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
            cv2.imwrite(os.path.join(d, f"col_high_{i:04d}.png"), frame)
        cap.release()
        if ok:
            print(f"wrote {d}")
            scene_index += 1
        else:
            print(f"short read at start={start}; scene skipped")
    return scene_index


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--start_id", type=int, default=1000)
    p.add_argument("--duration", type=int, default=120)
    p.add_argument("--disk_path", default="TrainingDataPath")
    p.add_argument("--summary_dir", default="log")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic scenes (the only source offline)")
    args = p.parse_args(argv)

    if args.synthetic <= 0:
        print("downloading the reference's video list is not part of this package; "
              "use --synthetic N, or data/convert2images.py on local videos")
        sys.exit(1)
    prev = sys.stdout
    log_path = tee_log(args.summary_dir)
    tee = sys.stdout
    try:
        print(f"logging to {log_path}")
        os.makedirs(args.disk_path, exist_ok=True)
        from .synthetic import write_synthetic_scene_folders

        write_synthetic_scene_folders(args.disk_path, num_scenes=args.synthetic,
                                      frames_per_scene=args.duration,
                                      start_index=args.start_id)
        print(f"generated {args.synthetic} synthetic scenes")
    finally:
        sys.stdout = prev
        tee.streams[1].close()


if __name__ == "__main__":
    main()
