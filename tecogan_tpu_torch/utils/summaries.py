"""Metrics and per-epoch artifacts (tecogan_tpu/utils/summaries.py): a
JSONL line per logged step under ``--summary_dir`` (``<run>_metrics.jsonl``,
keys ``step``, ``wall_time``, ``epoch`` and the metrics), and the
reference's per-epoch gif and tiled-jpg dumps (main.py:283-305).
Metric values may be numbers, numpy scalars or 0-d tensors.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class SummaryWriter:
    def __init__(self, summary_dir: str, run_name: str = "train"):
        os.makedirs(summary_dir, exist_ok=True)
        self.path = os.path.join(summary_dir, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "a", encoding="utf-8")
        self._t0 = time.time()

    def write(self, step: int, metrics: Dict, epoch: Optional[int] = None) -> None:
        rec = {"step": int(step), "wall_time": time.time() - self._t0}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def format_metrics(metrics: Dict, keys=None) -> str:
    keys = keys or sorted(metrics.keys())
    parts = []
    for k in keys:
        if k in metrics:
            try:
                parts.append(f"{k}={float(metrics[k]):.5g}")
            except (TypeError, ValueError):
                pass
    return " ".join(parts)


def save_epoch_artifacts(
    output_dir: str,
    gen_outputs_btchw: np.ndarray,
    targets_btchw: np.ndarray,
    inputs_btchw: np.ndarray,
    rnn_n: int,
    sample_index: int = 0,
) -> None:
    """Per-epoch gif + tiled-jpg dumps (main.py:284-294): gan.gif /
    real.gif / original.gif of one sample plus Gan_examples.jpg /
    real_image.jpg / original_image.jpg grids."""
    from ..ops.image import save_as_media, save_image_grid

    i = sample_index

    def thwc(clip_tchw):
        return np.transpose(np.asarray(clip_tchw), (0, 2, 3, 1))

    save_as_media(thwc(gen_outputs_btchw[i][:rnn_n]), os.path.join(output_dir, "gan.gif"))
    save_as_media(thwc(targets_btchw[i]), os.path.join(output_dir, "real.gif"))
    save_as_media(thwc(inputs_btchw[i]), os.path.join(output_dir, "original.gif"))

    def grid(x_btchw, name):
        b, t = x_btchw.shape[:2]
        flat = np.asarray(x_btchw).reshape((b * t,) + x_btchw.shape[2:])
        save_image_grid(np.transpose(flat, (0, 2, 3, 1)), os.path.join(output_dir, name))

    grid(gen_outputs_btchw, "Gan_examples.jpg")
    grid(targets_btchw, "real_image.jpg")
    grid(inputs_btchw, "original_image.jpg")
