"""Synthetic video fixtures (tecogan_tpu/data/synthetic.py):
deterministic moving scenes with known motion for data-free tests,
benchmarks and smoke training, and scene folders written from them.

The JAX package downsizes HR to LR with ``cv2.INTER_AREA``; at the
integer factor 4 that is the mean of each 4x4 block, computed here with
numpy.
"""

from __future__ import annotations

import numpy as np


def moving_rect_scene(num_frames: int = 120, height: int = 128,
                      width: int = 128, seed: int = 0) -> np.ndarray:
    """A deterministic scene: textured background + a foreground rectangle
    moving on a closed sinusoidal track.  Returns (T, H, W, 3) float32 in
    [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    background = np.stack(
        [
            0.5 + 0.5 * np.sin(2 * np.pi * xx / 31.0) * np.cos(2 * np.pi * yy / 17.0),
            0.5 + 0.5 * np.cos(2 * np.pi * (xx + yy) / 23.0),
            0.5 + 0.5 * np.sin(2 * np.pi * yy / 13.0),
        ],
        axis=-1,
    ).astype(np.float32)
    noise = rng.random((height, width, 3)).astype(np.float32)
    background = 0.7 * background + 0.3 * noise

    rect_h, rect_w = height // 5, width // 5
    rect = rng.random((rect_h, rect_w, 3)).astype(np.float32)

    frames = np.empty((num_frames, height, width, 3), np.float32)
    amp_y = (height - rect_h) // 3
    amp_x = (width - rect_w) // 3
    cy, cx = height // 2 - rect_h // 2, width // 2 - rect_w // 2
    for t in range(num_frames):
        ang = 2.0 * np.pi * t / max(num_frames, 1)
        y = int(cy + amp_y * np.sin(ang))
        x = int(cx + amp_x * np.cos(2 * ang))
        f = background.copy()
        f[y : y + rect_h, x : x + rect_w] = rect
        frames[t] = f
    return frames


def chess_scene(num_frames: int = 120, height: int = 128, width: int = 128,
                cells: int = 8, phase: int = 0) -> np.ndarray:
    """A drifting checkerboard: pure translation, so the flow is known
    exactly.  ``phase`` offsets the drift so repeated uses yield distinct
    clips."""
    cell_h, cell_w = height // cells, width // cells
    yy, xx = np.mgrid[0 : 2 * height, 0 : 2 * width]
    board = (((yy // cell_h) + (xx // cell_w)) % 2).astype(np.float32)
    board = np.stack([board, 1.0 - board, 0.5 * np.ones_like(board)], axis=-1)

    frames = np.empty((num_frames, height, width, 3), np.float32)
    for t in range(num_frames):
        dy = (2 * (t + phase)) % height
        dx = (3 * (t + phase)) % width
        frames[t] = board[dy : dy + height, dx : dx + width]
    return frames


def downscale_four(frames: np.ndarray) -> np.ndarray:
    """(T, 4h, 4w, C) -> (T, h, w, C): the mean of each 4x4 block, which
    is ``cv2.resize(..., INTER_AREA)`` at this integer factor."""
    T, H, W, C = frames.shape
    return frames.reshape(T, H // 4, 4, W // 4, 4, C).mean(axis=(2, 4),
                                                           dtype=np.float32)


def synthetic_scene_batch(batch: int, rnn_n: int, crop_size: int,
                          seed: int = 0, scene: str = "rect"
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Data-free LR/HR training batches with the reference's pairing rule:
    LR is the downscaled HR (code/dataloader.py:86-95, 4x factor).

    Returns (lr (B,T,3,h,w), hr (B,T,3,4h,4w)) float32 NCHW clips.
    ``scene="chess"`` offsets clip b's drift by ``seed + b`` (the JAX
    function passes ``seed=`` to ``chess_scene``, which takes none)."""
    hr_size = crop_size * 4
    lrs, hrs = [], []
    for b in range(batch):
        if scene == "rect":
            clip = moving_rect_scene(rnn_n, hr_size, hr_size, seed=seed + b)
        else:
            clip = chess_scene(rnn_n, hr_size, hr_size, phase=seed + b)
        hrs.append(clip.transpose(0, 3, 1, 2))
        lrs.append(downscale_four(clip).transpose(0, 3, 1, 2))
    return np.stack(lrs), np.stack(hrs)


def _capture_scene(cls_name: str, num_frames: int, size: int,
                   seed: int) -> np.ndarray:
    """A clip from one of the procedural capture classes
    (``data/capture.py``: chess, book, cube) as (T, H, W, 3) float32 RGB;
    ``seed`` offsets the scene's phase."""
    from .capture import create_capture

    cap = create_capture(f"synth:class={cls_name}:noise=0.02:size={size}x{size}")
    for _ in range(7 * seed % 93):  # deterministic phase offset
        cap.read()
    frames = np.empty((num_frames, size, size, 3), np.float32)
    for t in range(num_frames):
        ok, bgr = cap.read()
        if not ok:
            raise RuntimeError(f"synthetic capture {cls_name} returned no frame")
        frames[t] = bgr[..., ::-1].astype(np.float32) / 255.0
    return frames


def write_synthetic_scene_folders(root: str, num_scenes: int = 2,
                                  frames_per_scene: int = 120, size: int = 128,
                                  start_index: int = 1000, prefix: str = "scene",
                                  variety: bool = False, seed_offset: int = 0) -> None:
    """Scene folders in the reference's layout
    (``<prefix>_%04d/col_high_%04d.png``) from the synthetic generators, the
    JAX package's pixels written as PNGs with PIL.

    variety=True rotates through moving-rect, the drifting checkerboard
    (phase ``5 * s``) and the chess / book / cube captures; seed_offset
    shifts the rotation and the per-scene seed, so chunks generated in
    parallel do not repeat each other."""
    import os

    from ..ops.image import save_img

    makers = [lambda s: moving_rect_scene(frames_per_scene, size, size, seed=s)]
    if variety:
        makers += [
            lambda s: chess_scene(frames_per_scene, size, size, phase=5 * s),
            lambda s: _capture_scene("chess", frames_per_scene, size, s),
            lambda s: _capture_scene("book", frames_per_scene, size, s),
            lambda s: _capture_scene("cube", frames_per_scene, size, s),
        ]
    for s0 in range(num_scenes):
        s = s0 + seed_offset
        d = os.path.join(root, f"{prefix}_{start_index + s0:04d}")
        os.makedirs(d, exist_ok=True)
        clip = makers[s % len(makers)](s)
        for t in range(frames_per_scene):
            save_img(os.path.join(d, f"col_high_{t:04d}.png"), clip[t])
