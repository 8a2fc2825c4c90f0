"""Scene-folder datasets (tecogan_tpu/data/scenes.py; reference
code/dataloader.py:15-98), numpy and ``cv2`` on the host.  The same folder
and seed give the JAX package's arrays bit for bit
(``tests/test_torch_port_data.py``).

Layout on disk: ``<input_video_dir>/<prefix>_%04d/col_high_%04d.png`` with
>= 120 frames per scene (dataloader.py:55-61).  Training samples are
10-frame sliding windows; the LR frame is the 4x-downscaled HR png
(dataloader.py:86-95).

Sampling behavior is gated on ``cfg.bug_parity``:

``bug_parity=True`` reproduces the reference's sampling (numpy RNG and
cv2 bilinear stand in for torch RNG and PIL bilinear):
  * ``__len__`` returns the SCENE count (dataloader.py:62-65,78-79), so a
    shuffled epoch only ever draws the first num_scenes entries of the
    flat window list;
  * every frame is the full source frame resized (no crop, no flip);
    frame 0 alone additionally passes through an independent
    ``RandomResizedCrop`` for LR and for HR (dataloader.py:71-72,91-93).

``bug_parity=False`` runs the intended pipeline: ``__len__`` counts
windows, and random crop / flip apply consistently across the clip and
to the LR/HR pair jointly.

Either way ``--batch_size`` is honored.  Batches are numpy arrays that
``data/prefetch.py`` hands to the device.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import TecoConfig

WINDOWS_PER_SCENE = 110  # dataloader.py:67
FRAMES_PER_WINDOW = 10  # dataloader.py:68 (rnn_list of 10)


def _decode_u8(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB.  cv2's C++ decoder is
    ~1.6x faster than PIL for the scene PNGs (byte-identical output);
    PIL is the fallback for formats cv2 declines."""
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is not None:
        return np.ascontiguousarray(bgr[..., ::-1])
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _load_png(path: str) -> np.ndarray:
    return _decode_u8(path).astype(np.float32) / 255.0


def _resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def _random_resized_crop(
    img: np.ndarray, out: int, rng: np.random.Generator,
    scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """torchvision.transforms.RandomResizedCrop.get_params in numpy
    (the reference's frame-0 transform, dataloader.py:71-72,91-93):
    10 attempts at a random-area random-aspect crop, center-crop
    fallback, bilinear resize to (out, out)."""
    H, W = img.shape[:2]
    area = H * W
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = float(np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]))))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            i = int(rng.integers(0, H - h + 1))
            j = int(rng.integers(0, W - w + 1))
            return _resize_bilinear(img[i : i + h, j : j + w], out, out)
    # fallback: clamp aspect, center crop
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = H, int(round(H * ratio[1]))
    else:
        w, h = W, H
    i, j = (H - h) // 2, (W - w) // 2
    return _resize_bilinear(img[i : i + h, j : j + w], out, out)


def scan_scene_dirs(cfg: TecoConfig) -> List[List[str]]:
    """Enumerate frame paths per eligible scene (dataloader.py:52-69)."""
    if not cfg.input_video_dir:
        raise ValueError("Video input directory input_video_dir is not provided")
    if not os.path.exists(cfg.input_video_dir):
        raise ValueError("Video input directory not found")
    scenes = []
    for dir_i in range(cfg.str_dir, cfg.end_dir + 1):
        d = os.path.join(
            cfg.input_video_dir, f"{cfg.input_video_pre}_{dir_i:04d}"
        )
        if not os.path.exists(d):
            continue
        if len(os.listdir(d)) < 120:  # dataloader.py:57
            print(f"Skip {d}, since folder doesn't contain enough frames!")
            continue
        scenes.append(
            [os.path.join(d, f"col_high_{i:04d}.png") for i in range(cfg.max_frm + 1)]
        )
    return scenes


class TrainDataset:
    """Sliding-window clip dataset with LR-by-downscale pairing.

    Decoded source frames are kept in a bounded uint8 cache: adjacent
    windows share 9 of their 10 frames, so uncached sampling re-decodes
    every PNG ~10x per epoch (measured as the host-side wall on small
    configs)."""

    def __init__(self, cfg: TecoConfig, cache_mb: int = 1024):
        import threading

        self.cfg = cfg
        self.scenes = scan_scene_dirs(cfg)
        self.windows: List[Tuple[int, int]] = [
            (s, w)
            for s in range(len(self.scenes))
            for w in range(WINDOWS_PER_SCENE)
        ]
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_cap = int(cache_mb) * (1 << 20)
        self._cache_lock = threading.Lock()

    def _frame(self, path: str) -> np.ndarray:
        """Decoded frame as float32 (uint8-cached, FIFO-bounded; PNGs are
        8-bit so the cache is lossless).  Thread-safe: decode happens
        outside the lock (cv2/PIL release the GIL), bookkeeping inside."""
        with self._cache_lock:
            hit = self._cache.get(path)
        if hit is None:
            hit = _decode_u8(path)
            if self._cache_cap > 0:
                with self._cache_lock:
                    if path not in self._cache:
                        self._cache_bytes += hit.nbytes
                        self._cache[path] = hit
                        while self._cache_bytes > self._cache_cap and self._cache:
                            oldest = next(iter(self._cache))
                            self._cache_bytes -= self._cache.pop(oldest).nbytes
        return hit.astype(np.float32) / 255.0

    def __len__(self) -> int:
        # bug_parity: the reference's __len__ is the SCENE count
        # (dataloader.py:62-65,78-79) — the sampler therefore only ever
        # draws the first num_scenes windows of the flat list.
        if self.cfg.bug_parity:
            return len(self.scenes)
        return len(self.windows)

    def get_clip(self, idx: int, rng: Optional[np.random.Generator] = None):
        """Returns (lr (T,3,h,h), hr (T,3,4h,4h)) float32 NCHW."""
        cfg = self.cfg
        s_idx, w_idx = self.windows[idx]
        paths = self.scenes[s_idx][w_idx : w_idx + FRAMES_PER_WINDOW][: cfg.RNN_N]
        crop, hr_size = cfg.crop_size, cfg.crop_size * 4

        frames = [self._frame(p) for p in paths]

        if cfg.bug_parity:
            # reference __getitem__ (dataloader.py:81-98): full-frame
            # resize for every frame; frame 0 alone gets an INDEPENDENT
            # RandomResizedCrop for HR and LR (applied to the already-
            # resized frame) — misaligned vs frames 1..9 and vs each
            # other.  No flip, no clip-consistent crop.
            hr = [_resize_bilinear(f, hr_size, hr_size) for f in frames]
            lr = [_resize_bilinear(f, crop, crop) for f in frames]
            if rng is not None:
                hr[0] = _random_resized_crop(hr[0], hr_size, rng)
                lr[0] = _random_resized_crop(lr[0], crop, rng)
            hr, lr = np.stack(hr), np.stack(lr)
            return (
                np.ascontiguousarray(lr.transpose(0, 3, 1, 2)),
                np.ascontiguousarray(hr.transpose(0, 3, 1, 2)),
            )

        # movingFirstFrame (intent of --movingFirstFrame, main.py:83-84,
        # parsed but unused in the reference): occasionally synthesize
        # constant linear motion by sliding a crop window across frame 0 —
        # gives the recurrent net static-content-with-camera-motion clips.
        if cfg.movingFirstFrame and rng is not None and rng.random() < 0.3:
            base = frames[0]
            H0, W0 = base.shape[:2]
            m = max(H0 // 8, 4)
            dy = int(rng.integers(-m, m + 1))
            dx = int(rng.integers(-m, m + 1))
            n = len(frames)
            frames = []
            for t in range(n):
                oy = m + (dy * t) // max(n - 1, 1)
                ox = m + (dx * t) // max(n - 1, 1)
                frames.append(base[oy : oy + H0 - 2 * m, ox : ox + W0 - 2 * m])

        do_crop = cfg.random_crop and rng is not None
        do_flip = cfg.flip and rng is not None and rng.random() < 0.5

        if do_crop:
            # clip-consistent random crop in source space (intent of
            # main.py:82; reference instead misaligned frame 0 via
            # RandomResizedCrop — SURVEY §5.1.3)
            H, W = frames[0].shape[:2]
            ch = min(H, W)
            scale = rng.uniform(0.4, 1.0)
            ch = max(int(ch * scale), 8)
            y0 = int(rng.integers(0, H - ch + 1))
            x0 = int(rng.integers(0, W - ch + 1))
            frames = [f[y0 : y0 + ch, x0 : x0 + ch] for f in frames]

        hr = np.stack([_resize_bilinear(f, hr_size, hr_size) for f in frames])
        lr = np.stack([_resize_bilinear(f, crop, crop) for f in frames])
        if do_flip:
            hr = hr[:, :, ::-1]
            lr = lr[:, :, ::-1]
        return (
            np.ascontiguousarray(lr.transpose(0, 3, 1, 2)),
            np.ascontiguousarray(hr.transpose(0, 3, 1, 2)),
        )

    def batches(
        self, batch_size: int, shuffle: bool = True, seed: int = 0,
        drop_last: bool = True, workers: int = 0,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of (lr, hr) batches — the DataLoader role
        (main.py:227).

        workers > 1 decodes/augments the batch's clips on a thread pool
        (cv2/PIL release the GIL), the honest version of the reference's
        dead ``--queue_thread`` count.  Determinism is preserved: each
        clip's augmentation RNG is derived from the epoch seed and the
        clip's position, not from thread scheduling.

        bug_parity keeps trailing partial batches (torch DataLoader's
        drop_last=False default, main.py:227) — the parity price is a
        recompile when the last batch is smaller."""
        if self.cfg.bug_parity:
            drop_last = False
        rng = np.random.default_rng(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        n_full = len(order) // batch_size
        end = n_full * batch_size if drop_last else len(order)

        def clip_rng(pos: int) -> np.random.Generator:
            return np.random.default_rng((seed + 1) * 1_000_003 + pos)

        pool = None
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=workers)
        try:
            for i in range(0, end, batch_size):
                idxs = [int(j) for j in order[i : i + batch_size]]
                if pool is not None:
                    clips = list(
                        pool.map(
                            lambda t: self.get_clip(t[1], clip_rng(i + t[0])),
                            enumerate(idxs),
                        )
                    )
                else:
                    clips = [
                        self.get_clip(j, clip_rng(i + k))
                        for k, j in enumerate(idxs)
                    ]
                lr = np.stack([c[0] for c in clips])
                hr = np.stack([c[1] for c in clips])
                yield lr, hr
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


class InferenceDataset:
    """Folder-of-scenes inference input (reference inference_dataset,
    dataloader.py:15-43): each subfolder of input_dir_LR is one clip; every
    frame is resized to crop_size (the reference square-resizes too)."""

    def __init__(self, cfg: TecoConfig):
        filedir = cfg.input_dir_LR
        self.down_sample = False
        if not filedir or not os.path.exists(filedir):
            if not cfg.input_dir_HR or not os.path.exists(cfg.input_dir_HR):
                raise ValueError("Input directory not found")
            filedir = cfg.input_dir_HR
            self.down_sample = True
        self.cfg = cfg
        self.filedir = filedir
        self.clips = sorted(os.listdir(filedir))
        if cfg.input_dir_len > 0:
            self.clips = self.clips[: cfg.input_dir_len]

    def __len__(self) -> int:
        return len(self.clips)

    def get_clip(self, idx: int) -> np.ndarray:
        """(T, H, W, 3) float32 NHWC, resized to crop_size."""
        c = self.cfg.crop_size
        d = os.path.join(self.filedir, self.clips[idx])
        frames = []
        for name in sorted(os.listdir(d)):
            img = _load_png(os.path.join(d, name))
            frames.append(_resize_bilinear(img, c, c))
        return np.stack(frames)


def load_video_frames(path: str, crop_size: int) -> np.ndarray:
    """mp4 -> (T, crop, crop, 3) float32, BGR->RGB + INTER_AREA square
    resize exactly like the video inference mode (main.py:145-161)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    for _ in range(n):
        ret, frame = cap.read()
        if not ret:
            continue
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        frame = cv2.resize(
            frame, (crop_size, crop_size), interpolation=cv2.INTER_AREA
        )
        frames.append(frame.astype(np.float32) / 255.0)
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)
