"""Procedural video captures and the capture factory
(tecogan_tpu/data/capture.py; reference data/video.py:40-206,
data/tst_scene_render.py:14-96, and the lookat/mtx2rvec helpers of
data/common.py:73-90), numpy and ``cv2``.

They mimic the ``cv2.VideoCapture`` interface (``read() -> (ok, bgr)``,
``isOpened()``, ``set()``) so data preparation and the live demo fall
back to deterministic synthetic video when a real source cannot be
opened:
  * ``Chess``: a 3-D projected chessboard under an orbiting camera
    (cv2.projectPoints + fillConvexPoly);
  * ``Book`` / ``Cube``: moving-foreground / deforming-quad scenes via
    ``SceneRender`` over procedural backgrounds (the repo ships no
    images);
  * ``create_capture``: the ``synth:class=chess:noise=0.1:size=WxH`` spec
    grammar and its silent fallback.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# geometry helpers (reference data/common.py:73-90; used by Chess)
# ---------------------------------------------------------------------------

def lookat(eye, target, up=(0, 0, 1)) -> Tuple[np.ndarray, np.ndarray]:
    """Camera rotation + translation looking from ``eye`` toward
    ``target`` (right-down-forward rows)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ eye


def mtx2rvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle (Rodrigues) vector."""
    u, w, vt = np.linalg.svd(R - np.eye(3))
    p = vt[0] + u[:, 0] * w[0]
    cos_a = float(vt[0] @ p)
    sin_a = float(vt[1] @ p)
    axis = np.cross(vt[0], vt[1])
    return axis * math.atan2(sin_a, cos_a)


# ---------------------------------------------------------------------------
# procedural background / foreground assets (replace the reference's
# OpenCV sample images; deterministic, no binary files in the repo)
# ---------------------------------------------------------------------------

def _procedural_bg(w: int, h: int, seed: int = 7) -> np.ndarray:
    """Smooth colorful background (uint8 BGR)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 127 + 80 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    g = 127 + 80 * np.sin((xx + yy) / 53.0)
    b = 127 + 80 * np.cos(xx / 19.0 + yy / 41.0)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def _procedural_fg(size: int = 96) -> np.ndarray:
    """Textured square foreground object (uint8 BGR)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    v = 127 + 120 * np.sin(xx / 6.0) * np.sin(yy / 6.0)
    return np.clip(
        np.stack([v, 255 - v, np.full_like(v, 200)], axis=-1), 0, 255
    ).astype(np.uint8)


# ---------------------------------------------------------------------------
# TestSceneRender equivalent (reference data/tst_scene_render.py:14-96)
# ---------------------------------------------------------------------------

class SceneRender:
    """Moving-foreground / deforming-quad scene over a static background."""

    def __init__(self, bg: np.ndarray, fg: Optional[np.ndarray] = None,
                 deformation: bool = False, speed: float = 0.25):
        self.bg = bg
        self.fg = fg
        self.deformation = deformation
        self.speed = speed
        self.time = 0.0
        self.time_step = 1.0 / 30.0
        h, w = bg.shape[:2]
        if fg is not None:
            fh, fw = fg.shape[:2]
            self.center = (h // 2 - fh // 2, w // 2 - fw // 2)
            self.y_ampl = max(h - (self.center[0] + fh), 0)
            self.x_ampl = max(w - (self.center[1] + fw), 0)

    def next_frame(self) -> np.ndarray:
        import cv2

        img = self.bg.copy()
        t = self.time
        if self.fg is not None:
            dy = int(self.y_ampl * math.cos(t * self.speed))
            dx = int(self.x_ampl * math.sin(t * self.speed))
            y0 = self.center[0] + dy
            x0 = self.center[1] + dx
            fh, fw = self.fg.shape[:2]
            img[y0 : y0 + fh, x0 : x0 + fw] = self.fg
        else:
            h, w = img.shape[:2]
            base = np.array(
                [(w // 2, h // 2), (w // 2 + w // 10, h // 2),
                 (w // 2 + w // 10, h // 2 + h // 10), (w // 2, h // 2 + h // 10)]
            )
            off = int(30 * math.cos(t * self.speed) + 50 * math.sin(t * self.speed))
            quad = base + off
            if self.deformation:
                quad = quad.copy()
                quad[1:3, 1] += int(h / 20 * math.cos(t))
            cv2.fillConvexPoly(img, quad.astype(np.int32), (0, 0, 255))
        self.time += self.time_step
        return img


# ---------------------------------------------------------------------------
# VideoCapture-compatible synthetic sources (data/video.py:40-161)
# ---------------------------------------------------------------------------

class SynthCapture:
    """Base procedural capture: optional background image, gaussian noise."""

    def __init__(self, size=None, noise=0.0, bg=None, **params):
        import cv2

        self.frame_size = (640, 480)
        self.bg = None
        if bg is not None:
            self.bg = cv2.imread(bg, 1)
            if self.bg is not None:
                h, w = self.bg.shape[:2]
                self.frame_size = (w, h)
        if size is not None:
            w, h = map(int, str(size).split("x"))
            self.frame_size = (w, h)
            if self.bg is not None:
                self.bg = cv2.resize(self.bg, self.frame_size)
        self.noise = float(noise)
        self._frame_idx = 0

    def render(self, dst: np.ndarray) -> None:  # pragma: no cover - base
        pass

    def _noise(self, buf: np.ndarray) -> np.ndarray:
        if self.noise <= 0.0:
            return buf
        rng = np.random.default_rng(self._frame_idx)
        n = rng.normal(0.0, 255.0 * self.noise, buf.shape)
        return np.clip(buf.astype(np.float32) + n, 0, 255).astype(np.uint8)

    def read(self, dst=None):
        w, h = self.frame_size
        buf = (
            np.zeros((h, w, 3), np.uint8) if self.bg is None else self.bg.copy()
        )
        self.render(buf)
        self._frame_idx += 1
        return True, self._noise(buf)

    def isOpened(self) -> bool:
        return True

    def set(self, prop, value) -> None:
        """cv2.CAP_PROP_POS_FRAMES seek support (dataprepare's getImg
        calls cam.set(1, frame))."""
        if int(prop) == 1:
            self._seek(int(value))

    def _seek(self, frame: int) -> None:
        self._frame_idx = frame

    def get(self, prop):
        if int(prop) == 7:  # CAP_PROP_FRAME_COUNT: endless synth
            return float(10 ** 9)
        return 0.0

    def release(self) -> None:
        pass


class Chess(SynthCapture):
    """Orbiting-camera 3-D chessboard (reference data/video.py:104-150)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        w, h = self.frame_size
        sx, sy = 10, 7
        self.grid_size = (sx, sy)
        white, black = [], []
        for i in range(sy):
            for j in range(sx):
                q = [[j, i, 0], [j + 1, i, 0], [j + 1, i + 1, 0], [j, i + 1, 0]]
                (white if (i + j) % 2 == 0 else black).append(q)
        self.white_quads = np.float32(white)
        self.black_quads = np.float32(black)
        fx = 0.9
        self.K = np.float64(
            [[fx * w, 0, 0.5 * (w - 1)], [0, fx * w, 0.5 * (h - 1)], [0, 0, 1]]
        )
        self.dist_coef = np.float64([-0.2, 0.1, 0, 0])
        self.t = 0.0

    def _seek(self, frame: int) -> None:
        self._frame_idx = frame
        self.t = frame / 30.0

    def _draw_quads(self, img, quads, color) -> None:
        import cv2

        pts = cv2.projectPoints(
            quads.reshape(-1, 3), self.rvec, self.tvec, self.K, self.dist_coef
        )[0].reshape(quads.shape[:2] + (2,))
        for q in pts:
            cv2.fillConvexPoly(img, np.int32(q * 4), color, cv2.LINE_AA, shift=2)

    def render(self, dst: np.ndarray) -> None:
        t = self.t
        self.t += 1.0 / 30.0
        sx, sy = self.grid_size
        center = np.array([0.5 * sx, 0.5 * sy, 0.0])
        phi = math.pi / 3 + math.sin(t * 3) * math.pi / 8
        c, s = math.cos(phi), math.sin(phi)
        ofs = np.array([math.sin(1.2 * t), math.cos(1.8 * t), 0]) * sx * 0.2
        eye = center + np.array([math.cos(t) * c, math.sin(t) * c, s]) * 15.0 + ofs
        R, self.tvec = lookat(eye, center + ofs)
        self.rvec = mtx2rvec(R)
        self._draw_quads(dst, self.white_quads, (245, 245, 245))
        self._draw_quads(dst, self.black_quads, (10, 10, 10))


class Book(SynthCapture):
    """Moving textured foreground over a static background."""

    def __init__(self, **kw):
        super().__init__(**kw)
        w, h = self.frame_size
        fg = _procedural_fg(max(min(w, h) // 3, 4))
        self._scene = SceneRender(_procedural_bg(w, h), fg, speed=1)

    def _seek(self, frame: int) -> None:
        self._frame_idx = frame
        self._scene.time = frame * self._scene.time_step

    def read(self, dst=None):
        self._frame_idx += 1
        return True, self._noise(self._scene.next_frame())


class Cube(SynthCapture):
    """Deforming quad over a static background."""

    def __init__(self, **kw):
        super().__init__(**kw)
        w, h = self.frame_size
        self._scene = SceneRender(_procedural_bg(w, h, seed=3),
                                  deformation=True, speed=1)

    def _seek(self, frame: int) -> None:
        self._frame_idx = frame
        self._scene.time = frame * self._scene.time_step

    def read(self, dst=None):
        self._frame_idx += 1
        return True, self._noise(self._scene.next_frame())


SYNTH_CLASSES = {"chess": Chess, "book": Book, "cube": Cube}

DEFAULT_FALLBACK = "synth:class=chess:noise=0.1:size=640x480"


def create_capture(source=0, fallback: Optional[str] = DEFAULT_FALLBACK):
    """Open a capture from ``<int> | <filename> | synth[:k=v[:...]]``,
    falling back to procedural video when the source can't be opened
    (reference data/video.py:172-206)."""
    import cv2

    source = str(source).strip()
    chunks = source.split(":")
    if len(chunks) > 1 and len(chunks[0]) == 1 and chunks[0].isalpha():
        # windows drive letters ("c:...")
        chunks[1] = chunks[0] + ":" + chunks[1]
        del chunks[0]
    src = chunks[0]
    try:
        src = int(src)
    except ValueError:
        pass
    # Spec-grammar params (key=value chunks) are only meaningful for a
    # synth spec, a camera index, or a local file — for anything else
    # (rtsp://host/live?token=abc, http URLs) a chunk can contain '=' by
    # coincidence, so the whole string is the capture source.
    spec_like = (
        src == "synth" or isinstance(src, int) or os.path.exists(chunks[0])
    )
    if not spec_like:
        src, params = source, {}
    else:
        try:
            params = dict(s.split("=") for s in chunks[1:])
        except ValueError:
            if src == "synth":
                # the user clearly meant spec grammar — surface the typo
                # instead of silently handing back the default fallback
                raise ValueError(f"malformed synth spec {source!r} "
                                 "(expected synth:key=value:...)") from None
            src, params = source, {}

    cap = None
    if src == "synth":
        cls = SYNTH_CLASSES.get(params.get("class"), SynthCapture)
        try:
            cap = cls(**params)
        except Exception:
            cap = None
    else:
        cap = cv2.VideoCapture(src)
        if "size" in params:
            w, h = map(int, params["size"].split("x"))
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, w)
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, h)
    if cap is None or not cap.isOpened():
        print("Warning: unable to open video source:", source)
        if fallback is not None:
            return create_capture(fallback, None)
    return cap
