"""Range maps, the uint8 transfer pair and image / video I/O
(tecogan_tpu/ops/image.py).

Video containers are written with ``cv2.VideoWriter`` as in the JAX
package.  gif, png and jpg are written with PIL the way the JAX package's
``imageio`` calls its pillow plugin (``Image.fromarray`` of each uint8
frame, one ``save`` with the format of the file's extension, the later
frames as ``append_images``), so the files hold the same pixels; the
machine with the card has PIL and ``cv2`` but no ``imageio``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_INV_255 = torch.tensor(1.0 / 255.0, dtype=torch.float32).item()
_FOURCC = {".mp4": "mp4v", ".mov": "mp4v", ".avi": "XVID", ".webm": "VP80",
           ".mkv": "X264"}


def preprocess(image: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1]."""
    return image * 2.0 - 1.0


def deprocess(image: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1]."""
    return (image + 1.0) / 2.0


def transfer_quantize_u8(x) -> np.ndarray:
    """Host half of the ``--transfer_dtype u8`` round trip: float [0,1] ->
    uint8 by ``np.rint(x * 255)``; :func:`transfer_dequantize_f32` is the
    device half."""
    return np.rint(np.asarray(x) * 255.0).astype(np.uint8)


def transfer_dequantize_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 [0,1] as ``x * f32(1/255)``: a multiply by the
    float32 reciprocal, not a division, so the result is bit-identical to
    the JAX package's device half of the u8 transfer round trip."""
    return x.to(torch.float32) * _INV_255


def transfer_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """``clip(x * 255, 0, 255)`` in float32, then a truncating convert to
    uint8: the device half of :func:`to_uint8`, bit-identical to it."""
    x = x.to(torch.float32) * 255.0
    return x.clamp(0.0, 255.0).to(torch.uint8)


def start_host_copy(x: torch.Tensor, side) -> tuple:
    """Start copying the device tensor ``x`` to pinned host memory on the
    stream ``side``, after the work already queued for ``x``; returns
    ``(host, done)``, ``done`` the event to wait on before reading
    ``host``.  A CPU tensor is returned as it is, with no event.  The
    device's next work overlaps the copy."""
    if x.device.type == "cpu":
        return x, None
    done = torch.cuda.Event()
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done.record(side)
    x.record_stream(side)
    return host, done


def to_uint8(frames) -> np.ndarray:
    """float [0,1] -> uint8 numpy by ``* 255`` in float32 then truncation
    (the reference's save_as_gif); uint8 input passes through unchanged.
    Takes numpy arrays and CPU tensors."""
    arr = np.asarray(frames)
    if arr.dtype == np.uint8:
        return arr
    arr = arr.astype(np.float32) * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def _pil_save(path: str, images) -> None:
    """Write uint8 HWC frames as the JAX package's imageio pillow plugin
    does: one frame, or the first with the rest appended."""
    from PIL import Image

    frames = [Image.fromarray(np.asarray(f)) for f in images]
    fmt = Image.registered_extensions()[os.path.splitext(path)[1].lower()]
    args = {"save_all": True, "append_images": frames[1:]} if len(frames) > 1 else {}
    frames[0].save(path, format=fmt, **args)


def save_as_media(frames_thwc, filepath: str, fps: int = 24) -> None:
    """Save a (T, H, W, C) float [0,1] (or uint8) clip as a video container
    (``cv2.VideoWriter``) or, for any other extension, as PIL writes it
    (gif: every frame)."""
    with MediaWriter(filepath, fps) as w:
        w.append(frames_thwc)


class MediaWriter:
    """Incremental clip writer: append (T, H, W, C) float [0,1] or uint8
    windows.  Video containers encode frames as they arrive (host memory
    O(window)); a gif has no streaming encoder, so its frames are kept
    and written on ``close``."""

    def __init__(self, filepath: str, fps: int = 24):
        self.filepath = filepath
        self.fps = fps
        self._writer = None
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
        self._video = os.path.splitext(filepath)[1].lower() in _FOURCC
        self._frames = None if self._video else []

    def append(self, frames_thwc) -> None:
        images = to_uint8(frames_thwc)
        if not self._video:
            self._frames.extend(list(images))
            return
        import cv2

        if self._writer is None:
            h, w = images.shape[1:3]
            ext = os.path.splitext(self.filepath)[1].lower()
            self._writer = cv2.VideoWriter(self.filepath, cv2.VideoWriter_fourcc(*_FOURCC[ext]),
                                           self.fps, (w, h))
            if not self._writer.isOpened():
                raise IOError(f"cv2.VideoWriter could not open {self.filepath}")
        for frame in images:
            self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        elif self._frames:
            _pil_save(self.filepath, self._frames)
        self._frames = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_img(out_path: str, img_hwc) -> None:
    """Save one float [0,1] HWC image (the reference's save_img)."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    _pil_save(out_path, [to_uint8(img_hwc)])


def save_image_grid(images_nhwc, fp: str, ncols: int = 8) -> None:
    """Tiled image grid like torchvision.utils.save_image (main.py:288-294)."""
    images_nhwc = np.asarray(images_nhwc)
    n, h, w, c = images_nhwc.shape
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.zeros((nrows * h, ncols * w, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images_nhwc[i]
    save_img(fp, grid)


def read_gif(path: str) -> np.ndarray:
    """A gif's frames as (T, H, W, 3) uint8, as the JAX package's
    ``imageio.mimread`` decodes them with pillow (palette frames converted
    to their palette's mode)."""
    from PIL import Image, ImageSequence

    frames = []
    with Image.open(path) as im:
        for f in ImageSequence.Iterator(im):
            if f.mode == "P":
                f = f.convert(f.palette.mode)
            frames.append(np.asarray(f)[..., :3])
    return np.stack(frames)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)
