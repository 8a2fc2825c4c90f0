"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the generator's float32 weights (drawn here, in the
shapes its architecture lists) and the LR video.

Everything is drawn on the device with a ``torch.Generator`` in a few
large calls.  Each stream of draws has a seed of its own, derived from
the run's seed and a fixed tag, so the weights do not depend on the
traffic and one clip does not depend on another.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def sub_seed(seed: int, *tag) -> int:
    """A 63-bit seed for the draws named ``tag`` under the run's ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + tag).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *tag) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tag))


def uniform_params(seed: int, shapes: List[Tuple[str, tuple, int]], weight_gain: float,
                   device) -> Dict[str, torch.Tensor]:
    """float32 weights of the (name, shape, input channels) ``shapes``, in
    their order: each tensor uniform in ``(-b, b)`` with ``b = 1 /
    sqrt(9 * C_in)`` (PyTorch's default conv init), the tensors whose name
    ends in ``weight`` times ``weight_gain``.  One draw for all of them."""
    total = sum(torch.Size(s).numel() for _, s, _ in shapes)
    u = torch.rand(total, generator=generator(device, seed, "weights"), device=device)
    u = u * 2.0 - 1.0
    params, pos = {}, 0
    for name, shape, cin in shapes:
        n = torch.Size(shape).numel()
        bound = (9 * cin) ** -0.5 * (weight_gain if name.endswith("weight") else 1.0)
        params[name] = (u[pos:pos + n] * bound).view(shape)
        pos += n
    return params


def _texture(g, h: int, w: int, cells: int, device) -> torch.Tensor:
    """(h, w, 3) float32 in [0, 1]: noise on a grid of ``cells``-pixel
    cells, upscaled bicubically, plus a finer layer of 4-pixel cells."""
    def layer(cell):
        lo = torch.rand((1, 3, h // cell + 3, w // cell + 3), generator=g, device=device)
        return F.interpolate(lo, scale_factor=cell, mode="bicubic",
                             align_corners=False)[0, :, :h, :w]

    tex = 0.7 * layer(cells) + 0.3 * layer(4)
    return tex.clamp(0.0, 1.0).permute(1, 2, 0)


def make_clip(seed: int, tag, frames: int, height: int, width: int,
              max_level: int, device) -> torch.Tensor:
    """A moving scene, (frames, height, width, 3) uint8 in ``[0,
    max_level]`` on ``device``: a textured background panning at a speed
    drawn per clip (up to 2 px a frame each way), a textured rectangle of
    a fifth of the frame moving on its own straight path and bouncing off
    the edges, and sensor noise of up to 2 levels a pixel."""
    g = generator(device, seed, "clip", tag)
    r = torch.rand(8, generator=g, device=device).cpu()
    vy, vx = (r[0].item() * 4 - 2), (r[1].item() * 4 - 2)
    pad_y, pad_x = int(abs(vy) * frames) + 2, int(abs(vx) * frames) + 2
    bg = _texture(g, height + pad_y, width + pad_x, 32, device)
    oh, ow = height // 5, width // 5
    obj = _texture(g, oh, ow, 8, device)
    t = torch.arange(frames, device=device, dtype=torch.float32)
    # the background's offset at frame t, inside the padded texture
    oy = (t * vy).round().long() + (pad_y - 1 if vy < 0 else 0)
    ox = (t * vx).round().long() + (pad_x - 1 if vx < 0 else 0)
    ys = torch.arange(height, device=device)
    xs = torch.arange(width, device=device)
    video = bg[(oy[:, None] + ys[None, :])[:, :, None], (ox[:, None] + xs[None, :])[:, None, :]]
    # the rectangle: a start and a velocity, reflected off the frame's edges
    span_y, span_x = height - oh, width - ow
    py = (r[2].item() * span_y + t * (r[4].item() * 6 - 3)).remainder(2 * span_y)
    px = (r[3].item() * span_x + t * (r[5].item() * 6 - 3)).remainder(2 * span_x)
    py = torch.where(py > span_y, 2 * span_y - py, py).round().long()
    px = torch.where(px > span_x, 2 * span_x - px, px).round().long()
    iy = ys[None, :] - py[:, None]  # (T, H)
    ix = xs[None, :] - px[:, None]  # (T, W)
    inside = ((iy >= 0) & (iy < oh))[:, :, None] & ((ix >= 0) & (ix < ow))[:, None, :]
    patch = obj[iy.clamp(0, oh - 1)[:, :, None], ix.clamp(0, ow - 1)[:, None, :]]
    video = torch.where(inside[..., None], patch, video)
    noise = torch.randint(-2, 3, video.shape, generator=g, device=device,
                          dtype=torch.int16)
    levels = (video * max_level).round() + noise
    return levels.clamp(0, max_level).to(torch.uint8)
