"""The dense flow warp of TecoGAN as published, on the s2d carry: the CUDA
kernel and its plain PyTorch version.

Replaces no Pallas kernel (the JAX package serves no learned flow).  It
computes what the published inference (github.com/thunil/TecoGAN,
``main.py``) runs between FNet and the generator: ``upscale_four(flow *
4)``, ``tf.contrib.image.dense_image_warp`` of the previous SR frame and
the space-to-depth into the 48 feedback channels.  The kernel source is
``tecogan_tpu_torch/csrc/flow_warp_s2d.cu``; its header says what bounds it
and how it is laid out.  ``_build.load`` compiles it at first use; its
plain C entry point is bound with ``ctypes``.

Contract: ``flow`` ``(B, H, W, 2)`` f32 (LR pixels; channel 0 rows,
channel 1 columns) and ``carry`` ``(B, H, W, 48)`` f32 (the s2d SR frame,
channel ``c*16 + a*4 + b``), both contiguous NHWC -> ``(B, H, W, 48)``
bf16 in the carry's channel order, holding the frame warped by the flow:
``w(p) = bilinear(y, clamp(p - f(p)))`` with ``f = upscale_four_tf(flow *
4)``.  No u8 rounding, no deprocess: the published feedback is the
warped frame itself.

The function is the ``torch.library`` operator
``tecogan_tpu_torch::flow_warp_s2d`` (:data:`flow_warp_s2d`): a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version, and
its fake gives the contiguous output.  Importing the module registers the
op; nothing is built.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..resize import upscale_four_tf
from ._build import CSRC, load
from ._library import register

SOURCE = CSRC / "flow_warp_s2d.cu"

# Kernel launches; only the CUDA wrapper adds to it, callers reset it to 0.
launch_count = 0

_lib = None


def _lerp(lo: torch.Tensor, hi: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return alpha * (hi - lo) + lo


def dense_image_warp(frame: torch.Tensor, flow_hr: torch.Tensor) -> torch.Tensor:
    """``tf.contrib.image.dense_image_warp``: NHWC ``frame`` (B, H, W, C) and
    ``flow_hr`` (B, H, W, 2) in pixels -> the frame sampled bilinearly at
    ``(y - flow[..., 0], x - flow[..., 1])``, each coordinate's floor
    clamped to ``[0, size - 2]`` and its fraction to ``[0, 1]``, so that the
    sample position is clamped into the frame; float32."""
    B, H, W, C = frame.shape
    frame = frame.float()
    gy = torch.arange(H, device=frame.device, dtype=torch.float32).view(1, H, 1)
    gx = torch.arange(W, device=frame.device, dtype=torch.float32).view(1, 1, W)
    taps, alphas = [], []
    for q, size in ((gy - flow_hr[..., 0], H), (gx - flow_hr[..., 1], W)):
        fl = torch.floor(q).clamp(0.0, float(size - 2))
        alphas.append((q - fl).clamp(0.0, 1.0).unsqueeze(-1))
        taps.append(fl.long())
    iy, ix = taps
    b = torch.arange(B, device=frame.device).view(B, 1, 1)

    def at(dy: int, dx: int) -> torch.Tensor:
        return frame[b, iy + dy, ix + dx]

    top = _lerp(at(0, 0), at(0, 1), alphas[1])
    bottom = _lerp(at(1, 0), at(1, 1), alphas[1])
    return _lerp(top, bottom, alphas[0])


def flow_warp_s2d_reference(flow: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """Plain version, in float32: the carry unpacked to its frame, the flow
    upscaled (:func:`ops.resize.upscale_four_tf` of ``flow * 4``), the
    frame warped (:func:`dense_image_warp`) and packed back
    (``F.pixel_unshuffle(., 4)``); returned NHWC float32."""
    frame = F.pixel_shuffle(carry.float().permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    warped = dense_image_warp(frame, upscale_four_tf(flow.float() * 4.0))
    return F.pixel_unshuffle(warped.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1).contiguous()


def build() -> str:
    """Compile (unless this source's library is already in ``build/``) and
    load the kernel's library.  Returns the compiler's log ('' when the
    library was already built)."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = load(SOURCE)
    fn = lib.flow_warp_s2d_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return log


def _check(flow: torch.Tensor, carry: torch.Tensor) -> None:
    if carry.device.type != "cuda":
        raise ValueError(f"flow_warp_s2d kernel needs a CUDA tensor, got {carry.device}")
    if carry.dtype != torch.float32:
        raise ValueError(f"carry must be float32, got {carry.dtype}")
    if carry.dim() != 4 or carry.shape[3] != 48:
        raise ValueError(f"carry must be (B, H, W, 48), got {tuple(carry.shape)}")
    B, H, W, _ = carry.shape
    if tuple(flow.shape) != (B, H, W, 2) or flow.dtype != torch.float32:
        raise ValueError(f"flow must be ({B}, {H}, {W}, 2) float32, got "
                         f"{tuple(flow.shape)} {flow.dtype}")
    if B > 65535 or H > 65535:
        raise ValueError(f"carry {tuple(carry.shape)} exceeds the launch grid")
    for name, t in (("flow", flow), ("carry", carry)):
        if t.device != carry.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous NHWC on {carry.device}")
    if carry.data_ptr() % 16 or flow.data_ptr() % 8:
        raise ValueError("carry must be 16-byte and flow 8-byte aligned")


def flow_warp_s2d_cuda(flow: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).
    Raises on any input it does not take."""
    global launch_count
    _check(flow, carry)
    B, H, W, _ = carry.shape
    out = torch.empty(carry.shape, dtype=torch.bfloat16, device=carry.device)
    if out.numel() == 0:
        return out
    build()
    with torch.cuda.device(carry.device):
        err = _lib.flow_warp_s2d_launch(flow.data_ptr(), carry.data_ptr(), out.data_ptr(),
                                        B, H, W, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flow_warp_s2d launch failed with CUDA error {err}")
    launch_count += 1
    return out


def _flow_warp_s2d_cpu(flow: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    return flow_warp_s2d_reference(flow, carry).to(torch.bfloat16)


def _flow_warp_s2d_fake(flow, carry):
    return carry.new_empty(carry.shape, dtype=torch.bfloat16)


flow_warp_s2d = register("flow_warp_s2d", "(Tensor flow, Tensor carry) -> Tensor",
                         flow_warp_s2d_cuda, _flow_warp_s2d_cpu, _flow_warp_s2d_fake)
