"""conv_out + bias + TecoGAN's bicubic 4x skip + space-to-depth: the CUDA
kernel and its plain PyTorch version, the output layer of TecoGAN as
published (github.com/thunil/TecoGAN, ``lib/frvsr.py``'s ``generator_F``).

Replaces no Pallas kernel.  The kernel source is
``tecogan_tpu_torch/csrc/conv_out_bicubic_s2d.cu`` (``conv_out_s2d.cu``'s
bf16 kernel with the skip in the epilogue in place of the sigmoid); its
header says what bounds it.  ``_build.load`` compiles it at first use;
its plain C entry points are bound with ``ctypes``.

Contract: ``feat`` ``(B, 4H, 4W, 64)`` bf16 contiguous NHWC, ``kernel``
``(3, 3, 64, 3)`` f32 HWIO, ``bias`` ``(3,)`` f32, ``lr`` ``(B, H, W, 3)``
f32 -> ``(B, H, W, 48)`` f32 with channel ``c*16 + a*4 + b`` holding
``(conv(feat) + bias + bicubic_four(lr))[4i+a, 4j+b, c]``, f32 sums, not
clamped.  The kernel rounds the weights to bf16.

The function is the ``torch.library`` operator
``tecogan_tpu_torch::conv_out_bicubic_s2d`` (:data:`conv_out_bicubic_s2d`):
on CUDA tensors the kernel (or an error; it takes bf16 features only), on
CPU tensors the plain version, and its fake gives the contiguous output.
Importing the module registers the op; nothing is built.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..resize import bicubic_four
from ._build import CSRC, load
from ._library import register

SOURCE = CSRC / "conv_out_bicubic_s2d.cu"

# Kernel launches; only the CUDA wrapper adds to it, callers reset it to 0.
launch_count = 0

_lib = None
_ready_devices: set = set()  # devices whose shared memory limit is raised


def conv_out_bicubic_s2d_reference(feat: torch.Tensor, kernel: torch.Tensor,
                                   bias: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """Plain version, in float32: ``F.conv2d`` (padding 1) of ``feat`` with
    the weights rounded to ``feat``'s dtype, the bias, ``+
    bicubic_four(lr)``, ``F.pixel_unshuffle(., 4)``; returned NHWC float32."""
    x = feat.permute(0, 3, 1, 2).float()
    w = kernel.permute(3, 2, 0, 1).to(feat.dtype).float()  # HWIO -> OIHW
    y = F.conv2d(x, w, bias.float(), padding=1)
    y = y + bicubic_four(lr).permute(0, 3, 1, 2)
    return F.pixel_unshuffle(y, 4).permute(0, 2, 3, 1).contiguous()


def build() -> str:
    """Compile (unless this source's library is already in ``build/``) and
    load the kernel's library.  Returns the compiler's log ('' when the
    library was already built)."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = load(SOURCE)
    lib.conv_out_bicubic_s2d_init.argtypes = []
    lib.conv_out_bicubic_s2d_init.restype = ctypes.c_int
    fn = lib.conv_out_bicubic_s2d_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return log


def _check(feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           lr: torch.Tensor) -> None:
    if feat.device.type != "cuda":
        raise ValueError(f"conv_out_bicubic_s2d kernel needs a CUDA tensor, got {feat.device}")
    if feat.dtype != torch.bfloat16:
        raise ValueError(f"feat must be bfloat16, got {feat.dtype}")
    if feat.dim() != 4 or feat.shape[3] != 64 or feat.shape[1] % 4 or feat.shape[2] % 4:
        raise ValueError(f"feat must be (B, 4H, 4W, 64), got {tuple(feat.shape)}")
    B, H4, W4, _ = feat.shape
    if B > 65535 or -(-H4 // 4 // 17) > 65535:  # grid rows: bands of 17 LR rows
        raise ValueError(f"feat {tuple(feat.shape)} exceeds the launch grid")
    if tuple(kernel.shape) != (3, 3, 64, 3) or kernel.dtype != torch.float32:
        raise ValueError(f"kernel must be (3, 3, 64, 3) float32, got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    if tuple(bias.shape) != (3,) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be (3,) float32, got {tuple(bias.shape)} {bias.dtype}")
    if tuple(lr.shape) != (B, H4 // 4, W4 // 4, 3) or lr.dtype != torch.float32:
        raise ValueError(f"lr must be ({B}, {H4 // 4}, {W4 // 4}, 3) float32, got "
                         f"{tuple(lr.shape)} {lr.dtype}")
    for name, t, align in (("feat", feat, 16), ("kernel", kernel, 16), ("bias", bias, 16),
                           ("lr", lr, 4)):
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {feat.device}")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def conv_out_bicubic_s2d_cuda(feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                              lr: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).
    Raises on any input it does not take."""
    global launch_count
    _check(feat, kernel, bias, lr)
    B, H4, W4, _ = feat.shape
    H, W = H4 // 4, W4 // 4
    out = torch.empty((B, H, W, 48), dtype=torch.float32, device=feat.device)
    if out.numel() == 0:
        return out
    build()
    with torch.cuda.device(feat.device):
        if feat.device.index not in _ready_devices:
            err = _lib.conv_out_bicubic_s2d_init()
            if err != 0:
                raise RuntimeError(f"conv_out_bicubic_s2d init failed with CUDA error {err}")
            _ready_devices.add(feat.device.index)
        err = _lib.conv_out_bicubic_s2d_launch(
            feat.data_ptr(), kernel.data_ptr(), bias.data_ptr(), lr.data_ptr(),
            out.data_ptr(), B, H, W, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_out_bicubic_s2d launch failed with CUDA error {err}")
    launch_count += 1
    return out


def _conv_out_bicubic_s2d_cpu(feat, kernel, bias, lr):
    return conv_out_bicubic_s2d_reference(feat, kernel, bias, lr)


def _conv_out_bicubic_s2d_fake(feat, kernel, bias, lr):
    B, H4, W4, _ = feat.shape
    return feat.new_empty((B, H4 // 4, W4 // 4, 48), dtype=torch.float32)


conv_out_bicubic_s2d = register(
    "conv_out_bicubic_s2d", "(Tensor feat, Tensor kernel, Tensor bias, Tensor lr) -> Tensor",
    conv_out_bicubic_s2d_cuda, _conv_out_bicubic_s2d_cpu, _conv_out_bicubic_s2d_fake)
