"""conv_out + bias + sigmoid + space-to-depth: the CUDA kernel and its
plain PyTorch version.

Replaces the TPU Pallas kernels ``conv_out_s2d_pallas_paired`` and
``conv_out_s2d_pallas`` (tecogan_tpu/ops/pallas/conv_out_s2d.py).  The
kernel source is ``tecogan_tpu_torch/csrc/conv_out_s2d.cu``; its header
says what bounds it and how it is laid out.  ``_build.load`` compiles it
at first use; its plain C entry points are bound with ``ctypes``.

Contract: ``feat`` ``(B, 4H, 4W, 64)`` contiguous NHWC, ``kernel``
``(3, 3, 64, 3)`` f32 HWIO, ``bias`` ``(3,)`` f32 -> ``(B, H, W, 48)``
bf16 with channel ``c*16 + a*4 + b`` holding sigmoid(conv)[4i+a, 4j+b, c].
``feat`` in bf16 (the served route) takes the tensor-core kernel, which
rounds the weights to bf16 as the JAX route does; in float32 (the fp32
route, a precision reference) a kernel of f32 FMAs on the f32 weights.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import CSRC, load

SOURCE = CSRC / "conv_out_s2d.cu"

# Kernel launches; only the CUDA wrapper adds to it, callers reset it to 0.
launch_count = 0

_lib = None
_ready_devices: set = set()  # devices whose shared memory limit is raised


def conv_out_s2d_reference(feat: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Plain version, in ``feat``'s dtype: ``F.conv2d`` (padding 1) +
    bias, sigmoid, ``F.pixel_unshuffle(., 4)``, returned NHWC."""
    x = feat.permute(0, 3, 1, 2)
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)  # HWIO -> OIHW
    y = torch.sigmoid(F.conv2d(x, w, bias.to(x.dtype), padding=1))
    return F.pixel_unshuffle(y, 4).permute(0, 2, 3, 1)


def build() -> str:
    """Compile (unless this source's library is already in ``build/``) and
    load the kernel's library.  Returns the compiler's log ('' when the
    library was already built)."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = load(SOURCE)
    lib.conv_out_s2d_init.argtypes = []
    lib.conv_out_s2d_init.restype = ctypes.c_int
    fn = lib.conv_out_s2d_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return log


def _check(feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> None:
    if feat.device.type != "cuda":
        raise ValueError(f"conv_out_s2d kernel needs a CUDA tensor, got {feat.device}")
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"feat must be bfloat16 or float32, got {feat.dtype}")
    if feat.dim() != 4 or feat.shape[3] != 64 or feat.shape[1] % 4 or feat.shape[2] % 4:
        raise ValueError(f"feat must be (B, 4H, 4W, 64), got {tuple(feat.shape)}")
    # grid rows: bands of 17 LR rows (bf16), one LR row a block (f32)
    rows = -(-feat.shape[1] // 4 // (17 if feat.dtype == torch.bfloat16 else 1))
    if feat.shape[0] > 65535 or rows > 65535:
        raise ValueError(f"feat {tuple(feat.shape)} exceeds the launch grid")
    if not feat.is_contiguous():
        raise ValueError("feat must be contiguous NHWC (channels_last NCHW)")
    if tuple(kernel.shape) != (3, 3, 64, 3) or kernel.dtype != torch.float32:
        raise ValueError(f"kernel must be (3, 3, 64, 3) float32, got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    if tuple(bias.shape) != (3,) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be (3,) float32, got {tuple(bias.shape)} {bias.dtype}")
    for name, t in (("feat", feat), ("kernel", kernel), ("bias", bias)):
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {feat.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def conv_out_s2d_cuda(feat: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).
    Raises on any input it does not take."""
    global launch_count
    _check(feat, kernel, bias)
    B, H4, W4, _ = feat.shape
    H, W = H4 // 4, W4 // 4
    out = torch.empty((B, H, W, 48), dtype=torch.bfloat16, device=feat.device)
    if out.numel() == 0:
        return out
    build()
    with torch.cuda.device(feat.device):
        if feat.device.index not in _ready_devices:
            err = _lib.conv_out_s2d_init()
            if err != 0:
                raise RuntimeError(f"conv_out_s2d init failed with CUDA error {err}")
            _ready_devices.add(feat.device.index)
        err = _lib.conv_out_s2d_launch(
            feat.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, H, W, int(feat.dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_out_s2d launch failed with CUDA error {err}")
    launch_count += 1
    return out
