"""bf16 convolutions of the generator tail with the bias, ReLU and residual
add fused: the CUDA kernels and their plain PyTorch versions.

They replace, on the bf16 serving route, cuDNN's conv of each tail layer
and the separate passes after it (the bias add, the ReLU clamp, the skip
add), which stand in for the XLA convs of the JAX package's
``Generator.tail_features`` (``tecogan_tpu/models/generator.py``).  The
kernel source is ``tecogan_tpu_torch/csrc/bf16_conv.cu``; its header says
what bounds it and how it is laid out.  ``_build.load`` compiles it at
first use; its plain C entry points are bound with ``ctypes``.

Each function computes one whole layer, NHWC, as the module's chain of
torch ops does it:

1. the conv of ``x`` with ``w`` (bf16 operands, f32 sums, rounded to bf16);
2. ``+ bias`` in bf16 (when given);
3. ``F.relu`` (when ``relu``), then ``+ residual`` in bf16 (when given).

``w`` is ``(Cout, 3, 3, Cin)`` bf16, the kernel the layer convolves with
(for the transposed conv the spatially flipped ``ConvTranspose2d``
weight: ``engine.quant.forward_kernel``, the int8 tail's layout too).
``bf16_conv3x3`` is the 3x3 SAME conv; ``bf16_up2x`` the 2x transposed conv
(``ConvTranspose2d(k3, s2, p1, output_padding=1)``): ``(B, H, W, Cin) ->
(B, 2H, 2W, Cout)``.

The plain versions are that chain of torch ops on the module's weight
layout (``F.conv2d`` or ``F.conv_transpose2d`` with the bias, ``F.relu``,
``+ residual``), so a CPU tensor computes exactly what the module does.
The kernels take Cin and Cout in {64, 128} and differ from cuDNN's conv
followed by torch's adds only in the order of the f32 sum.

Both functions are ``torch.library`` operators,
``tecogan_tpu_torch::bf16_conv3x3`` and ``::bf16_up2x`` (:data:`bf16_conv3x3`,
:data:`bf16_up2x`): on CUDA tensors the kernels (or an error), on CPU
tensors the plain versions; their fakes give the contiguous output
without touching data.  Importing the module registers them; nothing is
built.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import CSRC, load
from ._library import register

SOURCE = CSRC / "bf16_conv.cu"
CHANNELS = (64, 128)

# Kernel launches, one count a kernel; only the CUDA wrappers add to them,
# callers reset them to 0.
conv3x3_launch_count = 0
up2x_launch_count = 0

_lib = None
_ready_devices: set = set()  # devices whose shared memory limit is raised


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """The kernel's ``(Cout, 3, 3, Cin)`` weight -> ``nn.Conv2d``'s OIHW, a
    channels_last view (the layout the serving generator holds)."""
    return w.permute(0, 3, 1, 2)


def conv_transpose_weight(w: torch.Tensor) -> torch.Tensor:
    """The kernel's ``(Cout, 3, 3, Cin)`` forward kernel -> the
    ``ConvTranspose2d`` weight ``(Cin, Cout, 3, 3)`` it flips, channels_last."""
    return w.permute(3, 0, 1, 2).flip(2, 3).contiguous(memory_format=torch.channels_last)


def _epilogue(y: torch.Tensor, relu: bool, residual: Optional[torch.Tensor]) -> torch.Tensor:
    y = y.permute(0, 2, 3, 1)
    if relu:
        y = F.relu(y)
    if residual is not None:
        y = y + residual
    return y


def bf16_conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, relu: bool = False,
                           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of one 3x3 layer: (B, H, W, Cin) -> (B, H, W, Cout)."""
    return _epilogue(F.conv2d(x.permute(0, 3, 1, 2), conv_weight(w), bias, padding=1),
                     relu, residual)


def bf16_up2x_reference(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, relu: bool = False,
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of one transposed layer: (B, H, W, Cin) -> (B, 2H, 2W,
    Cout)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv_transpose_weight(w), bias, stride=2,
                           padding=1, output_padding=1)
    return _epilogue(y, relu, residual)


def build() -> str:
    """Compile (unless this source's library is already in ``build/``) and
    load the kernels' library.  Returns the compiler's log ('' when the
    library was already built)."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = load(SOURCE)
    lib.bf16_conv_init.argtypes = []
    lib.bf16_conv_init.restype = ctypes.c_int
    for fn in (lib.bf16_conv3x3_launch, lib.bf16_up2x_launch):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return log


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           residual: Optional[torch.Tensor], up: bool) -> tuple:
    """Raise on what the kernel does not take; return the output's shape."""
    if x.device.type != "cuda":
        raise ValueError(f"bf16 conv kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] not in CHANNELS:
        raise ValueError(f"x must be (B, H, W, 64 or 128), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels_last NCHW)")
    B, H, W, cin = x.shape
    if (w.dtype != torch.bfloat16 or w.dim() != 4 or w.shape[0] not in CHANNELS
            or tuple(w.shape[1:]) != (3, 3, cin)):
        raise ValueError(f"w must be (64 or 128, 3, 3, {cin}) bfloat16, got "
                         f"{tuple(w.shape)} {w.dtype}")
    cout = w.shape[0]
    out_shape = (B, 2 * H, 2 * W, cout) if up else (B, H, W, cout)
    if bias is not None and (tuple(bias.shape) != (cout,) or bias.dtype != torch.bfloat16):
        raise ValueError(f"bias must be ({cout},) bfloat16, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if residual is not None and (residual.dtype != torch.bfloat16
                                 or tuple(residual.shape) != out_shape):
        raise ValueError(f"residual must be {out_shape} bfloat16, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    # x, w and the residual are read in 16-byte pieces, the bias a value at
    # a time
    for name, t, align in (("x", x, 16), ("w", w, 16), ("bias", bias, 2),
                           ("residual", residual, 16)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    return out_shape


def _run(up: bool, x, w, bias, relu, residual) -> torch.Tensor:
    out = torch.empty(_check(x, w, bias, residual, up), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build()
    B, H, W, cin = x.shape
    fn = _lib.bf16_up2x_launch if up else _lib.bf16_conv3x3_launch
    with torch.cuda.device(x.device):
        if x.device.index not in _ready_devices:
            err = _lib.bf16_conv_init()
            if err != 0:
                raise RuntimeError(f"bf16_conv init failed with CUDA error {err}")
            _ready_devices.add(x.device.index)
        err = fn(x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
                 None if residual is None else residual.data_ptr(), out.data_ptr(),
                 B, H, W, cin, w.shape[0], int(relu), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16 conv launch failed with CUDA error {err}")
    return out


def bf16_conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      relu: bool = False,
                      residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the 3x3 kernel on the current stream (no synchronise).
    Raises on any input it does not take."""
    global conv3x3_launch_count
    out = _run(False, x, w, bias, relu, residual)
    if out.numel():
        conv3x3_launch_count += 1
    return out


def bf16_up2x_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   relu: bool = False,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the transposed-conv kernel on the current stream (no
    synchronise).  Raises on any input it does not take."""
    global up2x_launch_count
    out = _run(True, x, w, bias, relu, residual)
    if out.numel():
        up2x_launch_count += 1
    return out


_SCHEMA = "(Tensor x, Tensor w, Tensor? bias, bool relu, Tensor? residual) -> Tensor"


def _fake(up: bool):
    def fake(x, w, bias, relu, residual):
        B, H, W, _ = x.shape
        s = 2 if up else 1
        return x.new_empty((B, s * H, s * W, w.shape[0]))

    return fake


def _cpu(reference):
    def cpu(x, w, bias, relu, residual):
        return reference(x, w, bias, relu, residual).contiguous()

    return cpu


bf16_conv3x3 = register("bf16_conv3x3", _SCHEMA, bf16_conv3x3_cuda,
                        _cpu(bf16_conv3x3_reference), _fake(False))
bf16_up2x = register("bf16_up2x", _SCHEMA, bf16_up2x_cuda, _cpu(bf16_up2x_reference),
                     _fake(True))
