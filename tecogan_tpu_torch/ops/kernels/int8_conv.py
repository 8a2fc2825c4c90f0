"""int8 (W8A8) convolutions of the generator tail: the CUDA kernels and
their plain PyTorch versions.

Replace the XLA s8 x s8 -> s32 convs of the JAX package's quantized tail
(``tecogan_tpu/engine/quant.py::tail_features_int8``), for which PyTorch
has no CUDA op.  The kernel source is ``tecogan_tpu_torch/csrc/int8_conv.cu``;
its header says what bounds it and how it is laid out.  ``_build.load``
compiles it at first use; its plain C entry points are bound with
``ctypes``.

Each function computes one whole JAX layer of that tail, NHWC:

1. ``xq = clamp(round(x.float() * inv_s), -127, 127)``;
2. the integer conv of ``xq`` with ``wq``, exact;
3. ``y.float() * deq``, ``+ bias``, cast to ``x``'s dtype;
4. optionally ReLU, then optionally ``+ residual`` in that dtype.

``wq`` is ``(Cout, 3, 3, Cin)`` int8 (the JAX HWIO kernel with the output
channel first).  ``int8_conv3x3`` is the 3x3 SAME conv; ``int8_up2x`` is
JAX's lhs-dilated conv (dilation 2, padding (1, 2)) on that kernel, the
2x transposed conv: ``(B, H, W, Cin) -> (B, 2H, 2W, Cout)``.

The plain versions do the integer conv in float64 as a sum of one matrix
product a tap: every partial sum is an integer below 2**53, so it is exact
whatever the order (float32 is not: at 128 -> 128 a sum reaches
127**2 * 1152 > 2**24).  The kernels take ``x`` (and the residual) in
bf16, the served route, or in float32, the fp32 route, and return that
dtype, bit-equal to the plain version.  Each launch is one persistent
block an SM that holds the layer's weights in shared memory and computes
all Cout channels of its tiles with ``wgmma``; the source's header gives
the design and its shared-memory budget for each (Cin, Cout).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import CSRC, load

SOURCE = CSRC / "int8_conv.cu"
CHANNELS = (64, 128)
DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches, one count a kernel; only the CUDA wrappers add to them,
# callers reset them to 0.
conv3x3_launch_count = 0
up2x_launch_count = 0

_lib = None
_ready_devices: set = set()  # devices whose shared memory limit is raised


def quantize(x: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """``clamp(round(x * inv_s), -127, 127)`` in float32 from x's float32
    value (round half to even, as ``jnp.round``), as int8."""
    return torch.clamp(torch.round(x.float() * inv_s), -127.0, 127.0).to(torch.int8)


def _tap_sums(xp: torch.Tensor, wq: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """sum over the 3x3 taps (u, v) of ``xp[:, u:u+H, v:v+W] @ wq[:, u, v].T``
    in float64: the exact integer sums, (B, H, W, Cout)."""
    w = wq.to(torch.float64)
    y = None
    for u in range(3):
        for v in range(3):
            t = xp[:, u:u + H, v:v + W, :] @ w[:, u, v, :].T
            y = t if y is None else y + t
    return y


def int8_conv3x3_sums(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The 3x3 SAME integer conv: xq (B, H, W, Cin) int8, wq (Cout, 3, 3,
    Cin) int8 -> (B, H, W, Cout) int32, exact."""
    B, H, W, _ = xq.shape
    xp = F.pad(xq.to(torch.float64), (0, 0, 1, 1, 1, 1))
    return _tap_sums(xp, wq, H, W).to(torch.int32)


def int8_up2x_sums(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """JAX's lhs-dilated integer conv (dilation 2, padding (1, 2) on both
    axes): xq (B, H, W, Cin) int8 -> (B, 2H, 2W, Cout) int32, exact.  The
    dilated input is written out with its zeros."""
    B, H, W, C = xq.shape
    xd = torch.zeros((B, 2 * H - 1, 2 * W - 1, C), dtype=torch.float64, device=xq.device)
    xd[:, ::2, ::2] = xq.to(torch.float64)
    xp = F.pad(xd, (0, 0, 1, 2, 1, 2))
    return _tap_sums(xp, wq, 2 * H, 2 * W).to(torch.int32)


def _epilogue(sums: torch.Tensor, dtype: torch.dtype, deq: torch.Tensor,
              bias: Optional[torch.Tensor], relu: bool,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
    y = sums.to(torch.float32) * deq
    if bias is not None:
        y = y + bias
    y = y.to(dtype)
    if relu:
        y = F.relu(y)
    if residual is not None:
        y = y + residual
    return y


def int8_conv3x3_reference(x: torch.Tensor, inv_s: torch.Tensor, wq: torch.Tensor,
                           deq: torch.Tensor, bias: Optional[torch.Tensor] = None,
                           relu: bool = False,
                           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of one 3x3 layer: (B, H, W, Cin) -> (B, H, W, Cout)
    in x's dtype."""
    return _epilogue(int8_conv3x3_sums(quantize(x, inv_s), wq), x.dtype, deq, bias,
                     relu, residual)


def int8_up2x_reference(x: torch.Tensor, inv_s: torch.Tensor, wq: torch.Tensor,
                        deq: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        relu: bool = False,
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of one transposed layer: (B, H, W, Cin) -> (B, 2H,
    2W, Cout) in x's dtype."""
    return _epilogue(int8_up2x_sums(quantize(x, inv_s), wq), x.dtype, deq, bias,
                     relu, residual)


def build() -> str:
    """Compile (unless this source's library is already in ``build/``) and
    load the kernels' library.  Returns the compiler's log ('' when the
    library was already built)."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = load(SOURCE)
    lib.int8_conv_init.argtypes = []
    lib.int8_conv_init.restype = ctypes.c_int
    for fn in (lib.int8_conv3x3_launch, lib.int8_up2x_launch):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return log


def _check(x: torch.Tensor, inv_s: torch.Tensor, wq: torch.Tensor, deq: torch.Tensor,
           bias: Optional[torch.Tensor], residual: Optional[torch.Tensor],
           up: bool) -> tuple:
    """Raise on what the kernel does not take; return the output's shape."""
    if x.device.type != "cuda":
        raise ValueError(f"int8 conv kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] not in CHANNELS:
        raise ValueError(f"x must be (B, H, W, 64 or 128), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels_last NCHW)")
    B, H, W, cin = x.shape
    if (wq.dtype != torch.int8 or wq.dim() != 4 or wq.shape[0] not in CHANNELS
            or tuple(wq.shape[1:]) != (3, 3, cin)):
        raise ValueError(f"wq must be (64 or 128, 3, 3, {cin}) int8, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    cout = wq.shape[0]
    out_shape = (B, 2 * H, 2 * W, cout) if up else (B, H, W, cout)
    if inv_s.numel() != 1 or inv_s.dtype != torch.float32:
        raise ValueError(f"inv_s must be one float32, got {tuple(inv_s.shape)} {inv_s.dtype}")
    for name, t in (("deq", deq), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (cout,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({cout},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if residual is not None and (residual.dtype != x.dtype
                                 or tuple(residual.shape) != out_shape):
        raise ValueError(f"residual must be {out_shape} {x.dtype}, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    # x, wq and the residual are read in 16-byte pieces, the rest a value
    # (or two) at a time
    for name, t, align in (("x", x, 16), ("wq", wq, 16), ("inv_s", inv_s, 4),
                           ("deq", deq, 4), ("bias", bias, 4), ("residual", residual, 16)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    return out_shape


def _run(up: bool, x, inv_s, wq, deq, bias, relu, residual) -> torch.Tensor:
    out = torch.empty(_check(x, inv_s, wq, deq, bias, residual, up),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build()
    B, H, W, cin = x.shape
    fn = _lib.int8_up2x_launch if up else _lib.int8_conv3x3_launch
    with torch.cuda.device(x.device):
        if x.device.index not in _ready_devices:
            err = _lib.int8_conv_init()
            if err != 0:
                raise RuntimeError(f"int8_conv init failed with CUDA error {err}")
            _ready_devices.add(x.device.index)
        err = fn(x.data_ptr(), wq.data_ptr(), inv_s.data_ptr(), deq.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 None if residual is None else residual.data_ptr(), out.data_ptr(),
                 B, H, W, cin, wq.shape[0], int(relu), int(x.dtype == torch.float32),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 conv launch failed with CUDA error {err}")
    return out


def int8_conv3x3_cuda(x: torch.Tensor, inv_s: torch.Tensor, wq: torch.Tensor,
                      deq: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      relu: bool = False,
                      residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the 3x3 kernel on the current stream (no synchronise).
    Raises on any input it does not take."""
    global conv3x3_launch_count
    out = _run(False, x, inv_s, wq, deq, bias, relu, residual)
    if out.numel():
        conv3x3_launch_count += 1
    return out


def int8_up2x_cuda(x: torch.Tensor, inv_s: torch.Tensor, wq: torch.Tensor,
                   deq: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   relu: bool = False,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the transposed-conv kernel on the current stream (no
    synchronise).  Raises on any input it does not take."""
    global up2x_launch_count
    out = _run(True, x, inv_s, wq, deq, bias, relu, residual)
    if out.numel():
        up2x_launch_count += 1
    return out
