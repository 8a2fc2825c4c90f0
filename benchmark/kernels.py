"""The program's hand-written kernels by their names in a device trace
(the CUDA sources' ``__global__`` functions)."""

from __future__ import annotations

import re
from typing import Optional, Tuple

_INT8 = re.compile(r"int8_conv_kernel")
_UP = re.compile(r"int8_conv_kernel\s*<[^>]*\btrue\b|int8_conv_kernelI.*Lb1E")


def which_hand_kernel(name: str) -> Optional[str]:
    """'conv_out_s2d', 'conv_out_s2d_f32', 'warp_s2d', 'int8_conv3x3',
    'int8_up2x', or None for a kernel not written by hand."""
    if "conv_out_s2d_f32_kernel" in name:
        return "conv_out_s2d_f32"
    if "conv_out_s2d_kernel" in name:
        return "conv_out_s2d"
    if "warp_s2d_kernel" in name:
        return "warp_s2d"
    if _INT8.search(name):
        return "int8_up2x" if _UP.search(name) else "int8_conv3x3"
    return None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def hand_kernel_time(trace: dict, kernel: str) -> Tuple[float, int]:
    """(device seconds, launches) of ``kernel`` in the reduced trace."""
    s, n = 0.0, 0
    for name, (sec, count) in trace["kernels"].items():
        if which_hand_kernel(name) == kernel:
            s += sec
            n += count
    return s, n
