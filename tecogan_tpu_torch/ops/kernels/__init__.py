"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``), each
beside its plain PyTorch version.

Importing this package registers the kernels as ``torch.library`` custom
ops in the ``tecogan_tpu_torch`` namespace (``conv_out_s2d``,
``warp_s2d_feedback``, ``int8_conv3x3``, ``int8_up2x``, ``bf16_conv3x3``,
``bf16_up2x``, and TecoGAN as published's ``flow_warp_s2d`` and
``conv_out_bicubic_s2d``): a CUDA tensor launches the kernel, a CPU tensor runs the
plain version.  Nothing is compiled until a kernel's first launch.  A program exported with
``torch.export`` that calls them loads after this import."""

from . import (bf16_conv, conv_out_bicubic_s2d, conv_out_s2d, flow_warp_s2d,  # noqa: F401
               int8_conv, warp_s2d)  # (importing them registers the ops)
