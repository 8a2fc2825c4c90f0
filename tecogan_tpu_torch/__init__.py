"""PyTorch / CUDA port of the TecoGAN recurrent 4x VSR serving path.

Mirrors the module layout of ``tecogan_tpu`` (the JAX reference, which
stays as it is): ``ops`` (image range maps, space-to-depth, resize, warp),
``models`` (layers, generator), ``engine`` (state, inference, the fused
s2d-carry route), ``utils`` (checkpoint loader, weight bridge, FLOP count)
and ``ops/kernels`` with the hand-written CUDA kernel for Hopper.

The package imports ``torch`` and never ``jax``: the only module it shares
with the JAX package is ``tecogan_tpu.config`` (argparse and dataclasses
only).  Public functions keep the JAX package's NHWC layout; inside, the
port runs NCHW tensors in ``torch.channels_last``, whose memory is NHWC,
so the permutes at the boundaries copy nothing.
"""
