"""PyTorch / CUDA port of the TecoGAN recurrent 4x VSR serving path.

Mirrors the module layout of ``tecogan_tpu`` (the JAX reference, which
stays as it is): ``ops`` (image range maps, space-to-depth, resize, warp),
``models`` (layers, generator), ``engine`` (state, inference, the fused
s2d-carry route), ``utils`` (checkpoint loader, weight bridge, FLOP count)
and ``ops/kernels`` with the hand-written CUDA kernels for Hopper.

The package imports ``torch`` and never ``jax``, nor anything of the JAX
package: ``config.py`` is its own copy of ``TecoConfig``.  Public
functions keep the JAX package's NHWC layout; inside, the
port runs NCHW tensors in ``torch.channels_last``, whose memory is NHWC,
so the permutes at the boundaries copy nothing.
"""
