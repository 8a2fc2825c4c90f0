"""PyTorch / CUDA port of TecoGAN's recurrent 4x VSR serving path and
its train step.

Mirrors the module layout of ``tecogan_tpu`` (the JAX reference, which
stays as it is): ``ops`` (image range maps, space-to-depth, resize, warp),
``models`` (layers, generator, discriminator), ``engine`` (state and
optimizers, inference, the fused s2d-carry route, losses, the train
step, adaptation), ``data`` (scene folders, synthetic scenes and
captures, the input pipeline), ``utils`` (checkpoints, summaries, the
weight bridge, FLOP counts, GPU timing), ``cli`` (the train / inference
command line, evaluation, the live stream) and ``ops/kernels`` with the
hand-written CUDA kernels for Hopper.

The package imports ``torch`` and never ``jax``, nor anything of the JAX
package: ``config.py`` is its own copy of ``TecoConfig``.  Public
functions keep the JAX package's NHWC layout; inside, the
port runs NCHW tensors in ``torch.channels_last``, whose memory is NHWC,
so the permutes at the boundaries copy nothing.
"""
