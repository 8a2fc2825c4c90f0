"""Port parity, conv_out_s2d: the plain PyTorch version of the CUDA kernel
against the JAX direct chain and both Pallas kernels (interpret mode, as
tests/test_fused.py runs them), and the dispatch rules around the kernel.

The kernel itself runs only on the card: its tests are in
tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.engine.fused import conv_out_s2d as j_conv_out_s2d
from tecogan_tpu.ops.pallas.conv_out_s2d import (
    conv_out_s2d_pallas, conv_out_s2d_pallas_paired)
from tecogan_tpu_torch.engine.fused import conv_out_s2d
from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod

# fp32: the same 576-term dot products per output, summed in another
# order, then a sigmoid (slope <= 1/4).
TOL = 1e-5

SHAPES = [(1, 48, 64, 64), (2, 36, 32, 64), (1, 96, 128, 64), (2, 24, 40, 64)]


def _cases():
    for shape in SHAPES:
        h = shape[1] // 4
        yield pytest.param(shape, "direct", id=f"{shape}-direct")
        if h % 2 == 0:
            yield pytest.param(shape, "paired", id=f"{shape}-paired")
        if h % 3 == 0:
            yield pytest.param(shape, "rv", id=f"{shape}-rv")


def _inputs(rng, shape):
    feat = rng.random(shape, np.float32)
    k = rng.normal(0, 0.1, (3, 3, 64, 3)).astype(np.float32)
    b = rng.normal(0, 0.1, (3,)).astype(np.float32)
    return feat, k, b


@pytest.mark.parametrize("shape,impl", list(_cases()))
def test_reference_matches_jax(rng, shape, impl):
    feat, k, b = _inputs(rng, shape)
    jf, jk, jb = jnp.asarray(feat), jnp.asarray(k), jnp.asarray(b)
    if impl == "direct":
        ref = j_conv_out_s2d(jf, jk, jb, out_dtype=jnp.float32, impl="direct")
    elif impl == "paired":
        ref = conv_out_s2d_pallas_paired(jf, jk, jb, out_dtype=jnp.float32,
                                         interpret=True)
    else:
        ref = conv_out_s2d_pallas(jf, jk, jb, out_dtype=jnp.float32,
                                  interpret=True)
    got = kmod.conv_out_s2d_reference(torch.from_numpy(feat),
                                      torch.from_numpy(k), torch.from_numpy(b))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_cpu_dispatch_takes_the_plain_version(rng):
    feat, k, b = _inputs(rng, (1, 8, 12, 64))
    args = (torch.from_numpy(feat), torch.from_numpy(k), torch.from_numpy(b))
    kmod.launch_count = 0
    got = conv_out_s2d(*args)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 2, 3, 48)
    torch.testing.assert_close(got, kmod.conv_out_s2d_reference(*args).bfloat16(),
                               rtol=0, atol=0)
    assert kmod.launch_count == 0


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """No silent fallback: the wrapper raises on a tensor it cannot launch
    on, before building or counting anything."""
    feat, k, b = _inputs(rng, (1, 8, 8, 64))
    kmod.launch_count = 0
    with pytest.raises(ValueError, match="CUDA"):
        kmod.conv_out_s2d_cuda(torch.from_numpy(feat).bfloat16(),
                               torch.from_numpy(k), torch.from_numpy(b))
    assert kmod.launch_count == 0
