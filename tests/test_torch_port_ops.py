"""Port parity, ops: tecogan_tpu_torch.ops against tecogan_tpu.ops on the
same numpy inputs (CPU, fp32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from tecogan_tpu.ops import image as j_image
from tecogan_tpu.ops import resize as j_resize
from tecogan_tpu.ops import space as j_space
from tecogan_tpu.ops import warp as j_warp
from tecogan_tpu_torch.ops import image, resize, space, warp

# fp32 op parity: the same formula evaluated by two libraries; only the
# order of a few float operations can differ.
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_preprocess_deprocess(rng):
    x = rng.random((2, 5, 7, 3), np.float32) * 2 - 1
    np.testing.assert_allclose(image.deprocess(_t(x)).numpy(),
                               np.asarray(j_image.deprocess(jnp.asarray(x))),
                               atol=TOL)
    np.testing.assert_allclose(image.preprocess(_t(x)).numpy(),
                               np.asarray(j_image.preprocess(jnp.asarray(x))),
                               atol=TOL)


def test_transfer_u8_pair_bit_exact(rng):
    """The u8 transfer pair is a bit-exact contract, so no tolerance."""
    q = rng.integers(0, 256, (2, 4, 6, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        image.transfer_dequantize_f32(_t(q)).numpy(),
        np.asarray(j_image.transfer_dequantize_f32(jnp.asarray(q))))
    # includes out-of-range values so the clip is exercised
    x = rng.random((2, 4, 6, 3), np.float32) * 1.4 - 0.2
    got = image.transfer_to_uint8(_t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_image.transfer_to_uint8(jnp.asarray(x))))
    np.testing.assert_array_equal(got, j_image.to_uint8(x))


def test_space_to_depth_is_pixel_unshuffle(rng):
    """Channel order c*16 + a*4 + b, identical to F.pixel_unshuffle (exact:
    pure data movement)."""
    x = rng.random((2, 8, 12, 3), np.float32)
    got = space.space_to_depth(_t(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_space.space_to_depth(jnp.asarray(x))))
    nchw = np.transpose(x, (0, 3, 1, 2))
    np.testing.assert_array_equal(
        F.pixel_unshuffle(_t(nchw), 4).numpy(),
        np.asarray(j_space.space_to_depth_nchw(jnp.asarray(nchw))))
    np.testing.assert_array_equal(space.depth_to_space(got).numpy(), x)
    np.testing.assert_array_equal(
        space.depth_to_space(got).numpy(),
        np.asarray(j_space.depth_to_space(jnp.asarray(got.numpy()))))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 6, 4)])
def test_upscale_four(rng, shape):
    x = rng.random(shape, np.float32)
    np.testing.assert_allclose(
        resize.upscale_four(_t(x)).numpy(),
        np.asarray(j_resize.upscale_four(jnp.asarray(x), layout="NCHW")),
        atol=TOL)


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-3.0, 5.0)],
                         ids=["in_range", "out_of_range"])
def test_grid_sample(rng, lo, hi):
    img = rng.random((2, 12, 10, 3), np.float32)
    grid = (rng.random((2, 9, 7, 2), np.float32) * (hi - lo) + lo)
    np.testing.assert_allclose(
        warp.grid_sample(_t(img), _t(grid)).numpy(),
        np.asarray(j_warp.grid_sample(jnp.asarray(img), jnp.asarray(grid))),
        atol=TOL)


@pytest.mark.parametrize("parity_half", [False, True])
def test_pseudo_flow_nchw(rng, parity_half):
    lr = rng.random((2, 3, 6, 5), np.float32)
    got = warp.pseudo_flow_nchw(_t(lr), parity_half=parity_half).numpy()
    ref = np.asarray(j_warp.pseudo_flow_nchw(jnp.asarray(lr),
                                             parity_half=parity_half))
    assert got.shape == (2, 24, 20, 2)
    np.testing.assert_allclose(got, ref, atol=TOL)
