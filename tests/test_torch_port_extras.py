"""Port parity, ``ops/extras.py`` (the reference's dead or broken op
stubs, rebuilt) and ``utils/flops.py``'s inference counts, against the
JAX package (CPU): the ops bit-equal (they move or select elements; the
kernel is float64 numpy on both sides), the FLOP counts equal and the MFU
within 1e-12 relative (the same arithmetic against another peak)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.ops import extras as j_extras
from tecogan_tpu.utils import flops as j_flops
from tecogan_tpu_torch.ops import extras
from tecogan_tpu_torch.utils import flops


def test_pixelshuffle_matches_jax(rng):
    for scale in (2, 4):
        x = rng.random((2, 3, 5, 3 * scale * scale), np.float32)
        want = np.asarray(j_extras.pixelshuffle(jnp.asarray(x), scale=scale))
        got = extras.pixelshuffle(torch.from_numpy(x), scale=scale)
        assert tuple(got.shape) == want.shape == (2, 3 * scale, 5 * scale, 3)
        np.testing.assert_array_equal(got.numpy(), want)


def test_phase_shift_matches_jax(rng):
    x = rng.random((2, 4, 6, 8), np.float32)
    shape_1, shape_2 = (2, 4, 6, 2, 4), (2, 8, 24)
    want = np.asarray(j_extras.phase_shift(jnp.asarray(x), 2, shape_1, shape_2))
    got = extras.phase_shift(torch.from_numpy(x), 2, shape_1, shape_2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_flip_batch_matches_jax(rng):
    x = rng.random((4, 3, 5, 6), np.float32)
    decision = np.array([0.1, 0.9, 0.5, 0.49], np.float32)
    want = np.asarray(j_extras.random_flip_batch(jnp.asarray(x), jnp.asarray(decision)))
    got = extras.random_flip_batch(torch.from_numpy(x), torch.from_numpy(decision))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), x[0, :, :, ::-1])
    np.testing.assert_array_equal(got[2].numpy(), x[2])


@pytest.mark.parametrize("decision", [0.2, 0.5, 0.8])
def test_random_flip_matches_jax(rng, decision):
    x = rng.random((2, 3, 4, 5), np.float32)
    want = np.asarray(j_extras.random_flip(jnp.asarray(x), decision))
    np.testing.assert_array_equal(extras.random_flip(torch.from_numpy(x), decision).numpy(),
                                  want)


@pytest.mark.parametrize("size,sig", [(5, 1.0), (7, 2.5), (4, 0.8)])
def test_gaussian_2dkernel_matches_jax(size, sig):
    want = j_extras.gaussian_2dkernel(size, sig)
    got = extras.gaussian_2dkernel(size, sig)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,nrb", [(270, 480, 16), (37, 53, 2), (64, 64, 10)])
def test_inference_flops_match_jax(h, w, nrb):
    assert flops.generator_flops_per_frame(h, w, nrb) == j_flops.generator_flops_per_frame(
        h, w, nrb)
    got = flops.inference_mfu(165.0, h, w, nrb)
    want = j_flops.inference_mfu(165.0, h, w, nrb, peak_flops=flops.H100_PEAK_BF16_FLOPS)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k
