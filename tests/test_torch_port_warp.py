"""Port parity, the fused warp: the plain PyTorch version of the
``warp_s2d`` CUDA kernel against the JAX package's warp of the s2d carry,
and the dispatch rules around the kernel (CPU).

(a) against ``warp_combine``, the Pallas kernel, run in interpret mode
    through ``engine/attic.py::grid_sample_packed_int8_pallas`` (as
    tests/test_pallas_combine.py runs it), which combines in float32;
(b) against the production ``warp_s2d_carry`` on
    ``planar_pseudo_flow_coords``, which combines in bf16.

The kernel itself runs only on the card: its tests are in
tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.engine import fused as j_fused
from tecogan_tpu.engine.attic import grid_sample_packed_int8_pallas
from tecogan_tpu.ops.image import deprocess as j_deprocess
from tecogan_tpu.ops.space import space_to_depth as j_space_to_depth
from tecogan_tpu_torch.engine.fused import warp_s2d_feedback
from tecogan_tpu_torch.ops.kernels import warp_s2d as kmod

# (a) both sides sample the same u8-quantized carry in float32; only the
# order of the bilinear weights' products differs.
PALLAS_TOL = 1e-4
# (b) the XLA combine rounds the weights and the sum to bf16 (2**-9
# relative), then deprocess halves it; tests/test_pallas_combine.py's bar.
XLA_MAX, XLA_MEAN = 2e-2, 3e-3

# LR (H, W) at B; prev_lr in [0, 1] (served clips: most samples land
# outside the frame) and in [-0.5, 0.5] (coordinates reach the left and
# top edges).
SHAPES = [(1, 8, 12), (2, 5, 7)]
RANGES = {"served": (0.0, 1.0), "edges": (-0.5, 0.5)}


def _inputs(seed, shape, lo, hi):
    rng = np.random.default_rng(seed)
    B, H, W = shape
    carry = torch.from_numpy(rng.random((B, H, W, 48), np.float32)).bfloat16()
    prev_lr = (rng.random((B, H, W, 3), np.float32) * (hi - lo) + lo).astype(np.float32)
    return carry, prev_lr


def _cases():
    for shape in SHAPES:
        for name, (lo, hi) in RANGES.items():
            yield pytest.param(shape, lo, hi, id=f"{shape}-{name}")


@pytest.mark.parametrize("shape,lo,hi", list(_cases()))
def test_reference_matches_pallas_warp_combine(shape, lo, hi):
    carry, prev_lr = _inputs(0, shape, lo, hi)
    frame = j_fused.s2d_to_frame(jnp.asarray(carry.float().numpy()))
    grid = j_fused.pseudo_flow_grid_fast(jnp.asarray(prev_lr))
    warped = grid_sample_packed_int8_pallas(frame, grid)
    ref = np.asarray(j_space_to_depth(j_deprocess(warped)))
    got = kmod.warp_s2d_feedback_reference(carry, torch.from_numpy(prev_lr))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=PALLAS_TOL)


@pytest.mark.parametrize("shape,lo,hi", list(_cases()))
def test_reference_matches_xla_warp_s2d_carry(shape, lo, hi):
    carry, prev_lr = _inputs(1, shape, lo, hi)
    ix, iy = j_fused.planar_pseudo_flow_coords(jnp.asarray(prev_lr))
    warped = j_fused.warp_s2d_carry(jnp.asarray(carry.float().numpy(), jnp.bfloat16),
                                    ix, iy)
    ref = np.asarray(j_space_to_depth(j_deprocess(warped.astype(jnp.float32))))
    got = kmod.warp_s2d_feedback_reference(carry, torch.from_numpy(prev_lr)).numpy()
    err = np.abs(got - ref)
    assert err.max() <= XLA_MAX and err.mean() <= XLA_MEAN, (err.max(), err.mean())


def test_cpu_dispatch_takes_the_plain_version():
    carry, prev_lr = _inputs(2, (2, 5, 7), -0.5, 0.5)
    prev_lr = torch.from_numpy(prev_lr)
    kmod.launch_count = 0
    got = warp_s2d_feedback(carry, prev_lr)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5, 7, 48)
    torch.testing.assert_close(
        got, kmod.warp_s2d_feedback_reference(carry, prev_lr).bfloat16(),
        rtol=0, atol=0)
    assert kmod.launch_count == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """No silent fallback: the wrapper raises on a tensor it cannot launch
    on, before building or counting anything."""
    carry, prev_lr = _inputs(3, (1, 4, 4), 0.0, 1.0)
    kmod.launch_count = 0
    with pytest.raises(ValueError, match="CUDA"):
        kmod.warp_s2d_feedback_cuda(carry, torch.from_numpy(prev_lr))
    assert kmod.launch_count == 0
