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


def _source_taps(dst, size):
    """torch's upsample_bilinear2d source taps of output index ``dst``
    (x4, align_corners=False), in float32 as the kernel computes them."""
    src = max((np.float32(dst) + np.float32(0.5)) * np.float32(0.25) - np.float32(0.5),
              np.float32(0.0))
    i0 = min(int(src), size - 1)
    i1 = i0 + (1 if i0 < size - 1 else 0)
    return i0, i1, np.float32(min(max(src - np.float32(i0), 0.0), 1.0))


def _plane_rows(r, H):
    plane = 1 if r >= 2 * H else 0
    rr = r - plane * 2 * H
    y0, y1, _ = _source_taps(2 * rr, H)
    return plane, rr, y0, y1


def _warp_model(carry, prev_lr, tj):
    """A torch transliteration, in float32, of how csrc/warp_s2d.cu
    decomposes the warp: blocks of ``tj`` LR pixels of one LR row; the
    block stages the plane rows its 4 sub-rows read (two planes when the
    raw view's plane switches inside the LR row), in window 0 (pixels with
    2c < 4W) and window 1 (the wrapped pixels); one thread per (LR pixel,
    sub-row) makes one vertical lerp per source column of its window and
    8 horizontal lerps with fixed weights, picking the window per pixel,
    samples the u8 carry and writes slots c*16 + a*4 + [0..3]."""
    B, H, W, _ = carry.shape
    H4, W4 = 4 * H, 4 * W
    span = 2 * tj + 2
    q = torch.round(carry.float() * 255).clamp(0, 255)
    frame = q.view(B, H, W, 3, 4, 4).permute(0, 1, 4, 2, 5, 3).reshape(B, H4, W4, 3)
    out = torch.full((B, H, W, 48), float("nan"))
    for b in range(B):
        for i in range(H):
            for j0 in range(0, W, tj):
                nj = min(tj, W - j0)
                p_first, _, lo0, _ = _plane_rows(4 * i, H)
                p_last, _, _, hi0 = _plane_rows(4 * i + 3, H)
                lo1, hi1 = 0, -1
                if p_last != p_first:
                    split = 2 * H - 4 * i
                    hi0 = _plane_rows(4 * i + split - 1, H)[3]
                    lo1 = _plane_rows(4 * i + split, H)[2]
                    hi1 = _plane_rows(4 * i + 3, H)[3]
                n0 = hi0 - lo0 + 1
                ns = n0 + hi1 - lo1 + 1
                assert ns <= 8
                need = (4 * j0 < 2 * W, 4 * (j0 + nj) - 1 >= 2 * W)
                staged = torch.zeros(2, 8, span)
                for w in (0, 1):
                    if not need[w]:
                        continue
                    cols = (2 * j0 - 1 - w * W + torch.arange(span)).clamp(0, W - 1)
                    for sl in range(ns):
                        second = sl >= n0
                        y = lo1 + sl - n0 if second else lo0 + sl
                        staged[w, sl] = prev_lr[b, y, cols, p_last if second else p_first]
                jl = torch.arange(nj)
                j = j0 + jl
                for a in range(4):
                    plane, rr, y0, y1 = _plane_rows(4 * i + a, H)
                    s0 = y0 - lo0 if plane == p_first else n0 + y0 - lo1
                    s1 = y1 - lo0 if plane == p_first else n0 + y1 - lo1
                    cols = 2 * jl[:, None] + torch.arange(4)
                    v = []
                    for ov in (0, 1):
                        ly = _source_taps(2 * rr + ov, H)[2]
                        v.append((1 - ly) * staged[ov, s0][cols] + ly * staged[ov, s1][cols])
                    for bb in range(4):
                        over = (8 * j + 2 * bb >= W4)[:, None]
                        vv = torch.where(over, v[1], v[0])
                        g = []
                        for k in range(2):
                            m = 2 * bb + k
                            c0 = (m + 2) // 4
                            lx = np.float32((m + 0.5) * 0.25 + 0.5 - c0)
                            g.append((1 - lx) * vv[:, c0] + lx * vv[:, c0 + 1])
                        ix = ((4 * g[0] + 1) * W4 - 1) * 0.5
                        iy = ((4 * g[1] + 1) * H4 - 1) * 0.5
                        fx, fy = torch.floor(ix), torch.floor(iy)
                        wx, wy = ix - fx, iy - fy
                        acc = torch.zeros(nj, 3)
                        for dy in (0, 1):
                            for dx in (0, 1):
                                ty, tx = fy + dy, fx + dx
                                ok = (ty >= 0) & (ty <= H4 - 1) & (tx >= 0) & (tx <= W4 - 1)
                                w = (wy if dy else 1 - wy) * (wx if dx else 1 - wx)
                                taps = frame[b, ty.clamp(0, H4 - 1).long(),
                                             tx.clamp(0, W4 - 1).long()]
                                acc += torch.where(ok, w, 0)[:, None] * taps
                        res = (acc * (1 / 255) + 1) * 0.5
                        for c in range(3):
                            out[b, i, j0:j0 + nj, c * 16 + a * 4 + bb] = res[:, c]
    return out


@pytest.mark.parametrize("tj", [32, 2])
@pytest.mark.parametrize("shape,lo,hi", [((2, 5, 7), -0.5, 0.5),
                                         ((1, 37, 53), -0.5, 0.5),
                                         ((1, 8, 12), 0.0, 1.0)])
def test_kernel_mapping_model_matches_reference(shape, lo, hi, tj):
    """Both planes inside one LR row (odd H) and the wrap of the raw view
    inside one thread's 4 pixels (odd W), at the kernel's block width and
    at one that cuts the row into many blocks.  prev_lr is drawn on a
    grid of 1/64, so that the upsample's values, and the coordinates, are
    exact in float32 whichever order the lerps run in (the kernel lerps
    vertically first, torch horizontally): the comparison then sees the
    mapping and not that rounding, which alone moves a coordinate of
    ~400 pixels by ~2e-5 of a pixel."""
    carry, prev_lr = _inputs(4, shape, lo, hi)
    prev_lr = torch.from_numpy(np.round(prev_lr * 64) / 64)
    got = _warp_model(carry, prev_lr, tj)
    want = kmod.warp_s2d_feedback_reference(carry, prev_lr)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


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
