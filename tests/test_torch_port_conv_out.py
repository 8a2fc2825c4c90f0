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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread in this module: the suite runs several
    pytest workers on the machine's cores, where torch's default of a
    thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _conv_out_model(feat, k, b, tc, bh):
    """A torch transliteration, in fp32, of how csrc/conv_out_s2d.cu
    decomposes the function: strips of ``tc`` LR columns with a 1-pixel
    halo, staged in M tiles of 16 pixel slots (zero-filled outside the
    image and past the strip); bands of ``bh`` LR rows walked one HR input
    row at a time.  Each row's products with the bf16-rounded weights go
    into the rolling accumulators of output row ``t - u``: ``F_row @ W_u``
    for columns ``n = 3v + c < 8`` (one 8-column tile per row tap ``u``),
    and column 8, ``(v 2, c 2)``, of all three taps from one shared tile
    ``F_row @ W_D`` (its column ``u``).  Once a row is complete, the column
    shift on its 9 sums, bias and sigmoid into the LR row's s2d records,
    stored after sub-row 3."""
    B, H4, W4, K = feat.shape
    H, W = H4 // 4, W4 // 4
    sw = 4 * tc + 2
    mrows = 16 * ((sw + 15) // 16)
    kb = k.bfloat16().float()
    wn = kb.permute(0, 2, 1, 3).reshape(3, K, 9)[:, :, :8]  # (u, k, 3v + c)
    wd = torch.zeros(K, 8)
    wd[:, :3] = kb[:, 2, :, 2].T  # column u: (u, v 2, c 2)
    out = torch.full((B, H, W, 48), float("nan"))
    slots = torch.arange(mrows)
    for bi in range(B):
        for j0 in range(0, W, tc):
            x = 4 * j0 - 1 + slots
            cols_in = (slots < sw) & (x >= 0) & (x < W4)
            for i0 in range(0, H, bh):
                nr = 4 * min(bh, H - i0) + 2
                acc = [torch.zeros(mrows, 8) for _ in range(3)]
                r8 = [torch.zeros(mrows) for _ in range(3)]
                rec = torch.zeros(tc, 3, 4, 4)  # (j, c, a, bb)
                for t in range(nr):
                    r = 4 * i0 - 1 + t
                    row = torch.zeros(mrows, K)
                    if 0 <= r < H4:
                        row[cols_in] = feat[bi, r, x[cols_in]]
                    d = row @ wd
                    for u in range(3):
                        acc[(t - u) % 3] += row @ wn[u]
                        r8[(t - u) % 3] += d[:, u]
                    o, done = t - 2, (t + 1) % 3
                    if o >= 0:
                        z = torch.cat([acc[done], r8[done][:, None]], dim=1)
                        xl = torch.arange(4 * tc)
                        y = b + z[xl, 0:3] + z[xl + 1, 3:6] + z[xl + 2, 6:9]
                        rec[:, :, o % 4, :] = torch.sigmoid(y).view(tc, 4, 3).permute(0, 2, 1)
                        if o % 4 == 3:
                            nj = min(tc, W - j0)
                            out[bi, i0 + o // 4, j0:j0 + nj] = rec[:nj].reshape(nj, 48)
                    acc[done], r8[done] = torch.zeros(mrows, 8), torch.zeros(mrows)
    return out


# the kernel's tiling (TC, BH) and a small one that cuts these shapes into
# many strips and bands with ragged tails
TILINGS = {"kernel": (30, 17), "small": (2, 3)}


@pytest.mark.parametrize("tiling", list(TILINGS))
@pytest.mark.parametrize("shape", SHAPES + [(1, 4, 4, 64), (2, 12, 4 * 37, 64)])
def test_kernel_tiling_model_matches_reference(rng, shape, tiling):
    feat, k, b = _inputs(rng, shape)
    feat, k, b = torch.from_numpy(feat), torch.from_numpy(k), torch.from_numpy(b)
    got = _conv_out_model(feat, k, b, *TILINGS[tiling])
    want = kmod.conv_out_s2d_reference(feat, k.bfloat16().float(), b)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def _f32_kernel_model(feat, k, b, tc, bh):
    """A torch transliteration, in fp32, of the fp32 route's kernel
    (``conv_out_s2d_f32_kernel``) on the f32 weights as they are.  A block
    owns a strip of ``tc`` LR columns (lane j: HR columns 4j .. 4j + 3 of
    the strip's ``4 tc + 2`` staged pixels, a halo of one, zero outside the
    image) and walks a band of ``bh`` LR rows one HR input row at a time
    (a ring stage; rows outside the image zero).  Warp g sums channels
    16g .. 16g + 15 of each row into 3 rolling output rows: input row t
    adds row tap u to output row t - u.  After row e + 2 the four warps'
    partial sums of output row e meet, in warp order, after the bias; the
    sigmoid goes to slot e % 4 of the lane's LR record, stored after slot
    3 for the lanes inside the image."""
    B, H4, W4, K = feat.shape
    H, W = H4 // 4, W4 // 4
    sw = 4 * tc + 2
    chans = [torch.arange(16 * g, 16 * g + 16) for g in range(4)]
    # lane j, column b, column tap v reads staged pixel 4j + b + v
    px = (4 * torch.arange(tc)[:, None, None] + torch.arange(4)[None, :, None]
          + torch.arange(3)[None, None, :])
    out = torch.full((B, H, W, 48), float("nan"))
    slots = torch.arange(sw)
    for bi in range(B):
        for j0 in range(0, W, tc):
            x = 4 * j0 - 1 + slots
            cols_in = (x >= 0) & (x < W4)
            nj = min(tc, W - j0)
            for i0 in range(0, H, bh):
                nr = 4 * min(bh, H - i0) + 2
                acc = torch.zeros(3, 4, tc, 4, 3)  # (output row t - 2 + o, warp, lane, b, c)
                rec = torch.zeros(tc, 3, 4, 4)     # (lane, c, a, b)
                for t in range(nr):
                    r = 4 * i0 - 1 + t
                    row = torch.zeros(sw, K)
                    if 0 <= r < H4:
                        row[cols_in] = feat[bi, r, x[cols_in]]
                    taps = row[px]  # (lane, b, v, K)
                    for g in range(4):
                        for u in range(3):
                            acc[2 - u, g] += torch.einsum(
                                "jbvk,vkc->jbc", taps[..., chans[g]], k[u][:, chans[g]])
                    e = t - 2
                    if e >= 0:
                        y = b + acc[0, 0] + acc[0, 1] + acc[0, 2] + acc[0, 3]
                        rec[:, :, e % 4, :] = torch.sigmoid(y).permute(0, 2, 1)
                        if e % 4 == 3:
                            out[bi, i0 + e // 4, j0:j0 + nj] = rec[:nj].reshape(nj, 48)
                    acc = torch.cat([acc[1:], torch.zeros(1, 4, tc, 4, 3)])
    return out


# the f32 kernel's strip and band (F_TC, F_BH), and a small tiling with
# ragged tails in both H and W
F32_TILINGS = {"kernel": (32, 16), "small": (3, 5)}


@pytest.mark.parametrize("tiling", list(F32_TILINGS))
@pytest.mark.parametrize("shape", [(1, 48, 64, 64), (2, 12, 4 * 37, 64), (1, 4, 4, 64),
                                   (1, 4 * 17, 4 * 33, 64)])
def test_f32_kernel_tiling_model_matches_reference(rng, shape, tiling):
    """The fp32 route's kernel sums on the f32 weights as they are: its
    tiling holds the plain version in f32 to summation order.  The last
    shape spans two strips and two bands of the kernel's tiling, each
    with a ragged tail."""
    feat, k, b = _inputs(rng, shape)
    feat, k, b = torch.from_numpy(feat), torch.from_numpy(k), torch.from_numpy(b)
    got = _f32_kernel_model(feat, k, b, *F32_TILINGS[tiling])
    torch.testing.assert_close(got, kmod.conv_out_s2d_reference(feat, k, b), rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(1, 48, 64, 64), (2, 24, 36, 64)])
def test_reference_on_bf16_weights_matches_pallas_bf16(rng, shape):
    """The kernel rounds its f32 weights to bf16, as the JAX route casts
    them to the features' dtype (conv_out_s2d.py:187): the plain version
    on bf16-rounded weights equals the paired Pallas kernel on bf16
    features (products exact in f32; only the summation order differs)."""
    feat, k, b = _inputs(rng, shape)
    feat16 = torch.from_numpy(feat).bfloat16()
    ref = conv_out_s2d_pallas_paired(
        jnp.asarray(feat16.float().numpy(), jnp.bfloat16), jnp.asarray(k),
        jnp.asarray(b), out_dtype=jnp.float32, interpret=True)
    got = kmod.conv_out_s2d_reference(feat16.float(), torch.from_numpy(k).bfloat16().float(),
                                      torch.from_numpy(b))
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
