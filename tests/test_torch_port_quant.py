"""Port parity, the int8 (W8A8) serving mode: tecogan_tpu_torch's quantized
tail, its calibration and its entry points against the JAX package's
(tecogan_tpu/engine/quant.py) on the same weights and clips (CPU,
num_resblock=2, small frames), and the plain int8 convs against JAX's
s8 x s8 -> s32 convs and against a model of the CUDA kernels' tiling."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine import quant as jq
from tecogan_tpu.engine.inference import build_clip_inference as j_build_clip
from tecogan_tpu.engine.inference import build_quantized_clip_inference as j_build_q
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine import quant
from tecogan_tpu_torch.engine.inference import (build_chunked_inference,
                                                build_clip_inference,
                                                build_quantized_clip_inference)
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.ops.image import transfer_dequantize_f32
from tecogan_tpu_torch.ops.kernels import int8_conv
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax, qtail_from_jax

CFG = TecoConfig(num_resblock=2, precision="fp32", bug_parity=False)
# as tests/test_torch_port_inference.py: conv kernels scaled by 2.5 and LR
# clips in [0, 0.3], so that the output depends on the input and the warp
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3
# the JAX package's own bar for its int8 clip against its bf16 clip
# (tests/test_quant.py:105)
INT8_VS_FLOAT_DB = 35.0


def _jax_cfg(cfg):
    return JaxTecoConfig(**dataclasses.asdict(cfg))


def _params(seed=0):
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else
                (v * np.float32(KERNEL_GAIN) if k == "kernel" else v)
                for k, v in tree.items()}
    return scale(init_generator(CFG, torch.Generator().manual_seed(seed)))


def _model(params, cfg=CFG):
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _clip(rng, shape=(1, 6, 8, 12, 3)):
    return rng.random(shape, np.float32) * np.float32(CLIP_RANGE)


def _np_qtail(q):
    return {k: {kk: None if v is None else np.asarray(v) for kk, v in layer.items()}
            for k, layer in q.items()}


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _jax_maxes(params, rng):
    net = jnp.asarray(rng.random((1, 8, 8, 64), np.float32))
    return {k: np.asarray(v) for k, v in jq.calibrate(params, net)[1].items()}


@pytest.mark.parametrize("form", ["flax", "state_dict"])
def test_quantize_tail_matches_jax(rng, form):
    """From the same float32 params and maxima: wq bit-equal in all 2n + 7
    layers, inv_s, deq and bias equal."""
    params = _params()
    maxes = _jax_maxes(params, rng)
    want = jq.quantize_tail(params, maxes)
    src = params if form == "flax" else generator_state_dict_from_jax(params)
    got = quant.quantize_tail(src, {k: torch.tensor(v) for k, v in maxes.items()})
    assert list(got) == list(want) and len(got) == 2 * CFG.num_resblock + 7
    for name, w in want.items():
        g = got[name]
        assert g["wq"].dtype == torch.int8
        np.testing.assert_array_equal(g["wq"].permute(1, 2, 3, 0).numpy(), np.asarray(w["wq"]))
        np.testing.assert_array_equal(g["inv_s"].numpy(), np.asarray(w["inv_s"]))
        np.testing.assert_array_equal(g["deq"].numpy(), np.asarray(w["deq"]))
        if w["bias"] is None:
            assert g["bias"] is None
        else:
            np.testing.assert_array_equal(g["bias"].numpy(), np.asarray(w["bias"]))


def test_quantize_tail_names_a_missing_layer(rng):
    """Every conv layer of the params' tail is quantized: maxima without
    one raise a KeyError that names it, at quantize_tail, not later in
    tail_features_int8."""
    params = _params()
    maxes = {k: torch.tensor(v) for k, v in _jax_maxes(params, rng).items()}
    del maxes["trunk_rb2/Conv_1"]
    with pytest.raises(KeyError, match="trunk_rb2/Conv_1"):
        quant.quantize_tail(params, maxes)


def test_quantize_tail_lies_on_the_maxima_device(rng, monkeypatch):
    """Without ``device`` the qtail goes where the maxima lie (the model's
    device, after calibrate_clip), not to a fixed device; with it, there."""
    params = _params()
    maxes = {k: torch.tensor(v) for k, v in _jax_maxes(params, rng).items()}
    seen = []
    real = quant.qtail_to
    monkeypatch.setattr(quant, "qtail_to", lambda q, dev: seen.append(dev) or real(q, dev))
    q = quant.quantize_tail(params, maxes)
    assert seen == [maxes["up1"].device]
    assert all(v.device == maxes["up1"].device for layer in q.values()
               for v in layer.values() if v is not None)
    quant.quantize_tail(params, maxes, device="cpu")
    assert seen[-1] == "cpu"


def test_quantize_tail_uses_the_cpu_only_when_named(rng, monkeypatch):
    """Maxima that are not tensors carry no device: the qtail then goes to
    the card, and with no card visible quantize_tail raises, unless the
    caller names the CPU."""
    params = _params()
    maxes = _jax_maxes(params, rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        quant.quantize_tail(params, maxes)
    q = quant.quantize_tail(params, maxes, device="cpu")
    assert all(v.device.type == "cpu" for layer in q.values() for v in layer.values()
               if v is not None)


def test_qtail_from_jax_is_the_ports_qtail(rng):
    """A JAX qtail carried across equals the port's own from the same
    params and maxima, tensor for tensor."""
    params = _params()
    maxes = _jax_maxes(params, rng)
    carried = qtail_from_jax(_np_qtail(jq.quantize_tail(params, maxes)))
    own = quant.quantize_tail(params, {k: torch.tensor(v) for k, v in maxes.items()})
    for name, layer in own.items():
        for k, v in layer.items():
            assert (v is None) == (carried[name][k] is None), (name, k)
            if v is not None:
                assert v.dtype == carried[name][k].dtype and torch.equal(v, carried[name][k])


def test_calibrate_matches_jax(rng):
    """The float tail with its maxima, fp32, same net: maxima within 1e-5
    relative; the features are the model's own tail_features, exactly."""
    params = _params()
    net = rng.random((2, 8, 12, 64), np.float32)
    feat_j, max_j = jq.calibrate(params, jnp.asarray(net))
    model = _model(params)
    with torch.no_grad():
        feat, maxes = quant.calibrate(model, torch.from_numpy(net))
        assert torch.equal(feat, model.tail_features(torch.from_numpy(net)))
    assert set(maxes) == set(max_j)
    for k, v in max_j.items():
        np.testing.assert_allclose(float(maxes[k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j), atol=2e-5)


def _jax_int_conv(xq, wq_hwio, dilated):
    kw = dict(dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    if dilated:
        return jax.lax.conv_general_dilated(xq, wq_hwio, (1, 1), padding=((1, 2), (1, 2)),
                                            lhs_dilation=(2, 2), **kw)
    return jax.lax.conv_general_dilated(xq, wq_hwio, (1, 1), padding=((1, 1), (1, 1)), **kw)


def _ints(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("dilated", [False, True])
def test_integer_sums_match_jax(rng, cin, cout, dilated):
    """The plain integer convs, bit-equal to JAX's preferred_element_type
    =int32 convs on the same int8 operands, full-range values (a 128 -> 128
    sum reaches past 2**24, where float32 would round)."""
    xq = _ints(rng, (2, 5, 7, cin))
    wq = _ints(rng, (3, 3, cin, cout))
    want = np.asarray(_jax_int_conv(jnp.asarray(xq), jnp.asarray(wq), dilated))
    fn = int8_conv.int8_up2x_sums if dilated else int8_conv.int8_conv3x3_sums
    got = fn(torch.from_numpy(xq), torch.from_numpy(np.ascontiguousarray(
        np.transpose(wq, (3, 0, 1, 2)))))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# The CUDA kernels' tiling (csrc/int8_conv.cu): tiles of TR rows x TW
# columns of pixels, one m64 wgmma tile a row; the ring's stage and the
# weights in shared memory as flat byte arrays in the canonical K-major
# layout without swizzle, read through wgmma's matrix descriptors.
TR, TW = 2, 64
CORE_SBO = 128  # bytes between core matrices (8 rows x 16 bytes) along M or N
# a grid small enough that the blocks' tile ranges end inside a column strip
MODEL_BLOCKS = 3


def _lbo_a(cin, up):
    """Bytes between the stage's 16-byte K chunks: the staged rows x
    columns of 16 bytes, rounded up to 128, plus 32 (Cin 64) or 16 (Cin 128)
    bytes so that a pixel's chunks fall in distinct banks."""
    ih, iw = (TR + 1, TW + 1) if up else (TR + 2, TW + 2)
    return -(-ih * iw * 16 // 128) * 128 + (32 if cin == 64 else 16), ih, iw


def _desc_offsets(rows, lbo):
    """Byte offsets of a (rows x 32) s8 operand read through a descriptor
    without swizzle: core matrices of 8 rows x 16 bytes, CORE_SBO apart
    along the rows, ``lbo`` apart along K."""
    m = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return (m // 8) * CORE_SBO + (m % 8) * 16 + (k // 16) * lbo + k % 16


def _quad_transpose(pieces):
    """The epilogue's shuffles, lane by lane: ``pieces[q][k]`` is what lane
    q of a quad holds of 8-channel block k (its 4-byte piece q).  Returns
    what each lane holds after: ``out[q][p]``."""
    out = [[pieces[q][q]] * 4 for q in range(4)]
    for i in (1, 2, 3):
        sent = [pieces[lane][(lane + i) % 4] for lane in range(4)]
        for q in range(4):
            src = (q - i) % 4
            out[q][src] = sent[src]
    return out


def _kernel_model(xq, wq, up):
    """The kernels' loops in numpy, for a grid of MODEL_BLOCKS blocks: tile
    ids running down each 64-column strip, a contiguous range of them a
    block; the producer's stages (quantized zeros outside the image),
    where a tile below the block's previous one copies the OV staged rows
    it shares and stages only the TR new ones; each consumer row's wgmma
    chain with the A descriptor's start moved by ((row + du) * IW + dv) *
    16 bytes a tap and 2 * LBO_A a k32 step, B at (tap * CIN / 16 + 2 kk) *
    COUT * 16; up2x's four phases with their own taps; the epilogue's
    fragment -> quad transpose -> 16-byte stores, masked at the ragged
    edges.  Every output element is written exactly once."""
    B, H, W, cin = xq.shape
    cout = wq.shape[0]
    kc_n = cin // 16
    lbo_a, ih, iw = _lbo_a(cin, up)
    lbo_b = cout * 16
    halo = 0 if up else 1
    ov = ih - TR
    # weights: chunk kc of row n at (kc * COUT + n) * 16
    w_rows = wq.reshape(cout, 9 * kc_n, 16).astype(np.int64)
    wbuf = np.ascontiguousarray(w_rows.transpose(1, 0, 2)).reshape(-1)
    off_a, off_b = _desc_offsets(TW, lbo_a), _desc_offsets(cout, lbo_b)
    # the epilogue: lane (warp, lane) holds pixels m and m + 8 of two
    # channels of every block; after the transpose, block 4g + q of pixel m
    assert all(_quad_transpose([[(q, k) for k in range(4)] for q in range(4)])[q]
               == [(p, q) for p in range(4)] for q in range(4))
    owner = np.zeros((TW, cout), np.int64)
    for warp in range(4):
        for lane in range(32):
            for h in range(2):
                m = 16 * warp + lane // 4 + 8 * h
                for g in range(cout // 32):
                    c = 8 * (4 * g + lane % 4)
                    owner[m, c:c + 8] += 1
    assert (owner == 1).all()

    OH, OW = (2 * H, 2 * W) if up else (H, W)
    out = np.zeros((B, OH, OW, cout), np.int64)
    written = np.zeros(out.shape[:3], np.int64)
    tiles_h, tiles_w = -(-H // TR), -(-W // TW)
    ntiles = B * tiles_h * tiles_w
    grid = min(ntiles, MODEL_BLOCKS)
    for blk in range(grid):
        first, last = ntiles * blk // grid, ntiles * (blk + 1) // grid
        prev = None
        for k, tile in enumerate(range(first, last)):
            b, rem = divmod(tile, tiles_h * tiles_w)
            seg, rp = divmod(rem, tiles_h)
            y0, x0 = rp * TR, seg * TW
            fresh = k == 0 or rp == 0
            stage = np.full(kc_n * lbo_a, -999, np.int64)  # unstaged bytes poison the sums
            new_rows = range(ih) if fresh else range(ov, ih)
            if not fresh:
                for kc in range(kc_n):
                    n = ov * iw * 16
                    stage[kc * lbo_a:kc * lbo_a + n] = \
                        prev[kc * lbo_a + TR * iw * 16:kc * lbo_a + TR * iw * 16 + n]
            for rho in new_rows:
                for px in range(iw):
                    gy, gx = y0 - halo + rho, x0 - halo + px
                    for kc in range(kc_n):
                        at = kc * lbo_a + (rho * iw + px) * 16
                        inside = 0 <= gy < H and 0 <= gx < W
                        stage[at:at + 16] = xq[b, gy, gx, kc * 16:kc * 16 + 16] if inside else 0
            prev = stage
            for r in range(TR):
                a_row = r * iw * 16
                for phase in range(4 if up else 1):
                    pr, pc = phase >> 1, phase & 1
                    acc = np.zeros((TW, cout), np.int64)
                    for tap in range(9):
                        u, v = divmod(tap, 3)
                        du, dv = u, v
                        if up:
                            if (u != 1) if pr == 0 else (u == 1):
                                continue
                            if (v != 1) if pc == 0 else (v == 1):
                                continue
                            du, dv = int(u == 2), int(v == 2)
                        a_tap = a_row + (du * iw + dv) * 16
                        for kk in range(cin // 32):
                            a = stage[a_tap + 2 * kk * lbo_a + off_a]
                            bm = wbuf[(tap * kc_n + 2 * kk) * lbo_b + off_b]
                            acc += a @ bm.T
                    y = y0 + r
                    for m in range(TW):
                        x = x0 + m
                        if y >= H or x >= W:
                            continue
                        oy, ox = (2 * y + pr, 2 * x + pc) if up else (y, x)
                        out[b, oy, ox] = acc[m]
                        written[b, oy, ox] += 1
    assert (written == 1).all()
    return out


# (B, H, W, Cin, Cout): ragged tiles in H and W, W below 64, W not a
# multiple of 64 (70, 130), H = 1, B = 3, Cin != Cout both ways
@pytest.mark.parametrize("shape", [(1, 9, 17, 64, 64), (2, 8, 16, 64, 64),
                                   (1, 20, 35, 64, 64), (1, 3, 70, 64, 128),
                                   (3, 1, 130, 128, 64)])
@pytest.mark.parametrize("up", [False, True])
def test_kernel_tiling_model_matches_plain(rng, shape, up):
    """The kernels' tiling, descriptor address maps, sub-pixel phases and
    epilogue lanes, modelled on the CPU, give the plain version's sums."""
    B, H, W, cin, cout = shape
    xq = _ints(rng, (B, H, W, cin))
    wq = _ints(rng, (cout, 3, 3, cin))
    fn = int8_conv.int8_up2x_sums if up else int8_conv.int8_conv3x3_sums
    want = fn(torch.from_numpy(xq), torch.from_numpy(wq)).numpy()
    np.testing.assert_array_equal(_kernel_model(xq, wq, up), want)


def _producer_quantize(x, inv_s):
    """The producer's quantizer on one pixel's channels, bit by bit: the
    16-byte loads as 32-bit words (two bf16 a word, low half first, or one
    f32), each value scaled and clamped in f32, then rounded half to even
    by adding 1.5 * 2**23, whose low byte is the two's-complement s8."""
    words = x.contiguous().view(torch.int32).numpy().view(np.uint32).reshape(-1)
    if x.dtype == torch.bfloat16:
        vals = np.stack([words << 16, words & 0xFFFF0000], axis=1).reshape(-1)
    else:
        vals = words
    v = vals.astype(np.uint32).view(np.float32)
    t = np.clip(v * np.float32(inv_s), np.float32(-127), np.float32(127))
    return ((t + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_producer_quantizer_is_quantize(rng, dtype):
    """The kernels' staging quantizer, for both activation types, gives
    ``quantize``'s s8 values byte for byte, clamped values and halves
    included."""
    x = torch.from_numpy(rng.normal(0, 40, (4, 64)).astype(np.float32))
    x[0, :6] = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5])  # ties to even
    x = x.to(dtype)
    want = int8_conv.quantize(x, torch.tensor(1.0)).view(torch.uint8).numpy().reshape(-1)
    np.testing.assert_array_equal(_producer_quantize(x, 1.0), want)


def test_f32_epilogue_lanes_cover_the_tile():
    """The f32 epilogue: lane (warp, lane) stores its own channel pairs
    8 j + 2 (lane % 4) of pixels m and m + 8; every output element of a
    64 x Cout tile is written exactly once."""
    for cout in (64, 128):
        owner = np.zeros((TW, cout), np.int64)
        for warp in range(4):
            for lane in range(32):
                for h in range(2):
                    m = 16 * warp + lane // 4 + 8 * h
                    for j in range(cout // 8):
                        c = 8 * j + 2 * (lane % 4)
                        owner[m, c:c + 2] += 1
        assert (owner == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_is_quantize_conv_dequantize(rng, dtype):
    """One whole plain layer: quantize (round half to even, clamp at
    -127), the exact conv, float32 dequantization and bias, the cast, ReLU
    and the residual add in the layer's dtype."""
    x = torch.from_numpy(rng.standard_normal((1, 6, 9, 64), np.float32)).to(dtype)
    inv_s = torch.tensor(60.0)  # max|x| * 60 > 127: some values clamp
    wq = torch.from_numpy(_ints(rng, (128, 3, 3, 64)))
    deq = torch.from_numpy(rng.random(128, np.float32) * np.float32(1e-4))
    bias = torch.from_numpy(rng.standard_normal(128, np.float32) * np.float32(0.1))
    res = torch.from_numpy(rng.standard_normal((1, 6, 9, 128), np.float32)).to(dtype)
    xq = torch.clamp(torch.round(x.float() * inv_s), -127, 127).to(torch.int8)
    assert int(xq.min()) == -127 and int(xq.max()) == 127
    y = (int8_conv.int8_conv3x3_sums(xq, wq).float() * deq + bias).to(dtype)
    want = torch.relu(y) + res
    got = int8_conv.int8_conv3x3_reference(x, inv_s, wq, deq, bias, relu=True, residual=res)
    assert got.dtype == dtype and torch.equal(got, want)
    half = torch.tensor([[[[0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0]]]])
    np.testing.assert_array_equal(int8_conv.quantize(half, torch.tensor(1.0)).numpy().ravel(),
                                  [0, 2, 2, 0, -2, 127, -127])


@pytest.mark.parametrize("precision,jit", [("fp32", False), ("fp32", True), ("bf16", False)])
def test_tail_features_int8_matches_jax(rng, precision, jit):
    """The quantized tail on the same net with the qtail carried from JAX:
    rel L2 <= 1e-5 against JAX (fp32), and bit-equal to JAX run op by op,
    which rounds where its code says.  Jitted, XLA drops the bf16 roundings
    between fused ops (excess precision), so a jitted bf16 JAX tail is not
    a bit-level reference (measured rel L2 4.2e-2, half the elements)."""
    params = _params()
    net = rng.random((1, 8, 8, 64), np.float32)
    qj = jq.quantize_tail(params, jq.calibrate(params, jnp.asarray(net))[1])
    jdt = jnp.float32 if precision == "fp32" else jnp.bfloat16
    fn = lambda n: jq.tail_features_int8(params, qj, n, compute_dtype=jdt)  # noqa: E731
    want = np.asarray((jax.jit(fn) if jit else fn)(jnp.asarray(net).astype(jdt))
                      .astype(jnp.float32))
    model = _model(params, CFG.replace(precision=precision))
    with torch.no_grad():
        got = quant.tail_features_int8(model, qtail_from_jax(_np_qtail(qj)),
                                       torch.from_numpy(net).to(model.dtype))
    assert got.dtype == model.dtype and tuple(got.shape) == (1, 32, 32, 64)
    assert got.is_contiguous()
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    equal = float(np.mean(got == want))
    print(f"int8 tail {precision} jit={jit}: rel L2 {rel:.3e}, bit-equal {equal:.4%}")
    assert rel <= 1e-5
    if not jit:
        assert equal == 1.0


@pytest.mark.parametrize("frames", [1, 4])
def test_prepare_matches_jax(rng, frames):
    """Calibration through the real recurrence, fp32, same clip: the
    maxima (inv_s = 127 / m) within 1e-5 on frame 0 alone; over 4 frames
    within one bf16 ulp (2**-8): from frame 1 on the warp reads the bf16
    carry, and the two packages' warps agree to one bf16 ulp
    (tests/test_torch_port_warp.py); a maximum is one element (measured
    2.8e-3)."""
    params, clip = _params(), _clip(rng)
    want = j_build_q(_jax_cfg(CFG))[0](params, jnp.asarray(clip), frames=frames)
    prepare, _ = build_quantized_clip_inference(CFG)
    model = _model(params)
    got = prepare(model, params, torch.from_numpy(clip), frames=frames)
    rtol = 1e-5 if frames == 1 else 2.0 ** -8
    for name, w in want.items():
        np.testing.assert_allclose(float(got[name]["inv_s"]), float(w["inv_s"]), rtol=rtol,
                                   err_msg=name)
        assert got[name]["wq"].dtype == torch.int8 and got[name]["wq"].device.type == "cpu"
    u8 = np.round(clip * 255).astype(np.uint8)
    from_u8 = prepare(model, params, u8, frames=frames)
    from_f32 = prepare(model, params, transfer_dequantize_f32(torch.from_numpy(u8)),
                       frames=frames)
    assert all(torch.equal(from_u8[k]["inv_s"], from_f32[k]["inv_s"]) for k in from_u8)


def test_int8_clip_frame0_matches_jax(rng):
    """Frame 0 of the int8 clip, fp32, qtail carried from JAX: the first
    layer's float sums differ only in their order, and the tail is
    bit-equal on equal inputs, so the frame stays above 45 dB."""
    params, clip = _params(), _clip(rng)
    prep_j, infer_j = j_build_q(_jax_cfg(CFG))
    qj = prep_j(params, jnp.asarray(clip), frames=4)
    want = np.asarray(infer_j(params, qj, jnp.asarray(clip[:, :1])))
    got = build_quantized_clip_inference(CFG)[1](_model(params), qtail_from_jax(_np_qtail(qj)),
                                                 torch.from_numpy(clip[:, :1]))
    assert _psnr(got.numpy(), want) >= 45.0


def test_int8_clip_matches_jax_int8_clip(rng):
    """The bf16 int8 clip with the qtail carried from JAX against JAX's
    int8 clip: every frame as close to it as JAX's own int8 clip is to
    JAX's bf16 clip, less 3 dB, and above 35 dB.  45 dB does not hold:
    the two recurrences differ by float rounding (the bf16 route agrees at
    ~51 dB), and an input that lands on the other side of a rounding
    boundary moves a value by a whole quantization step; jitted JAX also
    skips bf16 roundings in its tail (see above).  Measured ~40.5 dB a
    frame against JAX int8 vs JAX bf16 at ~42 dB."""
    cfg = CFG.replace(precision="bf16")
    params, clip = _params(), _clip(rng)
    prep_j, infer_j = j_build_q(_jax_cfg(cfg))
    qj = prep_j(params, jnp.asarray(clip), frames=4)
    want = np.asarray(infer_j(params, qj, jnp.asarray(clip)))
    want_bf16 = np.asarray(j_build_clip(_jax_cfg(cfg))(params, jnp.asarray(clip)))
    got = build_quantized_clip_inference(cfg)[1](_model(params, cfg),
                                                 qtail_from_jax(_np_qtail(qj)),
                                                 torch.from_numpy(clip)).numpy()
    assert got.shape == want.shape == (1, 6, 32, 48, 3)
    for t in range(clip.shape[1]):
        db, jax_db = _psnr(got[:, t], want[:, t]), _psnr(want[:, t], want_bf16[:, t])
        print(f"frame {t}: port int8 vs JAX int8 {db:.2f} dB, JAX int8 vs bf16 {jax_db:.2f} dB")
        assert db >= max(INT8_VS_FLOAT_DB, jax_db - 3.0)


def test_int8_clip_against_the_ports_bf16_clip(rng):
    """The port's own int8 clip (its own prepare) against its bf16 clip:
    quantization error only, above JAX's 35 dB bar; outputs in [0, 1]."""
    cfg = CFG.replace(precision="bf16")
    params, clip = _params(), _clip(rng)
    model = _model(params, cfg)
    prepare, infer = build_quantized_clip_inference(cfg)
    qtail = prepare(model, params, torch.from_numpy(clip), frames=4)
    got = infer(model, qtail, torch.from_numpy(clip))
    want = build_clip_inference(cfg)(model, torch.from_numpy(clip))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert _psnr(got.numpy(), want.numpy()) > INT8_VS_FLOAT_DB


def test_chunked_int8_is_bit_equal_to_one_shot(rng):
    cfg = CFG.replace(precision="bf16")
    params, clip = _params(), _clip(rng, (1, 7, 8, 12, 3))
    model = _model(params, cfg)
    prepare, infer = build_quantized_clip_inference(cfg)
    qtail = prepare(model, params, torch.from_numpy(clip), frames=4)
    one_shot = infer(model, qtail, torch.from_numpy(clip))
    windows = []
    build_chunked_inference(cfg)(model, clip, chunk=3, sink=windows.append, qtail=qtail)
    assert [w.shape[1] for w in windows] == [3, 3, 1]
    assert torch.equal(torch.cat(windows, dim=1), one_shot)
    assert not torch.equal(build_chunked_inference(cfg)(model, clip, chunk=3), one_shot)


@pytest.mark.parametrize("change", [dict(bug_parity=True), dict(use_pallas=False),
                                    dict(warp_group=2)])
def test_int8_needs_the_fused_route(change):
    with pytest.raises(ValueError):
        build_quantized_clip_inference(CFG.replace(**change))


def test_chunked_int8_refused_on_the_exact_route(rng):
    cfg = CFG.replace(use_pallas=False)
    params = _params()
    qtail = quant.quantize_tail(params, _jax_maxes(params, rng), device="cpu")
    with pytest.raises(ValueError):
        build_chunked_inference(cfg)(_model(params, cfg), _clip(rng), chunk=3, qtail=qtail)
