"""The port's CUDA kernels on the card (marked ``cuda``; skip without a GPU).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                build_quantized_clip_inference,
                                                build_stream_inference)
from tecogan_tpu_torch.engine.losses import apply_discriminator, discriminator_loss
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                            model_defs, state_from_params,
                                            train_model_defs, train_tensors)
from tecogan_tpu_torch.engine.train import build_train_step
from tecogan_tpu_torch.utils.checkpoint import load_train_state, save_train_state
from tecogan_tpu_torch.engine.quant import qtail_to, quantize_tail, tail_features_int8
from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod
from tecogan_tpu_torch.tools.int8_layers import layer_inputs
from tecogan_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                             generator_state_dict_from_jax)

pytestmark = pytest.mark.cuda

# bf16 kernel vs the fp32 plain version on the same bf16 inputs: two bf16
# ulps at 1.0 for the max, and a mean well below one ulp.
MAX_ERR, MEAN_ERR = 8e-3, 1e-3
# warp: its outputs lie in [0.5, 1) (deprocess), where one bf16 ulp is
# 2**-8 ~ 3.9e-3; the kernel rounds once, so the mean stays below 1e-3.
WARP_MAX_ERR, WARP_MEAN_ERR = 4e-3, 1e-3
# as in tests/test_torch_port_inference.py: conv kernels scaled by 2.5 and
# LR clips in [0, 0.3], so that the output depends on the input and the
# warp (at torch's default init scale it barely does).
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3
# training on the card against the CPU, fp32 with TF32 off: the two differ
# in summation order only (chip_smoke.py phase 10's bar).  After a step,
# the bars the CPU holds against JAX (tests/test_torch_port_train_step.py):
# BN statistics and params 1e-6 abs, Adam's moments and D's grads 1e-4
# of the leaf's largest element; Adam's first step is about sign(g) * lr,
# so where a gradient element is within that disagreement of 0, its step
# may go the other way: those (at most a few per thousand) are held to
# the step's range, 2 * lr.
TRAIN_RTOL = 1e-4
PARAM_TOL = STATS_TOL = 1e-6
MOMENT_RTOL = 1e-4
TINY_TRAIN = TecoConfig(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                        discrim_channels=16, batch_size=2, precision="fp32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, shape, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.rand(shape, generator=g, device=dev).to(dtype)
    k = torch.randn((3, 3, 64, 3), generator=g, device=dev) * 0.05
    b = torch.randn((3,), generator=g, device=dev) * 0.1
    return feat, k, b


def _warp_inputs(dev, shape, lo, hi, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, H, W = shape
    carry = torch.rand((B, H, W, 48), generator=g, device=dev).bfloat16()
    prev_lr = torch.rand((B, H, W, 3), generator=g, device=dev) * (hi - lo) + lo
    return carry, prev_lr


def _models(dev, cfg, seed=0, cpu_precision="fp32"):
    """The same random weights, conv kernels scaled by KERNEL_GAIN, on the
    card (cfg's dtype) and on the CPU (``cpu_precision``)."""
    sd = generator_state_dict_from_jax(
        init_generator(cfg, torch.Generator().manual_seed(seed)))
    sd = {k: v * KERNEL_GAIN if k.endswith("weight") else v for k, v in sd.items()}
    gpu = model_defs(cfg, device=dev)
    gpu.load_state_dict(sd)
    cpu = model_defs(cfg.replace(precision=cpu_precision), device="cpu")
    cpu.load_state_dict(sd)
    return gpu.eval(), cpu.eval(), sd


# the last spans 5 strips and 5 bands of the bf16 kernel's tiling, with
# ragged tails in both
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 48, 64, 64), (2, 36, 44, 64),
                                   (1, 148, 212, 64), (3, 4, 4, 64),
                                   (2, 4 * 67, 4 * 133, 64)])
def test_kernel_matches_reference(cuda, shape, dtype):
    """Against the plain version in f32 on the weights the kernel computes
    with, so that the bars measure its arithmetic: rounded to bf16 for bf16
    features, as they are for the fp32 route's f32 kernel."""
    feat, k, b = _inputs(cuda, shape, dtype=dtype)
    kw = k.bfloat16().float() if dtype == torch.bfloat16 else k
    ref = kmod.conv_out_s2d_reference(feat.float(), kw, b)
    kmod.launch_count = 0
    got = kmod.conv_out_s2d_cuda(feat, k, b)
    torch.cuda.synchronize()
    assert kmod.launch_count == 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref).abs()
    assert float(err.max()) <= MAX_ERR and float(err.mean()) <= MEAN_ERR


def test_kernel_refuses_what_it_does_not_take(cuda):
    feat, k, b = _inputs(cuda, (1, 16, 16, 64))
    bad = {
        "float16 features": (feat.half(), k, b),
        "NCHW memory": (feat.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), k, b),
        "channel count": (feat[..., :32].contiguous(), k, b),
        "HR not a multiple of 4": (feat[:, :14].contiguous(), k, b),
        "bf16 weights": (feat, k.bfloat16(), b),
        "CPU weights": (feat, k.cpu(), b),
    }
    kmod.launch_count = 0
    for what, args in bad.items():
        with pytest.raises(ValueError):
            kmod.conv_out_s2d_cuda(*args)
    assert kmod.launch_count == 0
    empty = kmod.conv_out_s2d_cuda(feat[:0], k, b)
    assert tuple(empty.shape) == (0, 4, 4, 48) and kmod.launch_count == 0


@pytest.mark.parametrize("shape,lo,hi", [((1, 8, 12), 0.0, 1.0),
                                         ((2, 5, 7), -0.5, 0.5),
                                         ((3, 37, 53), -0.5, 0.5),
                                         ((1, 68, 120), 0.0, 1.0),
                                         ((2, 67, 133), -0.5, 0.5)])
def test_warp_kernel_matches_reference(cuda, shape, lo, hi):
    carry, prev_lr = _warp_inputs(cuda, shape, lo, hi)
    ref = wmod.warp_s2d_feedback_reference(carry, prev_lr)
    wmod.launch_count = 0
    got = wmod.warp_s2d_feedback_cuda(carry, prev_lr)
    torch.cuda.synchronize()
    assert wmod.launch_count == 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref).abs()
    assert float(err.max()) <= WARP_MAX_ERR and float(err.mean()) <= WARP_MEAN_ERR


def test_warp_kernel_refuses_what_it_does_not_take(cuda):
    carry, prev_lr = _warp_inputs(cuda, (2, 6, 8), 0.0, 1.0)
    bad = {
        "float32 carry": (carry.float(), prev_lr),
        "NCHW carry": (carry.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                       prev_lr),
        "channel count": (carry[..., :24].contiguous(), prev_lr),
        "strided prev_lr": (carry, prev_lr.permute(0, 3, 1, 2).contiguous()
                            .permute(0, 2, 3, 1)),
        "bf16 prev_lr": (carry, prev_lr.bfloat16()),
        "prev_lr shape": (carry, prev_lr[:, :5].contiguous()),
        "CPU prev_lr": (carry, prev_lr.cpu()),
    }
    wmod.launch_count = 0
    for what, args in bad.items():
        with pytest.raises(ValueError):
            wmod.warp_s2d_feedback_cuda(*args)
    assert wmod.launch_count == 0


def test_fused_route_on_the_card_matches_the_cpu(cuda):
    """The served route on the card (bf16, both kernels) against the same
    route on the CPU (fp32, the plain versions): last-frame PSNR > 40 dB,
    one conv_out_s2d launch a frame and one warp launch a later frame."""
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    gpu_model, cpu_model, _ = _models(cuda, cfg)
    clip = torch.from_numpy(
        np.random.default_rng(0).random((1, 5, 12, 20, 3), np.float32) * CLIP_RANGE)
    infer = build_clip_inference(cfg)
    kmod.launch_count = wmod.launch_count = 0
    got = infer(gpu_model, clip.to(cuda)).cpu()
    assert (kmod.launch_count, wmod.launch_count) == (5, 4)
    want = infer(cpu_model, clip)
    mse = float(torch.mean((got[:, -1].double() - want[:, -1].double()) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 40.0


@pytest.mark.parametrize("bug_parity", [True, False])
def test_stream_equals_clip_on_the_card(cuda, bug_parity):
    """Frame by frame through step_fn == the one-shot clip, bit for bit
    (cuDNN held to deterministic algorithms), with the route's launch
    counts."""
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=bug_parity)
    model, _, _ = _models(cuda, cfg)
    clip = torch.from_numpy(
        np.random.default_rng(1).random((2, 6, 9, 13, 3), np.float32) * CLIP_RANGE).to(cuda)
    torch.backends.cudnn.deterministic = True
    try:
        want = build_clip_inference(cfg)(model, clip)
        init_fn, step_fn = build_stream_inference(cfg)
        state = init_fn((2, 9, 13, 3), device=cuda)
        kmod.launch_count = wmod.launch_count = 0
        frames = []
        for t in range(clip.shape[1]):
            state, frame = step_fn(model, state, clip[:, t])
            frames.append(frame)
        counts = (kmod.launch_count, wmod.launch_count)
    finally:
        torch.backends.cudnn.deterministic = False
    assert counts == ((0, 0) if bug_parity else (6, 5))
    assert torch.equal(torch.stack(frames, dim=1), want)


# (B, H, W, Cin, Cout, relu, residual): the main path's 3x3 layers at
# 270p -> 1080p (LR resblocks with ReLU and with the residual, the 540 x
# 960 trunk, conv_hr at 1080p), LR 135 x 240 at B=2, 37 x 53 with odd H
# and W in both channel counts, and the edges of the kernels' tiles of 2
# rows x 64 columns: W below 64, W = 64k + 1, W not a multiple of 64,
# H = 1, B = 3
INT8_CONV_SHAPES = [(1, 270, 480, 64, 64, True, False), (1, 270, 480, 64, 64, False, True),
                    (2, 135, 240, 64, 64, True, True), (1, 37, 53, 64, 128, False, False),
                    (1, 37, 53, 128, 64, True, True), (1, 540, 960, 64, 64, True, False),
                    (1, 540, 960, 64, 128, True, False), (1, 540, 960, 128, 128, False, False),
                    (1, 1080, 1920, 128, 64, True, False), (1, 5, 40, 64, 64, True, True),
                    (2, 3, 129, 128, 128, False, True), (1, 1, 130, 128, 64, True, False),
                    (3, 7, 70, 64, 128, False, True)]
# up1, up2, odd shapes in both channel counts, and the tile edges as
# above, with Cin != Cout both ways and residuals
INT8_UP_SHAPES = [(1, 270, 480, 64, 64, True, False), (1, 540, 960, 128, 128, True, False),
                  (2, 37, 53, 64, 64, True, True), (1, 37, 53, 128, 128, False, False),
                  (1, 5, 40, 128, 64, True, True), (2, 1, 65, 64, 128, False, True),
                  (3, 4, 129, 64, 64, True, True), (1, 3, 70, 128, 64, False, True)]


# the fp32 route's instantiations, float32 activations in and out
INT8_F32_SHAPES = [(1, 37, 53, 64, 64, False, True), (2, 3, 129, 128, 128, True, True),
                   (1, 1, 130, 128, 64, True, False), (3, 7, 70, 64, 128, False, True)]


@pytest.mark.parametrize("up,shape,dtype", [(False, s, torch.bfloat16) for s in INT8_CONV_SHAPES]
                         + [(True, s, torch.bfloat16) for s in INT8_UP_SHAPES]
                         + [(up, s, torch.float32) for s in INT8_F32_SHAPES
                            for up in (False, True)])
def test_int8_kernel_is_bit_equal_to_plain(cuda, up, shape, dtype):
    """Each int8 kernel against its plain version (float64 integer sums)
    on the same inputs, in x's dtype: bit-equal, one launch."""
    B, H, W, cin, cout, relu, residual = shape
    x, inv_s, wq, deq, bias, res = layer_inputs(cuda, up, (B, H, W, cin, cout), 0, dtype)
    res = res if residual else None
    kernel, plain = ((qmod.int8_up2x_cuda, qmod.int8_up2x_reference) if up else
                     (qmod.int8_conv3x3_cuda, qmod.int8_conv3x3_reference))
    qmod.conv3x3_launch_count = qmod.up2x_launch_count = 0
    got = kernel(x, inv_s, wq, deq, bias, relu, res)
    torch.cuda.synchronize()
    assert (qmod.conv3x3_launch_count, qmod.up2x_launch_count) == ((0, 1) if up else (1, 0))
    want = plain(x, inv_s, wq, deq, bias, relu, res)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("up", [False, True])
def test_int8_kernel_reads_inputs_made_just_before(cuda, up):
    """Under programmatic dependent launch every input may be written by
    the kernel just before on the stream: weights, deq, bias or inv_s made
    on the card right before each launch give the plain version's output."""
    x = layer_inputs(cuda, up, (1, 40, 200, 128, 128), 9)[0]
    kernel, plain = ((qmod.int8_up2x_cuda, qmod.int8_up2x_reference) if up else
                     (qmod.int8_conv3x3_cuda, qmod.int8_conv3x3_reference))
    g = torch.Generator(device=cuda).manual_seed(10)
    for i in range(8):
        wq = torch.randint(-127, 128, (128, 3, 3, 128), generator=g, device=cuda,
                           dtype=torch.int8)
        inv_s = (torch.rand((), generator=g, device=cuda) + 1.0) * 40.0
        deq = torch.rand((128,), generator=g, device=cuda) * 1e-4 + 1e-6
        bias = torch.randn((128,), generator=g, device=cuda) * 0.1
        # the last kernel before each launch writes one of the inputs
        last = (wq, inv_s, deq, bias)[i % 4]
        last.copy_(last.flip(0) if last.dim() else last + 1.0)
        got = kernel(x, inv_s, wq, deq, bias, True, None)
        want = plain(x, inv_s, wq, deq, bias, True, None)
        assert torch.equal(got, want), (i, float((got.float() - want.float()).abs().max()))


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    x, inv_s, wq, deq, bias, res = layer_inputs(cuda, False, (1, 6, 10, 64, 64), 0)
    bad = {
        "float16 x": (x.half(), inv_s, wq, deq, bias, False, None),
        "32 channels": (x[..., :32].contiguous(), inv_s, wq[..., :32].contiguous(), deq,
                        bias, False, None),
        "96 output channels": (x, inv_s, wq[:32].repeat(3, 1, 1, 1), deq.repeat(2)[:96],
                               None, False, None),
        "NCHW memory": (x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), inv_s, wq,
                        deq, bias, False, None),
        "float weights": (x, inv_s, wq.float(), deq, bias, False, None),
        "CPU deq": (x, inv_s, wq, deq.cpu(), bias, False, None),
        "bf16 bias": (x, inv_s, wq, deq, bias.bfloat16(), False, None),
        "float32 residual": (x, inv_s, wq, deq, bias, False, res.float()),
        "misaligned residual": (x, inv_s, wq, deq, bias, False,
                                torch.empty(res.numel() + 8, dtype=res.dtype, device=cuda)
                                [1:1 + res.numel()].view(res.shape)),
        "CPU x": (x.cpu(), inv_s, wq, deq, bias, False, None),
    }
    qmod.conv3x3_launch_count = qmod.up2x_launch_count = 0
    for what, args in bad.items():
        for fn in (qmod.int8_conv3x3_cuda, qmod.int8_up2x_cuda):
            with pytest.raises(ValueError):
                fn(*args)
    assert (qmod.conv3x3_launch_count, qmod.up2x_launch_count) == (0, 0)


def test_int8_tail_on_the_card_is_bit_equal_to_the_cpu(cuda):
    """The quantized tail (37 + 2 layers at 16 resblocks; here 2) on the
    card against the CPU's plain versions, same bf16 input and qtail: bit
    for bit, through the ReLU and residual plumbing."""
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    gpu_model, cpu_model, sd = _models(cuda, cfg, cpu_precision="bf16")
    clip = torch.from_numpy(
        np.random.default_rng(3).random((1, 3, 12, 20, 3), np.float32) * CLIP_RANGE)
    qtail = build_quantized_clip_inference(cfg)[0](gpu_model, sd, clip, frames=3)
    net = torch.rand((2, 12, 20, 64), generator=torch.Generator().manual_seed(4)).bfloat16()
    with torch.inference_mode():
        got = tail_features_int8(gpu_model, qtail, net.to(cuda)).cpu()
        want = tail_features_int8(cpu_model, qtail_to(qtail, "cpu"), net)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_int8_clip_on_the_card_matches_the_cpu(cuda):
    """The int8 route on the card (bf16, all four kernels) against the same
    route on the CPU (bf16, the plain versions) with one qtail, and the
    launch counts of T frames.  The first layer (cuDNN against the CPU's
    conv) and conv_out_s2d round their bf16 outputs differently, and a
    value on the other side of a quantizer's rounding boundary moves a
    whole step, so the card sits from the CPU about as far as the CPU's
    int8 clip from its bf16 clip: each frame within 3 dB of that, and above
    35 dB (JAX's int8 bar).  Frame 0 measured 40.2 dB, below the 45 dB
    first planned."""
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    gpu_model, cpu_model, sd = _models(cuda, cfg, cpu_precision="bf16")
    clip = torch.from_numpy(
        np.random.default_rng(2).random((1, 5, 12, 20, 3), np.float32) * CLIP_RANGE)
    prepare, infer = build_quantized_clip_inference(cfg)
    qtail = prepare(gpu_model, sd, clip, frames=4)
    assert all(q["wq"].device.type == "cuda" for q in qtail.values())
    qmod.conv3x3_launch_count = qmod.up2x_launch_count = 0
    kmod.launch_count = wmod.launch_count = 0
    got = infer(gpu_model, qtail, clip.to(cuda)).cpu()
    assert (qmod.conv3x3_launch_count, qmod.up2x_launch_count,
            kmod.launch_count, wmod.launch_count) == (5 * 9, 5 * 2, 5, 4)
    want = infer(cpu_model, qtail_to(qtail, "cpu"), clip)
    want_bf16 = build_clip_inference(cfg)(cpu_model, clip)

    def db(a, b):
        mse = float(torch.mean((a.double() - b.double()) ** 2))
        return 10 * np.log10(1.0 / max(mse, 1e-12))

    for t in range(clip.shape[1]):
        card, quant_err = db(got[:, t], want[:, t]), db(want[:, t], want_bf16[:, t])
        print(f"frame {t}: card vs CPU {card:.2f} dB, CPU int8 vs bf16 {quant_err:.2f} dB")
        assert card >= max(35.0, quant_err - 3.0), t


def _db(a, b):
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


# the fp32 fused route on the card against the CPU, TF32 off: the convs sum
# in another order, and a carry value on the other side of a rounding
# boundary moves a step; the CPU's bar against JAX
# (tests/test_torch_port_inference.py).  Measured 85-120 dB.
FP32_FUSED_DB = 50.0


def test_fp32_routes_on_the_card_match_the_cpu(cuda):
    """The fused and the int8 route in fp32 on the card, through the
    kernels' f32 instantiations (the warp kernel reads the bf16 carry):
    every frame matches the CPU's.  The bf16 route launches all four
    kernels as well."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TecoConfig(num_resblock=2, precision="fp32", bug_parity=False)
    gpu_model, cpu_model, sd = _models(cuda, cfg)
    T = 4
    clip = torch.from_numpy(
        np.random.default_rng(5).random((1, T, 12, 20, 3), np.float32) * CLIP_RANGE)

    def counts():
        return (qmod.conv3x3_launch_count, qmod.up2x_launch_count, kmod.launch_count,
                wmod.launch_count)

    def reset():
        qmod.conv3x3_launch_count = qmod.up2x_launch_count = 0
        kmod.launch_count = wmod.launch_count = 0

    infer = build_clip_inference(cfg)
    reset()
    got = infer(gpu_model, clip.to(cuda)).cpu()
    assert counts() == (0, 0, T, T - 1)
    want = infer(cpu_model, clip)
    fused_db = [_db(got[:, t], want[:, t]) for t in range(T)]

    prepare, qinfer = build_quantized_clip_inference(cfg)
    qtail = prepare(gpu_model, sd, clip, frames=T)
    reset()
    got = qinfer(gpu_model, qtail, clip.to(cuda)).cpu()
    assert counts() == (T * 9, T * 2, T, T - 1)
    want_int8 = qinfer(cpu_model, qtail_to(qtail, "cpu"), clip)
    # as the bf16 int8 route (test_int8_clip_on_the_card_matches_the_cpu):
    # a value across a quantizer's rounding boundary moves a whole step, so
    # each frame sits within 3 dB of the CPU's int8-vs-fused distance and
    # above 35 dB (measured 40.3-120 dB against a 42.1 dB distance)
    int8_db = [_db(got[:, t], want_int8[:, t]) for t in range(T)]
    quant_db = [_db(want_int8[:, t], want[:, t]) for t in range(T)]
    print(f"fp32 card vs CPU: fused {[f'{d:.2f}' for d in fused_db]} dB, "
          f"int8 {[f'{d:.2f}' for d in int8_db]} dB, CPU int8 vs fused "
          f"{[f'{d:.2f}' for d in quant_db]} dB")
    assert min(fused_db) > FP32_FUSED_DB
    assert all(d >= max(35.0, qd - 3.0) for d, qd in zip(int8_db, quant_db))

    bf16 = cfg.replace(precision="bf16")
    bf16_model = model_defs(bf16, device=cuda)
    bf16_model.load_state_dict(sd)
    reset()
    build_quantized_clip_inference(bf16)[1](bf16_model.eval(), qtail, clip.to(cuda))
    assert counts() == (T * 9, T * 2, T, T - 1)


def test_float64_clip_on_the_card_is_the_float32_clip(cuda):
    """A float64 LR clip on the served route (bf16, kernels) is taken as
    float32: bit-equal to the float32 clip (cuDNN held to deterministic
    algorithms), where the warp kernel used to refuse it at frame 1."""
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    model, _, _ = _models(cuda, cfg)
    clip = torch.from_numpy(
        np.random.default_rng(6).random((1, 4, 9, 13, 3)) * CLIP_RANGE).to(cuda)
    assert clip.dtype == torch.float64
    torch.backends.cudnn.deterministic = True
    try:
        infer = build_clip_inference(cfg)
        wmod.launch_count = 0
        got = infer(model, clip)
        assert wmod.launch_count == 3
        want = infer(model, clip.float())
    finally:
        torch.backends.cudnn.deterministic = False
    assert torch.equal(got, want)


def test_quantize_tail_follows_the_maxima_to_the_card(cuda):
    """Without ``device``, the qtail lies where the maxima lie."""
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    _, _, sd = _models(cuda, cfg)
    names = ([f"resblock_{i}/Conv_{j}" for i in range(2) for j in range(2)]
             + ["up1", "trunk_rb1/Conv_0", "trunk_rb1/Conv_1", "trunk_rb2/Conv_0",
                "trunk_rb2/Conv_1", "up2", "conv_hr"])
    maxes = {n: torch.tensor(1.5, device=cuda) for n in names}
    q = quantize_tail(sd, maxes)
    assert list(q) == names
    assert all(v.device.type == "cuda" for layer in q.values() for v in layer.values()
               if v is not None)


def _train_weights(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return init_generator(cfg, g), *init_discriminator(cfg, g)


def _train_batches(cfg, n):
    out = []
    for i in range(n):
        lr, hr = synthetic_scene_batch(cfg.batch_size, cfg.RNN_N, cfg.crop_size, seed=2 * i)
        out.append((torch.from_numpy(lr), torch.from_numpy(hr)))
    return out


def _leaf_rel(a, b):
    """max |a - b| over the largest |b|, a on the card, b on the CPU."""
    return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _assert_states_close(got, want):
    """Every leaf of a state on the card against the CPU's after one step."""
    for k, b in want.batch_stats_d.items():
        assert float((got.batch_stats_d[k].cpu() - b).abs().max()) <= STATS_TOL, k
    for side in ("g", "d"):
        opt_g, opt_w = getattr(got, f"opt_{side}"), getattr(want, f"opt_{side}")
        assert opt_g.count == opt_w.count and opt_g.learning_rate == opt_w.learning_rate
        for name in ("mu", "nu"):
            for k, b in getattr(opt_w, name).items():
                assert _leaf_rel(getattr(opt_g, name)[k], b) <= MOMENT_RTOL, (side, name, k)
        lr = opt_w.learning_rate
        for k, b in getattr(want, f"params_{side}").items():
            diff = (getattr(got, f"params_{side}")[k].cpu() - b).abs()
            mu = opt_w.mu[k].abs()
            free = mu <= MOMENT_RTOL * mu.max()
            assert float(torch.where(free, 0.0, diff).max()) <= PARAM_TOL, (side, k)
            assert float(torch.where(free, diff, 0.0).max()) <= 2.0001 * lr, (side, k)
            excused = int((free & (diff > PARAM_TOL)).sum())
            assert excused <= max(2, 3e-3 * diff.numel()), (side, k, excused)


@pytest.mark.parametrize("bug_parity", [True, False])
def test_train_steps_on_the_card_match_the_cpu(cuda, bug_parity):
    """Three tiny fp32 steps on the card and on the CPU from the same
    weights and batches: gen_loss each step, d_loss at step 0, and after
    step 0 every leaf of the state: G's and D's params, D's BN statistics
    and both Adam states."""
    cfg = TINY_TRAIN.replace(bug_parity=bug_parity)
    weights = _train_weights(cfg)
    losses, first = {}, {}
    for dev in (cuda, torch.device("cpu")):
        state = state_from_params(cfg, *weights, device=dev)
        step = build_train_step(cfg, device=dev)
        losses[dev.type] = []
        for lr, hr in _train_batches(cfg, 3):
            state, metrics, _ = step(state, lr, hr)
            losses[dev.type].append((float(metrics["gen_loss"]), float(metrics["d_loss"])))
            first.setdefault(dev.type, state)
        assert state.step == 3
    for (gg, gd), (cg, cd) in zip(losses["cuda"], losses["cpu"]):
        assert abs(gg - cg) <= TRAIN_RTOL * abs(cg)
    assert abs(losses["cuda"][0][1] - losses["cpu"][0][1]) <= TRAIN_RTOL * losses["cpu"][0][1]
    _assert_states_close(first["cuda"], first["cpu"])


def test_discriminator_on_the_card_matches_the_cpu(cuda):
    """D's score, maps, the BN running statistics after
    discriminator_loss and the loss's grads with respect to every D param,
    fp32 on the card (its params channels_last, as the train step holds
    them) against the CPU, with the bars the CPU holds against flax and
    JAX.  The inputs are drawn as the train step's: values in [0, 1], a
    batch of B * 3 triplets.  On zero-mean N(0, 1) inputs at batch 2 the
    card's float32 grads sit up to 3e-2 of the leaf's largest element off
    a float64 run, in either layout and with deterministic algorithms
    too (the CPU's: 1e-6; that backward runs a non-fused Winograd weight
    grad among cuDNN's kernels); on inputs like these, 3e-5
    (``python -m tecogan_tpu_torch.tools.grad_precision``)."""
    cfg = TINY_TRAIN
    _, params, stats = _train_weights(cfg, seed=1)
    rng = np.random.default_rng(3)
    n = cfg.batch_size * 3
    real = torch.from_numpy(rng.random((n, 27, 32, 32), np.float32))
    fake = torch.from_numpy(rng.random((n, 27, 32, 32), np.float32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        disc = train_model_defs(cfg, device=dev)[1]
        pd, sd = discriminator_state_dict_from_jax(params, stats)
        pd, sd = train_tensors(pd, dev), train_tensors(sd, dev)
        with torch.no_grad():
            score, layers, _ = apply_discriminator(disc, pd, sd, real.to(dev), mutable=False)
        leaves = {k: v.requires_grad_() for k, v in pd.items()}
        loss, new = discriminator_loss(disc, leaves, sd, real.to(dev), fake.to(dev), cfg)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        out[dev.type] = (score.cpu(), [x.cpu() for x in layers], float(loss.detach()),
                         {k: v.cpu() for k, v in new.items()},
                         {k: v.cpu() for k, v in grads.items()})
    (s_g, l_g, loss_g, st_g, gr_g), (s_c, l_c, loss_c, st_c, gr_c) = out["cuda"], out["cpu"]
    assert float((s_g - s_c).abs().max()) <= 1e-5
    for a, b in zip(l_g, l_c):
        assert float((a - b).abs().max()) <= 2e-5
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for k in st_c:
        assert float((st_g[k] - st_c[k]).abs().max()) <= STATS_TOL, k
    assert gr_g.keys() == gr_c.keys()
    for k in gr_c:
        assert _leaf_rel(gr_g[k], gr_c[k]) <= MOMENT_RTOL, k


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A bf16 training state on the card, two steps in, saved and loaded
    into a fresh state: every tensor bit-equal, counts, step and epoch."""
    cfg = TINY_TRAIN.replace(precision="bf16")
    state = state_from_params(cfg, *_train_weights(cfg), device=cuda)
    step = build_train_step(cfg, device=cuda)
    for lr, hr in _train_batches(cfg, 2):
        state, _, _ = step(state, lr, hr)
    save_train_state(str(tmp_path), state, epoch=4)
    template = state_from_params(cfg, *_train_weights(cfg, seed=5), device=cuda)
    loaded, epoch = load_train_state(str(tmp_path), template)
    assert (epoch, loaded.epoch, loaded.step) == (4, 4, 2)
    for a, b in ((state.params_g, loaded.params_g), (state.params_d, loaded.params_d),
                 (state.batch_stats_d, loaded.batch_stats_d),
                 (state.opt_g.mu, loaded.opt_g.mu), (state.opt_g.nu, loaded.opt_g.nu),
                 (state.opt_d.mu, loaded.opt_d.mu), (state.opt_d.nu, loaded.opt_d.nu)):
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].device.type == "cuda" and torch.equal(a[k], b[k]), k
    assert (loaded.opt_g.count, loaded.opt_d.count) == (2, 2)
    assert loaded.opt_d.learning_rate == state.opt_d.learning_rate
