"""The port's CUDA kernels on the card (marked ``cuda``; skip without a GPU).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                build_stream_inference)
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.rand(shape, generator=g, device=dev).bfloat16()
    k = torch.randn((3, 3, 64, 3), generator=g, device=dev) * 0.05
    b = torch.randn((3,), generator=g, device=dev) * 0.1
    return feat, k, b


def _warp_inputs(dev, shape, lo, hi, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, H, W = shape
    carry = torch.rand((B, H, W, 48), generator=g, device=dev).bfloat16()
    prev_lr = torch.rand((B, H, W, 3), generator=g, device=dev) * (hi - lo) + lo
    return carry, prev_lr


def _models(dev, cfg, seed=0):
    """The same random weights, conv kernels scaled by KERNEL_GAIN, on the
    card (cfg's dtype) and on the CPU (fp32)."""
    sd = generator_state_dict_from_jax(
        init_generator(cfg, torch.Generator().manual_seed(seed)))
    sd = {k: v * KERNEL_GAIN if k.endswith("weight") else v for k, v in sd.items()}
    gpu = model_defs(cfg, device=dev)
    gpu.load_state_dict(sd)
    cpu = model_defs(cfg.replace(precision="fp32"), device="cpu")
    cpu.load_state_dict(sd)
    return gpu.eval(), cpu.eval()


# the last spans 5 strips and 5 bands of the kernel's tiling, with ragged
# tails in both
@pytest.mark.parametrize("shape", [(1, 48, 64, 64), (2, 36, 44, 64),
                                   (1, 148, 212, 64), (3, 4, 4, 64),
                                   (2, 4 * 67, 4 * 133, 64)])
def test_kernel_matches_reference(cuda, shape):
    """Against the plain version on the bf16-rounded weights the kernel
    computes with, so that the bars measure its arithmetic."""
    feat, k, b = _inputs(cuda, shape)
    ref = kmod.conv_out_s2d_reference(feat.float(), k.bfloat16().float(), b)
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
        "float32 features": (feat.float(), k, b),
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
    gpu_model, cpu_model = _models(cuda, cfg)
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
    model, _ = _models(cuda, cfg)
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
