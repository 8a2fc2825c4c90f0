"""The port's CUDA kernel on the card (marked ``cuda``; skips without a GPU).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig
from tecogan_tpu_torch.engine.inference import build_clip_inference
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

pytestmark = pytest.mark.cuda

# bf16 kernel vs the fp32 plain version on the same bf16 inputs: two bf16
# ulps at 1.0 for the max, and a mean well below one ulp.
MAX_ERR, MEAN_ERR = 8e-3, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.rand(shape, generator=g, device=dev).bfloat16()
    k = torch.randn((3, 3, 64, 3), generator=g, device=dev) * 0.05
    b = torch.randn((3,), generator=g, device=dev) * 0.1
    return feat, k, b


@pytest.mark.parametrize("shape", [(1, 48, 64, 64), (2, 36, 44, 64),
                                   (1, 148, 212, 64), (3, 4, 4, 64)])
def test_kernel_matches_reference(cuda, shape):
    feat, k, b = _inputs(cuda, shape)
    ref = kmod.conv_out_s2d_reference(feat.float(), k, b)
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


def test_fused_route_on_the_card_matches_the_cpu(cuda):
    """The served route on the card (bf16, the kernel) against the same
    route on the CPU (fp32, the plain version): last-frame PSNR > 40 dB,
    and one kernel launch a frame."""
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    sd = generator_state_dict_from_jax(
        init_generator(cfg, torch.Generator().manual_seed(0)))
    gpu_model = model_defs(cfg).to(cuda)
    gpu_model.load_state_dict(sd)
    cpu_model = model_defs(cfg.replace(precision="fp32"))
    cpu_model.load_state_dict(sd)
    clip = torch.from_numpy(
        np.random.default_rng(0).random((1, 5, 12, 20, 3), np.float32))
    infer = build_clip_inference(cfg)
    kmod.launch_count = 0
    got = infer(gpu_model.eval(), clip.to(cuda)).cpu()
    assert kmod.launch_count == 5
    want = infer(cpu_model.eval(), clip)
    mse = float(torch.mean((got[:, -1].double() - want[:, -1].double()) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 40.0
