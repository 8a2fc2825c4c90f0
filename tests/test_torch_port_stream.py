"""Port parity, chunked and streaming inference: tecogan_tpu_torch's
build_chunked_inference and build_stream_inference against the JAX
package's on the same weights, and against the port's own one-shot clip
(CPU, fp32, num_resblock=2, small frames)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.inference import build_chunked_inference as j_chunked
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.inference import (
    StreamState, build_chunked_inference, build_clip_inference,
    build_stream_inference)
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.ops.image import transfer_to_uint8
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

CFG = TecoConfig(num_resblock=2, precision="fp32")
LR = (1, 8, 12, 3)  # (B, H, W, 3) of one LR frame
# the bars and inputs of tests/test_torch_port_inference.py, which says
# why: fp32 generator parity through the recurrence on the exact route,
# 50 dB on the fused route; conv kernels scaled by 2.5 and LR clips in
# [0, 0.3], so that the output depends on the input and the warp.
EXACT_TOL = 1e-4
FUSED_PSNR_DB = 50.0
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3

ROUTES = {"exact_parity": dict(bug_parity=True, use_pallas=False),
          "exact": dict(bug_parity=False, use_pallas=False),
          "fused": dict(bug_parity=False, use_pallas=True)}


def _cfg(route):
    return CFG.replace(**ROUTES[route])


def _params(seed=0):
    """init_generator's draw with every conv kernel scaled by KERNEL_GAIN."""
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else
                (v * np.float32(KERNEL_GAIN) if k == "kernel" else v)
                for k, v in tree.items()}
    return scale(init_generator(CFG, torch.Generator().manual_seed(seed)))


def _model(params, cfg=CFG):
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _clip(seed, T, B=LR[0]):
    rng = np.random.default_rng(seed)
    return rng.random((B, T, *LR[1:]), np.float32) * np.float32(CLIP_RANGE)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("route", ["exact_parity", "exact"])
def test_chunked_exact_route_matches_jax(route):
    cfg, params, clip = _cfg(route), _params(), _clip(0, 11)
    ref = j_chunked(JaxTecoConfig(**dataclasses.asdict(cfg)))(params, clip, chunk=4)
    got = build_chunked_inference(cfg)(_model(params), clip, chunk=4)
    assert tuple(got.shape) == ref.shape == (1, 11, 32, 48, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=EXACT_TOL)


def test_chunked_fused_route_matches_jax():
    cfg, params, clip = _cfg("fused"), _params(), _clip(1, 10)
    ref = j_chunked(JaxTecoConfig(**dataclasses.asdict(cfg)))(params, clip, chunk=4)
    got = build_chunked_inference(cfg)(_model(params), clip, chunk=4)
    assert tuple(got.shape) == ref.shape
    assert _psnr(got[:, -1].numpy(), ref[:, -1]) > FUSED_PSNR_DB


@pytest.mark.parametrize("route", list(ROUTES))
def test_stream_equals_clip(route):
    cfg = _cfg(route)
    model, clip = _model(_params()), torch.from_numpy(_clip(2, 6))
    want = build_clip_inference(cfg)(model, clip)
    init_fn, step_fn = build_stream_inference(cfg)
    state = init_fn(LR, device="cpu")
    assert isinstance(state, StreamState) and state.initialized is False
    carry_shape = (1, 8, 12, 48) if route == "fused" else (1, 32, 48, 3)
    assert tuple(state.prev_sr.shape) == carry_shape
    frames = []
    for t in range(clip.shape[1]):
        state, frame = step_fn(model, state, clip[:, t])
        frames.append(frame)
    assert state.initialized is True
    assert state.prev_sr.dtype == (torch.bfloat16 if route == "fused" else torch.float32)
    torch.testing.assert_close(torch.stack(frames, dim=1), want, rtol=0, atol=0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunked_equals_one_shot(route):
    """Windows of 3 over T=7: two full windows and a partial one."""
    cfg = _cfg(route)
    model, clip = _model(_params()), _clip(3, 7, B=2)
    want = build_clip_inference(cfg)(model, torch.from_numpy(clip))
    got = build_chunked_inference(cfg)(model, clip, chunk=3)
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_chunked_u8_output_equals_transfer_to_uint8(route):
    cfg = _cfg(route)
    model, clip = _model(_params()), _clip(4, 5)
    f32 = build_chunked_inference(cfg)(model, clip, chunk=2)
    u8 = build_chunked_inference(cfg, out_u8=True)(model, clip, chunk=2)
    assert u8.dtype == torch.uint8
    torch.testing.assert_close(u8, transfer_to_uint8(f32), rtol=0, atol=0)


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_u8_input_equals_host_dequantized_f32(route):
    """A uint8 clip or frame, dequantized on the device, equals the f32
    path fed the host-dequantized values: clip, chunked and stream."""
    cfg = _cfg(route)
    model = _model(_params())
    q = np.random.default_rng(5).integers(0, 256, (1, 5, *LR[1:]), dtype=np.uint8)
    host = torch.from_numpy(q.astype(np.float32) * np.float32(1.0 / 255.0))
    q = torch.from_numpy(q)
    want = build_clip_inference(cfg)(model, host)
    torch.testing.assert_close(build_clip_inference(cfg)(model, q), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(build_chunked_inference(cfg)(model, q, chunk=2),
                               want, rtol=0, atol=0)
    init_fn, step_fn = build_stream_inference(cfg)
    s_u8, s_f32 = init_fn(LR, device="cpu"), init_fn(LR, device="cpu")
    for t in range(q.shape[1]):
        s_u8, fr_u8 = step_fn(model, s_u8, q[:, t])
        s_f32, fr_f32 = step_fn(model, s_f32, host[:, t])
        torch.testing.assert_close(fr_u8, fr_f32, rtol=0, atol=0)
        torch.testing.assert_close(fr_u8, want[:, t], rtol=0, atol=0)


def test_sink_sees_the_windows_in_order():
    cfg = _cfg("fused")
    model, clip = _model(_params()), _clip(6, 10)
    want = build_clip_inference(cfg)(model, torch.from_numpy(clip))
    seen = []
    ret = build_chunked_inference(cfg)(model, clip, chunk=4, sink=seen.append)
    assert ret is None
    assert [w.shape[1] for w in seen] == [4, 4, 2]
    torch.testing.assert_close(torch.cat(seen, dim=1), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="chunk"):
        build_chunked_inference(cfg)(model, clip, chunk=0)
