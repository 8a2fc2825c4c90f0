"""Port parity, the serving slice: tecogan_tpu_torch's build_clip_inference
and fused s2d-carry pieces against the JAX package on the same weights and
clips (CPU, fp32, num_resblock=2, small frames)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine import fused as j_fused
from tecogan_tpu.engine.inference import build_clip_inference as j_build
from tecogan_tpu.engine.state import model_defs as j_model_defs
from tecogan_tpu.ops.image import deprocess as j_deprocess
from tecogan_tpu.ops.space import space_to_depth as j_space_to_depth
from tecogan_tpu.utils.checkpoint import save_generator_params, save_pytree
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine import fused
from tecogan_tpu_torch.engine.inference import build_clip_inference, build_stream_inference
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.utils.checkpoint import load_generator_params
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TecoConfig(num_resblock=2, precision="fp32")
CLIP_SHAPE = (1, 6, 8, 12, 3)

# exact route: fp32 generator parity (2e-5 a frame) carried through 5
# recurrent warps, each of which re-reads the previous frame's error.
EXACT_TOL = 1e-4
# fused route: both warps read the carry quantized to u8 and carry it in
# bf16; the JAX warp combines in bf16, the port's in float32 (then one
# bf16 rounding), and a carry value that rounds the other way moves a
# frame by one bf16 ulp.  Measured 55.6 dB; tests/test_fused.py:160 holds
# the JAX fast path to 45 dB.  A warp sampling at 1.01x the flow scores
# 45.7 dB, no warp 25.6 dB.
FUSED_PSNR_DB = 50.0
# Weights: at torch's default init scale this small generator's output
# barely depends on its input (sigmoid of ~0 everywhere; the fused route's
# last frame does not change at all when the warp is replaced), so a wrong
# warp would pass.  With every conv kernel scaled by 2.5 the last frame
# spans about [0.08, 0.88] and a missing warp costs ~30 dB.
KERNEL_GAIN = 2.5
# LR clips are drawn in [0, CLIP_RANGE]: the pseudo-flow of such frames
# keeps most warp samples inside the frame ([0, 1] clips leave ~7%).
CLIP_RANGE = 0.3


def _jax_cfg(cfg):
    return JaxTecoConfig(**dataclasses.asdict(cfg))


def _params(seed=0):
    """init_generator's draw (torch's default init) with every conv kernel
    scaled by KERNEL_GAIN (biases as drawn)."""
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else
                (v * np.float32(KERNEL_GAIN) if k == "kernel" else v)
                for k, v in tree.items()}
    return scale(init_generator(CFG, torch.Generator().manual_seed(seed)))


def _port_model(params, cfg=CFG):
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _clip(rng):
    return rng.random(CLIP_SHAPE, np.float32) * np.float32(CLIP_RANGE)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("bug_parity", [True, False])
def test_exact_route_matches_jax(rng, bug_parity):
    cfg = CFG.replace(bug_parity=bug_parity, use_pallas=False)
    params, clip = _params(), _clip(rng)
    ref = np.asarray(j_build(_jax_cfg(cfg))(params, jnp.asarray(clip)))
    got = build_clip_inference(cfg)(_port_model(params), torch.from_numpy(clip))
    assert tuple(got.shape) == ref.shape == (1, 6, 32, 48, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=EXACT_TOL)


def test_fused_route_matches_jax_fused(rng):
    cfg = CFG.replace(bug_parity=False, use_pallas=True)
    params, clip = _params(), _clip(rng)
    ref = np.asarray(j_build(_jax_cfg(cfg))(params, jnp.asarray(clip)))
    got = build_clip_inference(cfg)(_port_model(params), torch.from_numpy(clip))
    assert tuple(got.shape) == ref.shape
    assert _psnr(got[:, -1].numpy(), ref[:, -1]) > FUSED_PSNR_DB


def test_fused_first_layer_matches_jax(rng):
    """One conv over [lr || feedback], the feedback being the warp's
    s2d(deprocess(warped)), == the JAX identity-s2d formulation on the
    warped frame (fp32 conv parity)."""
    params = _params()
    cur_lr = rng.random((2, 8, 12, 3), np.float32)
    warped = rng.random((2, 32, 48, 3), np.float32)
    ref = j_fused.fused_first_layer(params, jnp.asarray(cur_lr),
                                    jnp.asarray(warped), dtype=jnp.float32)
    feedback = np.array(j_space_to_depth(j_deprocess(jnp.asarray(warped))))
    got = fused.fused_first_layer(_port_model(params), torch.from_numpy(cur_lr),
                                  torch.from_numpy(feedback))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-5)


def test_fused_first_frame_and_s2d_to_frame_match_jax(rng):
    """Frame 0 of the fused route: bf16 carries that agree to one bf16 ulp
    below 1.0 (2**-8), and the exact s2d -> frame unpacking."""
    params = _params()
    lr0 = rng.random((2, 8, 12, 3), np.float32)
    gen = j_model_defs(_jax_cfg(CFG))[0]
    ref = j_fused.fused_first_frame_s2d(gen, {"params": params}, params,
                                        jnp.asarray(lr0))
    got = fused.fused_first_frame_s2d(_port_model(params), torch.from_numpy(lr0))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=2**-8)
    s2d = rng.random((2, 3, 4, 5, 48), np.float32)
    np.testing.assert_array_equal(
        fused.s2d_to_frame(torch.from_numpy(s2d)).numpy(),
        np.asarray(j_fused.s2d_to_frame(jnp.asarray(s2d))))


@pytest.mark.parametrize("kind", ["generator_params", "train_state"])
def test_jax_checkpoint_loads_into_the_port(rng, tmp_path, kind):
    """A .ckpt written by the JAX package, read by the jax-free loader,
    gives outputs identical to the in-memory weights."""
    params = _params(seed=3)
    path = str(tmp_path / "generator.ckpt")
    if kind == "generator_params":
        save_generator_params(path, params, meta={"epoch": 2})
    else:  # the layout of save_train_state's generator.ckpt
        opt = {"mu": params["conv_out"], "count": np.zeros((), np.int32)}
        save_pytree(path, {"model_state_dict": params,
                           "optimizer_state_dict": opt},
                    meta={"epoch": 2, "step": 7})
    cfg = CFG.replace(bug_parity=False, use_pallas=False)
    clip = torch.from_numpy(_clip(rng)[:, :3])
    infer = build_clip_inference(cfg)
    want = infer(_port_model(params), clip)
    got = infer(_port_model(load_generator_params(path)), clip)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_uint8_clip_is_dequantized_on_device(rng):
    cfg = CFG.replace(bug_parity=False, use_pallas=True)
    model = _port_model(_params())
    q = rng.integers(0, 256, CLIP_SHAPE, dtype=np.uint8)
    infer = build_clip_inference(cfg)
    got = infer(model, torch.from_numpy(q))
    want = infer(model, torch.from_numpy(q.astype(np.float32) * np.float32(1 / 255)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bug_parity", [True, False])
def test_float64_clip_is_the_float32_clip(rng, bug_parity):
    """A float64 LR clip (numpy's default) is taken as float32, as JAX
    takes it: the clip and the stream give the float32 clip's frames bit
    for bit (on the card the warp kernel reads float32 prev_lr only)."""
    cfg = CFG.replace(bug_parity=bug_parity)
    model = _port_model(_params(), cfg)
    clip = _clip(rng)
    infer = build_clip_inference(cfg)
    want = infer(model, torch.from_numpy(clip))
    wide = torch.from_numpy(clip.astype(np.float64))
    got = infer(model, wide)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    init_fn, step_fn = build_stream_inference(cfg)
    state = init_fn(clip.shape[:1] + clip.shape[2:], device="cpu")
    for t in range(clip.shape[1]):
        state, frame = step_fn(model, state, wide[:, t])
        assert torch.equal(frame, want[:, t]), t


def test_nhwc_fused_route_is_refused():
    with pytest.raises(ValueError, match="warp_group"):
        build_clip_inference(CFG.replace(bug_parity=False, use_pallas=True,
                                         warp_group=2))


def test_port_runs_without_jax():
    """The port imports neither jax nor anything of the JAX package
    ``tecogan_tpu``: run the serving slice (the int8 mode included) and the
    training slice in a fresh interpreter."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from tecogan_tpu_torch.config import TecoConfig
        from tecogan_tpu_torch.engine.inference import (
            build_chunked_inference, build_clip_inference, build_stream_inference)
        from tecogan_tpu_torch.engine.state import init_generator, model_defs
        from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax
        from tecogan_tpu_torch.utils.flops import generator_macs_per_frame
        import tecogan_tpu_torch.tools.profile_clip
        import tecogan_tpu_torch.utils.checkpoint
        cfg = TecoConfig(num_resblock=1, precision="fp32", bug_parity=False)
        model = model_defs(cfg, device="cpu")
        params = init_generator(cfg, torch.Generator().manual_seed(0))
        model.load_state_dict(generator_state_dict_from_jax(params))
        clip = torch.rand((1, 3, 4, 8, 3), generator=torch.Generator().manual_seed(1))
        out = build_clip_inference(cfg)(model, clip)
        assert tuple(out.shape) == (1, 3, 16, 32, 3), out.shape
        assert torch.equal(build_chunked_inference(cfg)(model, clip, chunk=2), out)
        init_fn, step_fn = build_stream_inference(cfg)
        state, frame = step_fn(model, init_fn((1, 4, 8, 3), device="cpu"), clip[:, 0])
        assert torch.equal(frame, out[:, 0])
        assert generator_macs_per_frame(4, 8, 1) > 0
        from tecogan_tpu_torch.engine.inference import build_quantized_clip_inference
        from tecogan_tpu_torch.utils.flops import int8_tail_macs_per_frame
        prepare, qinfer = build_quantized_clip_inference(cfg)
        qtail = prepare(model, params, clip, frames=2)
        assert all(q["wq"].dtype == torch.int8 for q in qtail.values())
        qout = qinfer(model, qtail, clip)
        assert qout.shape == out.shape and bool(torch.isfinite(qout).all())
        assert torch.equal(build_chunked_inference(cfg)(model, clip, chunk=2, qtail=qtail), qout)
        assert 0 < int8_tail_macs_per_frame(4, 8, 1) < generator_macs_per_frame(4, 8, 1)
        import tempfile
        from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
        from tecogan_tpu_torch.engine.state import init_state
        from tecogan_tpu_torch.engine.train import build_train_step
        from tecogan_tpu_torch.utils.checkpoint import load_train_state, save_train_state
        from tecogan_tpu_torch.utils.flops import train_step_macs
        import tecogan_tpu_torch.tools.grad_precision
        import tecogan_tpu_torch.tools.profile_train
        tcfg = cfg.replace(crop_size=8, RNN_N=3, discrim_resblocks=1,
                           discrim_channels=8, batch_size=1)
        ts = init_state(tcfg, torch.Generator().manual_seed(0), device="cpu")
        lr, hr = synthetic_scene_batch(1, 3, 8)
        ts, m, _ = build_train_step(tcfg, device="cpu")(
            ts, torch.from_numpy(lr), torch.from_numpy(hr))
        assert ts.step == 1 and bool(torch.isfinite(m["gen_loss"])), m
        with tempfile.TemporaryDirectory() as d:
            save_train_state(d, ts, epoch=1)
            assert load_train_state(d, ts)[0].step == 1
        assert train_step_macs(1, 3, 8, 1, 1, 8) > 0
        bad = sorted(m for m in sys.modules if m in ("jax", "flax", "tecogan_tpu")
                     or m.startswith(("jax.", "flax.", "tecogan_tpu.")))
        assert not bad, bad
        print("NO_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
