"""Port parity, test-time adaptation and the NHWC fused route:
tecogan_tpu_torch's engine/adapt.py against tecogan_tpu/engine/adapt.py
(the internal windows, ``adapt_generator`` with and without its guard,
``lr_consistency_refine``), and the fused route at ``warp_group`` 2 and 8
against the port's s2d route and the JAX NHWC route (CPU; fp32; the
configs of tests/test_adapt.py and tests/test_torch_port_inference.py).

Bars: adaptation step 0's loss 1e-4 relative, later steps 2e-3 (float
summation order compounds through Adam's ``g / |g|``-sized first steps,
as in tests/test_torch_port_train_step.py's trajectory); the guard's
scores 1e-4; the refine 1e-5; the NHWC route against JAX above
``FUSED_PSNR_DB``.
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine import adapt as j_adapt
from tecogan_tpu.engine.inference import build_clip_inference as j_build
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine import adapt
from tecogan_tpu_torch.engine.inference import (build_chunked_inference,
                                                build_clip_inference,
                                                build_stream_inference)
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

# tests/test_adapt.py's config
ADAPT_CFG = TecoConfig(precision="fp32", num_resblock=1, bug_parity=False,
                       use_pallas=False, crop_size=8, RNN_N=3)
LOSS0_RTOL, LOSS_RTOL = 1e-4, 2e-3
SCORE_TOL = 1e-4
REFINE_TOL = 1e-5
# tests/test_torch_port_inference.py's bar, weight gain and clip range
FUSED_PSNR_DB = 50.0
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3
SERVE_CFG = TecoConfig(num_resblock=2, precision="fp32", bug_parity=False, use_pallas=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread in this module: the suite runs several
    pytest workers on the machine's cores, where torch's default of a
    thread a core oversubscribes them (these tests ran ~7x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(cfg):
    return JaxTecoConfig(**dataclasses.asdict(cfg))


def _smooth_clip(frames, seed=0):
    """tests/test_adapt.py's smooth content: a 12 x 12 random image, the
    same each frame, bilinear to 24 x 24."""
    base = np.random.default_rng(seed).random((1, 12, 12, 3)).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(np.repeat(base, frames, axis=0)),
                                       (frames, 24, 24, 3), "bilinear"))


def _jax_losses(text):
    return [float(v) for v in re.findall(r"adapt step \d+: loss ([0-9.]+)", text)]


def _run_both(clip, **kw):
    """(JAX's printed per-step losses, its result; the port's per-step
    losses, its result) from the same flax weights."""
    params = init_generator(ADAPT_CFG, torch.Generator().manual_seed(0))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        want = j_adapt.adapt_generator(_jax_cfg(ADAPT_CFG), params, clip, log_every=1, **kw)
    losses = []
    got = adapt.adapt_generator(ADAPT_CFG, params, clip, device="cpu",
                                on_step=lambda i, loss: losses.append(float(loss)), **kw)
    return params, _jax_losses(out.getvalue()), want, losses, got


def _check_losses(got, want):
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS0_RTOL)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("T,rnn_n", [(6, 4), (9, 3), (2, 5)])
def test_augment_windows_is_jaxs(T, rnn_n):
    clip = np.random.default_rng(T).random((T, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(adapt._augment_windows(clip, rnn_n),
                                  j_adapt._augment_windows(clip, rnn_n))


def test_adapt_trajectory_tracks_jax():
    """4 steps on the 3 x 24 x 24 clip, both loss terms: the losses step by
    step, the adapted params against JAX's beside how far they moved (the
    bar of tests/test_torch_port_train_step.py's trajectory), and the
    input left as it was."""
    clip = _smooth_clip(3)
    params, want_losses, want, losses, got = _run_both(
        clip, steps=4, learning_rate=1e-3, consistency=0.5)
    _check_losses(losses, want_losses)
    assert all(v.dtype == torch.float32 for v in got.values())
    ref = generator_state_dict_from_jax(want)
    base = generator_state_dict_from_jax(params)
    moved = max(float((ref[k] - base[k]).abs().max()) for k in ref)
    drift = torch.cat([(got[k] - ref[k]).abs().flatten() for k in ref])
    # Adam steps an element by about sign(g) * lr, so an element whose
    # gradient lies within float noise of 0 may step the other way: a few
    # per thousand drift, by up to a fraction of the distance moved
    assert moved > 1e-4 and float(drift.max()) < 0.2 * moved, (float(drift.max()), moved)
    assert float((drift > 1e-5).float().mean()) < 1e-2
    fresh = generator_state_dict_from_jax(
        init_generator(ADAPT_CFG, torch.Generator().manual_seed(0)))
    assert all(torch.equal(v, fresh[k]) for k, v in base.items())


def test_adapt_guard_report_matches_jax():
    """tests/test_adapt.py's guarded run (9 frames, 2 steps scored after
    each): the same report, the scores within 1e-4, the same snapshot."""
    clip = _smooth_clip(9)
    _, want_losses, (want, want_rep), losses, (got, rep) = _run_both(
        clip, steps=2, learning_rate=1e-3, consistency=0.0, guard=True, eval_every=1)
    _check_losses(losses, want_losses)
    assert rep.keys() == want_rep.keys()
    for k in ("base_psnr_db", "base_ssim", "chosen_psnr_db", "chosen_ssim"):
        np.testing.assert_allclose(rep[k], want_rep[k], atol=SCORE_TOL, err_msg=k)
    for k in ("holdout_windows", "holdout_overlaps_train", "chosen_step", "adapted_served"):
        assert rep[k] == want_rep[k], k
    assert rep["adapted_served"] and rep["chosen_psnr_db"] >= rep["base_psnr_db"]


def test_adapt_guard_single_window_clip():
    """A clip of one window group validates on its (trained-on) window."""
    cfg = ADAPT_CFG.replace(RNN_N=4)
    params = init_generator(cfg, torch.Generator().manual_seed(0))
    clip = np.random.default_rng(0).random((4, 16, 16, 3)).astype(np.float32)
    chosen, rep = adapt.adapt_generator(cfg, params, clip, steps=1, learning_rate=1e-3,
                                        consistency=0.0, guard=True, eval_every=1,
                                        device="cpu")
    assert rep["holdout_overlaps_train"] is True
    assert rep["holdout_windows"] == 1
    assert set(chosen) == set(generator_state_dict_from_jax(params))


def test_adapt_rejects_bad_shape():
    params = init_generator(ADAPT_CFG, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not /4-divisible"):
        adapt.adapt_generator(ADAPT_CFG, params, np.zeros((4, 10, 12, 3), np.float32),
                              steps=1, device="cpu")


def test_adapt_and_refine_use_the_cpu_only_when_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_generator(ADAPT_CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        adapt.adapt_generator(ADAPT_CFG, params, _smooth_clip(3), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        adapt.lr_consistency_refine(np.zeros((1, 8, 8, 3), np.float32),
                                    np.zeros((1, 2, 2, 3), np.float32))


def test_lr_consistency_refine_matches_jax():
    rng = np.random.default_rng(0)
    lr = rng.random((2, 8, 12, 3)).astype(np.float32)
    sr = rng.random((2, 32, 48, 3)).astype(np.float32)
    want = j_adapt.lr_consistency_refine(sr, lr, iters=5)
    got = adapt.lr_consistency_refine(torch.from_numpy(sr), torch.from_numpy(lr), iters=5)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=REFINE_TOL)


# ---------------------------------------------------------------------------
# the NHWC fused route (warp_group != 4)
# ---------------------------------------------------------------------------

def _serve_params():
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else
                (v * np.float32(KERNEL_GAIN) if k == "kernel" else v)
                for k, v in tree.items()}
    return scale(init_generator(SERVE_CFG, torch.Generator().manual_seed(0)))


def _serve_model(params):
    model = model_defs(SERVE_CFG, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("group", [2, 8])
def test_nhwc_route_is_the_s2d_route_where_the_table_applies(rng, group):
    """4W divisible by the group: the JAX route warps through its u8 table,
    which gives the s2d route's frames; the port's are bit-equal to its s2d
    route, and above the fused bar against JAX's NHWC route."""
    params = _serve_params()
    clip = rng.random((1, 5, 8, 12, 3), np.float32) * np.float32(CLIP_RANGE)
    model = _serve_model(params)
    cfg = SERVE_CFG.replace(warp_group=group)
    got = build_clip_inference(cfg)(model, torch.from_numpy(clip))
    assert torch.equal(got, build_clip_inference(SERVE_CFG)(model, torch.from_numpy(clip)))
    want = np.asarray(j_build(_jax_cfg(cfg))(params, jnp.asarray(clip)))
    assert tuple(got.shape) == want.shape
    assert _psnr(got[:, -1].numpy(), want[:, -1]) > FUSED_PSNR_DB


def test_nhwc_route_warps_the_bf16_frame_at_other_widths(rng):
    """warp_group 8 with an odd LR width: 4W is not a multiple of 8, so JAX
    warps the bf16 frame with no u8 rounding (grid_sample_patch); the port
    too.  Every frame above the fused bar against JAX; the chunked loop and
    the stream give the clip's frames bit for bit."""
    params = _serve_params()
    clip = rng.random((1, 5, 8, 11, 3), np.float32) * np.float32(CLIP_RANGE)
    model = _serve_model(params)
    cfg = SERVE_CFG.replace(warp_group=8)
    got = build_clip_inference(cfg)(model, torch.from_numpy(clip))
    want = np.asarray(j_build(_jax_cfg(cfg))(params, jnp.asarray(clip)))
    assert tuple(got.shape) == want.shape == (1, 5, 32, 44, 3)
    for t in range(clip.shape[1]):
        assert _psnr(got[:, t].numpy(), want[:, t]) > FUSED_PSNR_DB, t
    # not the u8 table: the s2d route's frames differ after frame 0
    s2d = build_clip_inference(SERVE_CFG)(model, torch.from_numpy(clip))
    assert torch.equal(got[:, 0], s2d[:, 0]) and not torch.equal(got, s2d)
    assert torch.equal(build_chunked_inference(cfg)(model, clip, chunk=2), got)
    init_fn, step_fn = build_stream_inference(cfg)
    state = init_fn((1, 8, 11, 3), device="cpu")
    for t in range(clip.shape[1]):
        state, frame = step_fn(model, state, torch.from_numpy(clip[:, t]))
        assert torch.equal(frame, got[:, t]), t
