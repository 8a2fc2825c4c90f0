"""Port parity, the evaluation slice: tecogan_tpu_torch's resizes, quality
metrics, VGG-19 and cosine schedule against the JAX package's
(``jax.image.resize``, tecogan_tpu/ops/metrics.py, tecogan_tpu/models/vgg.py,
``optax.cosine_decay_schedule``) on the same numpy inputs and weights,
and the train step's VGG loss against the JAX step's (CPU, fp32).

Bars: resizes 1e-6; metrics 1e-5 relative, PSNR 1e-4 dB, SSIM 1e-6; VGG
end points 1e-5 of each layer's largest value; the VGG train step's
``gen_loss`` 1e-4 relative; the schedule 1e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import TrainState as JaxTrainState
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu.engine.train import build_train_step as j_build_train_step
from tecogan_tpu.models import vgg as j_vgg
from tecogan_tpu.ops import metrics as j_metrics
from tecogan_tpu.utils.checkpoint import save_pytree as j_save_pytree
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.state import (cosine_decay_schedule, init_discriminator,
                                            init_generator, state_from_params)
from tecogan_tpu_torch.engine.train import build_train_step
from tecogan_tpu_torch.models import vgg
from tecogan_tpu_torch.ops import metrics
from tecogan_tpu_torch.ops.resize import resize_bicubic, resize_bilinear_aa
from tecogan_tpu_torch.utils.checkpoint import save_pytree
from tecogan_tpu_torch.utils.convert import vgg_params_to_jax, vgg_state_dict_from_jax

RESIZE_TOL = 1e-6
METRIC_RTOL = 1e-5
PSNR_TOL_DB = 1e-4
SSIM_TOL = 1e-6
VGG_RTOL = 1e-5
LOSS_RTOL = 1e-4
SCHEDULE_TOL = 1e-8
LAYERS = ("vgg_19/conv2_2", "vgg_19/conv3_4", "vgg_19/conv4_4")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread in this module: the suite runs several
    pytest workers on the machine's cores, where torch's default of a
    thread a core oversubscribes them (these tests ran ~7x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def surrogate():
    """The JAX package's fixed-seed VGG-19 params (a JAX PRNG draw), as
    numpy."""
    return jax.tree_util.tree_map(np.asarray, j_vgg.fixed_seed_vgg_params())


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape,out", [
    ((2, 3, 3, 24, 24), (2, 3, 3, 6, 6)),      # adaptation's pairs, /4
    ((5, 17, 3), (20, 68, 3)),                 # odd, x4
    ((2, 13, 21, 3), (2, 52, 84, 3)),          # odd and not square, x4
    ((1, 48, 40, 3), (1, 12, 10, 3)),          # not square, /4
])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_matches_jax(rng, shape, out, method):
    x = rng.random(shape, np.float32)
    if method == "bilinear":
        want = jax.image.resize(jnp.asarray(x), out, "bilinear", antialias=True)
        got = resize_bilinear_aa(_t(x), out)
    else:
        want = jax.image.resize(jnp.asarray(x), out, "bicubic")
        got = resize_bicubic(_t(x), out)
    assert got.dtype == torch.float32 and tuple(got.shape) == out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESIZE_TOL)


def test_psnr_metrics_match_jax(rng):
    ref = rng.random((4, 9, 13, 3), np.float32)
    tgt = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1).astype(np.float32)
    for name in ("psnr", "psnr_255", "psnr_per_frame"):
        a, b = (ref, tgt) if name != "psnr_255" else (ref * 255, tgt * 255)
        want = np.asarray(getattr(j_metrics, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(metrics, name)(_t(a), _t(b))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PSNR_TOL_DB, err_msg=name)


@pytest.mark.parametrize("smooth", [False, True])
def test_ssim_matches_jax(rng, smooth):
    """Random and smooth content (small local variances, where the
    E[x^2] - E[x]^2 cancellation loses most)."""
    x = rng.random((2, 24, 31, 3), np.float32)
    if smooth:
        x = np.asarray(jax.image.resize(jnp.asarray(x[:, :6, :8]), x.shape, "bilinear"))
    y = np.clip(x + rng.normal(0, 0.02, x.shape), 0, 1).astype(np.float32)
    want = float(j_metrics.ssim(jnp.asarray(x), jnp.asarray(y)))
    got = metrics.ssim(_t(x), _t(y))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= SSIM_TOL, (float(got), want)


def test_vgg_distances_match_jax(rng):
    fx = {k: rng.standard_normal((2, 4, 5, c)).astype(np.float32)
          for k, c in zip(LAYERS, (8, 16, 12))}
    fy = {k: v + rng.standard_normal(v.shape).astype(np.float32) * 0.3 for k, v in fx.items()}
    lin = {LAYERS[1]: rng.random(16).astype(np.float32)}
    jx = {k: jnp.asarray(v) for k, v in fx.items()}
    jy = {k: jnp.asarray(v) for k, v in fy.items()}
    tx = {k: _t(v) for k, v in fx.items()}
    ty = {k: _t(v) for k, v in fy.items()}
    cases = [(metrics.vgg_perceptual_distance(tx, ty), j_metrics.vgg_perceptual_distance(jx, jy)),
             (metrics.vgg_perceptual_distance(tx, ty, LAYERS[:2]),
              j_metrics.vgg_perceptual_distance(jx, jy, LAYERS[:2])),
             (metrics.lpips_distance(tx, ty), j_metrics.lpips_distance(jx, jy)),
             (metrics.lpips_distance(tx, ty, lin_weights={k: _t(v) for k, v in lin.items()}),
              j_metrics.lpips_distance(jx, jy, lin_weights=lin))]
    for i, (got, want) in enumerate(cases):
        np.testing.assert_allclose(float(got), float(want), rtol=METRIC_RTOL, err_msg=str(i))


def _port_vgg(params):
    return vgg.vgg_model(params, device="cpu")


def test_vgg19_end_points_match_jax(rng, surrogate):
    """Every end point at 32 x 32 from the JAX package's surrogate weights
    through the bridge."""
    x = rng.random((2, 32, 32, 3), np.float32) * 255.0 - 120.0
    _, want = j_vgg.VGG19().apply({"params": surrogate}, jnp.asarray(x))
    net, got = _port_vgg(surrogate)(_t(x))
    assert list(got) == list(want)
    assert torch.equal(net, got["vgg_19/pool5"])
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=VGG_RTOL * scale, err_msg=k)


@pytest.mark.parametrize("deep_list,norm", [(LAYERS, True), (None, False)])
def test_vgg19_features_match_jax(rng, surrogate, deep_list, norm):
    x = rng.random((1, 32, 32, 3), np.float32)
    want = j_vgg.vgg19_features(surrogate, jnp.asarray(x), deep_list, norm_flag=norm)
    got = vgg.vgg19_features(_port_vgg(surrogate), _t(x), deep_list, norm_flag=norm)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=VGG_RTOL * float(np.abs(w).max()), err_msg=k)


def test_vgg_ckpt_round_trip(tmp_path, surrogate):
    """A .ckpt the JAX package writes loads into the port bit for bit, and
    the port's params written back load into the JAX package unchanged;
    the 'surrogate' name gives the JAX package's surrogate leaves."""
    path = str(tmp_path / "vgg.ckpt")
    j_save_pytree(path, {"model_state_dict": surrogate})
    loaded = vgg.load_vgg_params(path)
    sd = _port_vgg(loaded).state_dict()
    want = vgg_state_dict_from_jax(surrogate)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    back = str(tmp_path / "back.ckpt")
    save_pytree(back, vgg_params_to_jax(sd))
    again = j_vgg.load_vgg_params(back)
    for name, layer in surrogate.items():
        for leaf, a in layer.items():
            np.testing.assert_array_equal(np.asarray(again[name][leaf]), a)
    named = vgg.load_vgg_params("surrogate")
    for name, layer in surrogate.items():
        for leaf, a in layer.items():
            np.testing.assert_array_equal(named[name][leaf], a)


def test_init_vgg_has_vgg19s_widths():
    params = vgg.init_vgg(torch.Generator().manual_seed(0))
    model = _port_vgg(params)
    assert sum(p.numel() for p in model.parameters()) == 20_024_384  # VGG-19's convs
    assert all(not p.requires_grad for p in model.parameters())


def test_vgg_train_step_matches_jax(surrogate):
    """One tiny fp32 train step with the VGG loss on (``vgg_scaling`` > 0,
    ``bug_parity`` off so the content and VGG terms train G) from the same
    weights, batch and VGG weights: ``gen_loss`` and ``vgg_all``."""
    cfg = TecoConfig(crop_size=8, RNN_N=3, num_resblock=1, discrim_resblocks=1,
                     discrim_channels=16, batch_size=1, precision="fp32",
                     bug_parity=False, vgg_scaling=0.2)
    jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
    g = torch.Generator().manual_seed(0)
    params_g, (params_d, stats) = init_generator(cfg, g), init_discriminator(cfg, g)
    rng = np.random.default_rng(1)
    lr = rng.random((1, 3, 3, 8, 8), np.float32) * np.float32(0.3)
    hr = rng.random((1, 3, 3, 32, 32), np.float32)

    def j_vgg_apply(images, deep_list):
        return j_vgg.vgg19_features(surrogate, images, deep_list)

    opt_g, opt_d, _ = j_make_optimizers(jcfg)
    js = JaxTrainState(params_g=params_g, params_d=params_d, batch_stats_d=stats,
                       opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
                       step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    _, jm, _ = j_build_train_step(jcfg, vgg_apply=j_vgg_apply, donate=False)(
        js, jnp.asarray(lr), jnp.asarray(hr))
    state = state_from_params(cfg, params_g, params_d, stats, device="cpu")
    step = build_train_step(cfg, vgg_apply=vgg.make_vgg_apply(_port_vgg(surrogate)),
                            device="cpu")
    _, m, _ = step(state, _t(lr), _t(hr))
    assert float(jm["vgg_all"]) > 0
    for k in ("vgg_all", "gen_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("init,decay", [(1e-4, 1000), (1e-3, 7), (5.0, 2), (3e-4, 1)])
def test_cosine_schedule_matches_optax(init, decay):
    want = optax.cosine_decay_schedule(init, decay)
    got = cosine_decay_schedule(init, decay)
    for count in range(decay + 3):
        assert abs(got(count) - float(want(jnp.int32(count)))) <= SCHEDULE_TOL, count
