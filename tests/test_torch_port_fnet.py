"""Port parity, the FNet variant: ``ops.resize.upscale_two``,
``models.fnet.FNet`` with its weight bridge, and
``engine.fnet_train`` (``flow_to_grid``, the unroll, the train step)
against the JAX package (CPU, fp32; FNet at 32 x 32, the step at the JAX
suite's FNet config: crop 16, RNN_N 3, 1 resblock, B = 1).

Bars: the resize and the grid within ``OP_TOL``; FNet's forward within
``FORWARD_TOL``; one train step's losses within ``LOSS_RTOL`` relative,
and the params of G and FNet after it within ``PARAM_TOL``, but for at
most ``STRAY_SHARE`` of a leaf's elements (and at least 2), which are held
to the step's range, 2 lr.  Adam's first step moves a weight by
``lr g / (|g| + eps)``, so where ``|g|`` is not far above eps a gradient
disagreement moves the step: here the two packages' gradients differ by
1e-4 to 1e-3 of each leaf's largest, while the port's sit within 1e-6 of
a float64 run of the port's step (measured on these inputs), and 4e-4 of
a leaf's elements at most land beyond ``PARAM_TOL``.  The gap is JAX's:
its f32 generator puts one ReLU pre-activation on the other side of the
kink from float64, and the port's f32 gradients lie within 1e-4 of JAX's
float64 run (tests/test_torch_port_fnet_grad_f64.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.fnet_train import build_fnet_train_step as j_build_fnet_train_step
from tecogan_tpu.engine.fnet_train import flow_to_grid as j_flow_to_grid
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu.models import FNet as JFNet
from tecogan_tpu.ops.resize import upscale_two as j_upscale_two
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.fnet_train import (build_fnet_train_step, flow_to_grid,
                                                 fnet_state_from_params, init_fnet)
from tecogan_tpu_torch.engine.state import init_generator
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.ops.resize import upscale_two
from tecogan_tpu_torch.ops.warp import grid_sample
from tecogan_tpu_torch.utils.convert import (fnet_params_to_jax, fnet_state_dict_from_jax,
                                             generator_params_to_jax)

OP_TOL = 1e-6
FORWARD_TOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-5
STRAY_SHARE = 1e-3
CFG = TecoConfig(crop_size=16, RNN_N=3, num_resblock=1, precision="fp32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warp(img_nchw, grid):
    return grid_sample(img_nchw.permute(0, 2, 3, 1), grid).permute(0, 3, 1, 2)


def test_upscale_two_matches_jax(rng):
    x = rng.random((2, 5, 7, 3), np.float32)
    want = np.asarray(j_upscale_two(jnp.asarray(x)))
    got = upscale_two(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL)


def test_flow_to_grid_matches_jax(rng):
    flow = rng.standard_normal((2, 2, 6, 10)).astype(np.float32) * 3
    want = np.asarray(j_flow_to_grid(jnp.asarray(flow)))
    np.testing.assert_allclose(flow_to_grid(torch.from_numpy(flow)).numpy(), want,
                               atol=OP_TOL)


def test_flow_to_grid_zero_flow_is_identity(rng):
    img = torch.from_numpy(rng.random((1, 3, 8, 12), np.float32))
    out = _warp(img, flow_to_grid(torch.zeros((1, 2, 8, 12))))
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-5)


def test_flow_to_grid_unit_shift(rng):
    img = torch.from_numpy(rng.random((1, 3, 6, 6), np.float32))
    flow = torch.zeros((1, 2, 6, 6))
    flow[:, 0] = 1.0
    out = _warp(img, flow_to_grid(flow))
    np.testing.assert_allclose(out[..., :-1].numpy(), img[..., 1:].numpy(), atol=1e-5)


def test_fnet_matches_flax(rng):
    params = init_fnet(torch.Generator().manual_seed(0))
    x = rng.random((2, 32, 32, 6), np.float32)
    want = np.asarray(JFNet().apply({"params": params}, jnp.asarray(x)))
    model = FNet()
    model.load_state_dict(fnet_state_dict_from_jax(params))
    got = model(torch.from_numpy(x)).detach()
    assert tuple(got.shape) == want.shape == (2, 32, 32, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FORWARD_TOL)
    back = fnet_params_to_jax(fnet_state_dict_from_jax(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_init_has_the_flax_shapes():
    want = jax.eval_shape(lambda: JFNet().init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 16, 16, 6))))["params"]
    got = init_fnet(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_train_step_matches_jax(rng):
    g = torch.Generator().manual_seed(0)
    params_g, params_f = init_generator(CFG, g), init_fnet(g)
    lr = rng.random((1, 3, 3, 16, 16), np.float32)
    hr = rng.random((1, 3, 3, 64, 64), np.float32)

    jcfg = JaxTecoConfig(**dataclasses.asdict(CFG))
    opt_g, opt_f, _ = j_make_optimizers(jcfg)
    js = {"params_g": params_g, "params_f": params_f, "opt_g": opt_g.init(params_g),
          "opt_f": opt_f.init(params_f), "step": jnp.zeros((), jnp.int32),
          "epoch": jnp.zeros((), jnp.int32)}
    js, jm = j_build_fnet_train_step(jcfg)[1](js, jnp.asarray(lr), jnp.asarray(hr))

    _, step = build_fnet_train_step(CFG, device="cpu")
    s, m = step(fnet_state_from_params(CFG, params_g, params_f, "cpu"),
                torch.from_numpy(lr), torch.from_numpy(hr))
    assert set(m) == set(jm) and s["step"] == 1
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])), k
    for side, to_jax in (("g", generator_params_to_jax), ("f", fnet_params_to_jax)):
        got = dict(_flat(to_jax(s[f"params_{side}"])))
        for key, want in _flat(js[f"params_{side}"]):
            diff = np.abs(got[key] - want)
            assert diff.max() <= 2.0001 * CFG.learning_rate, (side, key)
            stray = int((diff > PARAM_TOL).sum())
            assert stray <= max(2, STRAY_SHARE * diff.size), (side, key, stray)
