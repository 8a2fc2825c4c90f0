"""Port parity, the FNet variant's loss gradient in float32 and float64:
``engine.fnet_train.fnet_generator_unroll`` of both packages, content L2
plus ``warp_scaling`` times the LR warp loss (the step's loss), with
respect to the generator's and FNet's params, at the configuration and
inputs of tests/test_torch_port_fnet.py's train-step test (crop 16,
RNN_N 3, 1 resblock, B = 1), four ways: JAX f32, JAX f64 (the flax
modules built in float64 under ``jax.enable_x64``; no JAX file changed),
port f32 and port f64.

What it settles.  The train-step test there finds the two packages'
gradients 1e-4 to 1e-3 of a leaf apart.  The float64 runs agree within
``F64_RTOL`` (1.9e-6 measured: both FNets take ``tanh`` in float32, so
the flow and its upscale are float32 in both, forward and backward).  The
port's f32 gradient lies within ``F32_RTOL`` of JAX's f64 (2.3e-6
measured); JAX's f32 lies 1.1e-3 of ``conv_in.bias`` away.  The cause is
JAX's f32 generator alone (its FNet in f32 under an f64 generator moves
nothing): on frame 0 one of ``conv_hr``'s pre-activations lies 5.3e-9
from ReLU's kink in float64, and JAX's f32 run, 1.4e-8 off there, puts it
on the other side; the ReLU's gradient steps and moves every layer below.
The port's f32 run puts every pre-activation on float64's side.  So the
port is right, and tests/test_torch_port_fnet.py's bars on the params
after a step (``STRAY_SHARE``) cover JAX's crossing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine import fnet_train as jf
from tecogan_tpu.engine.losses import _mean_sum_w as j_mean_sum_w
from tecogan_tpu.models import FNet as JFNet
from tecogan_tpu.models.generator import Generator as JGenerator
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine import fnet_train as pf
from tecogan_tpu_torch.engine.fnet_train import init_fnet
from tecogan_tpu_torch.engine.losses import _mean_sum_w
from tecogan_tpu_torch.engine.state import init_generator
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.utils.convert import (fnet_params_to_jax, fnet_state_dict_from_jax,
                                             generator_params_to_jax,
                                             generator_state_dict_from_jax)
from test_torch_port_d_grad_f64 import _leaf_rel

CFG = TecoConfig(crop_size=16, RNN_N=3, num_resblock=1, precision="fp32")
F64_RTOL = 1e-5
F32_RTOL = 1e-4
# the generator's modules whose outputs go through a ReLU (flax path, "."
# joined = the port's module name)
KINKS = ("conv_in", "resblock_0.Conv_0", "up1", "trunk_rb1.Conv_0", "trunk_rb2.Conv_0",
         "up2", "conv_hr")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """The train-step test's params and batch (its ``rng`` fixture is
    ``np.random.default_rng(0)``)."""
    g = torch.Generator().manual_seed(0)
    params_g, params_f = init_generator(CFG, g), init_fnet(g)
    rng = np.random.default_rng(0)
    lr = rng.random((1, 3, 3, 16, 16), np.float32)
    hr = rng.random((1, 3, 3, 64, 64), np.float32)
    return params_g, params_f, lr, hr


def _jax_grad(params_g, params_f, lr, hr, dtype):
    jcfg = JaxTecoConfig(**dataclasses.asdict(CFG))
    gen = JGenerator(num_resblock=CFG.num_resblock, out_channels=3, dtype=dtype,
                     out_dtype=dtype)
    fnet = JFNet(dtype=dtype)
    lr_, hr_ = jnp.asarray(lr, dtype), jnp.asarray(hr, dtype)

    def objective(params):
        unroll = jf.fnet_generator_unroll(gen, fnet, params[0], params[1], lr_, jcfg)
        s_gen = unroll.gen_outputs.reshape(3, 3, 64, 64)
        content = j_mean_sum_w(jnp.square(s_gen - hr_.reshape(3, 3, 64, 64)))
        return content + jcfg.warp_scaling * unroll.warp_loss

    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), (params_g, params_f))
    grad = jax.jit(jax.grad(objective))(params)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), grad)


def _port_grad(params_g, params_f, lr, hr, dtype):
    gen = Generator(num_resblock=CFG.num_resblock, out_channels=3, dtype=dtype,
                    out_dtype=dtype)
    fnet = FNet(dtype=dtype)
    g = {k: v.to(dtype).requires_grad_(True)
         for k, v in generator_state_dict_from_jax(params_g).items()}
    f = {k: v.to(dtype).requires_grad_(True)
         for k, v in fnet_state_dict_from_jax(params_f).items()}
    hr_ = torch.from_numpy(hr).to(dtype)
    unroll = pf.fnet_generator_unroll(gen, fnet, g, f, torch.from_numpy(lr).to(dtype), CFG)
    content = _mean_sum_w(torch.square(unroll.gen_outputs.reshape(3, 3, 64, 64)
                                       - hr_.reshape(3, 3, 64, 64)))
    loss = content + CFG.warp_scaling * unroll.warp_loss
    grads = torch.autograd.grad(loss, list(g.values()) + list(f.values()))
    grads_g = {k: v.detach().double() for k, v in zip(g, grads)}
    grads_f = {k: v.detach().double() for k, v in zip(f, grads[len(g):])}
    tree = (generator_params_to_jax(grads_g), fnet_params_to_jax(grads_f))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _generator_inputs(params_g, params_f, lr):
    """The generator's input (B, 51, H, W) at each frame of the float64
    unroll."""
    f64 = torch.float64
    gen = Generator(num_resblock=CFG.num_resblock, out_channels=3, dtype=f64, out_dtype=f64)
    fnet = FNet(dtype=f64)
    g = {k: v.to(f64) for k, v in generator_state_dict_from_jax(params_g).items()}
    f = {k: v.to(f64) for k, v in fnet_state_dict_from_jax(params_f).items()}
    clip = torch.from_numpy(lr).to(f64)

    def run(x):
        return functional_call(gen, g, (x.permute(0, 2, 3, 1),)).permute(0, 3, 1, 2)

    x = torch.cat([clip[:, 0], clip.new_zeros((1, 48, 16, 16))], dim=1)
    inputs = [x]
    with torch.no_grad():
        sr = run(x)
        for t in range(1, clip.shape[1]):
            flow = pf.fnet_flow(fnet, f, clip[:, t - 1], clip[:, t])
            warped = pf._warp_nchw(sr, pf.flow_to_grid(flow))
            x = torch.cat([clip[:, t], torch.nn.functional.pixel_unshuffle(
                pf.deprocess(warped), 4)], dim=1)
            inputs.append(x)
            sr = run(x)
    return inputs


def _jax_pre_activations(params_g, x, dtype):
    gen = JGenerator(num_resblock=CFG.num_resblock, out_channels=3, dtype=dtype,
                     out_dtype=dtype)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params_g)
    _, state = gen.apply({"params": params}, jnp.asarray(x.permute(0, 2, 3, 1).numpy(), dtype),
                         capture_intermediates=True, mutable=["intermediates"])
    out = []
    for name in KINKS:
        node = state["intermediates"]
        for part in name.split("."):
            node = node[part]
        out.append(np.asarray(node["__call__"][0], np.float64))
    return out


def _port_pre_activations(params_g, x):
    gen = Generator(num_resblock=CFG.num_resblock, out_channels=3)
    mods = dict(gen.named_modules())
    acts = {}
    handles = [mods[name].register_forward_hook(
        lambda m, a, out, name=name: acts.__setitem__(
            name, out.detach().double().permute(0, 2, 3, 1).numpy()))
        for name in KINKS]
    with torch.no_grad():
        functional_call(gen, generator_state_dict_from_jax(params_g),
                        (x.float().permute(0, 2, 3, 1),))
    for h in handles:
        h.remove()
    return [acts[name] for name in KINKS]


def _crossings(acts, ref):
    """(the largest |ref| among the pre-activations on the other side of
    ReLU's kink from ``ref``'s, None when there is none; the largest
    |acts - ref|)."""
    worst, dev = None, 0.0
    for a, r in zip(acts, ref):
        dev = max(dev, float(np.abs(a - r).max()))
        wrong = (a > 0) != (r > 0)
        if wrong.any():
            worst = max(worst or 0.0, float(np.abs(r[wrong]).max()))
    return worst, dev


@pytest.fixture(scope="module")
def runs():
    params_g, params_f, lr, hr = _inputs()
    out = {"j32": _jax_grad(params_g, params_f, lr, hr, jnp.float32),
           "p32": _port_grad(params_g, params_f, lr, hr, torch.float32),
           "p64": _port_grad(params_g, params_f, lr, hr, torch.float64)}
    with jax.enable_x64(True):
        out["j64"] = _jax_grad(params_g, params_f, lr, hr, jnp.float64)
    crossed = {"j32": [], "p32": []}
    for x in _generator_inputs(params_g, params_f, lr):
        with jax.enable_x64(True):
            ref = _jax_pre_activations(params_g, x, jnp.float64)
        crossed["j32"].append(_crossings(_jax_pre_activations(params_g, x.float(),
                                                              jnp.float32), ref))
        crossed["p32"].append(_crossings(_port_pre_activations(params_g, x), ref))
    out["crossed"] = crossed
    return out


def test_the_f64_fnet_grads_agree(runs):
    rel = _leaf_rel(runs["p64"], runs["j64"])
    assert max(rel.values()) <= F64_RTOL, rel


def test_port_f32_fnet_grads_meet_jax_f64(runs):
    rel = _leaf_rel(runs["p32"], runs["j64"])
    assert max(rel.values()) <= F32_RTOL, rel
    assert all(worst is None for worst, _ in runs["crossed"]["p32"]), runs["crossed"]


def test_jax_f32_fnet_gap_is_a_crossed_kink(runs):
    gap = max(_leaf_rel(runs["j32"], runs["j64"]).values())
    assert gap > F32_RTOL, gap
    frames = [(worst, dev) for worst, dev in runs["crossed"]["j32"] if worst is not None]
    assert frames and all(worst <= dev for worst, dev in frames), runs["crossed"]
