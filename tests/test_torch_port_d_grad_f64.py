"""Port parity, the discriminator's gradient at B = 4 in float32 and
float64: ``engine.losses.discriminator_loss`` of both packages on the
same triplets, the tiny train config (D 1 x 16 on 32 x 32 triplets), four
ways: JAX f32, JAX f64 (the flax D built with ``dtype=float64`` under
``jax.enable_x64``), port f32 and port f64.  The triplets are JAX's
``tecogan_losses`` aux of one step at B = 4, ``bug_parity`` on and off,
on two batches: ``np.random.default_rng(5)``'s and the B = 4 batch of
tests/test_torch_port_dp.py.

What it settles.  At B = 4 the two packages' f32 D gradients part by up to
4e-2 of a leaf's largest element.  The cause is neither package's
arithmetic: D's gradient is discontinuous where an activation's input
crosses 0 (leaky ReLU's slope steps from 0.2 to 1, ReLU's from 0 to 1),
and at B = 4 a few of D's ~1e6 pre-activations lie within f32 rounding of
0.  Each f32 run rounds such an element to one side or the other, and the
one element moves the gradient of every layer below it by a finite step.
So:

* the two f64 runs agree within ``F64_RTOL`` of each leaf's largest
  element; their pre-activations agree within ``F64_ACT_RTOL`` of each
  layer's largest (1.6e-14 measured) and sit on the same side of every
  kink.
  Both D's round the fc's output to f32 before the sigmoid
  (tecogan_tpu/models/discriminator.py, ``.astype(jnp.float32)``; the
  port's ``.float()``), so the f64 runs share the f32 score and agree to
  its rounding (2.4e-7 measured), not to f64's;
* every f32 run's pre-activations lie within ``ACT_RTOL`` of JAX f64's,
  relative to each layer's largest (JAX's up to 9.4e-6, the port's up
  to 4.0e-6 measured);
* the port's f32 run with each pre-activation on JAX f64's side of its
  kink (the few that f32 put on the other side moved across, through a
  forward hook whose gradient is the identity) lies within ``F32_RTOL``
  of JAX's f64 gradient, leaf by leaf (6.3e-6 measured);
* each plain f32 run, JAX's and the port's, whose pre-activations all sit
  on JAX f64's side lies within ``F32_RTOL`` of it; a run beyond the bar
  has put pre-activations on the other side, each nearer 0 in the f64 run
  than that run's own largest f32 deviation from it: a rounding across
  the kink;
* on these batches the gap shows: some f32 run crosses a kink and lies
  more than 1e-3 of a leaf from JAX's f64 gradient.

JAX has no float64 train step (its dtype comes from ``cfg.precision``
alone, tecogan_tpu/engine/state.py:62), so the train-step tests at B = 4
keep the port's single-process step as their reference and say why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.losses import discriminator_loss as j_discriminator_loss
from tecogan_tpu.engine.losses import tecogan_losses as j_tecogan_losses
from tecogan_tpu.engine.state import model_defs as j_model_defs
from tecogan_tpu.models.discriminator import Discriminator as JDiscriminator
from tecogan_tpu.ops.image import nchw_to_nhwc
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.losses import d_input_spec, discriminator_loss
from tecogan_tpu_torch.engine.state import init_discriminator, init_generator
from tecogan_tpu_torch.models.discriminator import Discriminator
from tecogan_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                             state_dict_to_jax)

F64_RTOL = 1e-6
F32_RTOL = 1e-4
ACT_RTOL = 3e-5
F64_ACT_RTOL = 1e-12
GAP = 1e-3
CLIP_RANGE = 0.3
# the modules whose outputs are D's activation inputs (flax path, joined
# by "." = the port's module name): leaky ReLU after conv_in and each
# block's BatchNorm, ReLU after each resblock's first conv
KINKS = ("conv_in", "block1.BatchNorm_0", "resids1.rb_0.Conv_0", "block2.BatchNorm_0",
         "resids2.rb_0.Conv_0", "block3.BatchNorm_0", "resids3.rb_0.Conv_0",
         "block4.BatchNorm_0", "block5.BatchNorm_0")
CASES = [(batch, bp) for batch in ("rng5", "dp") for bp in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    base = dict(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                discrim_channels=16, batch_size=4, precision="fp32")
    base.update(kw)
    return TecoConfig(**base)


def _batch(which, c):
    if which == "rng5":
        rng = np.random.default_rng(5)
    else:  # tests/test_torch_port_dp.py draws B = 2, then B = 4, from rng(0)
        rng = np.random.default_rng(0)
        rng.random((2, 9, 3, c, c), np.float32)
        rng.random((2, 9, 3, 4 * c, 4 * c), np.float32)
    lr = rng.random((4, 9, 3, c, c), np.float32) * np.float32(CLIP_RANGE)
    return lr, rng.random((4, 9, 3, 4 * c, 4 * c), np.float32)


def _leaf_rel(got, want):
    """{leaf path: max |got - want| over max |want|} of two flax trees."""
    out = {}
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        out[jax.tree_util.keystr(path)] = float(np.abs(g - w).max() / np.abs(w).max())
    return out


def _jax_side(cfg, params_d, stats, real_in, fake_in, dtype):
    """JAX's D-loss gradient in ``dtype`` and D's activation inputs (NCHW)
    on the real and the fake triplets."""
    jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
    disc = JDiscriminator(resblocks=cfg.discrim_resblocks, channels=cfg.discrim_channels,
                          dtype=dtype)

    def cast(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)

    p, s = cast(params_d), cast(stats)
    xs = [jnp.asarray(x, dtype) for x in (real_in, fake_in)]
    grad = jax.jit(jax.grad(lambda q: j_discriminator_loss(disc, q, s, *xs, jcfg)[0]))(p)
    forward = jax.jit(lambda q, x: disc.apply(
        {"params": q, "batch_stats": s}, nchw_to_nhwc(x), train=True,
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)[1])
    acts = []
    for x in xs:
        inter = forward(p, x)["intermediates"]
        for name in KINKS:
            node = inter
            for part in name.split("."):
                node = node[part]
            acts.append(np.transpose(np.asarray(node["__call__"][0], np.float64),
                                     (0, 3, 1, 2)))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), grad), acts


def _port_side(cfg, params_d, stats, real_in, fake_in, dtype, ref=None):
    """The port's D-loss gradient in ``dtype`` and D's activation inputs;
    with ``ref`` (the f64 run's pre-activations, in call order) each
    pre-activation that lies on the other side of its kink is moved across
    to that side, its gradient the identity."""
    d_ch, d_hw = d_input_spec(cfg)
    disc = Discriminator(resblocks=cfg.discrim_resblocks, channels=cfg.discrim_channels,
                         dtype=dtype, in_channels=d_ch, in_size=d_hw)
    sd, bn = discriminator_state_dict_from_jax(params_d, stats)
    sd = {k: v.to(dtype).requires_grad_(True) for k, v in sd.items()}
    acts = []

    def hook(module, args, out):
        if ref is not None:
            want = torch.from_numpy(ref[len(acts)] > 0)
            wrong = (out > 0) != want
            if bool(wrong.any()):
                moved = torch.where(want, out.detach().abs(), -out.detach().abs())
                out = out + torch.where(wrong, moved - out.detach(), torch.zeros_like(out))
        acts.append(out.detach().double().numpy())
        return out

    mods = dict(disc.named_modules())
    handles = [mods[name].register_forward_hook(hook) for name in KINKS]
    loss, _ = discriminator_loss(disc, sd, {k: v.to(dtype) for k, v in bn.items()},
                                 torch.from_numpy(real_in).to(dtype),
                                 torch.from_numpy(fake_in).to(dtype), cfg)
    grads = torch.autograd.grad(loss, list(sd.values()))
    for h in handles:
        h.remove()
    tree = state_dict_to_jax({k: g.detach().double() for k, g in zip(sd, grads)})
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree), acts


def _flips(acts, ref):
    """The pre-activations on the other side of their kink from ``ref``'s,
    as the largest |ref| among them (None when there is none), and the
    largest |acts - ref| and, over the layers, the largest of it relative
    to the layer's largest |ref|."""
    worst, dev, rel = None, 0.0, 0.0
    for a, r in zip(acts, ref):
        dev = max(dev, float(np.abs(a - r).max()))
        rel = max(rel, float(np.abs(a - r).max() / np.abs(r).max()))
        wrong = (a > 0) != (r > 0)
        if wrong.any():
            worst = max(worst or 0.0, float(np.abs(r[wrong]).max()))
    return worst, dev, rel


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(which, bug_parity):
        if (which, bug_parity) not in cache:
            cfg = tiny_cfg(bug_parity=bug_parity)
            jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
            g = torch.Generator().manual_seed(0)
            params_g = init_generator(cfg, g)
            params_d, stats = init_discriminator(cfg, g)
            lr, hr = _batch(which, cfg.crop_size)
            gen, disc = j_model_defs(jcfg)
            _, aux = jax.jit(lambda p: j_tecogan_losses(
                gen, disc, p, params_d, stats, jnp.asarray(lr), jnp.asarray(hr),
                jnp.zeros((), jnp.int32), jcfg, None))(params_g)
            ins = (cfg, params_d, stats, np.array(aux["real_in"]), np.array(aux["fake_in"]))
            j32 = _jax_side(*ins, jnp.float32)
            with jax.enable_x64(True):
                j64 = _jax_side(*ins, jnp.float64)
            p32 = _port_side(*ins, torch.float32)
            p64 = _port_side(*ins, torch.float64)
            p32_sided = _port_side(*ins, torch.float32, ref=j64[1])
            cache[which, bug_parity] = {"j32": j32, "j64": j64, "p32": p32, "p64": p64,
                                        "p32_sided": p32_sided}
        return cache[which, bug_parity]

    return get


@pytest.mark.parametrize("which,bug_parity", CASES)
def test_the_f64_runs_agree(runs, which, bug_parity):
    r = runs(which, bug_parity)
    rel = _leaf_rel(r["p64"][0], r["j64"][0])
    assert max(rel.values()) <= F64_RTOL, rel
    crossed, _, act_rel = _flips(r["p64"][1], r["j64"][1])
    assert crossed is None and act_rel <= F64_ACT_RTOL, (crossed, act_rel)


@pytest.mark.parametrize("which,bug_parity", CASES)
def test_port_f32_on_the_f64_side_of_each_kink_meets_jax_f64(runs, which, bug_parity):
    r = runs(which, bug_parity)
    crossed, _, rel = _flips(r["p32_sided"][1], r["j64"][1])
    assert crossed is None and rel <= ACT_RTOL, (crossed, rel)
    rel = _leaf_rel(r["p32_sided"][0], r["j64"][0])
    assert max(rel.values()) <= F32_RTOL, rel


@pytest.mark.parametrize("which,bug_parity", CASES)
def test_each_f32_gap_is_a_crossed_kink(runs, which, bug_parity):
    r = runs(which, bug_parity)
    for side in ("j32", "p32"):
        worst = max(_leaf_rel(r[side][0], r["j64"][0]).values())
        crossed, dev, rel = _flips(r[side][1], r["j64"][1])
        assert rel <= ACT_RTOL, (side, rel)
        if crossed is None:
            assert worst <= F32_RTOL, (side, worst)
        else:
            assert crossed <= dev, (side, crossed, dev)


def test_the_b4_gap_shows_on_these_batches(runs):
    gaps = [(max(_leaf_rel(r[side][0], r["j64"][0]).values()),
             _flips(r[side][1], r["j64"][1])[0])
            for r in (runs(*case) for case in CASES) for side in ("j32", "p32")]
    assert any(gap > GAP and crossed is not None for gap, crossed in gaps), gaps
