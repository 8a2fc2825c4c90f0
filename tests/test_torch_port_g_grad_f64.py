"""Port parity, the generator's loss gradient in float64: ``engine.losses.
tecogan_losses`` of both packages at B = 4 on the tiny train config, the
generator and the discriminator built in float64 (JAX's under
``jax.enable_x64``, its generator's ``out_dtype`` float64 too; no JAX
file changed), ``bug_parity`` on and off, on the batches of
tests/test_torch_port_d_grad_f64.py.

What it settles.  With ``bug_parity`` on, the two float64 runs parted by
1e-4 of a leaf.  The reference rounds the pseudo-flow grid and the fake
triplet's flow through float16 (``.half()``, train.py:98,187).  torch takes
float64 to float16 through a float32 rounded to nearest, which rounds
twice; XLA and numpy round once.  Next to a float16 midpoint the two land
on different neighbours: 6 of the 65536 grid values of the ``rng5``
batch, 5 of the DP batch's.  A grid value one float16 step away moves the
warped feedback, and the generator's gradient with it.  The port now
rounds through ``ops.warp.round_through_half``, once, and:

* its float16 rounding of float64 values next to every kind of midpoint
  equals numpy's and JAX's, and of float32 values torch's own;
* its float64 grids equal JAX's bit for bit;
* the two float64 gradients agree within ``F64_RTOL`` of each leaf's
  largest element (2.2e-7 measured: both discriminators round the score to
  float32, and without ``bug_parity`` JAX's warp runs in float32,
  tecogan_tpu/engine/losses.py:91).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine import losses as jl
from tecogan_tpu.models.discriminator import Discriminator as JDiscriminator
from tecogan_tpu.models.generator import Generator as JGenerator
from tecogan_tpu_torch.engine import losses as pl
from tecogan_tpu_torch.engine.losses import d_input_spec
from tecogan_tpu_torch.engine.state import init_discriminator, init_generator
from tecogan_tpu_torch.models.discriminator import Discriminator
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.ops.warp import round_through_half
from tecogan_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                             generator_params_to_jax,
                                             generator_state_dict_from_jax)
from test_torch_port_d_grad_f64 import CASES, _batch, _leaf_rel, tiny_cfg

F64_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _near_midpoints():
    """float64 values at, just below and just above the midpoint of every
    pair of neighbouring positive float16 values below 4, and their
    negatives."""
    h = np.arange(0, 0x4400, dtype=np.uint16).view(np.float16).astype(np.float64)
    mid = (h[:-1] + h[1:]) / 2
    x = np.concatenate([mid, np.nextafter(mid, 0), np.nextafter(mid, np.inf),
                        mid * (1 - 2.0 ** -30), mid * (1 + 2.0 ** -30)])
    return np.concatenate([x, -x])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_round_through_half_rounds_once(dtype):
    x = _near_midpoints().astype(dtype)
    got = round_through_half(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = x.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    with jax.enable_x64(True):
        j = np.asarray(jnp.asarray(x).astype(jnp.float16).astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), j)
    if dtype == np.float32:
        t = torch.from_numpy(x).to(torch.float16).to(torch.float32)
        np.testing.assert_array_equal(got.numpy(), t.numpy())


@pytest.mark.parametrize("which", ["rng5", "dp"])
def test_f64_grids_equal_jax(which):
    lr, _ = _batch(which, 8)
    with jax.enable_x64(True):
        flow = jl.pseudo_flow_sequence(jnp.asarray(lr, jnp.float64), (8, 8))
        want = np.asarray(jl.flows_to_grids(flow, True))
    got = pl.flows_to_grids(pl.pseudo_flow_sequence(torch.from_numpy(lr).double()), True)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_grad(cfg, params_g, params_d, stats, lr, hr):
    jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
    f64 = jnp.float64
    gen = JGenerator(num_resblock=cfg.num_resblock, out_channels=3, dtype=f64, out_dtype=f64)
    disc = JDiscriminator(resblocks=cfg.discrim_resblocks, channels=cfg.discrim_channels,
                          dtype=f64)

    def cast(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, f64), tree)

    d, s = cast(params_d), cast(stats)

    def objective(p):
        return jl.tecogan_losses(gen, disc, p, d, s, jnp.asarray(lr, f64),
                                 jnp.asarray(hr, f64), jnp.zeros((), jnp.int32), jcfg)[0]

    grad = jax.jit(jax.grad(objective))(cast(params_g))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), grad)


def _port_grad(cfg, params_g, params_d, stats, lr, hr):
    f64 = torch.float64
    d_ch, d_hw = d_input_spec(cfg)
    gen = Generator(num_resblock=cfg.num_resblock, out_channels=3, dtype=f64, out_dtype=f64)
    disc = Discriminator(resblocks=cfg.discrim_resblocks, channels=cfg.discrim_channels,
                         dtype=f64, in_channels=d_ch, in_size=d_hw)
    g = {k: v.to(f64).requires_grad_(True)
         for k, v in generator_state_dict_from_jax(params_g).items()}
    d, s = discriminator_state_dict_from_jax(params_d, stats)
    loss, _ = pl.tecogan_losses(gen, disc, g, {k: v.to(f64) for k, v in d.items()},
                                {k: v.to(f64) for k, v in s.items()},
                                torch.from_numpy(lr).to(f64), torch.from_numpy(hr).to(f64),
                                0, cfg)
    grads = torch.autograd.grad(loss, list(g.values()))
    tree = generator_params_to_jax({k: v.detach() for k, v in zip(g, grads)})
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("which,bug_parity", CASES)
def test_the_f64_generator_grads_agree(which, bug_parity):
    cfg = tiny_cfg(bug_parity=bug_parity)
    g = torch.Generator().manual_seed(0)
    params_g = init_generator(cfg, g)
    params_d, stats = init_discriminator(cfg, g)
    lr, hr = _batch(which, cfg.crop_size)
    with jax.enable_x64(True):
        want = _jax_grad(cfg, params_g, params_d, stats, lr, hr)
    rel = _leaf_rel(_port_grad(cfg, params_g, params_d, stats, lr, hr), want)
    assert max(rel.values()) <= F64_RTOL, rel
