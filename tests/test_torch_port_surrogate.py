"""Port parity, the surrogate VGG-19: tecogan_tpu_torch.utils.jax_prng
against ``jax.random`` / flax's parameter keys, the regenerated
``fixed_seed_vgg_params`` against the JAX package's, and a train step
with the command line's ``--vgg_ckpt surrogate`` VGG loss against the JAX
step's (CPU).

Bars: the PRNG and the surrogate tree bit for bit; the train step's
``gen_loss`` and ``vgg_all`` 1e-4 relative (the bar of
tests/test_torch_port_metrics.py's VGG train step, fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import LazyRng

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import TrainState as JaxTrainState
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu.engine.train import build_train_step as j_build_train_step
from tecogan_tpu.models import vgg as j_vgg
from tecogan_tpu_torch.cli import main as cli
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                            state_from_params)
from tecogan_tpu_torch.engine.train import build_train_step
from tecogan_tpu_torch.models import vgg
from tecogan_tpu_torch.utils import jax_prng

LOSS_RTOL = 1e-4
SEEDS = [0, 1, 7, 20260816, 2**31 + 5, -3]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_surrogate():
    """The JAX package's surrogate VGG-19 params as numpy (one JAX init,
    ~9 s on the CPU)."""
    return jax.tree_util.tree_map(np.asarray, j_vgg.fixed_seed_vgg_params())


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    np.testing.assert_array_equal(jax_prng.prng_key(seed), _key(seed))
    for data in (0, 1, 12345, 2**32 - 1):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(jax_prng.fold_in(jax_prng.prng_key(seed), data), want)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 7), (3, 3, 64, 3), (2, 1, 130)])
def test_random_bits_match_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
    got = jax_prng.random_bits(jax_prng.prng_key(seed), shape)
    assert got.dtype == np.uint32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.37, 0.41), (-1 / 27 ** 0.5, 1 / 27 ** 0.5),
                                    (-2.5e-3, 2.5e-3), (3.0, 1e4)])
def test_uniform_matches_jax(seed, bounds):
    """Bit for bit, which needs the one rounding of the multiply-add
    (two roundings differ in the last bit for about half the elements)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 99)
    want = np.asarray(jax.random.uniform(key, (3, 3, 16, 8), jnp.float32, *bounds))
    got = jax_prng.uniform(jax_prng.fold_in(jax_prng.prng_key(seed), 99), (3, 3, 16, 8),
                           *bounds)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", [("conv1_1", 1), ("conv5_4", 2), ("resblock_10", 1),
                                    ("a", "b", 3), ("x", 300)])
def test_flax_param_key_matches_flax(suffix):
    root = jax.random.PRNGKey(20260816)
    want = np.asarray(LazyRng.create(root, *suffix).as_jax_rng())
    np.testing.assert_array_equal(
        jax_prng.flax_param_key(jax_prng.prng_key(20260816), *suffix), want)


def test_surrogate_tree_is_the_jax_surrogate(jax_surrogate):
    """Every leaf of the regenerated surrogate bit-equal to the JAX
    package's; the hash the card checks is the JAX tree's."""
    got = vgg.fixed_seed_vgg_params()
    assert got.keys() == jax_surrogate.keys()
    for name, layer in jax_surrogate.items():
        assert got[name].keys() == layer.keys()
        for leaf, want in layer.items():
            assert got[name][leaf].dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got[name][leaf], want, err_msg=f"{name}/{leaf}")
    assert vgg.params_sha256(jax_surrogate) == vgg.SURROGATE_SHA256
    assert vgg.params_sha256(vgg.load_vgg_params("surrogate")) == vgg.SURROGATE_SHA256


def test_other_seeds_differ():
    a = vgg.fixed_seed_vgg_params(1)
    b = vgg.fixed_seed_vgg_params()
    assert not np.array_equal(a["conv1_1"]["kernel"], b["conv1_1"]["kernel"])
    assert vgg.params_sha256(a) != vgg.SURROGATE_SHA256


def test_cli_surrogate_train_step_matches_jax(jax_surrogate):
    """One tiny fp32 step with the VGG loss as the command line builds it
    for ``--vgg_ckpt surrogate`` (``cli.main._vgg_apply``), against the JAX
    step on the JAX surrogate, from the same weights and batch."""
    cfg = TecoConfig(crop_size=8, RNN_N=3, num_resblock=1, discrim_resblocks=1,
                     discrim_channels=16, batch_size=1, precision="fp32",
                     bug_parity=False, vgg_scaling=0.2, vgg_ckpt="surrogate")
    jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
    g = torch.Generator().manual_seed(0)
    params_g, (params_d, stats) = init_generator(cfg, g), init_discriminator(cfg, g)
    rng = np.random.default_rng(2)
    lr = rng.random((1, 3, 3, 8, 8), np.float32) * np.float32(0.3)
    hr = rng.random((1, 3, 3, 32, 32), np.float32)

    def j_vgg_apply(images, deep_list):
        return j_vgg.vgg19_features(jax_surrogate, images, deep_list)

    opt_g, opt_d, _ = j_make_optimizers(jcfg)
    js = JaxTrainState(params_g=params_g, params_d=params_d, batch_stats_d=stats,
                       opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
                       step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    _, jm, _ = j_build_train_step(jcfg, vgg_apply=j_vgg_apply, donate=False)(
        js, jnp.asarray(lr), jnp.asarray(hr))
    vgg_apply = cli._vgg_apply(cfg, torch.device("cpu"))
    state = state_from_params(cfg, params_g, params_d, stats, device="cpu")
    _, m, _ = build_train_step(cfg, vgg_apply=vgg_apply, device="cpu")(
        state, torch.from_numpy(lr), torch.from_numpy(hr))
    assert float(jm["vgg_all"]) > 0
    for k in ("vgg_all", "gen_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
