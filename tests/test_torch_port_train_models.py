"""Port parity, the training slice's models and data: the discriminator
and its BatchNorm against flax, the weight bridge both ways, the random
discriminator weights, the synthetic batches and the FLOP counts (CPU,
fp32, the JAX suite's tiny sizes)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.data.synthetic import synthetic_scene_batch as j_synthetic_batch
from tecogan_tpu.engine.losses import discriminator_loss as j_discriminator_loss
from tecogan_tpu.engine.state import init_state as j_init_state
from tecogan_tpu.engine.state import model_defs as j_model_defs
from tecogan_tpu.utils import flops as j_flops
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
from tecogan_tpu_torch.engine.losses import discriminator_loss
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                            train_model_defs)
from tecogan_tpu_torch.utils import flops
from tecogan_tpu_torch.utils.convert import (discriminator_params_to_jax,
                                             discriminator_state_dict_from_jax,
                                             generator_params_to_jax,
                                             generator_state_dict_from_jax)

# fp32 D forward: two conv implementations summing up to 16*64-term dot
# products in other orders, then a sigmoid (score) or BN rescaling (maps)
SCORE_TOL, MAPS_TOL = 1e-5, 2e-5
STATS_TOL = 1e-6


def tiny_cfg(**kw):
    base = dict(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                discrim_channels=16, batch_size=2, precision="fp32")
    base.update(kw)
    return TecoConfig(**base)


def _jax_cfg(cfg):
    return JaxTecoConfig(**dataclasses.asdict(cfg))


def _weights(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return init_generator(cfg, g), *init_discriminator(cfg, g)


def _port_disc(cfg, params_d):
    disc = train_model_defs(cfg, device="cpu")[1]
    disc.load_state_dict(discriminator_state_dict_from_jax(params_d, {})[0])
    return disc


def _paths(tree):
    return [(p, np.shape(v)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("merged", [True, False])
def test_init_discriminator_has_the_flax_tree(merged):
    cfg = tiny_cfg(Dt_mergeDs=merged, crop_dt=1.0)
    ref = j_init_state(_jax_cfg(cfg), jax.random.PRNGKey(0))
    _, params, stats = _weights(cfg)
    assert _paths(params) == _paths(ref.params_d)
    assert _paths(stats) == _paths(ref.batch_stats_d)
    leaves = jax.tree_util.tree_leaves((params, stats))
    assert all(v.dtype == np.float32 for v in leaves)
    np.testing.assert_array_equal(stats["block1"]["BatchNorm_0"]["var"], 1.0)
    np.testing.assert_array_equal(params["resids1"]["bn_0"]["scale"], 1.0)


@pytest.mark.parametrize("in_ch,size", [(27, 32), (9, 32), (27, 64)])
def test_discriminator_matches_flax(rng, in_ch, size):
    """Score, the 4 layer maps and the BN batch statistics, merged
    (27 channels) and unmerged (9); the fc size follows the input."""
    cfg = tiny_cfg(Dt_mergeDs=in_ch == 27, crop_dt=1.0, crop_size=size // 4)
    _, params, stats = _weights(cfg, seed=1)
    x = rng.standard_normal((3, size, size, in_ch)).astype(np.float32)
    disc_j = j_model_defs(_jax_cfg(cfg))[1]
    (score_j, layers_j), upd = disc_j.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    score, layers, batch = _port_disc(cfg, params)(torch.from_numpy(x))
    assert score.dtype == torch.float32 and tuple(score.shape) == (3, 1)
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(score_j), atol=SCORE_TOL)
    assert len(layers) == 4
    for got, want in zip(layers, layers_j):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MAPS_TOL)
    # flax's running update 0.9 * 1 + 0.1 * batch_var recovers the batch var
    for path, var in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
        key = ".".join(p.key for p in path)
        if key.endswith(".var"):
            np.testing.assert_allclose((np.asarray(var) - 0.9) / 0.1,
                                       batch[key].numpy(), atol=1e-5)


@pytest.mark.parametrize("bug_parity", [True, False])
def test_bn_running_stats_match_flax(rng, bug_parity):
    """The BN running statistics after discriminator_loss (real, then
    fake) against JAX's batch_stats: flax's biased batch variance.
    torch's unbiased one, n/(n-1) larger with n <= 2 * 16 * 16, would move
    each running variance by ~0.1 * var / 511, two orders above the bar."""
    cfg = tiny_cfg(bug_parity=bug_parity)
    _, params, stats = _weights(cfg, seed=2)
    real = rng.standard_normal((2, 27, 32, 32)).astype(np.float32)
    fake = rng.standard_normal((2, 27, 32, 32)).astype(np.float32)
    disc_j = j_model_defs(_jax_cfg(cfg))[1]
    loss_j, stats_j = j_discriminator_loss(disc_j, params, stats, jnp.asarray(real),
                                           jnp.asarray(fake), _jax_cfg(cfg))
    pd, sd = discriminator_state_dict_from_jax(params, stats)
    loss, new = discriminator_loss(train_model_defs(cfg, device="cpu")[1], pd, sd,
                                   torch.from_numpy(real), torch.from_numpy(fake), cfg)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    _, got = discriminator_params_to_jax(pd, new)
    want = jax.tree_util.tree_map(np.asarray, stats_j)
    assert _paths(got) == _paths(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, atol=STATS_TOL)


def test_bridge_round_trip_is_exact():
    cfg = tiny_cfg()
    params_g, params_d, stats = _weights(cfg, seed=3)
    sd_g = generator_state_dict_from_jax(params_g)
    back = generator_state_dict_from_jax(generator_params_to_jax(sd_g))
    assert sd_g.keys() == back.keys()
    assert all(torch.equal(sd_g[k], back[k]) for k in sd_g)
    pd, sd = discriminator_state_dict_from_jax(params_d, stats)
    pd2, sd2 = discriminator_state_dict_from_jax(*discriminator_params_to_jax(pd, sd))
    for a, b in ((pd, pd2), (sd, sd2)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    # port -> flax is the flax tree itself, leaf for leaf
    for a, b in zip(jax.tree_util.tree_leaves(generator_params_to_jax(sd_g)),
                    jax.tree_util.tree_leaves(params_g)):
        np.testing.assert_array_equal(a, b)
    # the port's modules take the bridged dicts strictly
    gen, disc = train_model_defs(cfg, device="cpu")
    gen.load_state_dict(sd_g)
    disc.load_state_dict(pd)
    assert disc.fc.weight.shape == (1, 3)


@pytest.mark.parametrize("args", [(2, 5, 8, 3), (1, 3, 32, 0)])
def test_synthetic_batch_matches_jax(args):
    """The numpy 4x4 box mean against the JAX package's cv2.INTER_AREA."""
    lr, hr = synthetic_scene_batch(*args[:3], seed=args[3])
    lr_j, hr_j = j_synthetic_batch(*args[:3], seed=args[3])
    assert lr.shape == lr_j.shape and hr.shape == hr_j.shape
    assert lr.dtype == hr.dtype == np.float32
    np.testing.assert_array_equal(hr, hr_j)
    np.testing.assert_allclose(lr, lr_j, atol=1e-6)


def test_train_flops_match_jax():
    for kw in ({}, {"bug_parity": False}, {"pingpang": True}):
        assert flops.train_step_macs(4, 10, 32, **kw) == j_flops.train_step_macs(4, 10, 32, **kw)
    assert flops.discriminator_macs(128, 128) == j_flops.discriminator_macs(128, 128)
    mfu = flops.train_mfu(10.0, 4, 10, 32)
    assert mfu["train_tflop_per_step"] == pytest.approx(1.6175, abs=1e-4)
    assert mfu["mfu"] == pytest.approx(mfu["achieved_tflops"] * 1e12 / 989e12)
