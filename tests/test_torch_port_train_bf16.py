"""Port parity, the train step in bf16: one step of tecogan_tpu_torch's
build_train_step against the JAX package's with ``precision="bf16"``, on
the same flax weights (the generator's conv kernels scaled by 2.5, so
that its output depends on its input and on the trunk) and batches, with
``bug_parity`` on and off (CPU, the JAX suite's tiny config).

The two packages round to bf16 at the same points (each layer casts its
input and its float32 weight, the bias is added in bf16, BatchNorm works
in float32 and returns bf16, the sigmoid is float32), but their convs sum
in other orders, so a value near a rounding step rounds the other way
now and then and the difference grows through the layers and the BN
rescaling: the two bf16 steps sit about as far apart as either sits from
the exact (float32) step.  The bars say so:

* metrics: 2 * 2**-8 relative (absolute below 1), two bf16 unit
  roundoffs; the generator's outputs, in [0, 1]: 4 * 2**-8 absolute;
* Adam's moments and the params' update, per model: the relative L2
  distance to JAX's bf16 step at most twice that of the port's float32
  step, i.e. within the spread that bf16 rounding itself makes.

Measured with these inputs: metrics up to 0.58 of their bar, outputs
0.78, moments and updates up to 0.61 of theirs.  What this cannot show
is *where* each package rounds: a variant of the port that keeps the
bias and residual adds of the generator in float32 (as ``torch.autocast``
would) lands as close to JAX's bf16 step, whether or not XLA may keep
excess precision (``--xla_allow_excess_precision``), because the sum-order
noise above is as large as one rounding more or less.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cached_train_step
from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import TrainState as JaxTrainState
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                            state_from_params)
from tecogan_tpu_torch.engine.train import build_train_step
from tecogan_tpu_torch.utils.convert import (discriminator_params_to_jax,
                                             generator_params_to_jax)

BF16_ULP = 2.0 ** -8
METRIC_TOL = 2 * BF16_ULP
OUTPUT_TOL = 4 * BF16_ULP
SPREAD_FACTOR = 2.0
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3


def _cfg(bug_parity):
    return TecoConfig(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                      discrim_channels=16, batch_size=2, precision="bf16",
                      bug_parity=bug_parity)


def _weights(cfg):
    g = torch.Generator().manual_seed(0)
    params_g, params_d, stats = init_generator(cfg, g), *init_discriminator(cfg, g)
    params_g = jax.tree_util.tree_map_with_path(
        lambda p, v: v * np.float32(KERNEL_GAIN) if p[-1].key == "kernel" else v, params_g)
    return params_g, params_d, stats


def _batch(cfg):
    rng = np.random.default_rng(0)
    c = cfg.crop_size
    lr = rng.random((2, cfg.RNN_N, 3, c, c), np.float32) * np.float32(CLIP_RANGE)
    hr = rng.random((2, cfg.RNN_N, 3, 4 * c, 4 * c), np.float32)
    return lr, hr


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x, np.float32))
                           for x in jax.tree_util.tree_leaves(tree)])


def _port_trees(state):
    """Flat (params_g, params_d, mu_g, mu_d) of a port state in flax leaf order."""
    def d_tree(sd):
        return discriminator_params_to_jax(sd, {})[0]

    return {"params_g": _flat(generator_params_to_jax(state.params_g)),
            "params_d": _flat(d_tree(state.params_d)),
            "mu_g": _flat(generator_params_to_jax(state.opt_g.mu)),
            "mu_d": _flat(d_tree(state.opt_d.mu))}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("bug_parity", [True, False])
def test_bf16_step_matches_jax_bf16(bug_parity):
    cfg = _cfg(bug_parity)
    weights = _weights(cfg)
    lr, hr = _batch(cfg)
    jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
    opt_g, opt_d, _ = j_make_optimizers(jcfg)
    params_g, params_d, stats = weights
    j_state = JaxTrainState(params_g=params_g, params_d=params_d, batch_stats_d=stats,
                            opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
                            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    js, jm, jout = cached_train_step(jcfg)(j_state, jnp.asarray(lr), jnp.asarray(hr))
    want = {"params_g": _flat(js.params_g), "params_d": _flat(js.params_d),
            "mu_g": _flat(js.opt_g.inner_state[0].mu), "mu_d": _flat(js.opt_d.inner_state[0].mu)}

    got = {}
    for prec in ("bf16", "fp32"):
        c = cfg.replace(precision=prec)
        s0 = state_from_params(c, *weights, device="cpu")
        s, m, out = build_train_step(c, device="cpu")(s0, torch.from_numpy(lr),
                                                      torch.from_numpy(hr))
        got[prec] = (m, out, _port_trees(s))
    m, out, trees = got["bf16"]
    exact = got["fp32"][2]

    assert set(m) == set(jm)
    for k in jm:
        a, b = float(m[k]), float(jm[k])
        assert abs(a - b) <= METRIC_TOL * max(abs(b), 1.0), (k, a, b)
    assert out.dtype == torch.float32
    assert float(np.abs(out.numpy() - np.asarray(jout, np.float32)).max()) <= OUTPUT_TOL
    # the output depends on the trunk: bf16 and fp32 outputs are apart
    assert float((out - got["fp32"][1]).abs().max()) > BF16_ULP

    start = {"params_g": _flat(params_g), "params_d": _flat(params_d)}
    for side in ("g", "d"):
        mu = f"mu_{side}"
        assert _rel_l2(trees[mu], want[mu]) <= SPREAD_FACTOR * _rel_l2(exact[mu], want[mu]), mu
        p = f"params_{side}"
        upd, upd_want = trees[p] - start[p], want[p] - start[p]
        assert (_rel_l2(upd, upd_want)
                <= SPREAD_FACTOR * _rel_l2(exact[p] - start[p], upd_want)), p
