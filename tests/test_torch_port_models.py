"""Port parity, models: the weight bridge and the torch Generator against
the flax Generator on the same weights and inputs (CPU, fp32)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig
from tecogan_tpu.models.generator import Generator as JaxGenerator
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

# fp32 generator parity: two conv implementations summing ~600-term dot
# products in different orders, through 2 resblocks and two 2x upsamples.
TOL = 2e-5
CFG = TecoConfig(num_resblock=2, precision="fp32")


def _flax_params(seed=0):
    gen = JaxGenerator(num_resblock=CFG.num_resblock)
    params = gen.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, 51)))["params"]
    return gen, jax.tree_util.tree_map(np.asarray, params)


def _port(params):
    model = model_defs(CFG)
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def test_init_generator_has_the_flax_tree():
    _, ref = _flax_params()
    got = init_generator(CFG, torch.Generator().manual_seed(0))
    ref_paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_paths = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [(p, np.shape(v)) for p, v in ref_paths] == \
        [(p, np.shape(v)) for p, v in got_paths]
    assert all(v.dtype == np.float32 for _, v in got_paths)


def test_bridge_matches_the_torch_exporter():
    """The bridge gives the tensors tools/convert_torch_ckpt.py exports for
    the reference model (exact: pure layout maps)."""
    from convert_torch_ckpt import export_generator

    _, params = _flax_params()
    sd = generator_state_dict_from_jax(params)
    ref = export_generator(params, num_resblock=CFG.num_resblock)
    names = {"conv_in": "conv.0", "up1": "conv_trans.0",
             "trunk_rb1.Conv_0": "conv_trans.2.0",
             "trunk_rb1.Conv_1": "conv_trans.2.2",
             "trunk_rb2.Conv_0": "conv_trans.3.0",
             "trunk_rb2.Conv_1": "conv_trans.3.2",
             "up2": "conv_trans.4", "conv_hr": "conv_trans.6",
             "conv_out": "output"}
    for i in range(CFG.num_resblock):
        names[f"resblock_{i}.Conv_0"] = f"resids.{i}.0"
        names[f"resblock_{i}.Conv_1"] = f"resids.{i}.2"
    assert len(sd) == len(ref)
    for key, t in sd.items():
        mod, leaf = key.rsplit(".", 1)
        torch.testing.assert_close(t, ref[f"{names[mod]}.{leaf}"], rtol=0, atol=0)
    model = model_defs(CFG)
    model.load_state_dict(sd)  # strict: every key and shape matches


@pytest.mark.parametrize("method", ["forward", "tail", "tail_features"])
def test_generator_matches_flax(rng, method):
    gen, params = _flax_params(seed=1)
    model = _port(params)
    cin = 51 if method == "forward" else 64
    x = rng.standard_normal((2, 6, 5, cin)).astype(np.float32)
    if method == "forward":
        ref = gen.apply({"params": params}, jnp.asarray(x))
        got = model(torch.from_numpy(x))
    else:
        ref = gen.apply({"params": params}, jnp.asarray(x),
                        method=getattr(JaxGenerator, method))
        got = getattr(model, method)(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=TOL)
