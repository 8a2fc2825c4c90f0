"""Port parity, row-sharded single-stream serving
(tecogan_tpu_torch/parallel/spatial.py and its halo exchange) on 3 CPU
ranks of a gloo group, against the port's single-device routes and the
JAX package (CPU; 2 resblocks, LR 24 x 16, T = 3).

One spawn of 3 ranks runs every check (tests/_torch_port_ranks.py) and
writes its arrays under ``tmp_path``.  Bars:

* the halo exchange: exact, zeros at the image's edge, at n = 3, 2, 1;
* the exact route (fp32, ``bug_parity`` off and on) within
  ``SHARD_TOL`` of the port's single-device clip (a conv over R + 2 rows
  need not sum as the full frame's does) and within the port's exact bar
  ``EXACT_TOL`` of JAX's single-device clip (tests/test_torch_port_inference.py);
* the fused bf16 route bit-equal to the port's single-device fused route,
  and above the port's fused bar ``FUSED_PSNR_DB`` against JAX's
  ``build_spatial_fused_clip_inference`` on ``make_mesh(n_data=3)``;
* the int8 route with JAX's qtail bit-equal to the port's single-device
  int8 clip;
* a height the ranks do not divide raises JAX's error.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_ranks import HALO_BLOCK, halo_block, spatial_checks
from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.inference import build_clip_inference as j_build
from tecogan_tpu.engine.inference import build_quantized_clip_inference as j_build_q
from tecogan_tpu.parallel.mesh import make_mesh as j_make_mesh
from tecogan_tpu.parallel.spatial import (
    build_spatial_fused_clip_inference as j_build_spatial_fused)
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                build_quantized_clip_inference)
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.parallel import spawn
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax, qtail_from_jax

RANKS = 3
CLIP_SHAPE = (1, 3, 24, 16, 3)
SHARD_TOL = 2e-6          # tests/test_spatial.py:38-58
EXACT_TOL = 1e-4          # tests/test_torch_port_inference.py, the port's exact bar
FUSED_PSNR_DB = 50.0      # tests/test_torch_port_inference.py:43
KERNEL_GAIN = 2.5         # as tests/test_torch_port_inference.py: the output depends on the warp
CLIP_RANGE = 0.3

BASE = TecoConfig(num_resblock=2, crop_size=8, RNN_N=4, bug_parity=False)
CFGS = {"exact": BASE.replace(precision="fp32", use_pallas=False),
        "parity": BASE.replace(precision="fp32", use_pallas=False, bug_parity=True),
        "fused": BASE.replace(precision="bf16", use_pallas=True)}


def _jax_cfg(cfg):
    return JaxTecoConfig(**dataclasses.asdict(cfg))


def _params():
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else
                (v * np.float32(KERNEL_GAIN) if k == "kernel" else v)
                for k, v in tree.items()}
    return scale(init_generator(BASE, torch.Generator().manual_seed(0)))


def _model(cfg, params):
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This process's torch work on one thread, as the ranks' (the suite
    runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' arrays (rank -> npz) and the inputs they were given."""
    out = tmp_path_factory.mktemp("spatial")
    params = _params()
    clip = np.random.default_rng(0).random(CLIP_SHAPE, np.float32) * np.float32(CLIP_RANGE)
    prepare, _ = j_build_q(_jax_cfg(CFGS["fused"]))
    jax_qtail = prepare(params, jnp.asarray(clip), frames=CLIP_SHAPE[1])
    qtail_np = {name: {k: None if v is None else np.asarray(v) for k, v in layer.items()}
                for name, layer in jax_qtail.items()}
    spawn(spatial_checks, RANKS, device="cpu", init_file=str(out / "rdzv"),
          args=(str(out), CFGS, params, clip, qtail_np))
    ranks = [dict(np.load(out / f"spatial_r{r}.npz")) for r in range(RANKS)]
    return ranks, params, clip, qtail_np


@pytest.mark.parametrize("n", [3, 2, 1])
def test_halo_exchange_brings_the_neighbours_rows(run, n):
    ranks = run[0]
    blocks = [halo_block(r).numpy() for r in range(n)]
    zeros = np.zeros((1, 4) + HALO_BLOCK[2:], np.float32)
    for r in range(n):
        above = blocks[r - 1] if r > 0 else zeros
        below = blocks[r + 1] if r < n - 1 else zeros
        for up, down in ((1, 1), (0, 1), (4, 4)):
            want = np.concatenate([above[:, 4 - up:], blocks[r], below[:, :down]], axis=1)
            np.testing.assert_array_equal(ranks[r][f"halo{n}_{up}{down}"], want,
                                          err_msg=f"rank {r} up {up} down {down}")
    for r in range(n, RANKS):
        assert f"halo{n}_11" not in ranks[r]  # outside the mesh of n ranks


@pytest.mark.parametrize("route", ["exact", "parity"])
def test_exact_route_matches_single_device(run, route):
    ranks, params, clip, _ = run
    cfg = CFGS[route]
    got = ranks[0][route]
    for r in range(1, RANKS):
        np.testing.assert_array_equal(ranks[r][route], got)
    single = build_clip_inference(cfg)(_model(cfg, params), torch.from_numpy(clip)).numpy()
    jax_ref = np.asarray(j_build(_jax_cfg(cfg))(params, jnp.asarray(clip)))
    assert got.shape == single.shape == jax_ref.shape == (1, 3, 96, 64, 3)
    np.testing.assert_allclose(got, single, atol=SHARD_TOL)
    np.testing.assert_allclose(got, jax_ref, atol=EXACT_TOL)


def test_fused_route_is_the_single_device_fused_route(run):
    ranks, params, clip, _ = run
    cfg = CFGS["fused"]
    got = ranks[0]["fused"]
    single = build_clip_inference(cfg)(_model(cfg, params), torch.from_numpy(clip)).numpy()
    np.testing.assert_array_equal(got, single)
    jax_sp = np.asarray(j_build_spatial_fused(_jax_cfg(cfg), j_make_mesh(n_data=RANKS))(
        params, jnp.asarray(clip)))
    assert got.shape == jax_sp.shape
    assert _psnr(got[:, -1], jax_sp[:, -1]) > FUSED_PSNR_DB


def test_int8_route_is_the_single_device_int8_clip(run):
    ranks, params, clip, qtail_np = run
    cfg = CFGS["fused"]
    _, infer_q = build_quantized_clip_inference(cfg)
    single = infer_q(_model(cfg, params), qtail_from_jax(qtail_np), torch.from_numpy(clip))
    for r in range(RANKS):
        np.testing.assert_array_equal(ranks[r]["int8"], single.numpy())


def test_a_height_the_ranks_do_not_divide_raises(run):
    for rank in run[0]:
        assert str(rank["bad_height"]) == "LR height 20 not divisible by 3 shards"
