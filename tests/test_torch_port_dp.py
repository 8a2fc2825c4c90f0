"""Port parity, data parallelism (tecogan_tpu_torch/parallel/dp.py, the
train step's process group and BatchNorm over the global batch) on 2 CPU
ranks of a gloo group, against JAX's single-device step on the global
batch and the port's single-device routes (CPU, fp32, the JAX suite's
tiny train config).

One spawn of 2 ranks runs every check (tests/_torch_port_ranks.py) and
writes its arrays under ``tmp_path``.  Bars:

* the DP step, ``bug_parity`` on and off, at a global batch of 2 (1 a
  rank) against JAX's ``build_train_step`` on it: every metric within
  ``METRIC_RTOL`` (relative, 1e-5 absolute below 1), every param leaf and
  the BN statistics within ``LEAF_TOL``, the generator outputs within
  1e-5; as in tests/test_torch_port_train_step.py, params whose first-step
  Adam gradient lies within 1e-4 of 0 (relative to the leaf) may step the
  other way and are held to the step's range, 2 lr;
* the DP step at a global batch of 4 (2 a rank), ``bug_parity`` on and
  off, against the port's single-process step on the global batch: params
  and BN statistics as above, first moments within ``MOMENT_RTOL`` of each
  leaf's largest, the metrics within ``METRIC_RTOL``.  JAX is not the
  reference there: at B = 4 a few pre-activations lie within f32 rounding
  of a ReLU's or leaky ReLU's kink, each package's f32 step rounds them to
  its own side, and one such element moves a gradient by a finite step
  (up to 4e-2 of a D leaf; tests/test_torch_port_d_grad_f64.py holds the
  port's f32 D gradient to JAX's float64 one on each kink's float64
  side).  JAX has no float64 train step to hold the DP step to (its dtype
  comes from ``cfg.precision`` alone), so the reference is the port's
  single-process step on the same batch (at B = 2 the packages agree to
  2e-5);
* every rank holds the same state bit for bit (one D-balance decision);
* the gate: a threshold between the global ``t_balance`` and the larger
  rank-local one, which a rank-local gate would split on, against the
  port's single-process step at that threshold;
* K = 2 steps a dispatch against the port's single-process multi-step;
* DP serving and DP int8 serving bit-equal to each stream's
  single-device clip; the broadcast qtail bit-equal to a single-process
  calibration on the same clips.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_ranks import dp_checks, single_serving
from conftest import cached_train_step
from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import TrainState as JaxTrainState
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.inference import build_quantized_clip_inference
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator, model_defs,
                                            state_from_params)
from tecogan_tpu_torch.engine.train import build_multi_train_step, build_train_step
from tecogan_tpu_torch.parallel import make_mesh, shard_batch, spawn
from tecogan_tpu_torch.utils.convert import (discriminator_params_to_jax,
                                             generator_params_to_jax,
                                             generator_state_dict_from_jax)

RANKS = 2
METRIC_RTOL = 1e-5
LEAF_TOL = 1e-5
MOMENT_RTOL = 1e-4
CLIP_RANGE = 0.3


def tiny_cfg(**kw):
    base = dict(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                discrim_channels=16, precision="fp32")
    base.update(kw)
    return TecoConfig(**base)


SERVE = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False, use_pallas=True)


def _batch(rng, b, lead=()):
    c = tiny_cfg().crop_size
    lr = rng.random(lead + (b, 9, 3, c, c), np.float32) * np.float32(CLIP_RANGE)
    hr = rng.random(lead + (b, 9, 3, 4 * c, 4 * c), np.float32)
    return lr, hr


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_trees(state):
    params_d, stats = discriminator_params_to_jax(state.params_d, state.batch_stats_d)
    res = {}
    _flat("params_g/", generator_params_to_jax(state.params_g), res)
    _flat("params_d/", params_d, res)
    _flat("batch_stats_d/", stats, res)
    _flat("mu_g/", generator_params_to_jax(state.opt_g.mu), res)
    _flat("mu_d/", discriminator_params_to_jax(state.opt_d.mu, {})[0], res)
    return res


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
    out = tmp_path_factory.mktemp("dp")
    g = torch.Generator().manual_seed(0)
    weights = (init_generator(tiny_cfg(), g), *init_discriminator(tiny_cfg(), g))
    rng = np.random.default_rng(0)
    b2, b4 = _batch(rng, 2), _batch(rng, 4)
    steps = {f"{name}{b}": (tiny_cfg(bug_parity=bp, batch_size=b), *batch)
             for name, bp in (("parity", True), ("fixed", False))
             for b, batch in ((2, b2), (4, b4))}
    gate = (tiny_cfg(bug_parity=False, batch_size=4), *b4)
    multi = (tiny_cfg(bug_parity=False, batch_size=4, steps_per_dispatch=2),
             *_batch(rng, 4, (2,)))
    clips = rng.random((RANKS, 3, 8, 12, 3), np.float32) * np.float32(CLIP_RANGE)
    spawn(dp_checks, RANKS, device="cpu", init_file=str(out / "rdzv"),
          args=(str(out), steps, weights, gate, multi, (SERVE, clips)))

    def load(name):
        return [dict(np.load(out / f"{name}_r{r}.npz")) for r in range(RANKS)]

    return load, weights, steps, gate, multi, clips


def _jax_step(cfg, weights, lr, hr):
    jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
    opt_g, opt_d, _ = j_make_optimizers(jcfg)
    params_g, params_d, stats = weights
    js = JaxTrainState(params_g=params_g, params_d=params_d, batch_stats_d=stats,
                       opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
                       step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    js, jm, jout = cached_train_step(jcfg)(js, jnp.asarray(lr), jnp.asarray(hr))
    want = {}
    _flat("params_g/", js.params_g, want)
    _flat("params_d/", js.params_d, want)
    _flat("batch_stats_d/", js.batch_stats_d, want)
    _flat("mu_g/", js.opt_g.inner_state[0].mu, want)
    _flat("mu_d/", js.opt_d.inner_state[0].mu, want)
    return want, jm, np.asarray(jout)


def _single_step(cfg, weights, lr, hr, multi=False):
    s = state_from_params(cfg, *weights, device="cpu")
    build = build_multi_train_step if multi else build_train_step
    s, m, _ = build(cfg, device="cpu")(s, torch.from_numpy(lr), torch.from_numpy(hr))
    return _port_trees(s), m


def _same_on_every_rank(ranks, skip=("gen_out",)):
    for k, v in ranks[0].items():
        if k not in skip:
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def _close_metric(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= METRIC_RTOL * max(abs(want), 1.0), (what, got, want)


def _check_leaves(got, want, lr, tol=LEAF_TOL):
    """BN statistics within ``tol``; params within ``tol`` but where
    want's first Adam moment lies within MOMENT_RTOL of 0 relative to its
    leaf (the step's sign is free there): those within 2 lr, at most a few
    per thousand."""
    for key, w in want.items():
        if key.startswith("batch_stats_d/"):
            np.testing.assert_allclose(got[key], w, atol=tol, err_msg=key)
        elif key.startswith("params_"):
            mu = np.abs(want["mu_" + key[len("params_"):]])
            diff = np.abs(got[key] - w)
            free = mu <= MOMENT_RTOL * mu.max()
            assert diff[~free].max(initial=0.0) <= tol, (key, diff[~free].max())
            assert diff[free].max(initial=0.0) <= 2.0001 * lr, key
            excused = free & (diff > tol)
            assert excused.sum() <= max(2, 3e-3 * diff.size), (key, excused.sum())


def _like_single(got, want):
    """The DP state against the single-process one: params and BN
    statistics as :func:`_check_leaves`, first moments within MOMENT_RTOL
    of each leaf's largest element (the suite's bar for grads)."""
    _check_leaves(got, want, 1e-4)
    for key, w in want.items():
        if key.startswith("mu_"):
            assert np.abs(got[key] - w).max() <= MOMENT_RTOL * np.abs(w).max(), key


@pytest.mark.parametrize("case", ["parity", "fixed"])
def test_dp_step_matches_jax_on_the_global_batch(run, case):
    load, weights, steps = run[:3]
    ranks = load(f"{case}2")
    _same_on_every_rank(ranks)
    cfg, lr, hr = steps[f"{case}2"]
    want, jm, jout = _jax_step(cfg, weights, lr, hr)
    for k in jm:
        _close_metric(ranks[0][f"m/{k}"], jm[k], k)
    _check_leaves(ranks[0], want, 1e-4)
    gen_out = np.concatenate([r["gen_out"] for r in ranks])
    np.testing.assert_allclose(gen_out, jout, atol=1e-5)


@pytest.mark.parametrize("case", ["parity", "fixed"])
def test_dp_step_is_the_single_process_step_at_two_samples_a_rank(run, case):
    load, weights, steps = run[:3]
    ranks = load(f"{case}4")
    _same_on_every_rank(ranks)
    cfg, lr, hr = steps[f"{case}4"]
    want, m = _single_step(cfg, weights, lr, hr)
    _like_single(ranks[0], want)
    for k, v in m.items():
        _close_metric(ranks[0][f"m/{k}"], v, k)


def test_d_balance_gate_is_one_decision_for_every_rank(run):
    load, weights, _, (cfg, lr, hr) = run[:4]
    ranks = load("gate")
    _same_on_every_rank(ranks, skip=())
    tb, thr = ranks[0]["ranks_tb"], float(ranks[0]["thr"])
    # a gate on each rank's own t_balance would split the ranks ...
    assert (tb.min() < thr) and (tb.max() > thr), (tb, thr)
    # ... the global one sits below the threshold: every rank updates D
    assert float(ranks[0]["m/t_balance"]) < thr
    assert float(ranks[0]["m/withD_counter"]) == 1.0
    want, m = _single_step(cfg.replace(Dbalance=thr), weights, lr, hr)
    assert float(m["withD_counter"]) == 1.0
    _like_single(ranks[0], want)


def test_dp_multi_step_is_the_single_process_multi_step(run):
    load, weights, _, _, (cfg, lr_k, hr_k) = run[:5]
    ranks = load("multi")
    _same_on_every_rank(ranks, skip=())
    want, m = _single_step(cfg, weights, lr_k, hr_k, multi=True)
    for k, v in m.items():
        for i in range(2):
            _close_metric(ranks[0][f"m/{k}"][i], v[i], f"{k}[{i}]")
    _like_single(ranks[0], want)


def test_dp_serving_is_each_streams_single_device_clip(run):
    load, weights, clips = run[0], run[1], run[5]
    ranks = load("serve")
    _same_on_every_rank(ranks, skip=())
    model = model_defs(SERVE, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(weights[0]))
    prepare, _ = build_quantized_clip_inference(SERVE)
    qtail = prepare(model.eval(), weights[0], torch.from_numpy(clips), frames=clips.shape[1])
    for name, layer in qtail.items():
        for k, v in layer.items():
            if v is not None:
                np.testing.assert_array_equal(ranks[0][f"qtail/{name}/{k}"], v.numpy())
    bf16, int8 = single_serving(SERVE, weights[0], clips, qtail)
    np.testing.assert_array_equal(ranks[0]["bf16"], bf16)
    np.testing.assert_array_equal(ranks[0]["int8"], int8)


def test_make_mesh_keeps_the_jax_checks():
    """In a world of one process: the JAX package's shape checks and error
    text (tecogan_tpu/parallel/mesh.py:28-56), the model axis counted in
    them, and a mesh of one rank whose collectives are the identity."""
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.device.type) == (1, 0, None, "cpu")
    with pytest.raises(ValueError, match="mesh 1x2x1 needs 2 devices, only 1 visible"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x2x1 needs 4 devices, only 2 visible"):
        make_mesh(2, 1, devices=["cpu", "cpu"], n_slice=2)
    with pytest.raises(ValueError, match="mesh of 2 ranks in a world of 1 processes"):
        make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh 1x1x2 needs 2 devices, only 1 visible"):
        make_mesh(1, 2, device="cpu")
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(shard_batch(mesh, x).numpy(), x)
