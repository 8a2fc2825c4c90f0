"""Port parity, tensor parallelism (tecogan_tpu_torch/parallel/tp.py: the
channel-sharded train step over a (data, model) grid of processes) on 4
CPU ranks of a gloo group, against the port's single-process step and
JAX's single-device step (CPU, fp32, the JAX suite's tiny train config).

One spawn of 4 ranks runs every case (tests/_torch_port_ranks.py): the
2x2 grid (2 samples a data index) with ``bug_parity`` on and off, and the
1x2 grid on the first two ranks, at B = 4 for 2 steps and at B = 2 for one.
Bars:

* the sharded leaves are the ones JAX's ``_array_sharding`` shards on the
  same state (tecogan_tpu/parallel/tp.py:33-45), through the weight bridge;
* against the port's single-process step, as JAX's
  ``tests/test_dist.py::test_tp_channel_sharded_step_matches_single_device``
  holds its TP step: ``gen_loss`` and ``d_loss`` of each step within
  ``LOSS_RTOL``, Adam's ``mu`` and ``nu`` after the first within
  ``LEAF_ATOL``;
* leaf by leaf, against the single-process step whose convs add their bias
  after the conv, as the column-parallel convs add it after the join: the
  losses, and after each step ``mu`` and ``nu`` within ``LEAF_ATOL`` and
  within ``MOMENT_RTOL`` of each leaf's largest element, BN statistics and
  params within ``LEAF_ATOL`` (:func:`_check_state`).  That rounding is
  the one the two steps order differently, and under ``bug_parity`` it
  alone moves the generator trunk's gradients, small sums over ReLU masks,
  by more than 1e-3 of a leaf, one process against itself (a test below).
  The moments scale with the gradient:
  a first Adam step moves a param by about ``lr * sign(g)`` whatever the
  gradient's size, so the params alone would pass a gradient off by a
  factor, and the relative bar on the moments is what catches one;
* against JAX at B = 2 (at B = 4 the packages' fp32 gradients part where
  a pre-activation lies within f32 rounding of an activation's kink, each
  package rounding it to its own side, tests/test_torch_port_d_grad_f64.py,
  and JAX has no float64 step to hold TP to): the losses within
  ``LOSS_RTOL``, G's params and first moments within ``LEAF_ATOL``;
* every replicated leaf the same on every rank of a model group, the ranks
  of a data group holding the same shard, each shard the rank's slice of
  the gathered state;
* the TP-saved ``.ckpt`` pair has the single-process pair's leaves and
  metadata and loads into a single-process state equal to the gathered
  one, and back into the shard bit for bit.
"""

import contextlib
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_ranks import state_arrays, tp_checks
from conftest import cached_train_step
from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import TrainState as JaxTrainState
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu.parallel import make_mesh as j_make_mesh
from tecogan_tpu.parallel.mesh import MODEL_AXIS
from tecogan_tpu.parallel.tp import _array_sharding
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator,
                                            state_from_params)
from tecogan_tpu_torch.engine.train import build_train_step
from tecogan_tpu_torch.models import layers
from tecogan_tpu_torch.parallel import spawn
from tecogan_tpu_torch.utils.checkpoint import load_flat, load_train_state, save_train_state
from tecogan_tpu_torch.utils.convert import generator_params_to_jax

RANKS = 4
LOSS_RTOL = 2e-5
LEAF_ATOL = 2e-5
MOMENT_RTOL = 1e-4
STEPS = 2
CLIP_RANGE = 0.3
GRIDS = {"2x2": (2, 2, True), "2x2_fixed": (2, 2, False), "1x2": (1, 2, True)}


def tiny_cfg(**kw):
    base = dict(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                discrim_channels=16, precision="fp32")
    base.update(kw)
    return TecoConfig(**base)


def _batch(rng, b):
    c = tiny_cfg().crop_size
    lr = rng.random((b, 9, 3, c, c), np.float32) * np.float32(CLIP_RANGE)
    hr = rng.random((b, 9, 3, 4 * c, 4 * c), np.float32)
    return lr, hr


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
    out = tmp_path_factory.mktemp("tp")
    g = torch.Generator().manual_seed(0)
    weights = (init_generator(tiny_cfg(), g), *init_discriminator(tiny_cfg(), g))
    rng = np.random.default_rng(0)
    b4, b2 = _batch(rng, 4), _batch(rng, 2)
    cases = {name: (nd, nm, tiny_cfg(bug_parity=bp, batch_size=4), *b4, STEPS)
             for name, (nd, nm, bp) in GRIDS.items()}
    cases["jax"] = (1, 2, tiny_cfg(batch_size=2), *b2, 1)
    spawn(tp_checks, RANKS, device="cpu", init_file=str(out / "rdzv"),
          args=(str(out), cases, weights))

    def load(name):
        ranks = 2 * cases[name][0]
        return [dict(np.load(out / f"{name}_r{r}.npz")) for r in range(ranks)]

    return load, weights, cases, out


@contextlib.contextmanager
def bias_after_the_conv():
    """Every ``Conv`` / ``ConvTranspose2x`` adds its bias to the conv's
    result, as the column-parallel convs add it after the join, in place of
    the conv's own bias add: the one rounding the TP step orders otherwise
    (see :func:`test_the_bias_add_order_alone_moves_the_parity_trunk`)."""
    conv_fwd, convt_fwd = layers.Conv.forward, layers.ConvTranspose2x.forward

    def conv(self, x):
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None, None]

    def convt(self, x):
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), None, stride=2, padding=1,
                               output_padding=1)
        return y + self.bias.to(x.dtype)[:, None, None]

    layers.Conv.forward, layers.ConvTranspose2x.forward = conv, convt
    try:
        yield
    finally:
        layers.Conv.forward, layers.ConvTranspose2x.forward = conv_fwd, convt_fwd


def _single_steps(cfg, weights, lr, hr, steps):
    state = state_from_params(cfg, *weights, device="cpu")
    step = build_train_step(cfg, device="cpu")
    per_step = []
    for _ in range(steps):
        state, m, _ = step(state, torch.from_numpy(lr), torch.from_numpy(hr))
        per_step.append(({k: float(v) for k, v in m.items()}, state_arrays(state)))
    return per_step, state


@pytest.fixture(scope="module")
def single(run, tmp_path_factory):
    """The port's single-process steps of each B = 4 case: per step the
    metrics and the state's arrays, the same with :func:`bias_after_the_conv`,
    and that run's ``.ckpt`` pair after the last step."""
    _, weights, cases, _ = run
    res = {}
    for name in GRIDS:
        cfg, lr, hr, steps = cases[name][2:]
        plain = _single_steps(cfg, weights, lr, hr, steps)[0]
        with bias_after_the_conv():
            after, state = _single_steps(cfg, weights, lr, hr, steps)
        ckpt = tmp_path_factory.mktemp(f"single_{name}")
        save_train_state(str(ckpt), state, epoch=steps)
        res[name] = plain, after, str(ckpt)
    return res


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}.", v, out)
        else:
            out[prefix + k] = v
    return out


def _port_key(flax_path: str) -> str:
    """A flax path ``a.b.kernel`` as the port's ``state_dict`` key."""
    module, leaf = flax_path.rsplit(".", 1)
    return f"{module}.{'weight' if leaf == 'kernel' else leaf}"


def _check_state(got, want, lr, what, free, moment_rtol=MOMENT_RTOL):
    """``got`` (flat state arrays) against ``want`` after a step: Adam's
    moments within ``LEAF_ATOL`` and ``moment_rtol`` of each leaf's largest
    element, the BN statistics within ``LEAF_ATOL``, the params within
    ``LEAF_ATOL`` but where want's first moment has lain within
    ``MOMENT_RTOL`` of 0 relative to its leaf after this step or an
    earlier one (Adam's step is about ``lr * sign(g)`` there, its sign
    free): those within 2 lr a step, at most a few per thousand.  ``free``
    ({key: mask}, updated) carries those params from step to step."""
    steps = free.setdefault("steps", 0) + 1
    free["steps"] = steps
    for key, w in want.items():
        diff = np.abs(got[key] - w)
        if key.startswith(("mu_", "nu_")):
            assert diff.max() <= LEAF_ATOL, (what, key, diff.max())
            if moment_rtol is not None:
                assert diff.max() <= moment_rtol * np.abs(w).max(), (
                    what, key, diff.max(), np.abs(w).max())
        elif key.startswith("params_"):
            mu = np.abs(want["mu_" + key[len("params_"):]])
            f = free[key] = free.get(key, False) | (mu <= MOMENT_RTOL * mu.max())
            assert diff[~f].max(initial=0.0) <= LEAF_ATOL, (what, key, diff[~f].max())
            assert diff[f].max(initial=0.0) <= 2.0001 * lr * steps, (what, key)
            excused = f & (diff > LEAF_ATOL)
            assert excused.sum() <= max(2, 3e-3 * diff.size), (what, key, excused.sum())
        else:
            assert diff.max() <= LEAF_ATOL, (what, key, diff.max())


def test_sharded_leaves_are_jax_s(run):
    """The port's sharded keys and dims equal the leaves JAX shards over
    ``model`` on the same state (its params, moments and BN statistics in
    the flax layout), at n_model = 2; at least one generator kernel shards,
    ``conv_out`` does not."""
    load, weights, cases = run[:3]
    got = load("2x2")[0]
    jcfg = JaxTecoConfig(**dataclasses.asdict(cases["2x2"][2]))
    opt_g, opt_d, _ = j_make_optimizers(jcfg)
    params_g, params_d, stats = weights
    mesh = j_make_mesh(1, 2)
    trees = {"params_g": params_g, "params_d": params_d, "batch_stats_d": stats,
             "mu_g": opt_g.init(params_g).inner_state[0].mu,
             "nu_g": opt_g.init(params_g).inner_state[0].nu,
             "mu_d": opt_d.init(params_d).inner_state[0].mu,
             "nu_d": opt_d.init(params_d).inner_state[0].nu}
    for name, tree in trees.items():
        want = {_port_key(p) for p, x in _flat("", tree, {}).items()
                if MODEL_AXIS in str(_array_sharding(mesh, x).spec)}
        mine = {k.split("/", 2)[2] for k, v in got.items()
                if k.startswith(f"dim/{name}/") and v >= 0}
        assert mine == want, (name, mine ^ want)
    assert got["dim/params_g/conv_in.weight"] == 0
    assert got["dim/params_g/up1.weight"] == 1  # ConvTranspose2d: (in, out, kh, kw)
    assert got["dim/params_g/conv_out.weight"] == -1
    assert got["dim/params_d/block5.Conv_0.weight"] == -1


def test_grid_places_ranks_as_jax_reshape(run):
    """Rank r has data index r // n_model and model index r % n_model."""
    load = run[0]
    for name in ("2x2", "1x2"):
        for r, rank in enumerate(load(name)):
            n_data = 2 if name == "2x2" else 1
            assert tuple(rank["grid"]) == (r // 2, r % 2, 2, n_data), (name, r)


@pytest.mark.parametrize("case", list(GRIDS))
def test_tp_step_is_the_single_process_step(run, single, case):
    """Each step's ``gen_loss`` and ``d_loss`` within ``LOSS_RTOL`` and
    Adam's ``mu`` and ``nu`` within ``LEAF_ATOL`` of the port's
    single-process step; the metrics and the gathered state the same on
    every rank."""
    ranks = run[0](case)
    for i, (m, want) in enumerate(single[case][0]):
        got = ranks[0]
        for k in ("gen_loss", "d_loss"):
            np.testing.assert_allclose(float(got[f"m{i}/{k}"]), m[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        for key in (k for k in want if i == 0 and k.startswith(("mu_", "nu_"))):
            np.testing.assert_allclose(got[f"s{i}/{key}"], want[key], rtol=0, atol=LEAF_ATOL,
                                       err_msg=f"step {i} {key}")
        for r in ranks[1:]:
            for k, v in got.items():
                if k.startswith((f"m{i}/", f"s{i}/")):
                    np.testing.assert_array_equal(r[k], v, err_msg=k)


@pytest.mark.parametrize("case", list(GRIDS))
def test_tp_step_is_the_single_process_step_with_the_bias_added_alike(run, single, case):
    """Against the single-process step whose convs add their bias after the
    conv (:func:`bias_after_the_conv`), as the column-parallel convs do
    after the join: each step's state leaf by leaf (:func:`_check_state`:
    the moments, which scale with the gradient, within ``MOMENT_RTOL`` of
    each leaf's largest element; the params after each step), the losses
    within ``LOSS_RTOL``."""
    got, free = run[0](case)[0], {}
    for i, (m, want) in enumerate(single[case][1]):
        for k in ("gen_loss", "d_loss"):
            np.testing.assert_allclose(float(got[f"m{i}/{k}"]), m[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        _check_state({k: got[f"s{i}/{k}"] for k in want}, want, tiny_cfg().learning_rate,
                     f"step {i}", free)


def test_the_bias_add_order_alone_moves_the_parity_trunk(run, single):
    """Why the leaf-by-leaf bars take the bias added alike: under
    ``bug_parity`` the single-process step's first moments part from the
    same step with :func:`bias_after_the_conv` by more than 10
    ``MOMENT_RTOL`` of a leaf (the generator trunk's small gradients, sums
    over ReLU masks), and the TP step parts from the plain step no further;
    with ``bug_parity`` off the two single-process steps agree within
    ``MOMENT_RTOL``."""
    def worst(got, want):
        return max(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
                   for k in want if k.startswith("mu_"))

    plain, after = single["2x2"][0][0][1], single["2x2"][1][0][1]
    order = worst(after, plain)
    assert order > 10 * MOMENT_RTOL, order
    tp = run[0]("2x2")[0]
    assert worst({k: tp[f"s0/{k}"] for k in plain}, plain) <= 2 * order
    fixed_plain, fixed_after = single["2x2_fixed"][0][0][1], single["2x2_fixed"][1][0][1]
    assert worst(fixed_after, fixed_plain) <= MOMENT_RTOL


@pytest.mark.parametrize("case", list(GRIDS))
def test_replicated_leaves_are_equal_on_every_rank(run, case):
    """Every rank of a model group leaves the step with the same replicated
    leaves; the ranks of a data group hold the same shard; each shard is
    the rank's slice of the gathered state."""
    ranks = run[0](case)
    last = f"s{STEPS - 1}/"
    for r, rank in enumerate(ranks):
        model_rank = r % 2
        for key in (k[len("dim/"):] for k in rank if k.startswith("dim/")):
            shard, dim = rank[f"shard/{key}"], int(rank[f"dim/{key}"])
            full = rank[last + key]
            if dim < 0:
                np.testing.assert_array_equal(shard, ranks[r - model_rank][f"shard/{key}"],
                                              err_msg=(r, key))
                np.testing.assert_array_equal(shard, full, err_msg=(r, key))
            else:
                c = full.shape[dim] // 2
                want = np.take(full, range(model_rank * c, (model_rank + 1) * c), axis=dim)
                np.testing.assert_array_equal(shard, want, err_msg=(r, key))
            np.testing.assert_array_equal(shard, ranks[r % 2][f"shard/{key}"],
                                          err_msg=(r, key))
        np.testing.assert_array_equal(rank["gen_out"], ranks[r - model_rank]["gen_out"])


def test_tp_step_matches_jax_at_two_samples(run):
    """The 1x2 grid at B = 2 against JAX's single-device step."""
    load, weights, cases = run[:3]
    got = load("jax")[0]
    cfg, lr, hr = cases["jax"][2:5]
    jcfg = JaxTecoConfig(**dataclasses.asdict(cfg))
    opt_g, opt_d, _ = j_make_optimizers(jcfg)
    params_g, params_d, stats = weights
    js = JaxTrainState(params_g=params_g, params_d=params_d, batch_stats_d=stats,
                       opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
                       step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    js, jm, _ = cached_train_step(jcfg)(js, jnp.asarray(lr), jnp.asarray(hr))
    for k in ("gen_loss", "d_loss"):
        np.testing.assert_allclose(float(got[f"m0/{k}"]), float(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)

    def tree(prefix):
        sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in got.items()
              if k.startswith(prefix)}
        return _flat("", generator_params_to_jax(sd), {})

    got_g = {f"params_g/{k}": v for k, v in tree("s0/params_g/").items()}
    got_g.update({f"mu_g/{k}": v for k, v in tree("s0/mu_g/").items()})
    want = {f"params_g/{k}": np.asarray(v) for k, v in _flat("", js.params_g, {}).items()}
    want.update({f"mu_g/{k}": np.asarray(v)
                 for k, v in _flat("", js.opt_g.inner_state[0].mu, {}).items()})
    _check_state(got_g, want, cfg.learning_rate, "against JAX", {}, moment_rtol=None)


@pytest.mark.parametrize("case", ["2x2", "1x2"])
def test_tp_checkpoint_is_the_single_process_pair(run, single, case):
    """The shard's ``.ckpt`` pair (written once, by rank 0 of the grid) has
    the single-process pair's leaves and metadata; it loads into a
    single-process state equal to the gathered one, which
    :func:`_check_state` holds to the single-process state after the same
    steps (the bias added alike), and back into every shard bit for bit."""
    load, weights, cases, out = run
    ranks = load(case)
    single_dir = single[case][2]
    for f in ("generator.ckpt", "discrim.ckpt"):
        got, got_meta = load_flat(os.path.join(out, f"ckpt_{case}", f))
        want, want_meta = load_flat(os.path.join(single_dir, f))
        assert got.keys() == want.keys() and got_meta.keys() == want_meta.keys(), f
        for k in want_meta:
            np.testing.assert_array_equal(got_meta[k], want_meta[k], err_msg=k)
        for k, w in want.items():
            assert got[k].shape == w.shape and got[k].dtype == w.dtype, (f, k)
    template = state_from_params(cases[case][2], *weights, device="cpu")
    loaded, epoch = load_train_state(os.path.join(out, f"ckpt_{case}"), template)
    assert epoch == STEPS and loaded.step == STEPS
    arrays = state_arrays(loaded)
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, ranks[0][f"s{STEPS - 1}/{k}"], err_msg=k)
    free = {}
    for i, (_, want) in enumerate(single[case][1]):
        state_i = arrays if i == STEPS - 1 else {k: ranks[0][f"s{i}/{k}"] for k in want}
        _check_state(state_i, want, tiny_cfg().learning_rate, f"step {i}", free)
    for rank in ranks:
        assert int(rank["loaded_epoch"]) == STEPS
        for k in (k for k in rank if k.startswith("shard/")):
            np.testing.assert_array_equal(rank["loaded/" + k[len("shard/"):]], rank[k],
                                          err_msg=k)
