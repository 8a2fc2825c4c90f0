"""Port parity, the train step: tecogan_tpu_torch's build_train_step
against the JAX package's on the same flax weights and batches -- one
step with ``bug_parity`` on and off, with uint8 batches and with the D
update masked; a 4-step trajectory; Adam against optax; the K-step
dispatch, remat and the epoch schedule; checkpoints across both packages
(CPU, fp32, the JAX suite's tiny config).

Bars: metrics <= 1e-5 relative (1e-5 abs below 1: ``t_balance`` is a
difference of two ~1.2 terms); BN statistics and new params <= 1e-6 abs;
Adam moments <= 1e-4 relative per leaf (the grads' bar).  Adam's first
step moves a weight by ``lr * g / (|g| + eps)``, about ``sign(g) * lr``,
so where a gradient element is within that disagreement of 0 its sign,
and the step, may differ: those elements (at most a few per thousand)
are held to the step's range, 2 * lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import cached_train_step
from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import TrainState as JaxTrainState
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu.utils.checkpoint import load_train_state as j_load_train_state
from tecogan_tpu.utils.checkpoint import save_train_state as j_save_train_state
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine import state as port_state
from tecogan_tpu_torch.engine.state import (AdamState, init_discriminator,
                                            init_generator, init_state,
                                            make_optimizers, state_from_params,
                                            train_model_defs)
from tecogan_tpu_torch.engine.train import (build_multi_train_step,
                                            build_train_step, set_epoch)
from tecogan_tpu_torch.utils.checkpoint import (discriminator_ckpt_path,
                                                generator_ckpt_path,
                                                has_checkpoint, load_train_state,
                                                save_train_state)
from tecogan_tpu_torch.utils.convert import (discriminator_params_to_jax,
                                             generator_params_to_jax)

METRIC_RTOL = 1e-5
PARAM_TOL = 1e-6
STATS_TOL = 1e-6
MOMENT_RTOL = 1e-4
CLIP_RANGE = 0.3


def tiny_cfg(**kw):
    base = dict(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                discrim_channels=16, batch_size=2, precision="fp32", jit=True)
    base.update(kw)
    return TecoConfig(**base)


def _jax_cfg(cfg):
    return JaxTecoConfig(**dataclasses.asdict(cfg))


def _weights(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return init_generator(cfg, g), *init_discriminator(cfg, g)


def _batches(cfg, n, seed=0, u8=False):
    rng = np.random.default_rng(seed)
    c = cfg.crop_size
    out = []
    for _ in range(n):
        if u8:
            lr = (rng.random((2, cfg.RNN_N, 3, c, c)) * 255 * CLIP_RANGE).astype(np.uint8)
            hr = (rng.random((2, cfg.RNN_N, 3, 4 * c, 4 * c)) * 255).astype(np.uint8)
        else:
            lr = rng.random((2, cfg.RNN_N, 3, c, c), np.float32) * np.float32(CLIP_RANGE)
            hr = rng.random((2, cfg.RNN_N, 3, 4 * c, 4 * c), np.float32)
        out.append((lr, hr))
    return out


def _jax_state(cfg, params_g, params_d, stats):
    opt_g, opt_d, _ = j_make_optimizers(_jax_cfg(cfg))
    return JaxTrainState(params_g=params_g, params_d=params_d, batch_stats_d=stats,
                         opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
                         step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))


def _as_jax_trees(state):
    """The port's state as the flax trees the JAX state holds."""
    params_d, stats = discriminator_params_to_jax(state.params_d, state.batch_stats_d)

    def d_tree(sd):
        return discriminator_params_to_jax(sd, {})[0]

    return {"params_g": generator_params_to_jax(state.params_g), "params_d": params_d,
            "batch_stats_d": stats,
            "mu_g": generator_params_to_jax(state.opt_g.mu),
            "nu_g": generator_params_to_jax(state.opt_g.nu),
            "mu_d": d_tree(state.opt_d.mu), "nu_d": d_tree(state.opt_d.nu)}


def _jax_trees(js):
    g, d = js.opt_g.inner_state[0], js.opt_d.inner_state[0]
    return {"params_g": js.params_g, "params_d": js.params_d,
            "batch_stats_d": js.batch_stats_d, "mu_g": g.mu, "nu_g": g.nu,
            "mu_d": d.mu, "nu_d": d.nu}


def _pairs(got, want):
    """(path, got, want) numpy leaf triples of two trees of one structure."""
    leaves_w = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    return [(p, np.asarray(g), np.asarray(w)) for (p, g), (_, w) in zip(leaves_g, leaves_w)]


def _close_metric(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= METRIC_RTOL * max(abs(want), 1.0), (what, got, want)


def _check_params(got, want, mu_want, lr):
    """New params against JAX's: <= PARAM_TOL, but for first-step Adam
    where the reference gradient (mu / (1 - b1)) is within MOMENT_RTOL of
    0 relative to its leaf, held to the step's range."""
    for (path, g, w), (_, m, _) in zip(_pairs(got, want), _pairs(mu_want, mu_want)):
        diff = np.abs(g - w)
        free = np.abs(m) <= MOMENT_RTOL * np.abs(m).max()
        assert diff[~free].max(initial=0.0) <= PARAM_TOL, path
        assert diff[free].max(initial=0.0) <= 2.0001 * lr, path
        excused = free & (diff > PARAM_TOL)
        assert excused.sum() <= max(2, 3e-3 * diff.size), (path, excused.sum())


CASES = {
    "parity": (dict(bug_parity=True), False),
    "fixed": (dict(bug_parity=False), False),
    "parity_u8": (dict(bug_parity=True), True),
    # the balance EMA starts near 0, so a negative threshold masks D
    "fixed_d_masked": (dict(bug_parity=False, Dbalance=-1.0), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_jax(case):
    kw, u8 = CASES[case]
    cfg = tiny_cfg(**kw)
    weights = _weights(cfg)
    (lr, hr), = _batches(cfg, 1, u8=u8)
    js, jm, jout = cached_train_step(_jax_cfg(cfg))(_jax_state(cfg, *weights),
                                                    jnp.asarray(lr), jnp.asarray(hr))
    s0 = state_from_params(cfg, *weights, device="cpu")
    s, m, out = build_train_step(cfg, device="cpu")(s0, torch.from_numpy(lr),
                                                     torch.from_numpy(hr))
    assert set(m) == set(jm)
    for k in jm:
        _close_metric(m[k], jm[k], k)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    assert (s.step, s.opt_g.count, s.opt_d.count) == (1, 1, 1)
    assert int(js.step) == 1 and int(js.opt_d.inner_state[0].count) == 1
    assert s.opt_g.learning_rate == float(js.opt_g.hyperparams["learning_rate"])
    assert s.opt_d.learning_rate == float(js.opt_d.hyperparams["learning_rate"])

    got, want = _as_jax_trees(s), _jax_trees(js)
    for _, a, b in _pairs(got["batch_stats_d"], want["batch_stats_d"]):
        np.testing.assert_allclose(a, b, atol=STATS_TOL)
    for side in ("g", "d"):
        for name in (f"mu_{side}", f"nu_{side}"):
            for path, a, b in _pairs(got[name], want[name]):
                assert np.abs(a - b).max() <= MOMENT_RTOL * np.abs(b).max(), (name, path)
        _check_params(got[f"params_{side}"], want[f"params_{side}"], want[f"mu_{side}"], 1e-4)

    if case == "fixed_d_masked":
        # the mask holds D's params; its moments and count advance all the same
        assert float(m["withD_counter"]) == 0.0 and float(m["w_o_D_counter"]) == 1.0
        for k, v in s.params_d.items():
            assert torch.equal(v, s0.params_d[k])
        assert all(float(v.abs().max()) > 0 for v in s.opt_d.nu.values())
    else:
        assert float(m["withD_counter"]) == 1.0


def test_four_step_trajectory_tracks_jax():
    """Four steps from the same weights on the same batches: losses step
    by step, and the G params' drift from JAX's against how far they moved
    (the tolerances of tests/test_reference_parity.py's trajectory test)."""
    cfg = tiny_cfg(bug_parity=True)
    weights = _weights(cfg)
    batches = _batches(cfg, 4, seed=1)
    js = _jax_state(cfg, *weights)
    j_step = cached_train_step(_jax_cfg(cfg))
    s = state_from_params(cfg, *weights, device="cpu")
    step = build_train_step(cfg, device="cpu")
    for i, (lr, hr) in enumerate(batches):
        js, jm, _ = j_step(js, jnp.asarray(lr), jnp.asarray(hr))
        s, m, _ = step(s, torch.from_numpy(lr), torch.from_numpy(hr))
        np.testing.assert_allclose(float(m["gen_loss"]), float(jm["gen_loss"]),
                                   rtol=2e-3, atol=1e-4, err_msg=f"gen_loss step {i}")
        np.testing.assert_allclose(float(m["d_loss"]), float(jm["d_loss"]),
                                   rtol=2e-3 * 3 ** max(0, i - 1), atol=1e-4,
                                   err_msg=f"d_loss step {i}")
    got = generator_params_to_jax(s.params_g)
    drift = max(np.abs(a - b).max() for _, a, b in _pairs(got, js.params_g))
    moved = max(np.abs(a - b).max() for _, a, b in _pairs(js.params_g, weights[0]))
    assert moved > 1e-4
    assert drift < 0.2 * moved, (drift, moved)


@pytest.mark.parametrize("masked", [False, True])
def test_adam_matches_optax(masked):
    """Three updates on the same grads: optax's inject_hyperparams(adam)
    with the learning rate set before each, the update zeroed by the mask
    as the JAX step zeroes D's."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 3, 3, 3)).astype(np.float32) * 0.1,
              "b": rng.standard_normal((4,)).astype(np.float32) * 0.1}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 10.0 ** -i
              for k, v in params.items()} for i in range(3)]
    cfg = tiny_cfg(Dt_mergeDs=False)  # D's rate x0.3
    tx = j_make_optimizers(_jax_cfg(cfg))[1]
    jp, jst = params, tx.init(params)
    adam = make_optimizers(cfg)[1]
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    pst = adam.init(pp, cfg.learning_rate)
    assert pst.learning_rate == float(jst.hyperparams["learning_rate"])
    apply = torch.tensor(not masked)
    for i, g in enumerate(grads):
        lr = 1e-4 * 0.8 ** i
        jst.hyperparams["learning_rate"] = np.float32(lr) * np.float32(0.3)
        upd, jst = tx.update(g, jst, jp)
        if masked:
            upd = jax.tree_util.tree_map(jnp.zeros_like, upd)
        jp = optax.apply_updates(jp, upd)
        pp, pst = adam.update(pp, {k: torch.from_numpy(v) for k, v in g.items()}, pst, lr,
                              apply=apply)
    assert pst.count == int(jst.count) == 3
    assert pst.learning_rate == float(jst.hyperparams["learning_rate"])
    inner = jst.inner_state[0]
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-8)
        np.testing.assert_allclose(pst.mu[k].numpy(), np.asarray(inner.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(pst.nu[k].numpy(), np.asarray(inner.nu[k]), rtol=1e-6)
        if masked:
            assert torch.equal(pp[k], torch.from_numpy(params[k]))


def test_multi_step_equals_single_steps():
    cfg = tiny_cfg(bug_parity=False, steps_per_dispatch=2)
    (b0, b1) = _batches(cfg, 2, seed=2)
    s = init_state(cfg, torch.Generator().manual_seed(4), device="cpu")
    step = build_train_step(cfg, device="cpu")
    s1, m0, _ = step(s, *map(torch.from_numpy, b0))
    s1, m1, last = step(s1, *map(torch.from_numpy, b1))
    multi = build_multi_train_step(cfg, device="cpu")
    lr_k = torch.from_numpy(np.stack([b0[0], b1[0]]))
    hr_k = torch.from_numpy(np.stack([b0[1], b1[1]]))
    s2, mk, last_k = multi(s, lr_k, hr_k)
    assert s2.step == s1.step == 2
    for k in m0:
        assert tuple(mk[k].shape) == (2,)
        torch.testing.assert_close(mk[k], torch.stack([m0[k], m1[k]]), rtol=0, atol=1e-6)
    for a, b in ((s1.params_g, s2.params_g), (s1.params_d, s2.params_d),
                 (s1.opt_g.nu, s2.opt_g.nu)):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6)
    torch.testing.assert_close(last, last_k, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        build_multi_train_step(cfg.replace(steps_per_dispatch=1), device="cpu")


def test_remat_matches_plain_unroll():
    """Recomputing each frame in the backward changes no number."""
    cfg = tiny_cfg(bug_parity=False)
    (lr, hr), = _batches(cfg, 1, seed=3)
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        s = init_state(c, torch.Generator().manual_seed(6), device="cpu")
        out[remat] = build_train_step(c, device="cpu")(s, torch.from_numpy(lr),
                                                       torch.from_numpy(hr))
    (s0, m0, _), (s1, m1, _) = out[False], out[True]
    for k in m0:
        torch.testing.assert_close(m0[k], m1[k], rtol=0, atol=1e-6)
    for k in s0.params_g:
        torch.testing.assert_close(s0.params_g[k], s1.params_g[k], rtol=0, atol=1e-6)


def test_set_epoch_sets_the_step_lr_schedule():
    cfg = tiny_cfg(learning_rate=1e-4, decay_step=250, decay_rate=0.8)
    sched = port_state.lr_schedule(cfg)
    for epoch, want in ((0, 1e-4), (249, 1e-4), (250, 0.8e-4), (500, 0.64e-4)):
        assert sched(epoch) == pytest.approx(want, rel=1e-6)
    s = set_epoch(init_state(cfg, torch.Generator().manual_seed(0), device="cpu"), 250)
    assert s.epoch == 250
    (lr, hr), = _batches(cfg, 1)
    _, m, _ = build_train_step(cfg, device="cpu")(s, torch.from_numpy(lr), torch.from_numpy(hr))
    assert float(m["learning_rate"]) == pytest.approx(0.8e-4, rel=1e-6)


def _equal_trees(a, b):
    pairs = _pairs(a, b)
    assert pairs
    for path, x, y in pairs:
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    cfg = tiny_cfg()
    (lr, hr), = _batches(cfg, 1)
    s, _, _ = build_train_step(cfg, device="cpu")(
        init_state(cfg, torch.Generator().manual_seed(1), device="cpu"),
        torch.from_numpy(lr), torch.from_numpy(hr))
    save_train_state(str(tmp_path), s, epoch=7)
    assert has_checkpoint(str(tmp_path))
    template = _jax_state(cfg, *_weights(cfg, seed=2))
    js, epoch = j_load_train_state(str(tmp_path), template)
    assert epoch == 7 and int(js.epoch) == 7 and int(js.step) == s.step == 1
    trees = _as_jax_trees(s)
    _equal_trees(js.params_g, trees["params_g"])
    _equal_trees(js.params_d, trees["params_d"])
    _equal_trees(js.batch_stats_d, trees["batch_stats_d"])
    for side, opt in (("g", s.opt_g), ("d", s.opt_d)):
        jopt = getattr(js, f"opt_{side}")
        _equal_trees(jopt.inner_state[0].mu, trees[f"mu_{side}"])
        _equal_trees(jopt.inner_state[0].nu, trees[f"nu_{side}"])
        assert int(jopt.count) == int(jopt.inner_state[0].count) == opt.count
        assert np.float32(jopt.hyperparams["learning_rate"]) == np.float32(opt.learning_rate)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    cfg = tiny_cfg(bug_parity=False)
    (lr, hr), = _batches(cfg, 1, seed=4)
    js, _, _ = cached_train_step(_jax_cfg(cfg))(_jax_state(cfg, *_weights(cfg, seed=3)),
                                                jnp.asarray(lr), jnp.asarray(hr))
    j_save_train_state(str(tmp_path), js, epoch=5)
    template = init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    s, epoch = load_train_state(str(tmp_path), template)
    assert (epoch, s.epoch, s.step) == (5, 5, 1)
    trees = _as_jax_trees(s)
    want = _jax_trees(js)
    for name in trees:
        _equal_trees(trees[name], jax.tree_util.tree_map(np.asarray, want[name]))
    for side in ("g", "d"):
        jopt, opt = getattr(js, f"opt_{side}"), getattr(s, f"opt_{side}")
        assert isinstance(opt, AdamState) and opt.count == int(jopt.inner_state[0].count)
        assert opt.learning_rate == float(jopt.hyperparams["learning_rate"])
    # the loaded state keeps the template's device and memory format
    for k, v in s.params_g.items():
        assert v.device == template.params_g[k].device
        assert v.stride() == template.params_g[k].stride(), k
    # ... and trains on
    s2, m, _ = build_train_step(cfg, device="cpu")(s, torch.from_numpy(lr), torch.from_numpy(hr))
    assert s2.step == 2 and np.isfinite(float(m["gen_loss"]))


def test_torn_checkpoint_pair_raises(tmp_path):
    cfg = tiny_cfg()
    s = init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    a, b = tmp_path / "a", tmp_path / "b"
    save_train_state(str(a), s, epoch=1)
    save_train_state(str(b), s, epoch=2)
    (a / "discrim.ckpt").replace(discriminator_ckpt_path(str(b)))
    with pytest.raises(ValueError, match="torn checkpoint pair"):
        load_train_state(str(b), s)
    assert not has_checkpoint(str(a))
    assert generator_ckpt_path(str(a)).endswith("generator.ckpt")
    # a template of another size refuses the checkpoint
    c = tmp_path / "c"
    save_train_state(str(c), s, epoch=3)
    other = init_state(cfg.replace(discrim_channels=8), torch.Generator().manual_seed(1),
                       device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_train_state(str(c), other)


def test_entry_points_need_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_cfg()
    for call in (lambda: init_state(cfg, torch.Generator()),
                 lambda: build_train_step(cfg),
                 lambda: train_model_defs(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
