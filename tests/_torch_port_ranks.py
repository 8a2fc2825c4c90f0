"""Rank bodies of the port's multi-process CPU tests
(tests/test_torch_port_{spatial,dp,tp}.py).

``tecogan_tpu_torch.parallel.spawn`` runs each function in every rank of
a gloo group (one thread a rank) and pickles it by its import path, so
they live here, in a module that imports torch and the port only: a rank
never loads JAX.  Each rank writes what it computed to ``out/<name>_r<rank>.npz``;
the test compares in its own process.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                build_quantized_clip_inference)
from tecogan_tpu_torch.engine.losses import tecogan_losses
from tecogan_tpu_torch.engine.state import model_defs, state_from_params, train_model_defs
from tecogan_tpu_torch.parallel import (build_dp_inference, build_dp_multi_train_step,
                                        build_dp_quantized_inference, build_dp_train_step,
                                        build_spatial_clip_inference,
                                        build_spatial_fused_clip_inference,
                                        build_tp_train_step, gather_state_tp, make_mesh,
                                        replicate_state, shard_batch, shard_multi_batch,
                                        shard_state_tp, state_shardings)
from tecogan_tpu_torch.parallel.collectives import all_gather_cat, halo_rows
from tecogan_tpu_torch.utils.checkpoint import load_train_state, save_train_state
from tecogan_tpu_torch.utils.convert import (discriminator_params_to_jax,
                                             generator_params_to_jax,
                                             generator_state_dict_from_jax, qtail_from_jax)

HALO_BLOCK = (1, 4, 2, 3)  # (B, R, W, C) a rank


def halo_block(rank: int) -> torch.Tensor:
    """Rank ``rank``'s row block for the halo checks: distinct values."""
    n = int(np.prod(HALO_BLOCK))
    return (torch.arange(n, dtype=torch.float32) + 1000.0 * (rank + 1)).reshape(HALO_BLOCK)


def _save(out: str, name: str, arrays: dict) -> None:
    np.savez(os.path.join(out, f"{name}_r{dist.get_rank()}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _model(cfg: TecoConfig, params, device):
    model = model_defs(cfg, device=device)
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _flat(prefix: str, tree: dict, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        else:
            out[f"{prefix}{k}"] = v


def spatial_checks(device, out: str, cfgs: dict, params, clip: np.ndarray,
                   qtail_np) -> None:
    """The halo exchange at n = 3, 2 and 1 (new groups of the first ranks),
    then every spatial route at the world's 3 ranks on ``clip``: the exact
    route with ``bug_parity`` off and on, the fused bf16 route and the int8
    route with ``qtail_np`` (a JAX qtail); and the error of a height the
    ranks do not divide."""
    res = {}
    for n in (3, 2, 1):
        mesh = make_mesh(n, device=device)
        if not mesh.member:
            continue
        x = halo_block(mesh.rank)
        for up, down in ((1, 1), (0, 1), (4, 4)):
            res[f"halo{n}_{up}{down}"] = halo_rows(x, mesh, up, down)
    mesh = make_mesh(device=device)
    lr = torch.from_numpy(clip)
    for name in ("exact", "parity"):
        cfg = cfgs[name]
        res[name] = build_spatial_clip_inference(cfg, mesh)(_model(cfg, params, device), lr)
    cfg = cfgs["fused"]
    model = _model(cfg, params, device)
    res["fused"] = build_spatial_fused_clip_inference(cfg, mesh)(model, lr)
    qtail = qtail_from_jax(qtail_np, device)
    res["int8"] = build_spatial_fused_clip_inference(cfg, mesh, quantize=True)(model, qtail, lr)
    try:
        build_spatial_fused_clip_inference(cfg, mesh)(model, lr[:, :, :-4])
    except ValueError as e:
        res["bad_height"] = np.array(str(e))
    _save(out, "spatial", res)


def _trees(state) -> dict:
    """The state's params, BN statistics and first Adam moments, flat, in
    the flax layout."""
    params_d, stats = discriminator_params_to_jax(state.params_d, state.batch_stats_d)
    res = {}
    _flat("params_g/", generator_params_to_jax(state.params_g), res)
    _flat("params_d/", params_d, res)
    _flat("batch_stats_d/", stats, res)
    _flat("mu_g/", generator_params_to_jax(state.opt_g.mu), res)
    _flat("mu_d/", discriminator_params_to_jax(state.opt_d.mu, {})[0], res)
    return res


def dp_checks(device, out: str, steps: dict, weights, gate, multi, serve) -> None:
    """At the world's ranks: each of ``steps`` ({name: (cfg, lr, hr)}, the
    global batch) through the DP step; ``gate`` (cfg, lr, hr) with a
    D-balance threshold between the largest rank-local ``t_balance`` and
    the global one; ``multi`` (cfg, lr_k, hr_k) at K steps a dispatch;
    ``serve`` (cfg, clips): DP serving and DP int8 serving, one stream a
    rank."""
    mesh = make_mesh(device=device)
    for name, (cfg, lr_np, hr_np) in steps.items():
        lr, hr = shard_batch(mesh, lr_np, hr_np)
        state = replicate_state(mesh, state_from_params(cfg, *weights, device=device))
        new, metrics, gen_out = build_dp_train_step(cfg, mesh)(state, lr, hr)
        _save(out, name, {**_trees(new), **{f"m/{k}": v for k, v in metrics.items()},
                          "gen_out": gen_out})

    # the D-balance gate: each rank's t_balance before the mean (D's BN
    # statistics over the global batch), and a threshold between the
    # largest of them and the global mean, so a rank-local gate would split
    cfg, lr_np, hr_np = gate
    lr, hr = shard_batch(mesh, lr_np, hr_np)
    state = state_from_params(cfg, *weights, device=device)
    gen, disc = train_model_defs(cfg, device=device)
    _, aux = tecogan_losses(gen, disc, state.params_g, state.params_d, state.batch_stats_d,
                            lr, hr, state.step, cfg, group=mesh.group)
    local = aux["metrics"]["t_balance"].detach().reshape(1, 1)
    ranks_tb = all_gather_cat(local, mesh, 0).reshape(-1)
    thr = float((ranks_tb.max() + ranks_tb.mean()) / 2)
    gated = cfg.replace(Dbalance=thr)
    new, metrics, _ = build_dp_train_step(gated, mesh)(state, lr, hr)
    _save(out, "gate", {**_trees(new), **{f"m/{k}": v for k, v in metrics.items()},
                        "ranks_tb": ranks_tb, "thr": np.float64(thr)})

    cfg, lr_k, hr_k = multi
    state = state_from_params(cfg, *weights, device=device)
    lr_k, hr_k = shard_multi_batch(mesh, lr_k, hr_k)
    new, metrics, _ = build_dp_multi_train_step(cfg, mesh)(state, lr_k, hr_k)
    _save(out, "multi", {**_trees(new), **{f"m/{k}": v for k, v in metrics.items()}})

    (cfg, clips), params = serve, weights[0]
    model = _model(cfg, params, device)
    streams = shard_batch(mesh, clips)
    res = {"bf16": build_dp_inference(cfg, mesh)(model, streams)}
    prepare, infer = build_dp_quantized_inference(cfg, mesh)
    qtail = prepare(model, params, torch.from_numpy(clips), frames=clips.shape[1])
    res["int8"] = infer(model, qtail, streams)
    for name, layer in qtail.items():
        for k, v in layer.items():
            if v is not None:
                res[f"qtail/{name}/{k}"] = v
    _save(out, "serve", res)


def single_serving(cfg: TecoConfig, params, clips: np.ndarray, qtail) -> tuple:
    """The single-device routes on each stream alone (the references of
    :func:`dp_checks`' serving)."""
    model = _model(cfg, params, "cpu")
    infer = build_clip_inference(cfg)
    _, infer_q = build_quantized_clip_inference(cfg)
    bf16, int8 = [], []
    for b in range(clips.shape[0]):
        one = torch.from_numpy(clips[b:b + 1])
        bf16.append(infer(model, one))
        int8.append(infer_q(model, qtail, one))
    return torch.cat(bf16).numpy(), torch.cat(int8).numpy()


def state_arrays(state) -> dict:
    """Every tensor of a train state by ``<field>/<key>`` (``mu_g``,
    ``nu_d``, ...), as numpy arrays in the port's layout."""
    res = {}
    for name, sd in (("params_g", state.params_g), ("params_d", state.params_d),
                     ("batch_stats_d", state.batch_stats_d),
                     ("mu_g", state.opt_g.mu), ("nu_g", state.opt_g.nu),
                     ("mu_d", state.opt_d.mu), ("nu_d", state.opt_d.nu)):
        for k, v in sd.items():
            res[f"{name}/{k}"] = v.detach().cpu().numpy()
    return res


def _shard_dims(mesh, state) -> dict:
    """``state_shardings`` flat as :func:`state_arrays`: -1 for replicated."""
    dims = state_shardings(mesh, state)
    res = {}
    for name, sd in (("params_g", dims.params_g), ("params_d", dims.params_d),
                     ("batch_stats_d", dims.batch_stats_d), ("mu_g", dims.opt_g.mu),
                     ("nu_g", dims.opt_g.nu), ("mu_d", dims.opt_d.mu),
                     ("nu_d", dims.opt_d.nu)):
        for k, v in sd.items():
            res[f"dim/{name}/{k}"] = np.int64(-1 if v is None else v)
    return res


def tp_checks(device, out: str, cases: dict, weights) -> None:
    """Each of ``cases`` ({name: (n_data, n_model, cfg, lr, hr, steps)}, the
    global batch) through the TP step from ``weights`` on the grid's first
    ranks (the others sit it out): the metrics of every step, the gathered
    full state after each step, this rank's shard after the last and the
    sharded dims; after the last step the shard saved as a ``.ckpt`` pair
    under ``out/ckpt_<name>`` and loaded back into the shard."""
    for name, (n_data, n_model, cfg, lr_np, hr_np, steps) in cases.items():
        mesh = make_mesh(n_data, n_model, device=device)
        if not mesh.member:
            continue
        res = {"grid": np.array([mesh.rank, mesh.model_rank, mesh.n_model, mesh.size])}
        state = shard_state_tp(mesh, replicate_state(
            mesh, state_from_params(cfg, *weights, device=device)))
        res.update(_shard_dims(mesh, state))
        step = build_tp_train_step(cfg, mesh)
        lr, hr = shard_batch(mesh, lr_np, hr_np)
        for i in range(steps):
            state, metrics, gen_out = step(state, lr, hr)
            res.update({f"m{i}/{k}": v for k, v in metrics.items()})
            res.update({f"s{i}/{k}": v for k, v in
                        state_arrays(gather_state_tp(mesh, state)).items()})
        res["gen_out"] = gen_out
        res.update({f"shard/{k}": v for k, v in state_arrays(state).items()})
        ckpt = os.path.join(out, f"ckpt_{name}")
        save_train_state(ckpt, state, epoch=steps, mesh=mesh)
        loaded, epoch = load_train_state(ckpt, state, mesh=mesh)
        res["loaded_epoch"] = np.int64(epoch)
        res.update({f"loaded/{k}": v for k, v in state_arrays(loaded).items()})
        _save(out, name, res)
