"""Train / inference command line (tecogan_tpu/cli/main.py; the
reference's ``python3 main.py --mode {train,inference}``) on the port.

    python -m tecogan_tpu_torch.cli.main --mode inference --g_checkpoint G \\
        --input_dir_LR <scenes or mp4> [--inferencetype video] ...
    python -m tecogan_tpu_torch.cli.main --mode train --input_video_dir <scenes> ...

The flags are the JAX package's (``config.build_parser``) and the outputs
its files: an mp4 (or ``--videotype``) a clip, the ``.ckpt`` pair, the
per-epoch gifs and jpgs, ``<summary_dir>/train_metrics.jsonl``.  The
command line runs on the card and raises where none is visible; Python
callers may pass ``device="cpu"`` to :func:`run_inference` and
:func:`run_train`.

With several cards visible the JAX package's multi-device routes apply,
each rank a process this command spawns (``parallel.mesh.spawn``, NCCL,
one card a rank; rank 0 writes every file): ``--spatial_shards N`` serves
each clip's rows over the largest divisor of its LR height up to N
(``parallel.spatial``), several same-shape clips are served one a rank
(``parallel.dp``), and ``--data_axis N`` (0: every card) trains
data-parallel when the batch divides.  Above the visible cards the flags
clamp with the JAX package's warning.  On the CPU, ``ranks=N`` gives the
two functions N gloo ranks, one thread each; there is no default.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import TecoConfig, parse_config


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a tensor on any device, or an array)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _visible(dev: torch.device, ranks) -> int:
    """The devices the multi-rank routes may spread over: the visible cards
    on CUDA, ``ranks`` CPU ranks (1 unless given) on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return int(ranks) if ranks else 1


def _clamp(flag: str, n: int, n_vis: int) -> int:
    """``n`` for ``flag``, clamped to the visible devices with the JAX
    package's warning."""
    if n > n_vis:
        warnings.warn(f"{flag} {n} exceeds the {n_vis} visible device(s); "
                      f"clamping to {n_vis}.", stacklevel=3)
        return n_vis
    return n


def _launch(fn, world: int, dev: torch.device, args: tuple) -> None:
    """``fn(rank_device, *args)`` on ``world`` new ranks: one card a rank
    (NCCL) on CUDA, gloo ranks on the CPU.  A rank's exit 75 (the RSS
    watchdog) is this process's."""
    from ..parallel.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        try:
            spawn(fn, world, device="cuda" if dev.type == "cuda" else "cpu",
                  init_file=os.path.join(tmp, "rdzv"), args=args)
        except mp.ProcessExitedException as e:
            if e.exit_code == 75:
                raise SystemExit(75) from e
            raise


def _model(cfg: TecoConfig, params, dev: torch.device):
    """The serving generator on ``dev`` holding ``params`` (the flax tree
    or a float32 ``state_dict``)."""
    from ..engine.state import float_params, model_defs

    model = model_defs(cfg, device=dev)
    model.load_state_dict(float_params(params))
    return model.eval()


def _load_clips(cfg: TecoConfig) -> list:
    """The clips to serve: (T, H, W, 3) float [0, 1] numpy arrays."""
    from ..data.scenes import InferenceDataset, load_video_frames

    if cfg.inferencetype == "dataset":
        ds = InferenceDataset(cfg)
        return [ds.get_clip(i) for i in range(len(ds))]
    if cfg.inferencetype == "video":
        return [load_video_frames(cfg.input_dir_LR, cfg.crop_size)]
    raise ValueError("Invalid data type entered. Please use either video or dataset.")


def _write_clip(cfg: TecoConfig, idx: int, clip, sr_np, dt: float, n_batched: int = 1,
                dev=None) -> None:
    """``--consistency_refine`` (when set; not on data-parallel groups, as
    in the JAX package), then the clip's media file and its line."""
    from ..ops import image

    if cfg.consistency_refine > 0 and n_batched == 1:
        from ..engine.adapt import lr_consistency_refine

        sr_np = _host(lr_consistency_refine(sr_np, clip, iters=cfg.consistency_refine,
                                            device=dev))
    out = os.path.join(cfg.output_dir, f"{cfg.output_name}{idx}{cfg.videotype}")
    image.save_as_media(sr_np, out)
    print(f"clip {idx}: {clip.shape[0]} frames {clip.shape[1]}x{clip.shape[2]} -> 4x "
          f"in {dt:.2f}s ({n_batched * clip.shape[0] / dt:.1f} fps"
          f"{' aggregate' if n_batched > 1 else ''}) -> {out}")


def _adapt(cfg: TecoConfig, idx: int, params_g, clip, dev: torch.device):
    """``--adapt_steps``: the generator adapted to ``clip`` (with the
    guard), as a float32 ``state_dict`` or the flax tree."""
    from ..engine.adapt import adapt_generator

    t0 = time.time()
    adapted, report = adapt_generator(
        cfg, params_g, clip[: max(cfg.adapt_frames, cfg.RNN_N)],
        steps=cfg.adapt_steps, learning_rate=cfg.adapt_lr,
        consistency=cfg.adapt_consistency, guard=True, device=dev)
    served = "adapted" if report["adapted_served"] else "BASE (guard)"
    print(f"clip {idx}: {cfg.adapt_steps} adapt steps in {time.time() - t0:.1f}s; "
          f"serving {served} — holdout {report['base_psnr_db']:.2f} -> "
          f"{report['chosen_psnr_db']:.2f} dB")
    return adapted


def run_inference(cfg: TecoConfig, device=None, ranks=None) -> None:
    """Reference main.py:141-220: dataset or video input, recurrent SR, a
    media file per clip, on ``device`` (default: the card, see
    ``engine.state.resolve_device``); ``ranks``: the CPU ranks of the
    multi-rank routes when ``device`` is the CPU (see the module's
    docstring).

    Clips whose SR output exceeds 2 GiB (or every clip, with
    ``--infer_chunk N > 0``) stream through ``build_chunked_inference``
    into a ``MediaWriter``, converted to uint8 on the device; the others
    run one-shot and are written with ``save_as_media``.  ``--quantize
    int8`` serves the quantized tail, calibrated on the first 8 frames of
    the first clip or of every clip (``--quantize_calib``), and again for
    any clip served with other params than its qtail's (each adapted
    clip).  ``--adapt_steps`` adapts the generator to each clip (with the
    guard) and ``--consistency_refine`` back-projects one-shot clips.

    ``--spatial_shards N`` over several devices serves each clip's rows
    over the ranks (a clip whose height has no divisor above 1 up to N is
    served by rank 0 alone), through the fused route where
    ``use_pallas`` and not ``bug_parity`` (and its int8 tail under
    ``--quantize int8``), else the exact route.  Otherwise, with several
    devices (``--data_axis``, 0 for all) and at least as many clips of one
    shape, groups of one clip a rank are served data-parallel, and the
    clips left over by rank 0 alone."""
    from ..engine.state import resolve_device

    if cfg.g_checkpoint is None:
        raise ValueError("The checkpoint file is needed to perform the test")
    dev = resolve_device(device)
    n_vis = _visible(dev, ranks)
    clips = _load_clips(cfg)
    os.makedirs(cfg.output_dir, exist_ok=True)
    if cfg.spatial_shards > 1:
        n_req = _clamp("--spatial_shards", cfg.spatial_shards, n_vis)
        if n_req > 1:
            _launch(_inference_rank, n_req, dev, (cfg, clips, "spatial"))
            return
    else:
        n_data = _clamp("--data_axis", cfg.data_axis if cfg.data_axis > 0 else n_vis, n_vis)
        if n_data > 1 and len(clips) >= n_data and len({c.shape for c in clips}) == 1:
            _launch(_inference_rank, n_data, dev, (cfg, clips, "dp"))
            return
    _serve(cfg, dev, clips, range(len(clips)))


def _serve(cfg: TecoConfig, dev: torch.device, clips: list, indices) -> None:
    """The single-device loop over ``clips[i]`` for ``i`` in ``indices``."""
    from ..engine.inference import (build_chunked_inference, build_clip_inference,
                                    build_quantized_clip_inference)
    from ..ops import image
    from ..utils.checkpoint import load_generator_params

    params_g = load_generator_params(cfg.g_checkpoint)
    model = _model(cfg, params_g, dev)
    infer = build_clip_inference(cfg)
    prepare_q = qinfer = None
    if cfg.quantize == "int8":
        prepare_q, qinfer = build_quantized_clip_inference(cfg)

    def for_clip(idx, clip):
        """(params, model) serving clip ``idx``: the base, or adapted."""
        if cfg.adapt_steps <= 0:
            return params_g, model
        adapted = _adapt(cfg, idx, params_g, clip, dev)
        return adapted, _model(cfg, adapted, dev)

    # the qtail and the params it was calibrated from
    calib = {"params": None, "qtail": None}

    def qtail_for(idx, p_clip, m_clip, clip):
        if (calib["qtail"] is None or cfg.quantize_calib == "per_clip"
                or calib["params"] is not p_clip):
            calib["qtail"] = prepare_q(m_clip, p_clip, clip[None], frames=8)
            calib["params"] = p_clip
            print(f"int8: activation scales calibrated on clip {idx} (first 8 frames)")
        return calib["qtail"]

    def chunk_for(clip):
        """--infer_chunk: 0 auto (clips whose f32 SR output exceeds 2 GiB),
        -1 never, > 0 that window."""
        if cfg.infer_chunk < 0:
            return 0
        if cfg.infer_chunk > 0:
            return cfg.infer_chunk
        T, H, W = clip.shape[:3]
        return 64 if T * (4 * H) * (4 * W) * 3 * 4 > (2 << 30) else 0

    chunked = None
    for idx in indices:
        clip = clips[idx]
        chunk = chunk_for(clip)
        p_clip, m_clip = for_clip(idx, clip)
        t0 = time.time()
        if chunk:
            if chunked is None:
                chunked = build_chunked_inference(cfg, out_u8=True)
            qtail = qtail_for(idx, p_clip, m_clip, clip) if qinfer is not None else None
            if cfg.consistency_refine > 0:
                warnings.warn(
                    "--consistency_refine is not applied on the chunked streaming path "
                    "(windows are written incrementally); use --adapt_steps for long "
                    "clips.", stacklevel=2)
            clip_up = clip[None]
            if cfg.transfer_dtype == "u8":
                clip_up = image.transfer_quantize_u8(clip_up)
            out = os.path.join(cfg.output_dir, f"{cfg.output_name}{idx}{cfg.videotype}")
            with image.MediaWriter(out) as w:
                chunked(m_clip, clip_up, chunk=chunk, sink=lambda sr: w.append(sr[0]),
                        qtail=qtail)
            dt = time.time() - t0
            print(f"clip {idx}: {clip.shape[0]} frames {clip.shape[1]}x{clip.shape[2]} -> 4x "
                  f"STREAMED{' int8' if qinfer is not None else ''} (window {chunk}) in "
                  f"{dt:.2f}s ({clip.shape[0] / dt:.1f} fps) -> {out}")
            continue
        lr = torch.from_numpy(np.ascontiguousarray(clip))[None].to(dev)
        if qinfer is not None:
            sr = qinfer(m_clip, qtail_for(idx, p_clip, m_clip, clip), lr)
        else:
            sr = infer(m_clip, lr)
        _sync(dev)
        dt = time.time() - t0
        sr_np = _host(sr[0])
        del sr, lr
        _write_clip(cfg, idx, clip, sr_np, dt, dev=dev)


def _inference_rank(dev: torch.device, cfg: TecoConfig, clips: list, route: str) -> None:
    """One rank of :func:`run_inference`'s multi-rank routes."""
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(device=dev)
    if route == "spatial":
        _serve_spatial(cfg, mesh, clips)
        return
    done = _serve_dp(cfg, mesh, clips)
    if mesh.rank == 0 and done < len(clips):
        _serve(cfg, dev, clips, range(done, len(clips)))


def _serve_spatial(cfg: TecoConfig, world, clips: list) -> None:
    """Each clip's rows over the largest divisor of its LR height up to
    the world's size (tecogan_tpu/cli/main.py:104-174); rank 0 writes."""
    from ..engine.inference import build_quantized_clip_inference
    from ..engine.state import float_params
    from ..parallel.dp import calibrate_on_rank0
    from ..parallel.mesh import broadcast_object, make_mesh
    from ..parallel.spatial import (build_spatial_clip_inference,
                                    build_spatial_fused_clip_inference)
    from ..utils.checkpoint import load_generator_params

    dev, main = world.device, world.rank == 0
    use_fused = cfg.use_pallas and not cfg.bug_parity
    quantized = cfg.quantize == "int8" and use_fused
    if cfg.quantize == "int8" and not use_fused and main:
        warnings.warn("--quantize int8 requires the fused path (use_pallas, not bug_parity) "
                      "under --spatial_shards; serving bf16.", stacklevel=2)
    params_g = load_generator_params(cfg.g_checkpoint)
    model = _model(cfg, params_g, dev)
    prepare = build_quantized_clip_inference(cfg)[0] if quantized else None
    meshes, infers = {}, {}
    calib = {"params": None, "qtail": None}
    for idx, clip in enumerate(clips):
        H = clip.shape[1]
        n_sp = max(n for n in range(1, world.size + 1) if H % n == 0)
        if n_sp == 1:
            if main:
                warnings.warn(f"clip {idx}: height {H} has no divisor <= {world.size}; "
                              "serving single-device.", stacklevel=2)
                _serve(cfg, dev, clips, [idx])
            continue
        if n_sp not in meshes:  # every rank builds the same groups in turn
            meshes[n_sp] = mesh = make_mesh(n_sp, device=dev)
            infers[n_sp] = (build_spatial_fused_clip_inference(cfg, mesh, quantize=quantized)
                            if use_fused else build_spatial_clip_inference(cfg, mesh))
        mesh = meshes[n_sp]
        if not mesh.member:
            continue
        p_clip, m_clip = params_g, model
        if cfg.adapt_steps > 0:  # rank 0 adapts; every rank serves its params
            adapted = float_params(_adapt(cfg, idx, params_g, clip, dev)) if mesh.rank == 0 \
                else None
            p_clip = broadcast_object(mesh, adapted)
            m_clip = _model(cfg, p_clip, dev)
        lr = torch.from_numpy(np.ascontiguousarray(clip))[None].to(dev)
        t0 = time.time()
        if quantized:
            if (calib["qtail"] is None or cfg.quantize_calib == "per_clip"
                    or calib["params"] is not p_clip):
                calib["qtail"] = calibrate_on_rank0(mesh, prepare, m_clip, p_clip,
                                                    torch.from_numpy(clip[None]), 8)
                calib["params"] = p_clip
                if main:
                    print(f"int8: activation scales calibrated on clip {idx} (first 8 frames)")
            sr = infers[n_sp](m_clip, calib["qtail"], lr)
        else:
            sr = infers[n_sp](m_clip, lr)
        _sync(dev)
        dt = time.time() - t0
        if main:
            print(f"spatial: {n_sp}-way row sharding{' + int8 tail' if quantized else ''}")
            _write_clip(cfg, idx, clip, _host(sr[0]), dt, dev=dev)


def _serve_dp(cfg: TecoConfig, mesh, clips: list) -> int:
    """Groups of one clip a rank (tecogan_tpu/cli/main.py:176-215); rank 0
    writes.  Returns how many clips were served."""
    from ..parallel import build_dp_inference, build_dp_quantized_inference, shard_batch
    from ..utils.checkpoint import load_generator_params

    dev, main, n = mesh.device, mesh.rank == 0, mesh.size
    params_g = load_generator_params(cfg.g_checkpoint)
    model = _model(cfg, params_g, dev)
    if main:
        print(f"data-parallel inference over {n} devices")
        if cfg.adapt_steps > 0:
            warnings.warn("--adapt_steps is per-clip and is not applied to DP-batched clips "
                          "(use --data_axis 1 to adapt each clip).", stacklevel=2)
    dp_infer = build_dp_inference(cfg, mesh)
    prepare = dp_qinfer = qtail = None
    if cfg.quantize == "int8":
        prepare, dp_qinfer = build_dp_quantized_inference(cfg, mesh)
        if main:
            print("data-parallel int8 serving (qtail replicated)")
    done = 0
    while done + n <= len(clips):
        batch = np.stack(clips[done:done + n])
        t0 = time.time()
        if dp_qinfer is not None:
            if qtail is None or cfg.quantize_calib == "per_clip":
                # per_clip here is per batch: the scales cover every clip of it
                calib = batch[:, :8] if cfg.quantize_calib == "per_clip" else clips[0][None, :8]
                qtail = prepare(model, params_g, torch.from_numpy(calib), frames=8)
                if main:
                    print(f"int8: activation scales calibrated ({cfg.quantize_calib})")
            sr = dp_qinfer(model, qtail, shard_batch(mesh, batch))
        else:
            sr = dp_infer(model, shard_batch(mesh, batch))
        _sync(dev)
        dt = time.time() - t0
        if main:
            for j in range(n):
                _write_clip(cfg, done + j, clips[done + j], _host(sr[j]), dt, n_batched=n,
                            dev=dev)
        done += n
    return done


def _host_rss_gb() -> float:
    """This process's resident set size in GB (Linux /proc)."""
    try:
        with open("/proc/self/status") as f:
            return int(f.read().split("VmRSS:")[1].split()[0]) / (1 << 20)
    except (OSError, IndexError, ValueError):
        return 0.0


_STOP_REQUESTED: list = []


def request_graceful_stop(signum=None, frame=None) -> None:
    """SIGTERM handler: ask the train loop to checkpoint and exit at the
    next step boundary."""
    _STOP_REQUESTED.append(signum or True)


def _vgg_apply(cfg: TecoConfig, dev: torch.device):
    """The VGG loss's feature function, or None when ``--vgg_scaling`` is
    off.  A ``.ckpt`` path loads converted VGG-19 weights; ``surrogate``
    gives the JAX package's fixed-seed weights (``models.vgg.
    fixed_seed_vgg_params``, bit for bit)."""
    if cfg.vgg_scaling <= 0.0:
        return None
    from ..models.vgg import load_vgg_params, make_vgg_apply, vgg_model

    if not cfg.vgg_ckpt:
        raise ValueError("--vgg_scaling > 0 requires --vgg_ckpt (a converted VGG-19 "
                         "checkpoint, or the literal 'surrogate' for fixed-seed "
                         "random-feature weights)")
    params = load_vgg_params(cfg.vgg_ckpt)
    if cfg.vgg_ckpt == "surrogate":
        print("VGG loss: fixed-seed SURROGATE weights (no pretrained VGG-19 available "
              "offline)")
    return make_vgg_apply(vgg_model(params, device=dev))


def run_train(cfg: TecoConfig, device=None, ranks=None) -> None:
    """Reference main.py:223-320: the epoch loop with per-epoch artifacts,
    the StepLR decay and checkpoints, on ``device`` (default: the card).
    ``--steps_per_dispatch K`` groups K host batches into one call of
    ``build_multi_train_step``; loss values stay on the device until the
    epoch ends.

    With several devices (``--data_axis N``, 0 for all; ``ranks`` CPU
    ranks on the CPU) whose count divides ``--batch_size`` the step is
    data-parallel (``parallel.dp``): every rank reads the same batches and
    steps on its share; rank 0 writes the checkpoints, summaries and
    artifacts (of the global batch).  A batch the devices do not divide
    trains on one, with the JAX package's warning."""
    from ..engine.state import resolve_device

    dev = resolve_device(device)
    n_vis = _visible(dev, ranks)
    n_data = _clamp("--data_axis", cfg.data_axis if cfg.data_axis > 0 else n_vis, n_vis)
    if n_data > 1 and cfg.batch_size % n_data == 0:
        _launch(_train_rank, n_data, dev, (cfg,))
        return
    if n_data > 1:
        warnings.warn(
            f"batch_size={cfg.batch_size} is not divisible by {n_data} devices — falling "
            f"back to SINGLE-device training ({n_data - 1} devices idle). Pick a batch size "
            "divisible by the device count to enable data parallelism.", stacklevel=2)
    _train(cfg, dev)


def _train_rank(dev: torch.device, cfg: TecoConfig) -> None:
    """One rank of :func:`run_train`'s data-parallel route."""
    from ..parallel.mesh import make_mesh

    _train(cfg, dev, make_mesh(device=dev))


def _agree(mesh, flag: bool) -> bool:
    """``flag`` raised on any rank, on every rank (one all-reduce); the
    flag itself without a mesh."""
    if mesh is None or mesh.group is None:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def _train(cfg: TecoConfig, dev: torch.device, mesh=None) -> None:
    """:func:`run_train`'s loop on ``dev``; with a ``mesh``, this rank's
    part of the data-parallel run."""
    from ..data.prefetch import make_input_pipeline
    from ..data.scenes import TrainDataset
    from ..engine.state import init_state
    from ..engine.train import build_multi_train_step, build_train_step, set_epoch
    from ..ops.image import transfer_quantize_u8
    from ..parallel import (build_dp_multi_train_step, build_dp_train_step,
                            replicate_state)
    from ..parallel.collectives import all_gather_cat
    from ..utils.checkpoint import (has_checkpoint, load_train_state, save_train_state,
                                    wait_for_async_save)
    from ..utils.summaries import SummaryWriter, format_metrics, save_epoch_artifacts

    main = mesh is None or mesh.rank == 0
    say = print if main else (lambda *a, **kw: None)
    dataset = TrainDataset(cfg)
    if len(dataset) == 0:
        raise ValueError("no eligible scenes found under input_video_dir")
    say(f"dataset: {len(dataset.scenes)} scenes, {len(dataset)} samples/epoch"
        + (" (bug_parity sampling: scene-count __len__, dataloader.py:78-79)"
           if cfg.bug_parity else ""))
    vgg_apply = _vgg_apply(cfg, dev)
    state = init_state(cfg, torch.Generator().manual_seed(cfg.rand_seed), device=dev)
    if mesh is not None:
        state = replicate_state(mesh, state)

    k_dispatch = max(1, cfg.steps_per_dispatch)
    if 0 < cfg.steps_per_epoch < k_dispatch:
        warnings.warn(
            f"--steps_per_dispatch {k_dispatch} exceeds --steps_per_epoch "
            f"{cfg.steps_per_epoch}; clamping to the epoch cap so the first dispatch "
            "cannot overrun it.", stacklevel=2)
        k_dispatch = cfg.steps_per_epoch
        cfg = cfg.replace(steps_per_dispatch=k_dispatch)
    if mesh is not None:
        build = build_dp_multi_train_step if k_dispatch > 1 else build_dp_train_step
        step_fn = build(cfg, mesh, vgg_apply=vgg_apply)
        say(f"data-parallel over {mesh.size} devices")
    elif k_dispatch > 1:
        step_fn = build_multi_train_step(cfg, vgg_apply=vgg_apply, device=dev)
    else:
        step_fn = build_train_step(cfg, vgg_apply=vgg_apply, device=dev)
    if k_dispatch > 1:
        say(f"{k_dispatch} steps per dispatch")

    current_epoch = 0
    if cfg.pre_trained_model:
        state, current_epoch = load_train_state(cfg.output_dir, state, cfg.g_checkpoint,
                                                cfg.d_checkpoint)
        say(f"resumed from epoch {current_epoch}")
    elif cfg.auto_resume and has_checkpoint(cfg.output_dir):
        state, current_epoch = load_train_state(cfg.output_dir, state)
        say(f"auto-resumed from epoch {current_epoch}")

    # validation split: scenes end_dir+1 .. end_dir_val
    val_dataset = val_infer = None
    if cfg.validate_every > 0 and main:
        try:
            val_dataset = TrainDataset(cfg.replace(str_dir=cfg.end_dir + 1,
                                                   end_dir=cfg.end_dir_val))
        except ValueError:
            val_dataset = None
        if val_dataset is not None and len(val_dataset) == 0:
            val_dataset = None
        if val_dataset is not None:
            from ..engine.inference import build_clip_inference

            val_infer = build_clip_inference(cfg)
            print(f"validation: {len(val_dataset.scenes)} scenes")

    def run_validation(params_g) -> float:
        """Mean PSNR over the validation scenes' first windows; PSNR on the
        host, from the SR clip fetched there."""
        model = _model(cfg, params_g, dev)
        scores = []
        for s in range(len(val_dataset.scenes)):
            lr_clip, hr_clip = val_dataset.get_clip(s * 110)
            lr_nhwc = np.transpose(lr_clip, (0, 2, 3, 1))[None]
            if cfg.transfer_dtype == "u8":
                lr_nhwc = transfer_quantize_u8(lr_nhwc)
            sr = _host(val_infer(model, torch.from_numpy(np.ascontiguousarray(lr_nhwc))
                                 .to(dev))[0])
            mse = float(np.mean((np.transpose(hr_clip, (0, 2, 3, 1)) - sr) ** 2))
            scores.append(10.0 * float(np.log10(1.0 / max(mse, 1e-12))))
        return float(np.mean(scores))

    try:
        prev_term = signal.signal(signal.SIGTERM, request_graceful_stop)
    except ValueError:  # not the main thread (embedded use): no handler
        prev_term = None

    writer = SummaryWriter(cfg.summary_dir) if main else None
    since = time.time()
    log_keys = ["gen_loss", "d_loss", "l2_content_loss", "t_adversarial_loss",
                "t_discrim_real_output", "t_discrim_fake_output", "learning_rate"]
    try:
        for epoch in range(current_epoch, cfg.max_epochs):
            state = set_epoch(state, epoch)
            raw = dataset.batches(cfg.batch_size, shuffle=True, seed=cfg.rand_seed + epoch,
                                  workers=cfg.queue_thread)
            if cfg.transfer_dtype == "u8":  # upload uint8, dequantize on the device
                raw = ((transfer_quantize_u8(a), transfer_quantize_u8(b)) for a, b in raw)
            if k_dispatch > 1:
                raw = _grouped(raw, k_dispatch)
            if mesh is not None:  # this rank's share of every batch (dim 1 of K groups)
                lead = (slice(None),) * (k_dispatch > 1)
                raw = ((a[lead + (mesh.shard_slice(a.shape[len(lead)]),)],
                        b[lead + (mesh.shard_slice(b.shape[len(lead)]),)]) for a, b in raw)
            batches = make_input_pipeline(raw, queue_threads=cfg.queue_thread,
                                          prefetch=cfg.prefetch, device=dev)
            n_batches = 0
            lr_b = hr_b = gen_out = metrics = None
            g_vals, d_vals = [], []
            prof = None
            t_epoch = time.perf_counter()
            for batch_idx, (lr_b, hr_b) in enumerate(batches):
                # profiling window: dispatches 10-15 of the first epoch run
                if main and cfg.profile_dir and epoch == current_epoch and batch_idx == 10:
                    prof = _start_trace(dev)
                state, metrics, gen_out = step_fn(state, torch.as_tensor(lr_b),
                                                  torch.as_tensor(hr_b))
                if prof is not None and batch_idx >= 15:
                    prof = _stop_trace(prof, dev, cfg.profile_dir)
                # loss values stay on the device: a float() a step would make
                # the host wait for the card every step
                g_vals.append(metrics["gen_loss"])
                d_vals.append(metrics["d_loss"])
                n_batches += k_dispatch
                if main and cfg.log_every and batch_idx % cfg.log_every == 0:
                    log_m = metrics if k_dispatch == 1 else {k: v[-1] for k, v in
                                                             metrics.items()}
                    writer.write(int(state.step), log_m, epoch=epoch)
                # a SIGTERM on any rank stops every rank after this step (with
                # a mesh, one all-reduce a step, which waits for the step)
                if _agree(mesh, bool(_STOP_REQUESTED)):
                    _STOP_REQUESTED.append(True)
                    break
                if cfg.steps_per_epoch > 0 and n_batches + k_dispatch > cfg.steps_per_epoch:
                    break  # stop while at or under the cap
            if prof is not None:  # the loop ended inside the profiling window
                _stop_trace(prof, dev, cfg.profile_dir)
            if _STOP_REQUESTED:
                if main:
                    save_train_state(cfg.output_dir, state, epoch, async_save=False)
                say(f"SIGTERM: checkpointed epoch {epoch} after {n_batches} steps, "
                    "exiting cleanly")
                break
            if n_batches == 0:
                hint = (f"steps_per_dispatch={k_dispatch} exceeds the "
                        f"{len(dataset) // max(cfg.batch_size, 1)} batches this dataset "
                        "yields per epoch" if k_dispatch > 1
                        else "batch_size larger than dataset?")
                raise ValueError(f"empty epoch: {hint}")
            g_loss = float(np.mean(_host(torch.cat([v.reshape(-1) for v in g_vals]))))
            d_loss = float(np.mean(_host(torch.cat([v.reshape(-1) for v in d_vals]))))
            secs = time.perf_counter() - t_epoch
            if k_dispatch > 1:  # the last step's row; the held batch's last step
                metrics = {k: v[-1] for k, v in metrics.items()}
                lr_b, hr_b = lr_b[-1], hr_b[-1]
            if mesh is not None:  # the artifacts show the global batch
                gen_out, lr_b, hr_b = (all_gather_cat(torch.as_tensor(x).to(dev), mesh, 0)
                                       for x in (gen_out, lr_b, hr_b))
            if not main:  # rank 0 writes and reports; the watchdog's decision is shared
                if cfg.rss_limit_gb > 0 and _agree(mesh, _host_rss_gb() > cfg.rss_limit_gb):
                    dist.barrier(group=mesh.group)  # rank 0 has checkpointed
                    raise SystemExit(75)
                continue

            os.makedirs(cfg.output_dir, exist_ok=True)
            hr_np, lr_np = _host(hr_b), _host(lr_b)
            rng = np.random.default_rng(cfg.rand_seed + epoch)
            save_epoch_artifacts(cfg.output_dir, _host(gen_out), hr_np, lr_np, cfg.RNN_N,
                                 sample_index=int(rng.integers(0, len(hr_np))))

            print(f"Epoch: {epoch + 1}")
            print(f"Generator loss is: {g_loss}\nDiscriminator loss is: {d_loss}")
            lr_now = float(metrics["learning_rate"])
            print(f"Generator lr is: {lr_now}, Discriminator lr is: {lr_now}")
            print(format_metrics({k: metrics[k] for k in log_keys if k in metrics}))
            print(f"Epoch steps: {n_batches} in {secs:.3f} s, {secs / n_batches * 1e3:.3f} "
                  f"ms a step, {n_batches * cfg.batch_size / secs:.3f} samples/s (input "
                  "pipeline and first-step warm-up included)")

            if val_dataset is not None and (epoch + 1) % cfg.validate_every == 0:
                val_psnr = run_validation(state.params_g)
                writer.write(int(state.step), {"val_psnr_db": val_psnr}, epoch=epoch)
                print(f"Validation PSNR: {val_psnr:.3f} dB")

            if (epoch + 1) % cfg.checkpoint_every == 0:
                save_train_state(cfg.output_dir, state, epoch,
                                 async_save=cfg.async_checkpoint)
                print("Saving model...")

            elapsed = time.time() - since
            print(f"Training time {elapsed // 60:.0f}m {elapsed % 60:.0f}s", flush=True)

            # RSS watchdog: checkpoint this COMPLETE epoch as epoch + 1, so a
            # supervisor restart with --auto_resume continues at the next one,
            # and exit 75 (EX_TEMPFAIL)
            if cfg.rss_limit_gb > 0 and _agree(mesh, _host_rss_gb() > cfg.rss_limit_gb):
                save_train_state(cfg.output_dir, state, epoch + 1, async_save=False)
                print(f"RSS {_host_rss_gb():.1f} GB > limit {cfg.rss_limit_gb:g} GB: "
                      f"checkpointed through epoch {epoch}, exiting 75 for supervisor "
                      "restart", flush=True)
                if mesh is not None:
                    dist.barrier(group=mesh.group)
                raise SystemExit(75)
        wait_for_async_save()
    finally:
        if writer is not None:
            writer.close()
        # a leaked flag would stop the next run_train of this process after
        # one step
        _STOP_REQUESTED.clear()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


def _grouped(it, k: int):
    """K host batches stacked into one dispatch's (K, B, ...) pair, before
    the device copy; a trailing partial group is dropped."""
    buf = []
    for item in it:
        buf.append(item)
        if len(buf) == k:
            yield np.stack([b[0] for b in buf]), np.stack([b[1] for b in buf])
            buf = []


def _start_trace(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_trace(prof, dev: torch.device, profile_dir: str) -> None:
    """Ends the window and writes ``<profile_dir>/train_trace.json`` (a
    chrome trace); returns None."""
    _sync(dev)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "train_trace.json"))
    return None


def main(argv=None) -> None:
    cfg = parse_config(argv)
    if cfg.output_dir is None:
        raise ValueError("The output directory is needed")
    os.makedirs(cfg.output_dir, exist_ok=True)
    os.makedirs(cfg.summary_dir, exist_ok=True)
    if cfg.mode == "inference":
        run_inference(cfg)
    elif cfg.mode == "train":
        run_train(cfg)
    else:
        raise ValueError(f"unknown --mode {cfg.mode!r} (train or inference)")


if __name__ == "__main__":
    main()
