"""Port parity, the command line: tecogan_tpu_torch/cli/main.py's
run_inference and run_train, cli/evaluate.py and cli/live.py against the
JAX package's CLI or the port's engine routes (CPU, the JAX suite's tiny
config: crop 8, RNN_N 9, 2 resblocks, D 1 x 16, fp32).

Bars: the exact route's frames within ``EXACT_TOL`` and the fused
route's above ``FUSED_PSNR_DB`` of the JAX CLI's (the bars
tests/test_torch_port_inference.py holds those routes to, on its weight
gain and clip range); the chunked u8, int8, video-mode and live routes
bit-equal to the port's engine routes; a resumed epoch's checkpoint pair
bit-equal to a hand loop of ``build_train_step`` over the dataset's
batches; ``score_pair`` within ``SCORE_TOL`` of JAX's.  The multi-rank
routes on 2 gloo CPU ranks write the single-process run's frames (bit for
bit but the exact route, one uint8 level) and .ckpt leaves (1e-5 but for
at most 1e-3 of a leaf, held to two Adam steps' range).
"""

import contextlib
import importlib
import io
import os
import signal
import subprocess
import sys
import textwrap
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tecogan_tpu.engine as j_engine
import tecogan_tpu.ops as j_ops
from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import TrainState as JaxTrainState
from tecogan_tpu.engine.state import make_optimizers as j_make_optimizers
from tecogan_tpu.utils.checkpoint import save_train_state as j_save_train_state
from tecogan_tpu_torch.cli import evaluate, live
from tecogan_tpu_torch.cli import main as cli
from tecogan_tpu_torch.config import TecoConfig, parse_config
from tecogan_tpu_torch.data.scenes import TrainDataset, load_video_frames
from tecogan_tpu_torch.data.synthetic import moving_rect_scene, write_synthetic_scene_folders
from tecogan_tpu_torch.engine import inference as engine_inference
from tecogan_tpu_torch.engine.adapt import adapt_generator
from tecogan_tpu_torch.engine.inference import (build_clip_inference,
                                                build_quantized_clip_inference)
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator, init_state,
                                            model_defs)
from tecogan_tpu_torch.engine.train import build_train_step, set_epoch
from tecogan_tpu_torch.ops import image
from tecogan_tpu_torch.utils import checkpoint
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

j_cli = importlib.import_module("tecogan_tpu.cli.main")
j_evaluate = importlib.import_module("tecogan_tpu.cli.evaluate")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--crop_size", "8", "--RNN_N", "9", "--num_resblock", "2", "--discrim_resblocks", "1",
        "--discrim_channels", "16", "--precision", "fp32", "--batch_size", "2"]
EXACT_TOL = 1e-4
FUSED_PSNR_DB = 50.0
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(tree):
    return {k: _scaled(v) if isinstance(v, dict) else
            (v * np.float32(KERNEL_GAIN) if k == "kernel" else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Scenes for training (3 of 120 frames, 48 x 48), two inference clips of
    6 LR frames of 8 x 8 in [0, CLIP_RANGE], and a JAX-written checkpoint
    pair (epoch 0) of the tiny config with G's kernels x KERNEL_GAIN."""
    root = tmp_path_factory.mktemp("cli")
    scenes = str(root / "scenes")
    write_synthetic_scene_folders(scenes, num_scenes=3, frames_per_scene=120, size=48,
                                  variety=True)
    lr_root = root / "lr"
    rng = np.random.default_rng(0)
    for c in ("clip_a", "clip_b"):
        os.makedirs(lr_root / c)
        for t in range(6):
            image.save_img(str(lr_root / c / f"{t:04d}.png"),
                           rng.random((8, 8, 3), np.float32) * np.float32(CLIP_RANGE))
    cfg = parse_config(TINY)
    g = torch.Generator().manual_seed(0)
    params_g = _scaled(init_generator(cfg, g))
    params_d, stats = init_discriminator(cfg, g)
    opt_g, opt_d, _ = j_make_optimizers(JaxTecoConfig(**vars(cfg)))
    jstate = JaxTrainState(params_g=params_g, params_d=params_d, batch_stats_d=stats,
                           opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
                           step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    ck = str(root / "jax_ckpt")
    j_save_train_state(ck, jstate, 0)
    return types.SimpleNamespace(root=root, scenes=scenes, lr=str(lr_root), ckpt=ck,
                                 g_ckpt=os.path.join(ck, "generator.ckpt"), params_g=params_g)


def _infer_argv(ws, tmp_path, *extra):
    return TINY + ["--mode", "inference", "--input_dir_LR", ws.lr, "--g_checkpoint",
                   ws.g_ckpt, "--output_dir", str(tmp_path / "out")] + list(extra)


def _capture(monkeypatch, module, keep_writing=False):
    """Record the (clip, path) pairs ``module.save_as_media`` is handed."""
    got, real = [], module.save_as_media

    def save(frames, path, *a, **kw):
        got.append((np.array(frames), path))
        if keep_writing:
            real(frames, path, *a, **kw)

    monkeypatch.setattr(module, "save_as_media", save)
    return got


def _model(cfg, params):
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_inference_matches_the_jax_cli(ws, tmp_path, monkeypatch, route):
    """Dataset mode, both clips, through each package's run_inference.  The
    JAX CLI's TrainState init is replaced by the generator params template
    it reads (that init compiles for tens of seconds on the CPU)."""
    extra = [] if route == "exact" else ["--bug_parity", "False"]
    cfg = parse_config(_infer_argv(ws, tmp_path, *extra))
    monkeypatch.setattr(j_engine, "init_state",
                        lambda c, key: types.SimpleNamespace(params_g=ws.params_g))
    want = _capture(monkeypatch, j_ops)
    j_cli.run_inference(JaxTecoConfig(**vars(cfg)))
    got = _capture(monkeypatch, image)
    cli.run_inference(cfg, device="cpu")
    assert [p for _, p in got] == [p for _, p in want] == [
        str(tmp_path / "out" / f"output{i}.mp4") for i in (0, 1)]
    for (a, _), (b, _) in zip(got, want):
        assert a.shape == b.shape == (6, 32, 32, 3) and a.dtype == np.float32
        if route == "exact":
            np.testing.assert_allclose(a, b, rtol=0, atol=EXACT_TOL)
        else:
            mse = float(np.mean((a[-1].astype(np.float64) - b[-1]) ** 2))
            assert 10 * np.log10(1 / mse) > FUSED_PSNR_DB


def test_chunked_u8_route_is_the_one_shot_u8_clip(ws, tmp_path, monkeypatch):
    """--infer_chunk 4 --transfer_dtype u8 on the fused route: the windows
    handed to the MediaWriter are the one-shot clip of the u8 LR, converted
    to uint8 on the device, bit for bit; the mp4 holds every frame."""
    windows, real = [], image.MediaWriter

    class Recording(real):
        def append(self, frames):
            windows.append((self.filepath, np.array(frames)))
            super().append(frames)

    monkeypatch.setattr(image, "MediaWriter", Recording)
    cfg = parse_config(_infer_argv(ws, tmp_path, "--bug_parity", "False", "--infer_chunk",
                                   "4", "--transfer_dtype", "u8", "--input_dir_len", "1"))
    cli.run_inference(cfg, device="cpu")
    assert [w.shape[0] for _, w in windows] == [4, 2]
    clip = image.transfer_quantize_u8(
        np.stack([cv2.cvtColor(cv2.imread(os.path.join(ws.lr, "clip_a", f"{t:04d}.png")),
                               cv2.COLOR_BGR2RGB) for t in range(6)]) / np.float32(255.0))
    want = image.transfer_to_uint8(build_clip_inference(cfg)(
        _model(cfg, ws.params_g), torch.from_numpy(clip)[None]))[0].numpy()
    got = np.concatenate([w for _, w in windows])
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    cap = cv2.VideoCapture(windows[0][0])
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (32, 32)
    cap.release()


@pytest.mark.parametrize("adapt,calib,n_calib", [(0, "first_clip", 1), (0, "per_clip", 2),
                                                 (1, "first_clip", 2)])
def test_int8_qtail_follows_the_served_params(ws, tmp_path, monkeypatch, adapt, calib,
                                              n_calib):
    """--quantize int8 over two clips: the qtail is calibrated once under
    first_clip, on every clip under per_clip, and on each clip's own
    adapted params under --adapt_steps; every clip is bit-equal to the
    engine's int8 clip after ``prepare`` on the params it was served with."""
    calls = []

    def recording_build(cfg):
        prepare, infer = build_quantized_clip_inference(cfg)

        def rec_prepare(model, params, clip, frames=8):
            calls.append(params)
            return prepare(model, params, clip, frames)

        return rec_prepare, infer

    monkeypatch.setattr(engine_inference, "build_quantized_clip_inference", recording_build)
    got = _capture(monkeypatch, image)
    cfg = parse_config(_infer_argv(ws, tmp_path, "--bug_parity", "False", "--quantize",
                                   "int8", "--quantize_calib", calib, "--adapt_steps",
                                   str(adapt)))
    cli.run_inference(cfg, device="cpu")
    assert len(calls) == n_calib and len(got) == 2
    if adapt:
        assert calls[0] is not calls[1]
    prepare, qinfer = build_quantized_clip_inference(cfg)
    qtail = None
    for i, name in enumerate(("clip_a", "clip_b")):
        clip = np.stack([cv2.cvtColor(cv2.imread(os.path.join(ws.lr, name, f"{t:04d}.png")),
                                      cv2.COLOR_BGR2RGB) for t in range(6)]
                        ).astype(np.float32) / 255.0
        params = ws.params_g
        if adapt:
            params, _ = adapt_generator(cfg, ws.params_g, clip, steps=1,
                                        learning_rate=cfg.adapt_lr,
                                        consistency=cfg.adapt_consistency, guard=True,
                                        device="cpu")
            for k, v in params.items():
                assert torch.equal(v, calls[i][k]), k
        model = cli._model(cfg, params, torch.device("cpu"))
        if qtail is None or adapt or calib == "per_clip":
            qtail = prepare(model, params, clip[None])
        want = qinfer(model, qtail, torch.from_numpy(clip)[None])[0].numpy()
        assert np.array_equal(got[i][0], want), name


def test_consistency_refine_back_projects_one_shot_clips(ws, tmp_path, monkeypatch):
    """--consistency_refine 2: the one-shot clip written is
    lr_consistency_refine of the engine's clip; the chunked path warns."""
    from tecogan_tpu_torch.engine.adapt import lr_consistency_refine

    got = _capture(monkeypatch, image)
    cfg = parse_config(_infer_argv(ws, tmp_path, "--consistency_refine", "2",
                                   "--input_dir_len", "1"))
    cli.run_inference(cfg, device="cpu")
    clip = np.stack([cv2.cvtColor(cv2.imread(os.path.join(ws.lr, "clip_a", f"{t:04d}.png")),
                                  cv2.COLOR_BGR2RGB) for t in range(6)]).astype(np.float32) / 255.0
    sr = build_clip_inference(cfg)(_model(cfg, ws.params_g), torch.from_numpy(clip)[None])[0]
    want = lr_consistency_refine(sr, clip, iters=2, device="cpu").numpy()
    assert len(got) == 1 and np.array_equal(got[0][0], want)
    with pytest.warns(UserWarning, match="not applied on the chunked"):
        cli.run_inference(cfg.replace(infer_chunk=4), device="cpu")


def test_inference_needs_a_checkpoint(ws, tmp_path):
    cfg = parse_config(TINY + ["--mode", "inference", "--input_dir_LR", ws.lr])
    with pytest.raises(ValueError, match="checkpoint file is needed"):
        cli.run_inference(cfg, device="cpu")
    with pytest.raises(ValueError, match="Invalid data type"):
        cli.run_inference(cfg.replace(g_checkpoint=ws.g_ckpt, inferencetype="image"),
                          device="cpu")


def test_video_mode_is_the_engine_clip(ws, tmp_path, monkeypatch):
    """An mp4 written by cv2, served with --videotype .gif: the frames are
    the engine's clip of load_video_frames, and the gif holds them all;
    --spatial_shards above the one visible device clamps with a warning."""
    vid = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 24, (40, 40))
    for f in moving_rect_scene(5, 40, 40):
        w.write(cv2.cvtColor((f * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    w.release()
    got = _capture(monkeypatch, image, keep_writing=True)
    cfg = parse_config(_infer_argv(ws, tmp_path, "--inferencetype", "video", "--videotype",
                                   ".gif", "--spatial_shards", "2") + ["--input_dir_LR", vid])
    with pytest.warns(UserWarning, match="--spatial_shards 2 exceeds the 1 visible"):
        cli.run_inference(cfg, device="cpu")
    clip = load_video_frames(vid, 8)
    want = build_clip_inference(cfg)(_model(cfg, ws.params_g), torch.from_numpy(clip)[None])
    assert len(got) == 1 and np.array_equal(got[0][0], want[0].numpy())
    assert image.read_gif(got[0][1]).shape == (5, 32, 32, 3)


def test_several_cards_take_the_multi_rank_routes(ws, tmp_path, monkeypatch):
    """With two cards visible the multi-rank routes are taken, not refused:
    --spatial_shards 2, then two same-shape clips (data-parallel serving,
    --data_axis 0 is every card), then --data_axis 2 and 0 for training;
    each launches 2 ranks on the cards.  A batch the cards do not divide
    trains on one, with the JAX package's warning."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    launched = []
    monkeypatch.setattr(cli, "_launch", lambda fn, world, dev, args: launched.append(
        (fn.__name__, world, dev.type, args[-1] if fn is cli._inference_rank else None)))
    for extra in (["--spatial_shards", "2"], []):
        cli.run_inference(parse_config(_infer_argv(ws, tmp_path, *extra)), device="cuda")
    for axis in ("2", "0"):
        cli.run_train(parse_config(_train_argv(ws, tmp_path / "t", "--data_axis", axis)),
                      device="cuda")
    assert launched == [("_inference_rank", 2, "cuda", "spatial"),
                        ("_inference_rank", 2, "cuda", "dp"),
                        ("_train_rank", 2, "cuda", None), ("_train_rank", 2, "cuda", None)]
    monkeypatch.setattr(cli, "_train", lambda cfg, dev, mesh=None: launched.append("one"))
    with pytest.warns(UserWarning, match="batch_size=3 is not divisible by 2 devices"):
        cli.run_train(parse_config(_train_argv(ws, tmp_path / "t", "--batch_size", "3")),
                      device="cuda")
    assert launched[-1] == "one"


def _png_clips(out, n=2):
    """The frames of the ``output{i}.png`` clips (lossless, every frame)."""
    from PIL import Image, ImageSequence

    clips = []
    for i in range(n):
        with Image.open(os.path.join(out, f"output{i}.png")) as im:
            clips.append(np.stack([np.array(f.convert("RGB"))
                                   for f in ImageSequence.Iterator(im)]))
    return clips


@pytest.mark.parametrize("route", ["exact", "fused", "int8"])
def test_spatial_shards_write_the_single_process_frames(ws, tmp_path, capfd, route):
    """--spatial_shards 2 over 2 CPU ranks (each 8-row clip split in two)
    writes the frames the single-process run writes: bit for bit on the
    fused route and its int8 tail (each clip's qtail calibrated from the
    params it serves); on the exact route (bug_parity, fp32) within one
    uint8 level (its frames agree to 2e-6, tests/test_torch_port_spatial.py,
    and the uint8 conversion truncates)."""
    extra = {"exact": [], "fused": ["--bug_parity", "False"],
             "int8": ["--bug_parity", "False", "--quantize", "int8"]}[route]
    argv = _infer_argv(ws, tmp_path, "--videotype", ".png", *extra)
    cli.run_inference(parse_config(argv), device="cpu")
    want = _png_clips(tmp_path / "out")
    capfd.readouterr()
    cli.run_inference(parse_config(argv + ["--spatial_shards", "2", "--output_dir",
                                           str(tmp_path / "sp")]), device="cpu", ranks=2)
    for got, ref in zip(_png_clips(tmp_path / "sp"), want):
        assert got.shape == ref.shape == (6, 32, 32, 3)
        if route == "exact":
            assert np.abs(got.astype(int) - ref).max() <= 1
        else:
            np.testing.assert_array_equal(got, ref)
    text = capfd.readouterr().out
    tail = " + int8 tail" if route == "int8" else ""
    assert text.count(f"spatial: 2-way row sharding{tail}\n") == 2, text


def test_data_parallel_serving_writes_the_single_process_frames(ws, tmp_path, capfd):
    """Two same-shape clips on 2 CPU ranks (--data_axis 0: every rank), one
    a rank: the single-process run's frames, bit for bit."""
    argv = _infer_argv(ws, tmp_path, "--videotype", ".png", "--bug_parity", "False")
    cli.run_inference(parse_config(argv), device="cpu")
    want = _png_clips(tmp_path / "out")
    capfd.readouterr()
    cli.run_inference(parse_config(argv + ["--output_dir", str(tmp_path / "dp")]),
                      device="cpu", ranks=2)
    for got, ref in zip(_png_clips(tmp_path / "dp"), want):
        np.testing.assert_array_equal(got, ref)
    assert "data-parallel inference over 2 devices" in capfd.readouterr().out


def test_data_axis_trains_the_single_process_leaves(ws, tmp_path):
    """--data_axis 2 on 2 CPU ranks (one sample of the batch of 2 a rank),
    an epoch of 2 steps: the .ckpt pair holds the single-process run's
    leaves, within 1e-5 but for at most 1e-3 of a leaf's elements held to
    the steps' range (the Adam eps regime, tests/test_torch_port_dp.py)."""
    one, two = tmp_path / "one", tmp_path / "two"
    cli.run_train(parse_config(_train_argv(ws, one)), device="cpu")
    cli.run_train(parse_config(_train_argv(ws, two, "--data_axis", "2")), device="cpu",
                  ranks=2)
    got, want = _ckpt_files(two), _ckpt_files(one)
    lr = parse_config(TINY).learning_rate
    for name in want:
        (gd, gm), (wd, wm) = got[name], want[name]
        assert gd.keys() == wd.keys() and gm.keys() == wm.keys()
        assert all(np.array_equal(gm[key], wm[key]) for key in wm)
        for key in wd:
            diff = np.abs(gd[key].astype(np.float64) - wd[key])
            assert diff.max() <= 4.0001 * lr, (name, key)
            assert (diff > 1e-5).sum() <= max(2, 1e-3 * diff.size), (name, key)
    for f in ("gan.gif", "real.gif", "original.gif"):
        assert (two / f).exists()


def _train_argv(ws, out, *extra):
    return TINY + ["--mode", "train", "--input_video_dir", ws.scenes, "--str_dir", "1000",
                   "--end_dir", "1001", "--output_dir", str(out), "--summary_dir",
                   str(out / "summary"), "--queue_thread", "2", "--bug_parity", "False",
                   "--steps_per_epoch", "2", "--max_epochs", "1", "--log_every", "1"] + list(extra)


def _ckpt_files(d):
    return {name: checkpoint.load_flat(os.path.join(d, name))
            for name in ("generator.ckpt", "discrim.ckpt")}


def _copy_pair(src, dst):
    os.makedirs(dst, exist_ok=True)
    for name in ("generator.ckpt", "discrim.ckpt"):
        with open(os.path.join(src, name), "rb") as f, open(os.path.join(dst, name), "wb") as g:
            g.write(f.read())


@pytest.mark.parametrize("k", [1, 2])
def test_resumed_epoch_is_a_hand_loop_of_the_train_step(ws, tmp_path, k):
    """--pre_trained_model from the JAX-written pair, one epoch of 2 steps at
    --steps_per_dispatch k with validation: the written pair is the hand
    loop's (the JAX pair loaded, the dataset's first two batches of epoch
    0, build_train_step twice, saved) bit for bit; the artifacts, the
    summary lines and the validation PSNR are there."""
    out = tmp_path / "run"
    _copy_pair(ws.ckpt, out)
    cfg = parse_config(_train_argv(ws, out, "--pre_trained_model", "True",
                                   "--steps_per_dispatch", str(k), "--validate_every", "1",
                                   "--end_dir_val", "1002"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run_train(cfg, device="cpu")
    text = buf.getvalue()
    assert "resumed from epoch 0" in text and "Epoch: 1" in text and "validation: 1 scenes" in text

    state = checkpoint.load_train_state(
        ws.ckpt, init_state(cfg, torch.Generator().manual_seed(cfg.rand_seed), device="cpu"))[0]
    state = set_epoch(state, 0)
    step = build_train_step(cfg, device="cpu")
    batches = TrainDataset(cfg).batches(cfg.batch_size, shuffle=True, seed=cfg.rand_seed,
                                        workers=cfg.queue_thread)
    for _ in range(2):
        lr, hr = next(batches)
        state, metrics, _ = step(state, torch.from_numpy(lr), torch.from_numpy(hr))
    checkpoint.save_train_state(str(tmp_path / "hand"), state, 0)
    got, want = _ckpt_files(out), _ckpt_files(tmp_path / "hand")
    for name in want:
        (gd, gm), (wd, wm) = got[name], want[name]
        assert gd.keys() == wd.keys() and gm.keys() == wm.keys()
        for key in wd:
            assert np.array_equal(gd[key], wd[key]), (name, key)
        assert all(np.array_equal(gm[key], wm[key]) for key in wm)
    for name in ("gan.gif", "real.gif", "original.gif", "Gan_examples.jpg",
                 "real_image.jpg", "original_image.jpg"):
        assert os.path.exists(out / name), name

    import json

    lines = [json.loads(ln) for ln in open(out / "summary" / "train_metrics.jsonl")]
    assert set(lines[0]) == {"step", "wall_time", "epoch"} | set(metrics)
    assert lines[-1].keys() == {"step", "wall_time", "epoch", "val_psnr_db"}
    val = TrainDataset(cfg.replace(str_dir=1002, end_dir=1002))
    lr_clip, hr_clip = val.get_clip(0)
    sr = build_clip_inference(cfg)(cli._model(cfg, state.params_g, torch.device("cpu")),
                                   torch.from_numpy(np.ascontiguousarray(lr_clip.transpose(0, 2, 3, 1)))[None])
    mse = float(np.mean((hr_clip.transpose(0, 2, 3, 1) - sr[0].numpy()) ** 2))
    assert lines[-1]["val_psnr_db"] == 10.0 * float(np.log10(1.0 / mse))


def test_sigterm_checkpoints_and_exits(ws, tmp_path):
    """The SIGTERM handler's flag stops the epoch after the step in flight,
    checkpoints it and exits; the flag is cleared and the previous handler
    restored."""
    before = signal.getsignal(signal.SIGTERM)
    cfg = parse_config(_train_argv(ws, tmp_path, "--max_epochs", "3"))
    cli.request_graceful_stop(signal.SIGTERM)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run_train(cfg, device="cpu")
    assert "SIGTERM: checkpointed epoch 0 after 1 steps" in buf.getvalue()
    assert "Epoch: 1" not in buf.getvalue()
    _, meta = checkpoint.load_flat(str(tmp_path / "generator.ckpt"))
    assert (int(meta["epoch"]), int(meta["step"])) == (0, 1)
    assert cli._STOP_REQUESTED == [] and signal.getsignal(signal.SIGTERM) == before


def test_rss_watchdog_checkpoints_the_next_epoch_and_exits_75(ws, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_host_rss_gb", lambda: 99.0)
    cfg = parse_config(_train_argv(ws, tmp_path, "--max_epochs", "3", "--rss_limit_gb", "1",
                                   "--steps_per_epoch", "1"))
    with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(io.StringIO()):
        cli.run_train(cfg, device="cpu")
    assert e.value.code == 75
    _, meta = checkpoint.load_flat(str(tmp_path / "generator.ckpt"))
    assert (int(meta["epoch"]), int(meta["step"])) == (1, 1)


def test_profile_dir_writes_a_chrome_trace(ws, tmp_path):
    """--profile_dir traces dispatches 10-15 of the first epoch; an epoch
    of 12 ends inside the window, which is closed and written."""
    cfg = parse_config(_train_argv(ws, tmp_path, "--steps_per_epoch", "12", "--profile_dir",
                                   str(tmp_path / "prof"), "--checkpoint_every", "2"))
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run_train(cfg, device="cpu")
    with open(tmp_path / "prof" / "train_trace.json") as f:
        assert '"traceEvents"' in f.read()


def test_vgg_surrogate_is_the_jax_surrogate(ws, tmp_path, rng):
    """``--vgg_ckpt surrogate`` is the JAX package's surrogate VGG-19: the
    CLI trains an epoch with it (the JAX CLI's line printed), the VGG
    features its loss reads equal the JAX features on those weights, and
    ``cli/evaluate.py --vgg_ckpt surrogate`` scores ``vgg_dist`` and
    ``lpips_surrogate`` as the JAX evaluation does."""
    import json

    from tecogan_tpu.models import vgg as j_vgg

    cfg = parse_config(_train_argv(ws, tmp_path, "--vgg_scaling", "0.5", "--vgg_ckpt",
                                   "surrogate", "--steps_per_epoch", "1"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run_train(cfg, device="cpu")
    assert "fixed-seed SURROGATE weights" in buf.getvalue()
    assert "Epoch: 1" in buf.getvalue()
    with pytest.raises(ValueError, match="requires --vgg_ckpt"):
        cli.run_train(cfg.replace(vgg_ckpt=None), device="cpu")

    surrogate = j_vgg.fixed_seed_vgg_params()
    images = rng.random((2, 32, 32, 3), np.float32)
    layers = ["vgg_19/conv2_2", "vgg_19/conv3_4", "vgg_19/conv4_4"]
    with contextlib.redirect_stdout(io.StringIO()):
        got = cli._vgg_apply(cfg, torch.device("cpu"))(torch.from_numpy(images), layers)
    want = j_vgg.vgg19_features(surrogate, jnp.asarray(images), layers)
    for k in layers:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=SCORE_TOL * float(np.abs(w).max()), err_msg=k)

    sr = rng.random((3, 32, 32, 3), np.float32)
    hr = np.clip(sr + rng.normal(0, 0.05, sr.shape).astype(np.float32), 0, 1)
    image.save_as_media(sr, str(tmp_path / "sr.gif"))
    image.save_as_media(hr, str(tmp_path / "hr.gif"))
    argv = ["--sr_dir", str(tmp_path / "sr.gif"), "--hr_dir", str(tmp_path / "hr.gif"),
            "--vgg_ckpt", "surrogate"]
    with contextlib.redirect_stdout(io.StringIO()) as jbuf:
        j_evaluate.main(argv)
    want = json.loads([ln for ln in jbuf.getvalue().splitlines() if "__aggregate__" in ln][0])
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate.main(argv, device="cpu")
    assert got.keys() == want.keys() and "vgg_dist" in got and "lpips_surrogate" in got
    for k in ("psnr_db", "ssim", "vgg_dist", "lpips_surrogate"):
        assert abs(got[k] - want[k]) <= SCORE_TOL * max(1.0, abs(want[k])), k


def test_async_save_reads_back_bit_equal(tmp_path):
    cfg = parse_config(TINY)
    state = init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    checkpoint.save_train_state(str(tmp_path / "a"), state, 4, async_save=True)
    checkpoint.wait_for_async_save()
    loaded, epoch = checkpoint.load_train_state(
        str(tmp_path / "a"), init_state(cfg, torch.Generator().manual_seed(4), device="cpu"))
    assert epoch == 4
    for name in ("params_g", "params_d", "batch_stats_d"):
        a, b = getattr(state, name), getattr(loaded, name)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name
    # a write that fails in the thread raises at the wait
    open(tmp_path / "file", "w").close()
    checkpoint.save_train_state(str(tmp_path / "file" / "x"), state, 1, async_save=True)
    with pytest.raises(OSError):
        checkpoint.wait_for_async_save()
    checkpoint.wait_for_async_save()  # the error is raised once


def test_score_pair_matches_jax(rng):
    """With VGG-19 weights seeded by ``init_vgg`` (the flax tree both
    packages read)."""
    from tecogan_tpu_torch.models.vgg import init_vgg

    hr = rng.random((3, 24, 24, 3), np.float32)
    sr = np.clip(hr + rng.normal(0, 0.05, hr.shape).astype(np.float32), 0, 1)
    vgg = init_vgg(torch.Generator().manual_seed(0))
    got = evaluate.score_pair(sr, hr, vgg, device="cpu")
    want = j_evaluate.score_pair(sr, hr, vgg)
    assert got.keys() == want.keys() and got["frames"] == 3
    for k in want:
        assert abs(got[k] - want[k]) <= SCORE_TOL * max(1.0, abs(want[k])), k


def test_evaluate_main_matches_jax(tmp_path, rng):
    """--sr_dir a gif, --hr_dir a folder of frames at another size."""
    sr = rng.random((4, 16, 16, 3), np.float32)
    image.save_as_media(sr, str(tmp_path / "sr.gif"))
    for t in range(4):
        image.save_img(str(tmp_path / "hr" / f"{t}.png"), rng.random((20, 20, 3), np.float32))
    argv = ["--sr_dir", str(tmp_path / "sr.gif"), "--hr_dir", str(tmp_path / "hr"),
            "--json_out", str(tmp_path / "p.json")]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        j_evaluate.main(argv[:-1] + [str(tmp_path / "j.json")])
    want = [ln for ln in buf.getvalue().splitlines() if "__aggregate__" in ln]
    got = evaluate.main(argv, device="cpu")
    import json

    want = json.loads(want[0])
    assert got.keys() == want.keys()
    for k in ("psnr_db", "psnr_global_db", "ssim"):
        assert abs(got[k] - want[k]) <= SCORE_TOL * max(1.0, abs(want[k])), k
    assert json.load(open(tmp_path / "p.json"))["aggregate"] == got


def test_evaluate_model_mode_scores_the_engine_clip(ws):
    """--g_checkpoint + --input_dir_HR: each clip's record is score_pair of
    the engine's SR clip of the bilinear LR against the resized HR."""
    argv = ["--g_checkpoint", ws.g_ckpt, "--input_dir_HR", ws.lr, "--crop_size", "4",
            "--num_resblock", "2", "--limit_clips", "1"]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        agg = evaluate.main(argv, device="cpu")
    import json

    rec = json.loads(buf.getvalue().splitlines()[0])
    assert rec["clip"] == "clip_a" and agg["clips"] == 1
    src = evaluate._load_frames(os.path.join(ws.lr, "clip_a"))
    hr = np.stack([cv2.resize(f, (16, 16)) for f in src])
    lr = np.stack([cv2.resize(f, (4, 4), interpolation=cv2.INTER_LINEAR) for f in src])
    cfg = TecoConfig(crop_size=4, num_resblock=2)
    sr = build_clip_inference(cfg)(_model(cfg, ws.params_g), torch.from_numpy(lr)[None])[0]
    assert rec == {"clip": "clip_a", **evaluate.score_pair(sr.numpy(), hr, device="cpu")}


@pytest.mark.parametrize("fast", [True, False])
def test_live_is_the_stream_route(ws, tmp_path, monkeypatch, fast):
    """4 frames of the synthetic chess capture: the uint8 frames live
    makes on the device are to_uint8 of the clip route's (which the stream
    reproduces) on the same LR frames; --output records all of them."""
    frames_u8, real = [], image.transfer_to_uint8

    def rec(x):
        out = real(x)
        frames_u8.append(out.numpy())
        return out

    monkeypatch.setattr(image, "transfer_to_uint8", rec)
    source = "synth:class=chess:noise=0.1:size=64x48"
    stats = live.main(["--g_checkpoint", ws.g_ckpt, "--source", source, "--no-display",
                       "--frames", "4", "--crop_size", "8", "--num_resblock", "2",
                       "--output", str(tmp_path / "live.mp4")]
                      + ([] if fast else ["--no-fast"]), device="cpu")
    assert stats["frames"] == 4 and stats["latency_max_ms"] >= stats["latency_p50_ms"] > 0
    from tecogan_tpu_torch.data.capture import create_capture

    cap, lr = create_capture(source), []
    for _ in range(4):
        bgr = cap.read()[1]
        lr.append(cv2.resize(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), (8, 8),
                             interpolation=cv2.INTER_AREA).astype(np.float32) / 255.0)
    cfg = TecoConfig(crop_size=8, num_resblock=2, bug_parity=not fast)
    want = build_clip_inference(cfg)(_model(cfg, ws.params_g),
                                     torch.from_numpy(np.stack(lr))[None])[0]
    assert np.array_equal(np.stack(frames_u8), image.to_uint8(want))
    vc = cv2.VideoCapture(str(tmp_path / "live.mp4"))
    assert int(vc.get(cv2.CAP_PROP_FRAME_COUNT)) == 4
    vc.release()


def test_cli_modules_run_without_jax(ws, tmp_path):
    """The command line and its data modules import neither jax nor the
    JAX package: a tiny inference and a 1-step epoch in a fresh
    interpreter."""
    code = textwrap.dedent(f"""
        import sys
        import tecogan_tpu_torch.cli.main as cli
        import tecogan_tpu_torch.cli.evaluate, tecogan_tpu_torch.cli.live
        import tecogan_tpu_torch.data.scenes, tecogan_tpu_torch.data.capture
        import tecogan_tpu_torch.data.prefetch, tecogan_tpu_torch.utils.summaries
        import tecogan_tpu_torch.data.convert2images, tecogan_tpu_torch.data.dataprepare
        from tecogan_tpu_torch.config import parse_config
        tiny = {TINY!r}
        cli.run_inference(parse_config(tiny + ["--input_dir_LR", {ws.lr!r}, "--input_dir_len",
                          "1", "--g_checkpoint", {ws.g_ckpt!r}, "--output_dir",
                          {str(tmp_path / "i")!r}]), device="cpu")
        cli.run_train(parse_config(tiny + ["--input_video_dir", {ws.scenes!r}, "--end_dir",
                      "1001", "--output_dir", {str(tmp_path / "t")!r}, "--summary_dir",
                      {str(tmp_path / "s")!r}, "--max_epochs", "1", "--steps_per_epoch", "1",
                      "--bug_parity", "False"]), device="cpu")
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "tecogan_tpu")]
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr[-3000:]
