"""Port parity, the convergence-evidence tools
(tecogan_tpu_torch/tools/gen_scenes_r4.py, publish_round_eval.py) against
the JAX package's tools/gen_scenes_r4.py and tools/publish_round_eval.py,
on the CPU at a tiny size.

* The scenes decode to the JAX writer's pixels with the tool's arguments
  (index 1000 with ``seed_offset`` 0, 2100 with 1000, ``variety``), at 5
  training scenes (every maker of the variety rotation), one held-out
  scene, 3 frames of 16 x 16.  The files are not byte-equal: the JAX
  package writes PNGs with imageio, the port with PIL.
* Both tools on copies of one tiny run directory: a JAX-saved
  ``generator.ckpt`` at 1 resblock, a hand-written
  ``summary/train_metrics.jsonl`` that logs an epoch twice and restarts
  its wall clock, 2 held-out scenes of 32 x 32.  The bicubic anchors
  within ``cli.evaluate``'s 1e-5 (relative above 1); the records and the
  aggregate, which score the generator's SR clip from the bf16 fused route
  that each package rounds its own way (``cli.evaluate`` serves at the
  config's default precision), within ``BF16_SCORE_TOL``, one bf16 unit
  roundoff; the trajectory and the run's context equal, and
  ``train_mfu_wall`` the JAX value rescaled from its 197 TFLOP/s peak to
  the H100's 989 TFLOP/s, up to the 4 decimals both tools round to.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tecogan_tpu.data.synthetic import write_synthetic_scene_folders as j_write_scenes
from tecogan_tpu.utils.checkpoint import save_generator_params as j_save_generator_params
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.state import init_generator
from tecogan_tpu_torch.tools import publish_round_eval
from tecogan_tpu_torch.tools.gen_scenes_r4 import write_round_scenes
from tecogan_tpu_torch.utils.flops import H100_PEAK_BF16_FLOPS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5
BF16_SCORE_TOL = 2.0 ** -8
JAX_PEAK_TFLOPS = 197.0  # tools/publish_round_eval.py:139
STEPS = [(0, 10, 1.5), (0, 20, 3.0), (1, 30, 4.25), (0, 10, 0.75), (1, 40, 6.0),
         (2, 50, 7.5)]  # (epoch, step, wall_time): a restart after step 30


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(root):
    out = {}
    for scene in sorted(os.listdir(root)):
        for f in sorted(os.listdir(os.path.join(root, scene))):
            with Image.open(os.path.join(root, scene, f)) as im:
                out[f"{scene}/{f}"] = np.asarray(im)
    return out


def test_gen_scenes_decode_to_the_jax_tools_pixels(tmp_path):
    write_round_scenes(str(tmp_path / "port"), size=16, train_scenes=5, heldout_scenes=1,
                       frames_per_scene=3)
    jroot = str(tmp_path / "jax")
    j_write_scenes(jroot, num_scenes=5, frames_per_scene=3, size=16, start_index=1000,
                   variety=True, seed_offset=0)
    j_write_scenes(jroot, num_scenes=1, frames_per_scene=3, size=16, start_index=2100,
                   variety=True, seed_offset=1000)
    got, want = _pixels(str(tmp_path / "port")), _pixels(jroot)
    assert sorted(got) == sorted(want) and len(want) == 6 * 3
    assert {k.split("/")[0] for k in got} == {*(f"scene_{1000 + i}" for i in range(5)),
                                             "scene_2100"}
    for k, w in want.items():
        assert got[k].shape == (16, 16, 3)
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_gen_scenes_flags_are_the_jax_tools(monkeypatch, tmp_path):
    """``--root`` (required: the JAX default is a path of the machine it
    was written on) and ``--size`` (default 144) reach the writer."""
    import tecogan_tpu_torch.tools.gen_scenes_r4 as tool

    calls = []
    monkeypatch.setattr(tool, "write_round_scenes", lambda *a: calls.append(a))
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        tool.main([])
    with contextlib.redirect_stderr(io.StringIO()):
        tool.main(["--root", str(tmp_path)])
        tool.main(["--root", str(tmp_path), "--size", "20"])
    assert calls == [(str(tmp_path), 144), (str(tmp_path), 20)]


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """Both tools' JSON from copies of one tiny run directory."""
    base = tmp_path_factory.mktemp("round_eval")
    scenes = str(base / "scenes")
    j_write_scenes(scenes, num_scenes=2, frames_per_scene=4, size=32, start_index=2100,
                   variety=True, seed_offset=1000)
    run = base / "run"
    params = init_generator(TecoConfig(num_resblock=1), torch.Generator().manual_seed(0))
    j_save_generator_params(str(run / "generator.ckpt"), params, meta={"epoch": 3})
    os.makedirs(run / "summary")
    with open(run / "summary" / "train_metrics.jsonl", "w") as f:
        for i, (epoch, step, wall) in enumerate(STEPS):
            rec = {"epoch": epoch, "step": step, "wall_time": wall, "gen_loss": 0.5 / (i + 1)}
            if i in (1, 2, 3, 5):  # epoch 0 logged twice, as a resumed run does
                rec["val_psnr_db"] = 20.0 + i + 0.12345
            f.write(json.dumps(rec) + "\n")
    shutil.copytree(run, base / "run_port")
    flags = ["--scene_dir", scenes, "--eval_scenes", "2100,2101", "--crop_size", "8",
             "--limit_frames", "4", "--num_resblock", "1", "--context_note", "tiny"]
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_tool("publish_round_eval").main(
            ["--run_dir", str(run), "--out", str(base / "jax.json"), "--platform", "cpu"]
            + flags)
        got = publish_round_eval.main(["--run_dir", str(base / "run_port"), "--out",
                                       str(base / "port.json"), "--device", "cpu"] + flags)
    with open(base / "jax.json") as f:
        want = json.load(f)
    with open(base / "port.json") as f:
        assert json.load(f) == got
    return got, want, base


def _close(got, want, what, tol=SCORE_TOL):
    assert abs(got - want) <= tol * max(1.0, abs(want)), (what, got, want)


def test_records_and_aggregate_are_the_jax_tools(published):
    got, want, _ = published
    assert len(got["records"]) == len(want["records"]) == 2
    for g, w in zip(got["records"] + [got["aggregate"]], want["records"] + [want["aggregate"]]):
        assert g.keys() == w.keys() and g["clip"] == w["clip"], (g, w)
        assert "vgg_dist" in g and "lpips_surrogate" in g
        for k, v in w.items():
            if k == "clip":
                continue
            _close(g[k], v, (w["clip"], k), BF16_SCORE_TOL)


def test_bicubic_anchors_are_the_jax_tools(published):
    got, want, _ = published
    g, w = got["heldout_bicubic4x"], want["heldout_bicubic4x"]
    assert g.keys() == w.keys() == {"scene_2100", "scene_2101", "aggregate_psnr_db"}
    _close(g["aggregate_psnr_db"], w["aggregate_psnr_db"], "aggregate_psnr_db")
    for s in ("scene_2100", "scene_2101"):
        assert g[s].keys() == w[s].keys()
        for k in w[s]:
            _close(g[s][k], w[s][k], (s, k))


def test_trajectory_and_context_are_the_jax_tools(published):
    got, want, base = published
    assert got["validation_psnr_trajectory_db"] == want["validation_psnr_trajectory_db"]
    assert got["validation_psnr_trajectory_db"] == {"epoch1": [21.123, 23.123],
                                                     "epoch2": 22.123, "epoch3": 25.123}
    gc, wc = got["context"], want["context"]
    for k in ("scored_checkpoint_epoch", "final_epoch", "final_step", "train_wall_s",
              "median_ms_per_step_wall", "train_tflop_per_step", "protocol", "note"):
        assert gc[k] == wc[k], k
    assert gc["scored_checkpoint_epoch"] == 3 and gc["median_ms_per_step_wall"] == 150.0
    assert gc["eval_device"] == "cpu" and gc["train_mfu_peak_tflops"] == 989.0
    assert gc["run_dir"] == str(base / "run_port")
    assert not os.path.exists(os.path.join(ROOT, "eval", "port.json"))


def test_train_mfu_is_against_the_h100_peak(published):
    """The JAX tool's MFU against its 197 TFLOP/s, rescaled to 989 TFLOP/s:
    equal up to the 4 decimals each rounds to."""
    got, want, _ = published
    scale = JAX_PEAK_TFLOPS * 1e12 / H100_PEAK_BF16_FLOPS
    mfu, jmfu = got["context"]["train_mfu_wall"], want["context"]["train_mfu_wall"]
    assert abs(mfu - jmfu * scale) <= 0.5e-4 * (1 + scale), (mfu, jmfu)
    ms = got["context"]["median_ms_per_step_wall"]
    assert mfu == round(3.297e12 / (ms / 1e3) / H100_PEAK_BF16_FLOPS, 4)
