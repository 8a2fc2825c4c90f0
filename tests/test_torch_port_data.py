"""Port parity, the data modules and image I/O: tecogan_tpu_torch's
data/scenes.py, data/capture.py, data/synthetic.py's scene folders,
data/prefetch.py, data/convert2images.py, data/dataprepare.py,
ops/image.py's writers and readers and utils/summaries.py against the
JAX package's on the same folders and seeds (CPU).

Bars: every array and every decoded pixel bit-equal; the PIL writers
reproduce the JAX package's imageio (pillow) files byte for byte, gif
palette included, so no tolerance is needed there.
"""

import hashlib
import importlib
import itertools
import json
import os

import cv2
import imageio
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.data import capture as jcapture
from tecogan_tpu.data import scenes as jscenes
from tecogan_tpu.data.synthetic import moving_rect_scene
from tecogan_tpu.data.synthetic import write_synthetic_scene_folders as j_write
from tecogan_tpu.ops import image as jimage
from tecogan_tpu.utils import summaries as jsummaries
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data import capture, prefetch, scenes
from tecogan_tpu_torch.data.synthetic import write_synthetic_scene_folders
from tecogan_tpu_torch.ops import image
from tecogan_tpu_torch.utils import summaries

j_convert = importlib.import_module("tecogan_tpu.data.convert2images")
from tecogan_tpu_torch.data import convert2images, dataprepare  # noqa: E402

TINY = dict(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1, discrim_channels=16,
            batch_size=2, precision="fp32", str_dir=1000, end_dir=1001)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """Two 120-frame scenes of 48 x 48 (moving-rect, drifting checkerboard)
    written by the JAX package, and a third for the validation split."""
    root = str(tmp_path_factory.mktemp("scenes"))
    j_write(root, num_scenes=3, frames_per_scene=120, size=48, variety=True)
    return root


def _cfgs(root, **kw):
    kw = {**TINY, "input_video_dir": root, **kw}
    return TecoConfig(**kw), JaxTecoConfig(**kw)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def test_variety_scene_folders_match_the_jax_package(tmp_path):
    """Every maker of the rotation (moving-rect, checkerboard, the chess,
    book and cube captures) at a seed offset: the same PNG files."""
    kw = dict(num_scenes=5, frames_per_scene=6, size=40, variety=True, seed_offset=3)
    j_write(str(tmp_path / "j"), **kw)
    write_synthetic_scene_folders(str(tmp_path / "p"), **kw)
    names = _files(tmp_path / "j")
    assert names == _files(tmp_path / "p") and len(names) == 30
    for n in names:
        a, b = str(tmp_path / "j" / n), str(tmp_path / "p" / n)
        assert np.array_equal(scenes._decode_u8(a), scenes._decode_u8(b)), n
        assert _md5(a) == _md5(b), n


@pytest.mark.parametrize("bug_parity", [True, False])
def test_get_clip_is_the_jax_clip(scene_root, bug_parity):
    ours, theirs = _cfgs(scene_root, bug_parity=bug_parity)
    p_ds, j_ds = scenes.TrainDataset(ours), jscenes.TrainDataset(theirs)
    assert len(p_ds) == len(j_ds) and p_ds.windows == j_ds.windows
    for idx in (0, 7, 109, 110, 219):
        for seed in (None, 3):
            rng = None if seed is None else (np.random.default_rng(seed),
                                             np.random.default_rng(seed))
            got = p_ds.get_clip(idx, None if rng is None else rng[0])
            want = j_ds.get_clip(idx, None if rng is None else rng[1])
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w), (idx, seed)


@pytest.mark.parametrize("bug_parity,workers", [(True, 0), (True, 2), (False, 0), (False, 2)])
def test_batches_are_the_jax_batches(scene_root, bug_parity, workers):
    """The first batches of two epochs, with the thread pool or without:
    each clip's rng comes from the seed and its position, so the arrays
    do not depend on thread scheduling."""
    ours, theirs = _cfgs(scene_root, bug_parity=bug_parity)
    p_ds, j_ds = scenes.TrainDataset(ours), jscenes.TrainDataset(theirs)
    for seed in (1, 2):
        got = list(itertools.islice(p_ds.batches(2, seed=seed, workers=workers), 3))
        want = list(itertools.islice(j_ds.batches(2, seed=seed, workers=0), 3))
        assert len(got) == len(want) == (1 if bug_parity else 3)
        for (gl, gh), (wl, wh) in zip(got, want):
            assert gl.shape == (2, 9, 3, 8, 8) and gh.shape == (2, 9, 3, 32, 32)
            assert np.array_equal(gl, wl) and np.array_equal(gh, wh)


def test_frame_cache_is_bounded_and_lossless(scene_root):
    ours, _ = _cfgs(scene_root)
    ds = scenes.TrainDataset(ours, cache_mb=0)
    ds._cache_cap = 3 * 48 * 48 * 3
    first = [ds._frame(p) for p in ds.scenes[0][:5]]
    assert len(ds._cache) == 3 and ds._cache_bytes <= ds._cache_cap
    again = [ds._frame(p) for p in ds.scenes[0][:5]]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("hr_fallback", [False, True])
def test_inference_dataset_is_the_jax_one(scene_root, hr_fallback):
    kw = dict(input_dir_HR=scene_root) if hr_fallback else dict(input_dir_LR=scene_root)
    ours, theirs = _cfgs(scene_root, input_dir_len=2, **kw)
    p_ds, j_ds = scenes.InferenceDataset(ours), jscenes.InferenceDataset(theirs)
    assert p_ds.down_sample == j_ds.down_sample == hr_fallback
    assert p_ds.clips == j_ds.clips and len(p_ds) == 2
    for i in range(len(p_ds)):
        got, want = p_ds.get_clip(i), j_ds.get_clip(i)
        assert got.shape == (120, 8, 8, 3) and np.array_equal(got, want)


def test_inference_dataset_without_a_folder_raises(tmp_path):
    with pytest.raises(ValueError, match="Input directory not found"):
        scenes.InferenceDataset(TecoConfig(input_dir_LR=str(tmp_path / "none")))


def _write_mp4(path, frames=8, size=(48, 40)):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, size)
    for f in moving_rect_scene(frames, size[1], size[0]):
        w.write(cv2.cvtColor((f * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    w.release()


def test_load_video_frames_is_the_jax_read(tmp_path):
    path = str(tmp_path / "in.mp4")
    _write_mp4(path)
    got = scenes.load_video_frames(path, 12)
    assert got.shape == (8, 12, 12, 3)
    assert np.array_equal(got, jscenes.load_video_frames(path, 12))


@pytest.mark.parametrize("spec", ["synth:class=chess:noise=0.1:size=64x48",
                                  "synth:class=book:size=64x48",
                                  "synth:class=cube:noise=0.02:size=64x48",
                                  "synth:size=32x24", "no_such_source"])
def test_captures_give_the_jax_frames(spec):
    """Five frames of each capture, then five after a seek; an unknown
    source falls back to the default chess capture in both."""
    ours, theirs = capture.create_capture(spec), jcapture.create_capture(spec)
    assert type(ours).__name__ == type(theirs).__name__
    for seek in (None, 40):
        if seek is not None:
            ours.set(cv2.CAP_PROP_POS_FRAMES, seek)
            theirs.set(cv2.CAP_PROP_POS_FRAMES, seek)
        for _ in range(5):
            (ok_p, a), (ok_j, b) = ours.read(), theirs.read()
            assert ok_p and ok_j and np.array_equal(a, b)


def test_capture_helpers_match():
    R, t = capture.lookat((3.0, -2.0, 5.0), (0.5, 0.5, 0.0))
    jR, jt = jcapture.lookat((3.0, -2.0, 5.0), (0.5, 0.5, 0.0))
    assert np.array_equal(R, jR) and np.array_equal(t, jt)
    assert np.array_equal(capture.mtx2rvec(R), jcapture.mtx2rvec(R))
    with pytest.raises(ValueError, match="malformed synth spec"):
        capture.create_capture("synth:class")


def test_uint8_conversions_match(rng):
    x = np.concatenate([rng.random(1000, np.float32) * 1.2 - 0.1,
                        np.float32([0.0, 1.0, 0.5, 1 / 255, 254.5 / 255])])
    assert np.array_equal(image.to_uint8(x), jimage.to_uint8(x))
    assert np.array_equal(image.to_uint8(torch.from_numpy(x)), jimage.to_uint8(x))
    assert np.array_equal(image.transfer_quantize_u8(x), jimage.transfer_quantize_u8(x))
    # the device half is the host's conversion, bit for bit
    assert np.array_equal(image.transfer_to_uint8(torch.from_numpy(x)).numpy(),
                          image.to_uint8(x))
    u8 = image.to_uint8(x)
    assert image.to_uint8(u8) is u8


@pytest.mark.parametrize("name", ["clip.gif", "clip.mp4", "one.gif"])
def test_save_as_media_writes_the_jax_file(tmp_path, rng, name):
    clip = rng.random((1 if name == "one.gif" else 6, 24, 32, 3), np.float32)
    jimage.save_as_media(clip, str(tmp_path / "j" / name))
    image.save_as_media(clip, str(tmp_path / "p" / name))
    assert _md5(tmp_path / "j" / name) == _md5(tmp_path / "p" / name)
    if name.endswith(".gif"):
        want = np.stack([np.asarray(f)[..., :3]
                         for f in imageio.mimread(str(tmp_path / "j" / name))])
        assert np.array_equal(image.read_gif(str(tmp_path / "p" / name)), want)


@pytest.mark.parametrize("ext", [".gif", ".mp4"])
def test_media_writer_in_windows_is_save_as_media(tmp_path, rng, ext):
    clip = rng.random((7, 16, 16, 3), np.float32)
    image.save_as_media(clip, str(tmp_path / f"whole{ext}"))
    with image.MediaWriter(str(tmp_path / f"windows{ext}")) as w:
        for pos in range(0, 7, 3):
            w.append(image.to_uint8(clip[pos:pos + 3]))
    assert _md5(tmp_path / f"whole{ext}") == _md5(tmp_path / f"windows{ext}")


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_save_img_and_grid_write_the_jax_files(tmp_path, rng, ext):
    img = rng.random((20, 28, 3), np.float32)
    jimage.save_img(str(tmp_path / f"j{ext}"), img)
    image.save_img(str(tmp_path / f"p{ext}"), img)
    assert _md5(tmp_path / f"j{ext}") == _md5(tmp_path / f"p{ext}")
    grid = rng.random((11, 8, 6, 3), np.float32)
    jimage.save_image_grid(grid, str(tmp_path / f"jg{ext}"), ncols=4)
    image.save_image_grid(grid, str(tmp_path / f"pg{ext}"), ncols=4)
    assert _md5(tmp_path / f"jg{ext}") == _md5(tmp_path / f"pg{ext}")
    assert np.array_equal(scenes._decode_u8(str(tmp_path / f"pg{ext}")),
                          scenes._decode_u8(str(tmp_path / f"jg{ext}")))


def test_layout_helpers():
    x = torch.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    assert torch.equal(image.nhwc_to_nchw(image.nchw_to_nhwc(x)), x)
    assert tuple(image.nchw_to_nhwc(x).shape) == (2, 4, 5, 3)


def test_threaded_batches_keep_order_and_raise():
    items = [(np.full(3, i), np.full(2, -i)) for i in range(9)]
    got = list(prefetch.threaded_batches(iter(items), depth=2))
    assert [int(a[0]) for a, _ in got] == list(range(9))

    def broken():
        yield items[0]
        raise RuntimeError("decode failed")

    seen = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for item in prefetch.threaded_batches(broken(), depth=1):
            seen.append(item)
    assert len(seen) == 1


@pytest.mark.parametrize("size,threads", [(0, 0), (1, 0), (2, 2), (5, 1)])
def test_device_prefetch_on_the_cpu_yields_the_same_items(size, threads):
    items = [(np.random.default_rng(i).random((2, 3), np.float32),
              np.arange(i, i + 4, dtype=np.uint8)) for i in range(4)]
    got = list(prefetch.make_input_pipeline(iter(items), queue_threads=threads,
                                            prefetch=size, device="cpu"))
    assert len(got) == len(items)
    for (a, b), (c, d) in zip(got, items):
        assert torch.equal(torch.as_tensor(a), torch.from_numpy(c))
        assert torch.equal(torch.as_tensor(b), torch.from_numpy(d))
        if size:
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"


@pytest.mark.parametrize("call", ["device_prefetch", "make_input_pipeline"])
def test_prefetch_defaults_to_the_card(monkeypatch, call):
    """No device named: the card, as every entry point; without one it
    raises when called, before any item is drawn."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    drawn = []

    def items():
        drawn.append(1)
        yield (np.zeros(2, np.float32),)

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        getattr(prefetch, call)(items())
    assert not drawn


def test_summary_lines_have_the_jax_keys(tmp_path):
    metrics = {"gen_loss": torch.tensor(1.25), "d_loss": np.float32(0.5),
               "learning_rate": 1e-4, "label": "skipped"}
    for mod, d in ((jsummaries, "j"), (summaries, "p")):
        w = mod.SummaryWriter(str(tmp_path / d))
        w.write(3, metrics, epoch=1)
        w.write(4, {"val_psnr_db": 20.5})
        w.close()
    lines = {d: [json.loads(ln) for ln in open(tmp_path / d / "train_metrics.jsonl")]
             for d in "jp"}
    for a, b in zip(lines["j"], lines["p"]):
        assert a.keys() == b.keys()
        assert {k: v for k, v in a.items() if k != "wall_time"} == \
            {k: v for k, v in b.items() if k != "wall_time"}
    assert summaries.format_metrics({"a": torch.tensor(2.0), "b": 0.125}) == \
        jsummaries.format_metrics({"a": 2.0, "b": 0.125})


def test_epoch_artifacts_are_the_jax_files(tmp_path, rng):
    gen = rng.random((2, 5, 3, 16, 16), np.float32)
    hr = rng.random((2, 5, 3, 16, 16), np.float32)
    lr = rng.random((2, 5, 3, 4, 4), np.float32)
    jsummaries.save_epoch_artifacts(str(tmp_path / "j"), gen, hr, lr, 5, sample_index=1)
    summaries.save_epoch_artifacts(str(tmp_path / "p"), gen, hr, lr, 5, sample_index=1)
    names = _files(tmp_path / "j")
    assert names == _files(tmp_path / "p") == sorted(
        ["gan.gif", "real.gif", "original.gif", "Gan_examples.jpg", "real_image.jpg",
         "original_image.jpg"])
    for n in names:
        assert _md5(tmp_path / "j" / n) == _md5(tmp_path / "p" / n), n


def test_convert2images_writes_the_jax_scenes(tmp_path):
    os.makedirs(tmp_path / "videos")
    _write_mp4(str(tmp_path / "videos" / "a.mp4"), frames=10, size=(160, 128))
    args = ["--video_dir", str(tmp_path / "videos"), "--frames_per_scene", "4",
            "--scale", "1.0", "--start_index", "7"]
    j_convert.main(args + ["--output_dir", str(tmp_path / "j")])
    convert2images.main(args + ["--output_dir", str(tmp_path / "p")])
    names = _files(tmp_path / "j")
    assert names == _files(tmp_path / "p") and len(names) == 8
    assert names[0].startswith("scene_0007")
    for n in names:
        assert _md5(tmp_path / "j" / n) == _md5(tmp_path / "p" / n), n


def test_dataprepare_synthetic_and_offline_refusal(tmp_path, capsys):
    dataprepare.main(["--synthetic", "2", "--duration", "3", "--disk_path",
                      str(tmp_path / "data"), "--summary_dir", str(tmp_path / "log")])
    assert _files(tmp_path / "data") == [f"scene_{s}/col_high_000{t}.png"
                                         for s in (1000, 1001) for t in range(3)]
    assert "generated 2 synthetic scenes" in open(
        os.path.join(tmp_path / "log", os.listdir(tmp_path / "log")[0])).read()
    with pytest.raises(SystemExit) as e:
        dataprepare.main(["--disk_path", str(tmp_path / "none")])
    assert e.value.code == 1
    n = dataprepare.extract_scenes("no_such.mp4", [0, 30], str(tmp_path / "ex"), 5,
                                   frames_per_scene=3)
    assert n == 7 and _files(tmp_path / "ex")[0] == "scene_0005/col_high_0000.png"
