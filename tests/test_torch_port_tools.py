"""Port parity, the user-facing tools: tecogan_tpu_torch/tools/
convert_torch_ckpt.py against the JAX package's tools/convert_torch_ckpt.py
(forward and --reverse, at non-default sizes and the torchvision VGG-19
index map), and tecogan_tpu_torch/tools/adapt_clip.py against the JAX
tool's flags and the port's engine calls (CPU).

Bars: every array and tensor bit for bit; the adapted params, the SR clip
and the scores equal to the engine calls they stand for.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.state import model_defs as j_model_defs
from tecogan_tpu.utils.checkpoint import load_generator_params as j_load_generator_params
from tecogan_tpu.utils.checkpoint import save_pytree as j_save_pytree
from tecogan_tpu_torch.cli.evaluate import score_pair
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.synthetic import moving_rect_scene
from tecogan_tpu_torch.engine.adapt import adapt_generator, lr_consistency_refine
from tecogan_tpu_torch.engine.inference import build_clip_inference
from tecogan_tpu_torch.engine.state import (float_params, init_discriminator,
                                            init_generator, model_defs)
from tecogan_tpu_torch.models.vgg import VGG19_CFG
from tecogan_tpu_torch.ops import image
from tecogan_tpu_torch.tools import adapt_clip, convert_torch_ckpt
from tecogan_tpu_torch.utils import checkpoint
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_CONVERT = _jax_tool("convert_torch_ckpt")
J_ADAPT = _jax_tool("adapt_clip")
SIZES = ["--num_resblock", "3", "--discrim_resblocks", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(seed=0):
    """Random generator and discriminator trees (flax layout) at 3 and 2
    resblocks, BN scales and statistics drawn too."""
    cfg = TecoConfig(num_resblock=3, discrim_resblocks=2, discrim_channels=16, crop_size=8)
    g = torch.Generator().manual_seed(seed)
    params_g = init_generator(cfg, g)
    params_d, stats = init_discriminator(cfg, g)
    rng = np.random.default_rng(seed)

    def jitter(tree):
        return {k: jitter(v) if isinstance(v, dict) else
                v + rng.normal(0, 0.1, v.shape).astype(np.float32) for k, v in tree.items()}
    return params_g, jitter(params_d), jitter(stats)


def _reference_dicts(seed=0):
    """The reference's state dicts, written by the JAX tool's exporters,
    and a torchvision VGG-19 ``features`` dict."""
    params_g, params_d, stats = _trees(seed)
    rng = np.random.default_rng(seed + 1)
    vgg_sd, cin = {}, 3
    for idx, ch in zip(J_CONVERT._VGG_TORCHVISION_IDX, [c for _, c in VGG19_CFG if c]):
        vgg_sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, (ch, cin, 3, 3)).astype(np.float32))
        vgg_sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(0, 0.05, ch).astype(np.float32))
        cin = ch
    return {"generator": J_CONVERT.export_generator(params_g, 3),
            "discriminator": J_CONVERT.export_discriminator(params_d, stats, 2),
            "vgg19": vgg_sd}


def _ckpt_equal(a, b):
    fa, ma = checkpoint.load_flat(a)
    fb, mb = checkpoint.load_flat(b)
    assert fa.keys() == fb.keys() and ma.keys() == mb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


@pytest.mark.parametrize("arch", ["generator", "discriminator", "vgg19"])
def test_forward_conversion_matches_the_jax_tool(tmp_path, arch):
    src = str(tmp_path / "ref.pt")
    torch.save({"epoch": 7, "model_state_dict": _reference_dicts()[arch]}, src)
    for fn, out in ((convert_torch_ckpt.main, "port.ckpt"), (J_CONVERT.main, "jax.ckpt")):
        _quiet(fn, ["--torch", src, "--arch", arch, "--out", str(tmp_path / out), *SIZES])
    _ckpt_equal(str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt"))


def test_vgg19_bare_index_dict(tmp_path):
    """A state dict without the ``features.`` prefix (``0.weight``)."""
    sd = {k[len("features."):]: v for k, v in _reference_dicts()["vgg19"].items()}
    torch.save(sd, str(tmp_path / "bare.pth"))
    for fn, out in ((convert_torch_ckpt.main, "port.ckpt"), (J_CONVERT.main, "jax.ckpt")):
        _quiet(fn, ["--torch", str(tmp_path / "bare.pth"), "--arch", "vgg19",
                    "--out", str(tmp_path / out)])
    _ckpt_equal(str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt"))


@pytest.mark.parametrize("arch", ["generator", "discriminator"])
def test_reverse_matches_the_jax_tool_and_round_trips(tmp_path, arch):
    """``--reverse``: tensor for tensor the JAX tool's ``.pt``, in its key
    order; forward after reverse gives the source ``.ckpt`` back exactly,
    and the reverse of that gives the same ``.pt``."""
    params_g, params_d, stats = _trees(3)
    ckpt = str(tmp_path / "src.ckpt")
    if arch == "generator":
        j_save_pytree(ckpt, {"model_state_dict": params_g}, meta={"epoch": 5})
    else:
        j_save_pytree(ckpt, {"model_state_dict": params_d, "batch_stats": stats})
    for fn, out in ((convert_torch_ckpt.main, "port.pt"), (J_CONVERT.main, "jax.pt")):
        _quiet(fn, ["--reverse", ckpt, "--arch", arch, "--out", str(tmp_path / out), *SIZES])
    got = torch.load(str(tmp_path / "port.pt"), weights_only=False)
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=False)
    assert got.keys() == want.keys()
    assert got.get("epoch") == want.get("epoch")
    assert list(got["model_state_dict"]) == list(want["model_state_dict"])
    for k, t in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], t), k
        assert got["model_state_dict"][k].is_contiguous()
    _quiet(convert_torch_ckpt.main, ["--torch", str(tmp_path / "port.pt"), "--arch", arch,
                                     "--out", str(tmp_path / "back.ckpt"), *SIZES])
    _ckpt_equal(str(tmp_path / "back.ckpt"), ckpt)


def test_converted_generator_loads_in_both_packages(tmp_path):
    """A reference ``generator.pt`` converted by the port: the JAX loader
    and the port's loader read the same arrays, and the port's model
    serves them."""
    ref = _reference_dicts(4)["generator"]
    torch.save({"epoch": 2, "model_state_dict": ref}, str(tmp_path / "g.pt"))
    out = str(tmp_path / "g.ckpt")
    _quiet(convert_torch_ckpt.main, ["--torch", str(tmp_path / "g.pt"), "--arch", "generator",
                                     "--out", out, "--num_resblock", "3"])
    jcfg = JaxTecoConfig(num_resblock=3, precision="fp32")
    gen, _ = j_model_defs(jcfg)
    template = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51), jnp.float32))["params"]
    j_params = j_load_generator_params(out, template)
    port = checkpoint.load_generator_params(out)
    flat_j = {jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(j_params)[0]}
    flat_p = {jax.tree_util.keystr(p): v
              for p, v in jax.tree_util.tree_flatten_with_path(port)[0]}
    assert flat_j.keys() == flat_p.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_p[k], flat_j[k], err_msg=k)
    model = model_defs(TecoConfig(num_resblock=3, precision="fp32"), device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(port))
    # the port's modules hold the reference's tensors as they were
    for k, t in ref.items():
        name = {"conv.0": "conv_in", "output": "conv_out"}.get(k.rsplit(".", 1)[0])
        if name:
            assert torch.equal(model.state_dict()[f"{name}.{k.rsplit('.', 1)[1]}"], t)


def test_converter_refusals(tmp_path):
    with pytest.raises(SystemExit):
        _quiet(convert_torch_ckpt.main, ["--arch", "generator", "--out", str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        _quiet(convert_torch_ckpt.main, ["--reverse", "x.ckpt", "--arch", "vgg19",
                                         "--out", str(tmp_path / "x")])


class _Parsed(Exception):
    pass


def _jax_parser():
    """The JAX tool's parser, caught at ``parse_args`` (its ``main``
    builds it inline)."""
    real = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = catch
    try:
        J_ADAPT.main([])
    except _Parsed as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("the JAX tool parsed no arguments")


def _flags(parser):
    return {a.option_strings[0]: (a.default, a.type, a.required, a.dest)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_adapt_clip_flags_are_the_jax_tools():
    """The JAX tool's flags with their defaults, types and requiredness,
    plus ``--device`` (default None: the card)."""
    port, jax_flags = _flags(adapt_clip.build_parser()), _flags(_jax_parser())
    assert port.pop("--device") == (None, None, False, "device")
    assert port == jax_flags


def test_adapt_clip_outputs_equal_the_engine_calls(tmp_path):
    """The tool on a 10-frame 8 x 12 clip (a folder of pngs) with its
    ground truth, 2 resblocks, 2 steps, 1 refine iteration, on the CPU:
    the adapted ``.ckpt`` holds ``adapt_generator``'s params (and loads in
    the JAX package), the SR clip is ``build_clip_inference`` +
    ``lr_consistency_refine`` on them, the scores ``score_pair``'s, and
    ``--json_out`` records them."""
    hr = moving_rect_scene(num_frames=10, height=32, width=48, seed=2)
    lr = np.stack([hr[t, 1::4, 1::4] for t in range(10)])
    for name, frames in (("lr", lr), ("gt", hr)):
        for t, f in enumerate(frames):
            image.save_img(str(tmp_path / name / f"{t:04d}.png"), f)
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    params = init_generator(cfg, torch.Generator().manual_seed(6))
    src = str(tmp_path / "g.ckpt")
    checkpoint.save_generator_params(src, params)
    scores = str(tmp_path / "scores.json")
    res = _quiet(adapt_clip.main, [
        "--input", str(tmp_path / "lr"), "--g_checkpoint", src, "--num_resblock", "2",
        "--steps", "2", "--refine", "1", "--out_ckpt", str(tmp_path / "a.ckpt"),
        "--out_sr", str(tmp_path / "sr.gif"), "--gt", str(tmp_path / "gt"),
        "--json_out", scores, "--record_suffix", "t", "--device", "cpu"])

    clip = adapt_clip.load_clip(str(tmp_path / "lr"))
    with contextlib.redirect_stdout(io.StringIO()):
        adapted, report = adapt_generator(cfg, params, clip, steps=2, log_every=1,
                                          guard=True, device="cpu")
    assert res["report"] == report
    saved = generator_state_dict_from_jax(
        checkpoint.load_generator_params(str(tmp_path / "a.ckpt")))
    assert saved.keys() == adapted.keys()
    assert all(torch.equal(saved[k], adapted[k]) for k in saved)
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(float_params(adapted))
    sr = build_clip_inference(cfg)(model.eval(), torch.from_numpy(clip)[None])[0]
    sr = lr_consistency_refine(sr, clip, iters=1, device="cpu").numpy()
    np.testing.assert_array_equal(res["sr"], sr)
    assert res["score"] == score_pair(sr, adapt_clip.load_clip(str(tmp_path / "gt")),
                                      device="cpu")
    with open(scores) as f:
        data = json.load(f)
    assert data["records"]["ours_adapted_t"] == res["score"]
    assert data["context"]["ours_adapted_t"]["steps"] == 2
    assert os.path.getsize(tmp_path / "sr.gif") > 0
    # the JAX loader reads the adapted checkpoint
    gen, _ = j_model_defs(JaxTecoConfig(num_resblock=2))
    template = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51), jnp.float32))["params"]
    j_params = j_load_generator_params(str(tmp_path / "a.ckpt"), template)
    np.testing.assert_array_equal(np.asarray(j_params["conv_out"]["bias"]),
                                  adapted["conv_out.bias"].numpy())
