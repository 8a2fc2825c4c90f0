"""The port's command-line surface (tecogan_tpu_torch/config.py's
build_parser, parse_config, str2bool) against the JAX package's, and the
command line's device rule: ``main`` runs on the card and raises where no
GPU is visible."""

import argparse
import dataclasses

import pytest
import torch

from tecogan_tpu import config as jconfig
from tecogan_tpu_torch import config
from tecogan_tpu_torch.cli import main as cli


def _actions(parser):
    """{option string: (dest, default, type name, nargs, choices, const)}."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        t = getattr(a.type, "__name__", a.type)
        for s in a.option_strings:
            out[s] = (a.dest, a.default, t, a.nargs, a.choices, a.const)
    return out


def test_parser_takes_the_jax_flags_with_their_defaults_types_and_choices():
    ours, theirs = _actions(config.build_parser()), _actions(jconfig.build_parser())
    assert sorted(ours) == sorted(theirs)
    assert len(theirs) == 80
    for flag, want in theirs.items():
        assert ours[flag] == want, flag


ARGVS = [
    [],
    ["--mode", "inference", "--g_checkpoint", "g.ckpt", "--input_dir_LR", "lr",
     "--inferencetype", "video", "--videotype", ".gif", "--quantize", "int8",
     "--quantize_calib", "per_clip", "--infer_chunk", "16", "--transfer_dtype", "u8"],
    ["--mode", "train", "--batch_size", "2", "--RNN_N", "9", "--crop_size", "8",
     "--bug_parity", "False", "--pingpang", "yes", "--steps_per_dispatch", "2",
     "--learning_rate", "3e-5", "--Dt_mergeDs", "0", "--vgg_scaling", "0.5",
     "--vgg_ckpt", "surrogate", "--auto_resume", "t", "--async_checkpoint", "n"],
    ["--adapt_steps", "3", "--adapt_lr", "2e-4", "--consistency_refine", "2",
     "--spatial_shards", "2", "--data_axis", "1", "--precision", "fp32",
     "--cudaID", "1", "--jit", "False", "--rss_limit_gb", "1.5", "--profile_dir", "p"],
    ["--input_dir_LR", "--RNN_N"],  # nargs="?" flags given no value take their const
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_config_gives_the_jax_fields(argv):
    ours, theirs = config.parse_config(argv), jconfig.parse_config(argv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("spelling,want", [
    ("yes", True), ("true", True), ("True", True), ("t", True), ("y", True), ("1", True),
    ("no", False), ("false", False), ("FALSE", False), ("f", False), ("n", False),
    ("0", False), (True, True), (False, False)])
def test_str2bool_spellings(spelling, want):
    assert config.str2bool(spelling) is want is jconfig.str2bool(spelling)


def test_str2bool_refuses_other_words():
    for fn in (config.str2bool, jconfig.str2bool):
        with pytest.raises(argparse.ArgumentTypeError):
            fn("maybe")
    with pytest.raises(SystemExit):
        config.build_parser().parse_args(["--flip", "maybe"])


@pytest.mark.parametrize("mode", ["inference", "train"])
def test_main_raises_without_a_gpu(mode, monkeypatch, tmp_path):
    """``main`` passes no device: with no GPU visible it raises before any
    work, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--mode", mode, "--output_dir", str(tmp_path / "out"),
            "--summary_dir", str(tmp_path / "sum"), "--g_checkpoint", "missing.ckpt",
            "--input_video_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(argv)


def test_main_refuses_an_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="unknown --mode"):
        cli.main(["--mode", "serve", "--output_dir", str(tmp_path / "o"),
                  "--summary_dir", str(tmp_path / "s")])
