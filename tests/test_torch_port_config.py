"""The port's own TecoConfig (tecogan_tpu_torch/config.py) against the JAX
package's dataclass, and the port's device default."""

import dataclasses

import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.inference import build_stream_inference
from tecogan_tpu_torch.engine.state import model_defs


def test_fields_and_defaults_match_the_jax_dataclass():
    ours = [(f.name, f.default) for f in dataclasses.fields(TecoConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxTecoConfig)]
    assert ours == theirs
    assert dataclasses.asdict(TecoConfig()) == dataclasses.asdict(JaxTecoConfig())


def test_properties_and_replace_match():
    for kw in ({}, {"crop_size": 8, "RNN_N": 9, "pingpang": True}):
        ours, theirs = TecoConfig(**kw), JaxTecoConfig(**kw)
        assert (ours.hr_size, ours.unrolled_frames) == \
            (theirs.hr_size, theirs.unrolled_frames)
        assert dataclasses.asdict(ours.replace(num_resblock=3)) == \
            dataclasses.asdict(theirs.replace(num_resblock=3))


def test_entry_points_default_to_the_card():
    """With no device named, model_defs and the stream state build on the
    card, and raise where none is visible: no silent CPU fallback."""
    cfg = TecoConfig(num_resblock=1, precision="fp32")
    init_fn, _ = build_stream_inference(cfg)
    if torch.cuda.is_available():
        assert model_defs(cfg).conv_in.weight.device.type == "cuda"
        assert init_fn((1, 4, 4, 3)).prev_lr.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            model_defs(cfg)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            init_fn((1, 4, 4, 3))
    assert model_defs(cfg, device="cpu").conv_in.weight.device.type == "cpu"
    assert init_fn((1, 4, 4, 3), device="cpu").prev_sr.device.type == "cpu"
