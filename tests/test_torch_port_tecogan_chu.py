"""TecoGAN as published on the port (CPU): the resizes of the published
code at their quarter offsets, the two new ops' plain versions against the
plain reference's formulas (``benchmark/architectures/tecogan_chu/
reference/model.py``, which imports nothing of the port), the published
route through the chunked loop and the stream step against that reference,
and dwight-foster's generator and 4-level FNet left as they were.  The
CUDA kernels are held to the plain versions on the card (``chip_smoke.py``
phase 19).

The sizes are small and odd on purpose: LR 26 x 40 floors FNet's pools
(26 -> 13 -> 6 -> 3) and pads 2 flow rows; 2 resblocks.  The weights are
the benchmark's seeded draw at its configuration's gains."""

import ast
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.architectures import tecogan_chu as arch
from benchmark.architectures.tecogan_chu.reference import model as ref
from benchmark.reference.frames import dequant
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine import inference, published
from tecogan_tpu_torch.engine.state import published_model_defs
from tecogan_tpu_torch.models import Generator
from tecogan_tpu_torch.models.fnet import FNet, PublishedFNet, pad_symmetric
from tecogan_tpu_torch.ops import resize
from tecogan_tpu_torch.ops.kernels import conv_out_bicubic_s2d as cb
from tecogan_tpu_torch.ops.kernels import flow_warp_s2d as fw
from tecogan_tpu_torch.utils import spans

H, W, T, CHUNK = 26, 40, 4, 3
NRB = 2
CONFIG = {"num_resblock": NRB, "weight_gain": 1.3, "fnet_weight_gain": 2.25,
          "calibration_frames": 0, "precision": "bf16"}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(precision: str, seed: int = 3):
    cfg = TecoConfig(num_resblock=NRB, precision=precision)
    params = arch.make_params(seed, CONFIG, "cpu")
    model = published_model_defs(cfg, device="cpu")
    model.load_state_dict(params)
    return cfg, model.eval(), params


def _clip(seed: int = 3, frames: int = T):
    return inputs.make_clip(seed, ("archive", 0), frames, H, W, 76, "cpu")[None]


# ---------------------------------------------------------------- the resizes


def test_upscale_four_tf_at_quarter_offsets():
    """Rows of ``[0, 4, 8]``: output row 4i + a is ``x[i] + a`` (offset a/4
    of the 4-level step), the last 4 rows repeat the last row."""
    x = torch.tensor([0.0, 4.0, 8.0]).view(1, 3, 1, 1)
    want = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 8, 8], dtype=torch.float32)
    assert torch.equal(resize.upscale_four_tf(x)[0, :, 0, 0], want)
    assert torch.equal(resize.upscale_four_tf(x.transpose(1, 2))[0, 0, :, 0], want)


def test_bicubic_four_at_quarter_offsets():
    """Rows ``[0, 1, 4, 9]``: row 4 + a (source row 1 at offset a/4) is
    ``w . [0, 1, 4, 9]`` with Keys' taps at a = -0.75, by hand: offset 0
    gives the source row, 1/4 ``.87890625 + 4 * .26171875 - 9 *
    .03515625``, 1/2 ``.59375 + 4 * .59375 - 9 * .09375``, 3/4
    ``.26171875 + 4 * .87890625 - 9 * .10546875``; row 0 reads row 0 twice
    (the edge repeated)."""
    x = torch.tensor([0.0, 1.0, 4.0, 9.0]).view(1, 4, 1, 1)
    got = resize.bicubic_four(x)[0, :, 0, 0]
    assert got[4:8].tolist() == [1.0, 1.609375, 2.125, 2.828125]
    assert got[0].item() == 0.0 and got[1].item() == 0.26171875 * 1.0 - 0.03515625 * 4.0
    assert torch.equal(resize.bicubic_four(x.transpose(1, 2))[0, 0, :, 0], got)


@pytest.mark.parametrize("a", [0, 1, 2, 3])
def test_bicubic_weights_are_keys_at_a_minus_075(a):
    t = torch.tensor(a / 4.0, dtype=torch.float64)
    d = torch.stack([1 + t, t, 1 - t, 2 - t])
    assert torch.equal(torch.tensor(resize.bicubic_weights(a / 4.0), dtype=torch.float64),
                       ref._keys(d))


def test_upscale_two_tf_is_tf1_legacy_bilinear():
    x = torch.tensor([[0.0, 2.0], [4.0, 8.0]]).view(1, 1, 2, 2)
    want = torch.tensor([[0, 1, 2, 2], [2, 3.5, 5, 5], [4, 6, 8, 8], [4, 6, 8, 8]])
    assert torch.equal(resize.upscale_two_tf(x)[0, 0], want)
    y = torch.rand(1, 5, 3, 7).contiguous(memory_format=torch.channels_last)
    out = resize.upscale_two_tf(y)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.allclose(out, ref.resize_linear(y, 2), rtol=0, atol=1e-6)


def test_fnet_pads_the_flow_symmetrically():
    x = torch.arange(4.0).view(1, 4, 1, 1).expand(1, 4, 3, 1)
    got = pad_symmetric(x, 7, 5)[0, :, :, 0]
    assert got[:, 0].tolist() == [0, 1, 2, 3, 3, 2, 1]
    assert got[0].tolist() == [0, 0, 0, 0, 0]
    fnet = PublishedFNet()
    assert fnet(torch.rand(1, H, W, 3), torch.rand(1, H, W, 3)).shape == (1, H, W, 2)


# ---------------------------------------------------------------- the two ops


def test_flow_warp_s2d_plain_version_is_the_references_warp():
    """The op's plain version (a float32 carry in, bf16 out) against the
    reference's upscale, warp and packing in float32, on flows that reach
    past the frame's edges: within one bf16 rounding of the value (2**-8
    of it); zero flow gives the carry back, rounded to bf16."""
    g = torch.Generator().manual_seed(0)
    carry = torch.rand((2, 7, 9, 48), generator=g)
    flow = (torch.rand((2, 7, 9, 2), generator=g) * 2 - 1) * 12
    got = fw.flow_warp_s2d(flow, carry).float()
    frame = ref.carry_to_frame(carry).permute(0, 3, 1, 2)
    want = F.pixel_unshuffle(
        ref.warp(frame, ref.resize_linear(flow.permute(0, 3, 1, 2) * 4.0, 4)), 4)
    want = want.permute(0, 2, 3, 1)
    assert ((got - want).abs() <= want.abs() * 2 ** -8 + 1e-6).all()
    assert torch.equal(fw.flow_warp_s2d(torch.zeros_like(flow), carry), carry.bfloat16())


def test_conv_out_bicubic_s2d_plain_version_is_the_references_output_layer():
    """The op's plain version (float32 out) against ``conv_out`` + the
    bicubic skip of the reference, packed: the same f32 sums, in another
    order (2**-18 of the value)."""
    g = torch.Generator().manual_seed(1)
    feat = torch.rand((1, 4 * 7, 4 * 9, 64), generator=g)
    kernel = torch.randn((3, 3, 64, 3), generator=g) * 0.05
    bias = torch.randn((3,), generator=g) * 0.1
    lr = torch.rand((1, 7, 9, 3), generator=g)
    got = cb.conv_out_bicubic_s2d(feat, kernel, bias, lr).float()
    p = {"c.weight": kernel.permute(3, 2, 0, 1), "c.bias": bias}
    want = ref._conv(feat.permute(0, 3, 1, 2), p, "c", None)
    want = want + ref.resize_bicubic4(lr.permute(0, 3, 1, 2))
    want = F.pixel_unshuffle(want, 4).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    assert ((got - want).abs() <= want.abs() * 2 ** -18 + 1e-5).all()


# ---------------------------------------------------------------- the route


def _reference_u8(params, clip):
    with torch.no_grad():
        return torch.stack([u8 for _, u8 in ref.run_clip(params, clip, NRB)], dim=1)


def _gap(a, b):
    d = (a.to(torch.int16) - b.to(torch.int16)).abs().float()
    return d.mean().item(), d.max().item()


# Tolerances in u8 levels of the served frames, each frame's mean |gap| and
# its largest.  float32: the feedback is held in bf16 (a rounding of 2**-9
# of a value near 0.3, 0.15 levels) and the sums run in another order, so
# a value can cross a level (1); bf16: every conv rounds its output to bf16
# too (2**-9 of each activation), so a value may cross two.  The routes
# read 0.0022 (float32) and 0.0071 (bf16) here; a warp fed a zero or a
# doubled flow reads 0.079-0.086 and zero feedback 0.76 (the test below),
# so the mean bar sits between the two.
TOL = {"fp32": (0.02, 1), "bf16": (0.02, 2)}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_published_route_matches_the_plain_reference(precision):
    cfg, model, params = _model(precision)
    clip = _clip()
    want = _reference_u8(params, clip)
    chunked = inference.build_chunked_inference(cfg, out_u8=True)(model, clip, chunk=CHUNK)
    init_fn, step_fn = inference.build_stream_inference(cfg)
    state, frames = init_fn((1, H, W, 3), device="cpu"), []
    for t in range(T):
        state, sr = step_fn(model, state, clip[:, t])
        frames.append(sr)
    stream = torch.stack(frames, dim=1)
    # the loops run the same per-frame functions: bit for bit
    assert torch.equal(inference.build_clip_inference(cfg)(model, clip), stream)
    assert torch.equal(chunked, (stream * 255.0).clamp(0, 255).to(torch.uint8))
    mae_bar, max_bar = TOL[precision]
    for t in range(T):
        mae, worst = _gap(chunked[:, t], want[:, t])
        assert mae <= mae_bar and worst <= max_bar, (t, mae, worst)


def test_published_frames_depend_on_the_flow_and_the_feedback():
    """A control the check above could not pass with a broken warp: frames
    served with the flow zeroed or doubled differ from the reference's by
    more than the bf16 tolerance, and so do frames served with zero
    feedback."""
    cfg, model, params = _model("fp32")
    clip = _clip()
    want = _reference_u8(params, clip)
    infer = inference.build_chunked_inference(cfg, out_u8=True)
    real = published._warp.flow_warp_s2d
    for broken in (lambda flow, carry: real(torch.zeros_like(flow), carry),
                   lambda flow, carry: real(2.0 * flow, carry),
                   lambda flow, carry: carry.new_zeros(carry.shape, dtype=torch.bfloat16)):
        published._warp.flow_warp_s2d = broken
        try:
            out = infer(model, clip, chunk=CHUNK)
        finally:
            published._warp.flow_warp_s2d = real
        assert max(_gap(out[:, t], want[:, t])[0] for t in range(1, T)) > TOL["bf16"][0]


def test_published_step_records_its_spans():
    cfg, model, _ = _model("bf16")
    clip = dequant(_clip(frames=2))
    with torch.profiler.profile() as prof:
        carry = published.first_frame(model, clip[:, 0])
        published.step(model, carry, clip[:, 0], clip[:, 1])
    names = {e.name for e in prof.events() if e.name.startswith(spans.PREFIX)}
    assert {spans.PREFIX + n for n in ("fnet", "flow_warp", "first_layer", "trunk",
                                       "trunk.resblocks", "trunk.upsample",
                                       "conv_out")} <= names


def test_int8_is_refused_for_the_published_model():
    cfg, model, params = _model("bf16")
    with pytest.raises(ValueError, match="dwight-foster"):
        inference.build_chunked_inference(cfg)(model, _clip(), chunk=CHUNK, qtail={})
    fused = cfg.replace(bug_parity=False, use_pallas=True)
    prepare, _ = inference.build_quantized_clip_inference(fused)
    with pytest.raises(ValueError, match="dwight-foster"):
        prepare(model, params, _clip())


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark/architectures/tecogan_chu/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top in ("", "torch", "benchmark", "__future__") or \
                    top in sys.stdlib_module_names, f"{path.name} imports {name}"
                assert not name.startswith("benchmark.") or \
                    name.startswith("benchmark.reference"), f"{path.name} imports {name}"


# ---------------------------------------------------------------- dwight-foster's, unchanged


def test_dwight_foster_models_keep_their_names():
    gen = Generator(num_resblock=2)
    want = ["conv_in.weight", "conv_in.bias"]
    for i in range(2):
        want += [f"resblock_{i}.Conv_0.weight", f"resblock_{i}.Conv_0.bias",
                 f"resblock_{i}.Conv_1.weight"]
    want += ["up1.weight", "up1.bias", "trunk_rb1.Conv_0.weight", "trunk_rb1.Conv_0.bias",
             "trunk_rb1.Conv_1.weight", "trunk_rb2.Conv_0.weight", "trunk_rb2.Conv_0.bias",
             "trunk_rb2.Conv_1.weight", "up2.weight", "up2.bias", "conv_hr.weight",
             "conv_hr.bias", "conv_out.weight", "conv_out.bias"]
    assert list(gen.state_dict()) == want
    fnet = FNet()
    names = list(fnet.state_dict())
    assert len(names) == 2 * (2 * 8 + 2) and names[0] == "_DownBlock_0.Conv_0.weight"
    assert names[-1] == "Conv_1.bias" and "_UpBlock_3.Conv_1.weight" in names
    assert fnet.Conv_0.in_channels == 64 and fnet._DownBlock_3.Conv_0.out_channels == 256


def test_dwight_foster_fnet_keeps_its_half_pixel_upsample_and_numbers():
    """The 4-level FNet's up blocks still resize with half-pixel centres
    (``ops.resize.upscale_two``), so its output equals the module chain
    written out here with ``F.interpolate``."""
    torch.manual_seed(0)
    fnet = FNet().eval()
    x = torch.rand(1, 16, 16, 6)
    net = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        for i in range(4):
            b = getattr(fnet, f"_DownBlock_{i}")
            net = F.max_pool2d(F.leaky_relu(b.Conv_1(F.leaky_relu(b.Conv_0(net), 0.2)), 0.2), 2)
        for i in range(4):
            b = getattr(fnet, f"_UpBlock_{i}")
            net = F.leaky_relu(b.Conv_1(F.leaky_relu(b.Conv_0(net), 0.2)), 0.2)
            net = F.interpolate(net, scale_factor=2, mode="bilinear", align_corners=False)
        net = fnet.Conv_1(F.leaky_relu(fnet.Conv_0(net), 0.2))
        want = (torch.tanh(net) * 24.0).permute(0, 2, 3, 1)
        assert torch.equal(fnet(x), want)


def test_the_published_model_holds_the_architectures_parameters():
    """The served model's ``state_dict`` is exactly the benchmark's
    parameter list: names and shapes."""
    _, model, _ = _model("fp32")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {n: s for n, s, _ in arch.param_shapes(NRB)}
