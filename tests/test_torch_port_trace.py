"""The port's spans (tecogan_tpu_torch/utils/spans.py) on the CPU, at a
tiny generator (2 resblocks, 4x8 LR frames, fp32): none is entered
without a profiler, the serving paths and the train step give their span
trees under ``torch.profiler``, and tracing changes no output bit."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
from tecogan_tpu_torch.engine.inference import (
    build_chunked_inference, build_clip_inference, build_quantized_clip_inference,
    build_stream_inference)
from tecogan_tpu_torch.engine.state import init_generator, init_state, model_defs
from tecogan_tpu_torch.engine.train import build_train_step
from tecogan_tpu_torch.tools.profile_train import SPANS as TRAIN_SPANS
from tecogan_tpu_torch.utils import spans
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

CFG = TecoConfig(num_resblock=2, precision="fp32", bug_parity=False)  # the fused route
T, CHUNK = 5, 2  # windows of 2, 2 and 1 frames
WINDOWS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread in this module: the suite runs several
    pytest workers on the machine's cores, where torch's default of a
    thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    params = init_generator(CFG, torch.Generator().manual_seed(0))
    model = model_defs(CFG, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    model.eval()
    clip = (torch.rand((1, T, 4, 8, 3), generator=torch.Generator().manual_seed(1))
            * 255).to(torch.uint8)
    prepare, _ = build_quantized_clip_inference(CFG)
    qtail = prepare(model, params, clip, frames=2)
    return model, clip, qtail


def _traced(fn):
    """``fn()`` under the profiler -> (its result, Counter of (parent span,
    span) over the ``teco.*`` events; the parent is the nearest enclosing
    ``teco.*`` event or None)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    tree = Counter()
    for ev in prof.events():
        if not ev.name.startswith(spans.PREFIX):
            continue
        up = ev.cpu_parent
        while up is not None and not up.name.startswith(spans.PREFIX):
            up = up.cpu_parent
        strip = len(spans.PREFIX)
        tree[(None if up is None else up.name[strip:], ev.name[strip:])] += 1
    return out, tree


def _frame_tree(frames, warps, parent=None):
    """The spans of ``frames`` frames of the fused route."""
    return Counter({(parent, "frame"): frames, ("frame", "warp"): warps,
                    ("frame", "first_layer"): frames, ("frame", "trunk"): frames,
                    ("trunk", "trunk.resblocks"): frames,
                    ("trunk", "trunk.upsample"): frames, ("frame", "conv_out"): frames})


def _stream(model, clip, cfg=CFG):
    init_fn, step_fn = build_stream_inference(cfg)
    state = init_fn((1, 4, 8, 3), device="cpu")
    out = []
    for t in range(clip.shape[1]):
        state, sr = step_fn(model, state, clip[:, t])
        out.append(sr)
    return torch.stack(out, dim=1)


def _train_step():
    cfg = CFG.replace(crop_size=8, RNN_N=3, num_resblock=1, discrim_resblocks=1,
                      discrim_channels=8, batch_size=1)
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    lr, hr = synthetic_scene_batch(1, 3, 8)
    _, metrics, sr = build_train_step(cfg, device="cpu")(
        state, torch.from_numpy(lr), torch.from_numpy(hr))
    return metrics, sr


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range was entered with no profiler running")


def test_no_range_is_entered_without_a_profiler(setup, monkeypatch):
    model, clip, qtail = setup
    assert not torch.autograd._profiler_enabled()
    assert spans.span("frame") is spans.span("trunk")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    with spans.span("frame"):
        pass
    chunked = build_chunked_inference(CFG, out_u8=True)
    chunked(model, clip, chunk=CHUNK)
    chunked(model, clip, chunk=CHUNK, qtail=qtail)
    _stream(model, clip)
    build_clip_inference(CFG.replace(use_pallas=False))(model, clip)
    metrics, _ = _train_step()
    assert bool(torch.isfinite(metrics["gen_loss"]))


@pytest.mark.parametrize("int8", [False, True], ids=["float_tail", "int8_tail"])
def test_chunked_loop_span_tree(setup, int8):
    model, clip, qtail = setup
    chunked = build_chunked_inference(CFG, out_u8=True)
    out, tree = _traced(lambda: chunked(model, clip, chunk=CHUNK,
                                        qtail=qtail if int8 else None))
    want = _frame_tree(T, T - 1)
    for name in ("upload", "output", "copy_start", "copy_wait"):
        want[(None, name)] = WINDOWS
    assert tree == want
    assert tuple(out.shape) == (1, T, 16, 32, 3) and out.dtype == torch.uint8


def test_stream_step_span_tree(setup):
    model, clip, _ = setup
    _, tree = _traced(lambda: _stream(model, clip))
    want = _frame_tree(T, T - 1)
    want.update({(None, "upload"): T, (None, "output"): T})
    assert tree == want


def test_exact_route_span_tree(setup):
    """The exact route (no fused kernels): the frame, its warp and the
    trunk's two parts, which ``Generator`` records itself."""
    model, clip, _ = setup
    _, tree = _traced(lambda: build_clip_inference(CFG.replace(use_pallas=False))(model, clip))
    assert tree == Counter({(None, "frame"): T, ("frame", "warp"): T - 1,
                            ("frame", "trunk.resblocks"): T,
                            ("frame", "trunk.upsample"): T})


@pytest.mark.parametrize("path", ["chunked", "stream", "chunked_int8"])
def test_outputs_are_bit_identical_with_and_without_tracing(setup, path):
    model, clip, qtail = setup
    chunked = build_chunked_inference(CFG)
    run = {"chunked": lambda: chunked(model, clip, chunk=CHUNK),
           "stream": lambda: _stream(model, clip),
           "chunked_int8": lambda: chunked(model, clip, chunk=CHUNK, qtail=qtail)}[path]
    plain = run()
    traced, tree = _traced(run)
    assert tree[(None, "frame")] == T
    assert torch.equal(plain, traced)


def test_train_step_spans_are_recorded():
    (metrics, _), tree = _traced(_train_step)
    recorded = {name for (_, name) in tree}
    assert {s[len(spans.PREFIX):] for s in TRAIN_SPANS} <= recorded
    for name in ("gen_objective", "gen_backward", "disc_step", "adam"):
        assert tree[(None, name)] == 1, (name, tree)
    assert bool(torch.isfinite(metrics["gen_loss"]))
