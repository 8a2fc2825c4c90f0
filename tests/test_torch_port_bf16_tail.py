"""The bf16 tail on the fused conv ops (CPU): the ops' plain versions
against the modules' chain of torch ops, the bf16 fused route against the
route as it ran on the modules, which route takes the ops, and that the
train step never does.  The CUDA kernels are held to these plain versions
in ``tests/test_torch_port_cuda.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine import bf16_tail, inference, quant
from tecogan_tpu_torch.engine.fused import (fused_first_frame_s2d, fused_sr_step_s2d,
                                            s2d_to_frame)
from tecogan_tpu_torch.engine.state import (init_discriminator, init_generator, model_defs,
                                            state_from_params)
from tecogan_tpu_torch.engine.train import build_train_step
from tecogan_tpu_torch.models.layers import Conv, ConvTranspose2x
from tecogan_tpu_torch.ops.kernels import bf16_conv
from tecogan_tpu_torch.data.synthetic import synthetic_scene_batch
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

CFG = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
# as tests/test_torch_port_inference.py: conv kernels scaled by 2.5 and LR
# clips in [0, 0.3], so that the output depends on the input and the warp
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3

# (transposed, B, H, W, Cin, Cout): the tail's nine layer shapes (LR
# resblock convs, up1, trunk_rb1, trunk_rb2, up2, conv_hr) at reduced H and
# W, then widths that are not a multiple of 64, H = 1, B = 3
LAYER_SHAPES = [(False, 1, 6, 10, 64, 64), (True, 1, 6, 10, 64, 64),
                (False, 1, 12, 20, 64, 64), (False, 1, 12, 20, 64, 128),
                (False, 1, 12, 20, 128, 128), (True, 1, 12, 20, 128, 128),
                (False, 1, 24, 40, 128, 64), (False, 2, 5, 67, 64, 64),
                (True, 1, 3, 65, 128, 64), (False, 1, 1, 130, 128, 128),
                (True, 3, 2, 33, 64, 128)]


def _model(seed=0, cfg=CFG):
    sd = generator_state_dict_from_jax(init_generator(cfg, torch.Generator().manual_seed(seed)))
    sd = {k: v * KERNEL_GAIN if k.endswith("weight") else v for k, v in sd.items()}
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(sd)
    return model.eval(), sd


def _clip(seed=0, shape=(1, 5, 6, 10, 3)):
    return torch.from_numpy(
        np.random.default_rng(seed).random(shape, np.float32) * np.float32(CLIP_RANGE))


@pytest.mark.parametrize("shape", LAYER_SHAPES)
@pytest.mark.parametrize("bias,relu,residual", [(True, True, False), (False, False, True),
                                                (True, False, True), (False, True, False)])
def test_plain_op_is_the_modules_chain(shape, bias, relu, residual):
    """The op on CPU tensors (its plain version) equals, bit for bit, the
    layer's module (channels_last bf16, as the serving generator holds it)
    followed by F.relu and + residual, on the kernel layout of its weight."""
    up, B, H, W, cin, cout = shape
    g = torch.Generator().manual_seed(cin + cout + W)
    module = (ConvTranspose2x(cin, cout, dtype=torch.bfloat16) if up else
              Conv(cin, cout, bias=bias, dtype=torch.bfloat16))
    if up and not bias:
        module.bias = None
    module.to(memory_format=torch.channels_last)
    x = torch.randn((B, H, W, cin), generator=g).bfloat16()
    s = 2 if up else 1
    res = torch.randn((B, s * H, s * W, cout), generator=g).bfloat16() if residual else None
    w = module.weight.detach()
    wk = w.flip(2, 3).permute(1, 2, 3, 0) if up else w.permute(0, 2, 3, 1)
    b = None if module.bias is None else module.bias.detach()
    with torch.inference_mode():
        want = module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if relu:
            want = F.relu(want)
        if residual:
            want = want + res
        op = bf16_conv.bf16_up2x if up else bf16_conv.bf16_conv3x3
        got = op(x, wk.contiguous(), b, relu, res)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (B, s * H, s * W, cout)
    assert torch.equal(got, want)


def test_kernel_weight_layouts_round_trip():
    """The kernel layout maps back to the modules' weights exactly, in the
    channels_last layout the serving generator holds them."""
    w = torch.randn(64, 3, 3, 128).bfloat16()
    conv = bf16_conv.conv_weight(w)
    assert torch.equal(conv.permute(0, 2, 3, 1), w)
    assert conv.is_contiguous(memory_format=torch.channels_last)
    tr = bf16_conv.conv_transpose_weight(w)
    assert tr.shape == (128, 64, 3, 3)
    assert tr.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(tr.flip(2, 3).permute(1, 2, 3, 0), w)


def test_tail_on_the_ops_is_the_modules_tail():
    model, _ = _model()
    net = torch.rand((2, 6, 10, 64), generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.inference_mode():
        got = bf16_tail.tail_features_bf16(model, net)
        want = model.tail_features(net)
    assert got.is_contiguous() and got.shape == (2, 24, 40, 64)
    assert torch.equal(got, want)


def _module_route_clip(model, clip):
    """The fused route as it ran before the ops: the modules' tail."""
    frames, carry = [], None
    with torch.inference_mode():
        for t in range(clip.shape[1]):
            carry = (fused_first_frame_s2d(model, clip[:, 0]) if carry is None else
                     fused_sr_step_s2d(model, carry, clip[:, t - 1], clip[:, t]))
            frames.append(s2d_to_frame(carry).float())
    return torch.stack(frames, dim=1)


def test_bf16_fused_route_gives_the_frames_it_gave_on_the_modules():
    """The clip, the chunked loop (u8 in) and the stream on the CPU: the
    same frames, bit for bit, as the route on the modules' tail."""
    model, _ = _model()
    clip = _clip()
    want = _module_route_clip(model, clip)
    assert torch.equal(inference.build_clip_inference(CFG)(model, clip), want)
    assert torch.equal(inference.build_chunked_inference(CFG)(model, clip, chunk=2), want)
    init_fn, step_fn = inference.build_stream_inference(CFG)
    state = init_fn((1, 6, 10, 3), device="cpu")
    for t in range(clip.shape[1]):
        state, frame = step_fn(model, state, clip[:, t])
        assert torch.equal(frame, want[:, t]), t
    clip_u8 = (clip * 255).round().to(torch.uint8)
    want_u8 = _module_route_clip(model, clip_u8.float() / 255)
    assert torch.equal(inference.build_chunked_inference(CFG)(model, clip_u8, chunk=3),
                       want_u8)


def _count_tail(monkeypatch):
    calls = []
    real = inference.tail_features_bf16

    def counted(model, net):
        calls.append(model.dtype)
        return real(model, net)

    monkeypatch.setattr(inference, "tail_features_bf16", counted)
    return calls


@pytest.mark.parametrize("precision,bug_parity,use_pallas,takes",
                         [("bf16", False, True, True), ("fp32", False, True, False),
                          ("bf16", True, True, False), ("bf16", False, False, False)])
def test_route_takes_the_ops_for_a_bf16_fused_model(monkeypatch, precision, bug_parity,
                                                    use_pallas, takes):
    """Only the fused route with a bf16 model takes the fused ops (once a
    frame); the fp32 fused route and the exact routes run the modules."""
    calls = _count_tail(monkeypatch)
    cfg = CFG.replace(precision=precision, bug_parity=bug_parity, use_pallas=use_pallas)
    model, _ = _model(cfg=cfg)
    inference.build_clip_inference(cfg)(model, _clip(shape=(1, 3, 6, 10, 3)))
    assert calls == ([torch.bfloat16] * 3 if takes else [])


def test_int8_route_does_not_take_the_bf16_ops(monkeypatch):
    calls = _count_tail(monkeypatch)
    model, sd = _model()
    clip = _clip(shape=(1, 3, 6, 10, 3))
    prepare, infer = inference.build_quantized_clip_inference(CFG)
    qtail = prepare(model, sd, clip, frames=2)
    infer(model, qtail, clip)
    inference.build_chunked_inference(CFG)(model, clip, chunk=2, qtail=qtail)
    assert calls == []


def _raise(*args, **kwargs):
    raise AssertionError("the train step reached a bf16 fused conv op")


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_train_step_never_reaches_the_ops(monkeypatch, precision):
    """A stub op that raises: the serving route reaches it, the train step
    (Generator under autograd) never does."""
    monkeypatch.setattr(bf16_conv, "bf16_conv3x3", _raise)
    monkeypatch.setattr(bf16_conv, "bf16_up2x", _raise)
    model, _ = _model()
    with pytest.raises(AssertionError, match="reached"):
        inference.build_clip_inference(CFG)(model, _clip(shape=(1, 1, 6, 10, 3)))
    cfg = TecoConfig(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                     discrim_channels=16, batch_size=2, precision=precision)
    g = torch.Generator().manual_seed(0)
    state = state_from_params(cfg, init_generator(cfg, g), *init_discriminator(cfg, g),
                              device="cpu")
    step = build_train_step(cfg, device="cpu")
    lr, hr = synthetic_scene_batch(2, 9, 8, seed=0)
    state, metrics, _ = step(state, torch.from_numpy(lr), torch.from_numpy(hr))
    assert np.isfinite(float(metrics["gen_loss"]))


def test_tail_reads_the_parameters_as_they_are_at_the_call():
    """A load_state_dict, an in-place update and ``functional_call`` binding
    other tensors (as the exported windows bind theirs) all reach the ops."""
    model, sd = _model()
    net = torch.rand((1, 6, 10, 64), generator=torch.Generator().manual_seed(2)).bfloat16()

    def agree(m):
        with torch.inference_mode():
            got = bf16_tail.tail_features_bf16(m, net)
            assert torch.equal(got, m.tail_features(net))
        return got

    first = agree(model)
    model.load_state_dict({k: v * 0.5 for k, v in sd.items()})  # in place
    second = agree(model)
    assert not torch.equal(second, first)
    with torch.no_grad():
        model.up1.weight.add_(0.01)
    assert not torch.equal(agree(model), second)

    class Window(torch.nn.Module):  # as inference._Window binds its params
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, x):
            return bf16_tail.tail_features_bf16(self.model, x), self.model.tail_features(x)

    params = {f"model.{k}": v.detach() * 0.5 for k, v in model.named_parameters()}
    with torch.inference_mode():
        got, want = torch.func.functional_call(Window(), params, (net,))
        assert torch.equal(got, want)
        assert not torch.equal(got, bf16_tail.tail_features_bf16(model, net))


def test_kernel_weight_of_a_channels_last_conv_is_a_view():
    """The serving generator's channels_last 3x3 weights reach the kernel
    as views, with no copy; a transposed layer's is the flipped copy."""
    conv = Conv(64, 128, dtype=torch.bfloat16).to(memory_format=torch.channels_last)
    w = quant.forward_kernel(conv.weight.detach(), False)
    assert w.is_contiguous() and w.data_ptr() == conv.weight.data_ptr()
    up = ConvTranspose2x(64, 64, dtype=torch.bfloat16).to(memory_format=torch.channels_last)
    wt = quant.forward_kernel(up.weight.detach(), True).contiguous()
    assert torch.equal(bf16_conv.conv_transpose_weight(wt), up.weight.detach())
