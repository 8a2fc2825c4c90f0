"""The plain reference of the ``tecogan_df`` architecture
(benchmark/architectures/tecogan_df/reference/) held to the port on the
CPU at a small size, and its controls shown to fail the check's limits.

The port runs its kernels' plain versions on the CPU.  The generator
keeps its published depth (16 residual blocks of 64 channels), since the
depth is what amplifies a lower precision's rounding; the frames are
small (16 x 24 LR).
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import check, inputs
from benchmark.architectures import tecogan_df
from benchmark.architectures.tecogan_df.reference import controls, int8, tecogan as ref
from benchmark.reference.frames import dequant, to_u8

LIMITS = Path(__file__).resolve().parents[1] / "limits"
H, W, T = 16, 24, 6
GAIN = json.loads((Path(__file__).resolve().parents[1] / "configs"
                   / "tecogan-g16-bf16.json").read_text())["weight_gain"]


def _port(nrb=16, precision="bf16"):
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.engine import inference
    from tecogan_tpu_torch.engine.state import model_defs

    cfg = TecoConfig(num_resblock=nrb, precision=precision, bug_parity=False,
                     use_pallas=True, warp_group=4)
    return cfg, inference, model_defs(cfg, device="cpu")


def _served_stream(seed, nrb=16, precision="bf16"):
    """The port's stream over a seeded clip: the served uint8 frames and
    the carries."""
    from tecogan_tpu_torch.ops.image import transfer_to_uint8

    cfg, inference, model = _port(nrb, precision)
    params = inputs.uniform_params(seed, tecogan_df.param_shapes(nrb), GAIN, "cpu")
    model.load_state_dict(params)
    clip = inputs.make_clip(seed, ("test",), T, H, W, 76, "cpu")
    init, step = inference.build_stream_inference(cfg)
    state = init((1, H, W, 3), device="cpu")
    served, carries = [], []
    for t in range(T):
        state, sr = step(model, state, clip[t][None])
        served.append(transfer_to_uint8(sr))
        carries.append(state.prev_sr)
    return params, clip, served, carries


def _limit(cell, name):
    return json.loads((LIMITS / f"{cell}.json").read_text())[name]["limit"]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_follows_the_port_free_running(seed):
    params, clip, served, _ = _served_stream(seed)
    with torch.no_grad():
        for t, want in ref.run_clip(params, clip[None], 16):
            mae, far = check.gap(served[t], want)
            assert mae <= _limit("bf16-archive", "frame_mae_worst"), (t, mae)
            assert far <= _limit("bf16-archive", "far8_pct_worst"), (t, far)


def test_reference_feedback_is_the_warp_kernels_plain_version():
    from tecogan_tpu_torch.ops.kernels.warp_s2d import warp_s2d_feedback_reference

    g = torch.Generator().manual_seed(5)
    carry = torch.rand((1, H, W, 48), generator=g).to(torch.bfloat16)
    prev_lr = torch.rand((1, H, W, 3), generator=g) * 0.3
    port = warp_s2d_feedback_reference(carry, prev_lr)
    mine = ref.feedback(ref.carry_to_frame(carry), prev_lr).permute(0, 2, 3, 1)
    assert torch.allclose(mine, port, atol=1e-6, rtol=0)


def test_teacher_forced_step_and_handoff():
    params, clip, served, carries = _served_stream(7)
    with torch.no_grad():
        for t in range(1, T):
            want = to_u8(ref.frame(params, dequant(clip[t][None]),
                                   ref.carry_to_frame(carries[t - 1]),
                                   dequant(clip[t - 1][None]), 16))
            assert check.gap(served[t], want)[0] <= _limit("bf16-live", "step_mae_worst")
            left = to_u8(ref.carry_to_frame(carries[t]))
            assert torch.equal(left, served[t])


@pytest.mark.parametrize("seed", [3, 9])
def test_fp8_control_fails_the_limits(seed):
    params, clip, served, carries = _served_stream(seed)
    with torch.no_grad():
        worst_free = worst_step = 0.0
        frames = dict(ref.run_clip(params, clip[None], 16))
        for t, ctl in ref.run_clip(params, clip[None], 16, quant=controls.fp8_quant):
            worst_free = max(worst_free, check.gap(ctl, frames[t])[0])
        for t in range(1, T):
            args = (dequant(clip[t][None]), ref.carry_to_frame(carries[t - 1]),
                    dequant(clip[t - 1][None]), 16)
            want = to_u8(ref.frame(params, *args))
            ctl = to_u8(ref.frame(params, *args, quant=controls.fp8_quant))
            worst_step = max(worst_step, check.gap(ctl, want)[0])
    assert worst_free > _limit("bf16-archive", "frame_mae_worst")
    assert worst_step > _limit("bf16-live", "step_mae_worst")


def _int8_served(seed, precision):
    cfg, inference, model = _port(16, precision)
    params = inputs.uniform_params(seed, tecogan_df.param_shapes(16), GAIN, "cpu")
    model.load_state_dict(params)
    calib = inputs.make_clip(seed, ("calibration",), 8, H, W, 76, "cpu")
    clip = inputs.make_clip(seed, ("test",), T, H, W, 76, "cpu")
    prepare, _ = inference.build_quantized_clip_inference(cfg)
    qtail = prepare(model, params, calib[None], frames=8)
    chunked = inference.build_chunked_inference(cfg, out_u8=True)
    out = chunked(model, clip[None], chunk=4, qtail=qtail)
    return params, calib, clip, out[0]


def test_int8_reference_follows_the_port():
    params, calib, clip, served = _int8_served(4, "bf16")
    with torch.no_grad():
        tail = int8.tail_conv_from(int8.quantize(params, int8.calibrate(params, calib[None])))
        for t, want in ref.run_clip(params, clip[None], 16, tail_conv=tail):
            mae, far = check.gap(served[t][None], want)
            assert mae <= _limit("int8-archive", "frame_mae_worst"), (t, mae)
            assert far <= _limit("int8-archive", "far8_pct_worst"), (t, far)


def test_int8_reference_scales_match_the_ports_in_float32():
    """In float32 the port's calibration and the reference's agree: on
    frame 0, which reads no carry, the same maxima to float32 rounding
    (later frames read the port's bf16 carry); the same integer weights."""
    from tecogan_tpu_torch.engine.quant import calibrate_clip, quantize_tail

    cfg, inference, model = _port(2, "fp32")
    params = inputs.uniform_params(1, tecogan_df.param_shapes(2), GAIN, "cpu")
    model.load_state_dict(params)
    calib = inputs.make_clip(1, ("calibration",), 4, H, W, 76, "cpu")
    theirs = calibrate_clip(model, dequant(calib[None]), 1)
    mine = int8.calibrate(params, calib[None], 1, 2)
    assert set(theirs) == set(mine)
    for k in mine:
        assert torch.allclose(theirs[k], mine[k], rtol=1e-5, atol=0), k
    q = quantize_tail(params, theirs, device="cpu")
    qm = int8.quantize(params, mine)
    for k in mine:
        w = qm[k]["wq"]
        if k in int8.TRANSPOSED:
            w = w.flip(2, 3).permute(1, 2, 3, 0)
        else:
            w = w.permute(0, 2, 3, 1)
        assert torch.equal(w.to(torch.int8), q[k]["wq"]), k


def test_int4_control_fails_the_limits():
    params, calib, clip, served = _int8_served(4, "bf16")
    with torch.no_grad():
        tail = int8.tail_conv_from(int8.quantize(params, int8.calibrate(params, calib[None])))
        frames = dict(ref.run_clip(params, clip[None], 16, tail_conv=tail))
        ctl_tail = controls.int4_tail(params, calib[None], 8, 16)
        worst = max(check.gap(ctl, frames[t])[0]
                    for t, ctl in ref.run_clip(params, clip[None], 16, tail_conv=ctl_tail))
    assert worst > _limit("int8-archive", "frame_mae_worst")
