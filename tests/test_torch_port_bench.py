"""Port parity, the measurement programs (tecogan_tpu_torch/tools/bench.py,
bench_serving.py, bench_quant.py, bench_train.py, bench_train_scaling.py)
against the JAX repo's (bench.py, tools/bench_*.py), on the CPU at tiny
sizes (``device="cpu"``; one torch thread).

Bars:

* each record has the JAX tool's keys, less ``vs_baseline`` (a TPU
  target), plus ``card`` (and the scaling step's
  ``max_memory_allocated_gib``);
* ``gen_tflop_per_frame`` and ``train_tflop_per_step`` equal the JAX
  package's ``utils/flops.py`` on the same shapes, to float64 rounding
  (``FLOP_RTOL``); ``mfu`` and ``train_mfu`` are the achieved rate over the
  H100's 989 TFLOP/s bf16 dense peak;
* each stream of a B = 3 clip is bit-equal to that stream served alone;
* ``int8_vs_bf16_psnr_db`` on JAX-made weights read through
  ``--g_checkpoint`` lies within ``PSNR_DB`` of the same quantity from
  JAX's ``build_clip_inference`` / ``build_quantized_clip_inference``
  (40.89 dB JAX, 41.06 dB port, measured): jitted JAX fuses the bf16
  roundings the port makes eagerly, so the two int8 outputs agree in
  their noise's level, not bit for bit.  The generator's kernels are
  scaled by ``KERNEL_GAIN`` (as tests/test_torch_port_quant.py does), or
  its output ignores the input and both routes give the same frames;
* in ``bench_train_scaling`` an injected ``torch.cuda.OutOfMemoryError``
  gives an ``error`` line and the run goes on; any other exception
  propagates;
* every ``main`` runs on the card alone: without one it raises;
* the programs import nothing of JAX (a fresh interpreter).
"""

import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.inference import build_clip_inference as j_build_clip_inference
from tecogan_tpu.engine.inference import (
    build_quantized_clip_inference as j_build_quantized_clip_inference)
from tecogan_tpu.engine.state import model_defs as j_model_defs
from tecogan_tpu.utils import flops as j_flops
from tecogan_tpu.utils.checkpoint import save_generator_params as j_save_generator_params
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.tools import (bench, bench_quant, bench_serving, bench_train,
                                     bench_train_scaling)
from tecogan_tpu_torch.utils.flops import H100_PEAK_BF16_FLOPS

FLOP_RTOL = 1e-12
PSNR_DB = 0.5
KERNEL_GAIN = 2.5
H, W, FRAMES = 8, 12, 3
SERVE = TecoConfig(precision="bf16", num_resblock=2, bug_parity=False)
TRAIN = TecoConfig(crop_size=8, RNN_N=9, num_resblock=2, discrim_resblocks=1,
                   discrim_channels=16, batch_size=2)
SCALING = bench_train_scaling.scaling_config(8).replace(
    RNN_N=3, num_resblock=2, discrim_resblocks=1, discrim_channels=16)

# the JAX tools' record keys, by file:line
JAX_KEYS = {
    # bench.py:69-77, 100-101
    "bench": {"metric", "value", "unit", "vs_baseline", "gen_tflop_per_frame",
              "achieved_tflops", "mfu", "fps_int8_serving", "int8_speedup"},
    # tools/bench_serving.py:55-62
    "bench_serving": {"metric", "batch", "frames", "value", "unit",
                      "per_stream_ms_per_frame"},
    # tools/bench_quant.py:68-75
    "bench_quant": {"metric", "fps_bf16", "fps_int8", "speedup", "int8_vs_bf16_psnr_db",
                    "checkpoint"},
    # tools/bench_train.py:56-63
    "bench_train": {"metric", "value", "unit", "steps_per_s", "train_tflop_per_step",
                    "achieved_tflops", "mfu"},
    # tools/bench_train_scaling.py:70-77; the error line :64-65
    "bench_train_scaling": {"metric", "batch", "crop", "ms_per_step", "samples_per_sec",
                            "train_tflop_per_step", "train_mfu"},
    "bench_train_scaling_error": {"batch", "crop", "error"},
}
PORT_EXTRA = {"bench_train_scaling": {"max_memory_allocated_gib"}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(tool, rec):
    want = (JAX_KEYS[tool] - {"vs_baseline"}) | {"card"} | PORT_EXTRA.get(tool, set())
    assert set(rec) == want, (tool, sorted(set(rec) ^ want))
    assert rec["card"] == "cpu"
    assert all(math.isfinite(v) for v in rec.values() if isinstance(v, float))


def _close(got, want):
    assert abs(got - want) <= FLOP_RTOL * abs(want), (got, want)


def test_bench_record():
    rec = bench.run(SERVE, device="cpu", h=H, w=W, frames=FRAMES, reps=1)
    _keys("bench", rec)
    assert rec["metric"] == "recurrent_4x_vsr_inference_270p_to_1080p"
    assert rec["unit"] == "fps/gpu"
    want = j_flops.inference_mfu(rec["value"], H, W, SERVE.num_resblock,
                                 peak_flops=H100_PEAK_BF16_FLOPS)
    for k in ("gen_tflop_per_frame", "achieved_tflops", "mfu"):
        _close(rec[k], want[k])
    _close(rec["mfu"], rec["achieved_tflops"] * 1e12 / 989e12)
    _close(rec["int8_speedup"], rec["fps_int8_serving"] / rec["value"])


def test_bench_serving_records():
    recs = list(bench_serving.run(SERVE, device="cpu", batches=(1, 3), h=H, w=W,
                                  frames=FRAMES, reps=1))
    assert [r["batch"] for r in recs] == [1, 3]
    for r in recs:
        _keys("bench_serving", r)
        # tools/bench_serving.py:42: Tb = max(8, T // B)
        assert r["frames"] == max(8, FRAMES // r["batch"])
        assert r["unit"] == "fps/gpu" and r["metric"] == "serving_aggregate_fps"
        _close(r["per_stream_ms_per_frame"], r["batch"] * 1e3 / r["value"])


def test_each_stream_of_a_batch_is_the_stream_served_alone():
    model, _ = bench.serving_model(SERVE, torch.device("cpu"))
    clip = bench.lr_clip(np.random.default_rng(3), (3, 8, H, W, 3), torch.device("cpu"))
    got = bench_serving.streams_alone(SERVE, model, clip)
    assert got == {"bit_equal": True, "max_abs": 0.0, "min_psnr_db": math.inf}


def test_bench_quant_psnr_matches_jax_on_jax_weights(tmp_path):
    jcfg = JaxTecoConfig(precision="bf16", num_resblock=2, bug_parity=False)
    gen, _ = j_model_defs(jcfg)
    params = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51), jnp.float32))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * KERNEL_GAIN if path[-1].key == "kernel" else a, params)
    ckpt = str(tmp_path / "g.ckpt")
    j_save_generator_params(ckpt, params)
    frames = bench.CALIB_FRAMES
    rec = bench_quant.run(SERVE, device="cpu", g_checkpoint=ckpt, h=H, w=W, frames=frames,
                          reps=1)
    _keys("bench_quant", rec)
    assert rec["checkpoint"] == ckpt
    _close(rec["speedup"], rec["fps_int8"] / rec["fps_bf16"])
    # the JAX tool's clip and PSNR (tools/bench_quant.py:50-67)
    clip = jnp.asarray(np.random.default_rng(0).random((1, frames, H, W, 3), np.float32))
    sr = j_build_clip_inference(jcfg)(params, clip)
    prepare, infer_q = j_build_quantized_clip_inference(jcfg)
    sr_q = infer_q(params, prepare(params, clip, frames=8), clip)
    mse = float(np.mean((np.asarray(sr_q) - np.asarray(sr)) ** 2))
    want = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert want < 60.0  # the scaled weights make the quantization visible
    assert abs(rec["int8_vs_bf16_psnr_db"] - want) <= PSNR_DB, (rec["int8_vs_bf16_psnr_db"], want)


def test_bench_train_records():
    recs = list(bench_train.run(TRAIN, device="cpu", reps=1))
    assert [r["metric"] for r in recs] == ["train_parity", "train_fixed_bptt",
                                           "train_fixed_bptt_bf16"]
    for r, bug_parity in zip(recs, (True, False, False)):
        _keys("bench_train", r)
        assert r["unit"] == "ms/step"
        want = j_flops.train_mfu(r["value"], TRAIN.batch_size, TRAIN.RNN_N, TRAIN.crop_size,
                                 TRAIN.num_resblock, TRAIN.discrim_resblocks,
                                 TRAIN.discrim_channels, pingpang=False, bug_parity=bug_parity,
                                 peak_flops=H100_PEAK_BF16_FLOPS)
        for k in ("train_tflop_per_step", "achieved_tflops", "mfu"):
            _close(r[k], want[k])
        _close(r["steps_per_s"], 1e3 / r["value"])
    assert torch.backends.cudnn.allow_tf32  # the fp32 modes restore it


def _scaling_tflop(b):
    return j_flops.train_step_macs(b, SCALING.RNN_N, SCALING.crop_size, SCALING.num_resblock,
                                   SCALING.discrim_resblocks, SCALING.discrim_channels,
                                   pingpang=True, bug_parity=False) * 2 / 1e12


def test_bench_train_scaling_goes_on_past_an_out_of_memory_batch(monkeypatch):
    real = bench_train_scaling.build_train_step

    def build(cfg, **kw):
        if cfg.batch_size == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(cfg, **kw)

    monkeypatch.setattr(bench_train_scaling, "build_train_step", build)
    err, rec = bench_train_scaling.run(SCALING, device="cpu", batches=(1, 2), reps=1)
    _keys("bench_train_scaling_error", err)
    assert err["batch"] == 1 and "out of memory (injected)" in err["error"]
    _keys("bench_train_scaling", rec)
    assert rec["metric"] == "train_step_convergence_cfg"
    assert (rec["batch"], rec["crop"], rec["max_memory_allocated_gib"]) == (2, 8, None)
    _close(rec["train_tflop_per_step"], _scaling_tflop(2))
    _close(rec["train_mfu"], rec["train_tflop_per_step"] * 1e12 * rec["samples_per_sec"]
           / 2 / 989e12)
    _close(rec["samples_per_sec"], 2e3 / rec["ms_per_step"])


def test_bench_train_scaling_propagates_other_errors(monkeypatch):
    def build(cfg, **kw):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(bench_train_scaling, "build_train_step", build)
    with pytest.raises(RuntimeError, match="not a memory error"):
        list(bench_train_scaling.run(SCALING, device="cpu", batches=(1, 2), reps=1))


@pytest.mark.parametrize("tool,argv", [(bench, []), (bench_serving, ["1"]),
                                       (bench_quant, ["--frames", "3"]),
                                       (bench_train, []),
                                       (bench_train_scaling, ["--batches", "4"])])
def test_main_needs_the_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tool.main(argv)


def test_programs_run_without_jax():
    code = textwrap.dedent("""
        import sys
        from tecogan_tpu_torch.config import TecoConfig
        from tecogan_tpu_torch.tools import (bench, bench_quant, bench_serving, bench_train,
                                             bench_train_scaling)
        cfg = TecoConfig(precision="bf16", num_resblock=1, bug_parity=False)
        rec = bench.run(cfg, device="cpu", h=4, w=8, frames=2, reps=1)
        assert rec["card"] == "cpu", rec
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tecogan_tpu"))
        assert not bad, bad
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
