"""Port parity, exported serving: the hand kernels as ``torch.library``
custom ops, ``engine.inference.build_window_programs``,
``tools/export_infer.py`` and ``tools/serve_exported.py`` (CPU, where the
ops run their plain versions).

Bars: the window programs, live and exported, bit for bit the port's
chunked loop (the tail window padded with its last frame and trimmed);
served from a process that imports no ``models`` / ``engine`` module,
bit for bit too; against the JAX package's ``head_fn`` / ``cont_fn`` on
the fused route the fused bar of tests/test_torch_port_stream.py (50 dB,
conv kernels x 2.5, LR in [0, 0.3]).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxTecoConfig
from tecogan_tpu.engine.inference import build_chunked_inference as j_chunked
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.engine.inference import (build_chunked_inference,
                                                build_quantized_clip_inference,
                                                build_window_programs, window_params)
from tecogan_tpu_torch.engine.state import init_generator, model_defs
from tecogan_tpu_torch.tools import export_infer
from tecogan_tpu_torch.tools.serve_exported import load_programs, serve_exported
from tecogan_tpu_torch.utils.checkpoint import save_generator_params
from tecogan_tpu_torch.utils.convert import generator_state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = (1, 8, 12)  # (B, H, W) of an LR frame
K, T = 4, 10     # window and clip length: two full windows and a padded one
FUSED_PSNR_DB = 50.0
KERNEL_GAIN = 2.5
CLIP_RANGE = 0.3
OPS = ("conv_out_s2d", "warp_s2d_feedback", "int8_conv3x3", "int8_up2x")
# tools/export_infer.py's manifest keys in the JAX package
JAX_MANIFEST = {"platforms", "batch", "chunk", "height", "width", "precision", "num_resblock",
                "wire", "lr_window", "sr_window", "carry", "params", "protocol"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, seed=0, gain=1.0):
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else
                (v * np.float32(gain) if k == "kernel" else v) for k, v in tree.items()}
    return scale(init_generator(cfg, torch.Generator().manual_seed(seed)))


def _model(cfg, params):
    model = model_defs(cfg, device="cpu")
    model.load_state_dict(generator_state_dict_from_jax(params))
    return model.eval()


def _clip(seed, u8=False, scale=1.0):
    rng = np.random.default_rng(seed)
    if u8:
        return rng.integers(0, 256, (LR[0], T, *LR[1:], 3), dtype=np.uint8)
    return rng.random((LR[0], T, *LR[1:], 3), np.float32) * np.float32(scale)


def _windows(head, cont, p, clip, *extra):
    """Run ``clip`` through the programs as the serving protocol says."""
    clip = torch.as_tensor(clip)
    out, carry = [], None
    for pos in range(0, clip.shape[1], K):
        w = clip[:, pos:pos + K]
        k = w.shape[1]
        if k < K:
            w = torch.cat([w, w[:, -1:].expand(-1, K - k, -1, -1, -1)], dim=1)
        with torch.inference_mode():
            if carry is None:
                carry, sr = head(p, w.contiguous(), *extra)
            else:
                carry, sr = cont(p, carry, w.contiguous(), *extra)
        out.append(sr[:, :k])
    return torch.cat(out, dim=1)


def test_kernels_are_custom_ops():
    """The four hand kernels are ops of one namespace whose fakes give the
    real output's shape, dtype and strides (``torch.library.opcheck``),
    and on CPU tensors they are the plain versions."""
    from tecogan_tpu_torch.ops.kernels import conv_out_s2d as kmod
    from tecogan_tpu_torch.ops.kernels import int8_conv as qmod
    from tecogan_tpu_torch.ops.kernels import warp_s2d as wmod

    g = torch.Generator().manual_seed(0)
    feat = torch.rand((1, 8, 12, 64), generator=g).bfloat16()
    w, b = torch.rand((3, 3, 64, 3), generator=g) * 0.1, torch.rand((3,), generator=g)
    carry = torch.rand((1, 2, 3, 48), generator=g).bfloat16()
    prev = torch.rand((1, 2, 3, 3), generator=g)
    x = torch.rand((1, 4, 6, 64), generator=g).bfloat16()
    wq = torch.randint(-127, 128, (64, 3, 3, 64), dtype=torch.int8, generator=g)
    q = (torch.tensor(50.0), wq, torch.rand((64,), generator=g) * 1e-3)
    cases = {"conv_out_s2d": ((feat, w, b), kmod.conv_out_s2d_reference(feat, w, b)),
             "warp_s2d_feedback": ((carry, prev), wmod.warp_s2d_feedback_reference(carry, prev)),
             "int8_conv3x3": ((x, *q, torch.rand((64,), generator=g), True, None), None),
             "int8_up2x": ((x, *q, None, False, torch.rand((1, 8, 12, 64)).bfloat16()), None)}
    for name in OPS:
        op = getattr(torch.ops.tecogan_tpu_torch, name).default
        args, want = cases[name]
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, (name, result)
        got = op(*args)
        if want is None:
            plain = qmod.int8_up2x_reference if name == "int8_up2x" else \
                qmod.int8_conv3x3_reference
            want = plain(*args)
        assert got.is_contiguous() and torch.equal(got, want.to(got.dtype)), name


ROUTES = {"fused_fp32": (dict(precision="fp32"), False, False),
          "fused_bf16_u8": (dict(precision="bf16"), True, False),
          "exact_fp32": (dict(precision="fp32", use_pallas=False), False, False),
          "int8_bf16": (dict(precision="bf16"), True, True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_window_programs_equal_the_chunked_loop(route):
    """head + cont + padded cont, run live, equal the chunked loop; the
    programs are weight-agnostic (a second set of params through the
    same programs gives that model's clip)."""
    over, u8, quantized = ROUTES[route]
    cfg = TecoConfig(num_resblock=2, bug_parity=False, **over)
    clip = _clip(1, u8=u8)
    head, cont = build_window_programs(cfg, out_u8=u8, quantized=quantized)
    for seed in (0, 5):
        params = _params(cfg, seed)
        model = _model(cfg, params)
        extra, qtail = (), None
        if quantized:
            prepare, _ = build_quantized_clip_inference(cfg)
            qtail = prepare(model, params, _clip(2))
            extra = (qtail,)
        want = build_chunked_inference(cfg, out_u8=u8)(model, clip, chunk=K, qtail=qtail)
        got = _windows(head, cont, window_params(model), clip, *extra)
        assert got.dtype == (torch.uint8 if u8 else torch.float32)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="fused"):
        build_window_programs(cfg.replace(use_pallas=False), quantized=True)


def _export(out, *extra):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        manifest = export_infer.main(["--out", str(out), "--height", str(LR[1]), "--width",
                                      str(LR[2]), "--chunk", str(K), "--num_resblock", "2",
                                      "--device", "cpu", "--check", *extra])
    return manifest, buf.getvalue()


SERVE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from tecogan_tpu_torch.tools.serve_exported import serve_exported
    torch.set_num_threads(1)
    out, params = sys.argv[2], torch.load(sys.argv[3])
    clip = np.load(sys.argv[4])
    served = {"plain": serve_exported(out, clip, params, "cpu")}
    if sys.argv[5] == "int8":
        served["int8"] = serve_exported(out, clip, params, "cpu", quantized=True)
    torch.save(served, sys.argv[6])
    print(json.dumps(sorted(m for m in sys.modules if m.startswith("tecogan"))))
""")


@pytest.mark.parametrize("wire", ["f32", "u8_int8"])
def test_exported_programs_serve_without_model_code(tmp_path, wire):
    """``export_infer`` (with ``--check``) on the CPU, then a fresh
    interpreter that imports ``tools.serve_exported`` alone serves the
    clip bit-equal to the live chunked loop, the int8 programs too."""
    u8 = wire != "f32"
    extra = ["--wire", "u8", "--quantize", "int8"] if u8 else []
    manifest, text = _export(tmp_path / "x", *extra)
    assert text.count("check ok") == (2 if u8 else 1)
    with open(tmp_path / "x" / "manifest.json") as f:
        on_disk = json.load(f)
    assert set(on_disk) == JAX_MANIFEST | ({"qtail", "protocol_q"} if u8 else set())
    assert on_disk["platforms"] == ["cpu"] and manifest["lr_window"][1] == (
        "uint8" if u8 else "float32")
    assert set(manifest["export_seconds"]) == (
        {"head", "cont", "head_q", "cont_q"} if u8 else {"head", "cont"})

    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    params = _params(cfg)  # export_infer's default weights: init_generator, seed 0
    model = _model(cfg, params)
    clip = _clip(3, u8=u8)
    want = {"plain": build_chunked_inference(cfg, out_u8=u8)(model, clip, chunk=K)}
    if u8:
        prepare, _ = build_quantized_clip_inference(cfg)
        calib = torch.from_numpy(export_infer._calibration_clip(None, 1, LR[1], LR[2]))
        qtail = prepare(model, params, calib)
        want["int8"] = build_chunked_inference(cfg, out_u8=True)(model, clip, chunk=K,
                                                                  qtail=qtail)
    torch.save({k: v.float() for k, v in window_params(model).items()}, tmp_path / "p.pt")
    np.save(tmp_path / "clip.npy", clip)
    proc = subprocess.run(
        [sys.executable, "-c", SERVE, ROOT, str(tmp_path / "x"), str(tmp_path / "p.pt"),
         str(tmp_path / "clip.npy"), "int8" if u8 else "plain", str(tmp_path / "got.pt")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tecogan_tpu_torch.tools.serve_exported" in mods
    assert not [m for m in mods if ".models" in m or ".engine" in m], mods
    got = torch.load(tmp_path / "got.pt")
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_exported_windows_match_jax_head_cont(tmp_path):
    """The exported fp32 fused programs, loaded, against the JAX package's
    ``head_fn`` / ``cont_fn`` on the same weights and windows."""
    cfg = TecoConfig(num_resblock=2, precision="fp32", bug_parity=False)
    params = _params(cfg, 1, KERNEL_GAIN)
    save_generator_params(str(tmp_path / "g.ckpt"), params)
    _export(tmp_path / "x", "--precision", "fp32", "--g_checkpoint", str(tmp_path / "g.ckpt"))
    head, cont = load_programs(str(tmp_path / "x"))
    p = window_params(_model(cfg, params))
    j = j_chunked(JaxTecoConfig(**dataclasses.asdict(cfg)))
    clip = _clip(4, scale=CLIP_RANGE)
    w1, w2 = clip[:, :K], clip[:, K:2 * K]
    j_carry, j_sr1 = j.head_fn(params, w1)
    _, j_sr2 = j.cont_fn(params, j_carry, w2)
    carry, sr1 = head(p, torch.from_numpy(w1))
    _, sr2 = cont(p, carry, torch.from_numpy(np.ascontiguousarray(w2)))
    for got, want in ((sr1, j_sr1), (sr2, j_sr2)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape == (1, K, 4 * LR[1], 4 * LR[2], 3)
        mse = float(np.mean((got.numpy().astype(np.float64) - want) ** 2))
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) > FUSED_PSNR_DB


def test_serve_exported_refuses_what_the_programs_do_not_take(tmp_path):
    _export(tmp_path / "x")
    cfg = TecoConfig(num_resblock=2, precision="bf16", bug_parity=False)
    p = window_params(_model(cfg, _params(cfg)))
    out = str(tmp_path / "x")
    with pytest.raises(ValueError, match="does not fit"):
        serve_exported(out, np.zeros((1, 3, 8, 16, 3), np.float32), p, "cpu")
    with pytest.raises(ValueError, match="uint8"):
        serve_exported(out, np.zeros((1, 3, 8, 12, 3), np.uint8), p, "cpu")
    with pytest.raises(KeyError, match="conv_out.bias"):
        serve_exported(out, _clip(5), {k: v for k, v in p.items() if k != "conv_out.bias"},
                       "cpu")
    assert tuple(serve_exported(out, _clip(5), p, "cpu").shape) == (1, T, 32, 48, 3)
