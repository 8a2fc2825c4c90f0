"""The bf16 fused conv kernels layer by layer, on one GPU.

    python -m tecogan_tpu_torch.tools.bf16_layers [--out layers.json]

Builds ``csrc/bf16_conv.cu``, then at each of the tail's 9 layer shapes at
270p -> 1080p, 16 resblocks (``int8_layers.LAYERS``), with the layer's
bias, ReLU and residual as the bf16 tail runs them: checks the kernel
against its plain version (the module's chain of torch ops, run on the
card: cuDNN's conv, then the bias, ReLU and skip-add passes) within the
bars of :func:`check`, and times (a CUDA graph of 20 launches) the kernel,
the plain chain (what the bf16 route ran before the fused kernels) and,
as a yardstick, cuDNN's conv + bias of the shape with its ReLU.  Prints
one line a layer and a frame's sums, and writes the records as JSON to
``--out``.  Fails without a GPU and on any disagreement.

``chip_smoke.py`` phase 18 and ``tests/test_torch_port_cuda.py`` take
their inputs and bars from here.
"""

from __future__ import annotations

import argparse
import json
import os

from .int8_layers import HBM_BYTES_PER_S, LAYERS

PEAK_BF16_FLOPS = 989e12  # dense tensor cores, data sheet
REPS = 20
# The layers of LAYERS without a bias: the resblocks' and trunk blocks'
# Conv_1 (ResidualBlock's second conv has none).
NO_BIAS = ("resblock Conv_1 + skip", "trunk_rb1/Conv_1", "trunk_rb2/Conv_1")


def layer_inputs(dev, transposed: bool, shape: tuple, seed: int, bias: bool = True):
    """A layer's bf16 inputs from ``seed`` on ``dev``: x, the (Cout, 3, 3,
    Cin) weight at the scale of the module's default init (outputs of
    order 1), the bias (or None) and a residual of the output's shape."""
    import torch

    B, H, W, cin, cout = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((B, H, W, cin), generator=g, device=dev) * 0.5).bfloat16()
    w = (torch.randn((cout, 3, 3, cin), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).bfloat16()
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).bfloat16() if bias else None
    oh, ow = (2 * H, 2 * W) if transposed else (H, W)
    res = torch.randn((B, oh, ow, cout), generator=g, device=dev).bfloat16()
    return x, w, b, res


def check(got, want, x, w, bias, relu: bool, residual, transposed: bool) -> dict:
    """Hold the kernel's output to the plain chain's.  The two sum the same
    bf16 products in f32 in another order: each f32 sum lies within
    K * 2**-24 * sum |x w| of the exact one (K = 9 Cin terms), so the two
    sums within twice that; then, where a sum lies near a rounding
    boundary of bf16, they may round apart by one bf16 ulp of the conv's
    sum s, then of s + bias and of the output, each at most 2**-8 of its
    magnitude (the ReLU and the adds carry a gap on unchanged).  Bar:
    |got - want| <= 2 K 2**-24 S + 2**-7 (|s| + |s + b| + |want|)
    elementwise, with s the f32 conv of the same bf16 operands and S the
    f32 conv of their magnitudes (TF32 off), and the mean gap below 2**-10
    of the mean |want|.  Returns the max and mean gaps and the share of
    elements that differ; raises ``AssertionError`` past a bar."""
    import torch

    from ..ops.kernels import bf16_conv as k

    plain = k.bf16_up2x_reference if transposed else k.bf16_conv3x3_reference
    s = plain(x.float(), w.float())
    sb = s if bias is None else s + bias.float()
    gap = (got.float() - want.float()).abs()
    terms = 9 * x.shape[3]
    bar = (2.0 * terms * 2.0 ** -24 * plain(x.float().abs(), w.float().abs())
           + 2.0 ** -7 * (s.abs() + sb.abs() + want.float().abs()))
    over = int((gap > bar).sum())
    mean, scale = float(gap.mean()), float(want.float().abs().mean())
    rec = {"max_abs_err": float(gap.max()), "mean_abs_err": mean,
           "differ_share": float((gap > 0).float().mean())}
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    assert over == 0, f"{over} elements past the bar, max gap {rec['max_abs_err']}"
    assert mean <= 2.0 ** -10 * scale, f"mean gap {mean} against mean |want| {scale}"
    return rec


def layer_work(x, out, w, residual: bool) -> tuple:
    """(bytes, bf16 FLOPs) a layer needs: x read once, the output written
    once (and the residual read), the weights and bias once; 2 * 9 * Cin *
    Cout per input pixel (the 3x3 conv's 9 taps; up2x's 4 phases take 9
    taps an input pixel)."""
    B, H, W, cin = x.shape
    moved = (x.numel() + out.numel() * (2 if residual else 1) + w.numel() + w.shape[0]) * 2
    return moved, 2 * 9 * cin * w.shape[0] * B * H * W


def bound_ms(bytes_moved: float, flops: float) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time an H100 needs."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def measure(dev, reps: int = REPS) -> list:
    """One record a layer of LAYERS (see the module's docstring)."""
    import torch
    import torch.nn.functional as F

    from ..ops.kernels import bf16_conv as k
    from ..utils.timing import graph_ms

    rows = []
    for i, (name, up, shape, relu, residual, n) in enumerate(LAYERS):
        x, w, b, res = layer_inputs(dev, up, shape, 200 + i, name not in NO_BIAS)
        res = res if residual else None
        kernel, plain = ((k.bf16_up2x_cuda, k.bf16_up2x_reference) if up else
                         (k.bf16_conv3x3_cuda, k.bf16_conv3x3_reference))
        got = kernel(x, w, b, relu, res)
        want = plain(x, w, b, relu, res)
        rec = check(got, want, x, w, b, relu, res, up)
        bytes_moved, flops = layer_work(x, got, w, residual)
        ms = graph_ms(lambda: kernel(x, w, b, relu, res), reps)
        xc = x.permute(0, 3, 1, 2)
        if up:
            wt = k.conv_transpose_weight(w)
            cudnn = lambda: F.relu(F.conv_transpose2d(xc, wt, b, stride=2, padding=1,  # noqa: E731
                                                      output_padding=1))
        else:
            wt = k.conv_weight(w)
            cudnn = lambda: F.relu(F.conv2d(xc, wt, b, padding=1))  # noqa: E731
        bms, by = bound_ms(bytes_moved, flops)
        rows.append({"layer": name, "kernel": "bf16_up2x" if up else "bf16_conv3x3",
                     "shape": list(shape), "bias": b is not None, "relu": relu,
                     "residual": residual, "launches_a_frame": n, "ms": ms,
                     "bound_ms": bms, "bound_by": by, "tflops": flops / ms / 1e9,
                     "plain_ms": graph_ms(lambda: plain(x, w, b, relu, res), reps),
                     "cudnn_bias_relu_ms": graph_ms(cudnn, reps), **rec})
        del x, w, b, res, got, want
    return rows


def summary(rows: list) -> str:
    out = []
    for key in ("ms", "bound_ms", "plain_ms"):
        out.append(f"{key} {sum(r[key] * r['launches_a_frame'] for r in rows):.4f}")
    return "a frame: " + ", ".join(out)


def main(argv=None) -> list:
    import torch

    from ..ops.kernels import bf16_conv as k
    from ..utils.timing import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16_layers needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log = k.build()
    print("\n".join(ln for ln in log.splitlines() if "registers" in ln or "spill" in ln))
    smi = card()
    rows = measure(torch.device("cuda", 0))
    for r in rows:
        print(f"{r['layer']} {tuple(r['shape'])} x{r['launches_a_frame']}: {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%}), "
              f"{r['tflops']:.1f} TFLOP/s | plain chain {r['plain_ms']:.4f} ms | cuDNN conv "
              f"+ bias + ReLU {r['cudnn_bias_relu_ms']:.4f} ms | max gap {r['max_abs_err']:.3e},"
              f" {r['differ_share']:.2%} differ | {smi}", flush=True)
    print(f"{summary(rows)} | {smi}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__, "layers": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
