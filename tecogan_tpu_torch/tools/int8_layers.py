"""The int8 conv kernels layer by layer, on one GPU, for one or more trees.

    python -m tecogan_tpu_torch.tools.int8_layers [--trees DIR ...] [--out layers.json]

For each tree (a checkout of this repository; default: this one), in the
order given, a child process imports that tree's ``tecogan_tpu_torch``,
builds its ``csrc/int8_conv.cu``, checks each kernel bit-equal to its
plain version and times it (a CUDA graph of 20 launches) at the int8
tail's 9 layer shapes at 270p -> 1080p, 16 resblocks.  Name a tree twice,
interleaved with another (A B B A), to compare two designs in one call.
For this checkout's first run, the child also times two labelled
yardsticks that are not the same function (PyTorch has no int8 conv): the bf16 cuDNN conv +
bias of the shape, and ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32) on its
im2col GEMM alone (M = B H W, K = 9 Cin, N = Cout).  Prints one line a
measurement and writes all of them as JSON to ``--out``.  Fails without a
GPU and on any disagreement.

``chip_smoke.py`` phase 12 takes its layer table, inputs, work counts and
yardsticks from here, so the two time the same thing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_INT8_OPS = 1979e12    # dense tensor cores, data sheet
REPS = 20
# (name, transposed, (B, H, W, Cin, Cout), relu, residual, launches a frame)
LAYERS = [("resblock Conv_0", False, (1, 270, 480, 64, 64), True, False, 16),
          ("resblock Conv_1 + skip", False, (1, 270, 480, 64, 64), False, True, 16),
          ("up1", True, (1, 270, 480, 64, 64), True, False, 1),
          ("trunk_rb1/Conv_0", False, (1, 540, 960, 64, 64), True, False, 1),
          ("trunk_rb1/Conv_1", False, (1, 540, 960, 64, 64), False, False, 1),
          ("trunk_rb2/Conv_0", False, (1, 540, 960, 64, 128), True, False, 1),
          ("trunk_rb2/Conv_1", False, (1, 540, 960, 128, 128), False, False, 1),
          ("up2", True, (1, 540, 960, 128, 128), True, False, 1),
          ("conv_hr", False, (1, 1080, 1920, 128, 64), True, False, 1)]


def layer_inputs(dev, transposed: bool, shape: tuple, seed: int, dtype=None):
    """A layer's inputs from ``seed`` on ``dev``: x (bf16, or ``dtype``),
    its scale (m at 0.8 of max|x|: some values clamp), full-range int8
    weights, deq, bias and a residual of the output's shape in x's dtype."""
    import torch

    B, H, W, cin, cout = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((B, H, W, cin), generator=g, device=dev) * 0.5).to(dtype or torch.bfloat16)
    inv_s = torch.tensor(127.0, device=dev) / (0.8 * x.float().abs().max())
    wq = torch.randint(-127, 128, (cout, 3, 3, cin), generator=g, device=dev, dtype=torch.int8)
    deq = torch.rand((cout,), generator=g, device=dev) * 1e-4 + 1e-6
    bias = torch.randn((cout,), generator=g, device=dev) * 0.1
    oh, ow = (2 * H, 2 * W) if transposed else (H, W)
    res = torch.randn((B, oh, ow, cout), generator=g, device=dev).to(x.dtype)
    return x, inv_s, wq, deq, bias, res


def layer_work(x, out, wq, residual: bool) -> tuple:
    """(bytes, int8 operations) a layer needs: x read once, the output
    written once (and the residual read), the weights, deq and bias."""
    B, H, W, cin = x.shape
    moved = (x.numel() + out.numel() * (2 if residual else 1)) * x.element_size()
    return moved + wq.numel() + wq.shape[0] * 8, 2 * 9 * cin * wq.shape[0] * B * H * W


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time an H100 needs."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def yardsticks(x, wq, bias, transposed: bool, reps: int) -> tuple:
    """(ms of the bf16 cuDNN conv + bias of the layer's shape, ms of
    ``torch._int_mm`` on its im2col GEMM alone): neither is the same
    function (PyTorch has no int8 conv)."""
    import torch
    import torch.nn.functional as F

    from tecogan_tpu_torch.utils.timing import events_ms, int_mm_ms

    B, H, W, cin = x.shape
    cout = wq.shape[0]
    xc = x.permute(0, 3, 1, 2).bfloat16()
    b16 = bias.bfloat16()
    if transposed:
        wt = wq.permute(3, 0, 1, 2).bfloat16().contiguous(memory_format=torch.channels_last)
        cudnn = events_ms(lambda: F.conv_transpose2d(xc, wt, b16, stride=2, padding=1,
                                                     output_padding=1), reps)
    else:
        wt = wq.permute(0, 3, 1, 2).bfloat16().contiguous(memory_format=torch.channels_last)
        cudnn = events_ms(lambda: F.conv2d(xc, wt, b16, padding=1), reps)
    return cudnn, int_mm_ms(B * H * W, 9 * cin, cout, reps, x.device)


def child(tree: str, yardsticks_too: bool) -> dict:
    """Time the kernels of ``tree`` (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from tecogan_tpu_torch.ops.kernels import int8_conv as q
    from tecogan_tpu_torch.utils.timing import card, graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("int8_layers needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    q.build()
    smi = card()
    rows = []
    for i, (name, up, shape, relu, residual, n) in enumerate(LAYERS):
        x, inv_s, wq, deq, bias, res = layer_inputs(dev, up, shape, 100 + i)
        res = res if residual else None
        kernel, plain = ((q.int8_up2x_cuda, q.int8_up2x_reference) if up else
                         (q.int8_conv3x3_cuda, q.int8_conv3x3_reference))
        got = kernel(x, inv_s, wq, deq, bias, relu, res)
        if not torch.equal(got, plain(x, inv_s, wq, deq, bias, relu, res)):
            raise SystemExit(f"{tree}: {name} differs from its plain version")
        ms = graph_ms(lambda: kernel(x, inv_s, wq, deq, bias, relu, res), REPS)
        bytes_moved, ops = layer_work(x, got, wq, residual)
        row = {"layer": name, "kernel": "int8_up2x" if up else "int8_conv3x3",
               "shape": list(shape), "launches_a_frame": n, "ms": ms,
               "bound_ms": bound_ms(bytes_moved, ops)[0], "tops": ops / ms / 1e9}
        if yardsticks_too:
            row["cudnn_bf16_ms"], row["int_mm_ms"] = yardsticks(x, wq, bias, up, REPS)
            row["int_mm_tops"] = ops / row["int_mm_ms"] / 1e9
        rows.append(row)
        del x, wq, res, got
    return {"tree": tree, "card": smi, "torch": torch.__version__, "layers": rows}


def _summary(rec: dict) -> str:
    out = []
    for kern in ("int8_conv3x3", "int8_up2x"):
        rows = [r for r in rec["layers"] if r["kernel"] == kern]
        ms = sum(r["ms"] * r["launches_a_frame"] for r in rows)
        bound = sum(r["bound_ms"] * r["launches_a_frame"] for r in rows)
        out.append(f"{kern} {ms:.4f} ms a frame, bound {bound:.4f} ({bound / ms:.1%})")
    return "; ".join(out)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts whose kernels to time, in this order")
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--yardsticks", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child, args.yardsticks)))
        return []
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    recs, yardsticks_done = [], False
    for i, tree in enumerate(args.trees):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree]
        if not yardsticks_done and os.path.abspath(tree) == here:
            cmd.append("--yardsticks")
            yardsticks_done = True
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"int8_layers failed on {tree}:\n{proc.stdout}\n{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["run"] = i
        recs.append(rec)
        for r in rec["layers"]:
            line = (f"[{i}] {tree} {r['layer']} {tuple(r['shape'])} x{r['launches_a_frame']}: "
                    f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%}),"
                    f" {r['tops']:.1f} TOP/s")
            if "int_mm_ms" in r:
                line += (f" | not the same function: bf16 cuDNN {r['cudnn_bf16_ms']:.4f} ms, "
                         f"torch._int_mm {r['int_mm_ms']:.4f} ms ({r['int_mm_tops']:.1f} TOP/s)")
            print(line + f" | {rec['card']}", flush=True)
        print(f"[{i}] {tree}: {_summary(rec)} | {rec['card']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return recs


if __name__ == "__main__":
    main()
