"""Where the time of the two CUDA kernels goes, on one GPU.

    python -m tecogan_tpu_torch.tools.kernel_ablation [--out ablation.json]

Builds each kernel from ``tecogan_tpu_torch/csrc`` as it is and as copies
with one part cut out (the copies go to ``build/ablation/``), and times
each by CUDA-graph replay of 50 launches at the main path's shapes:

* ``conv_out_s2d`` on (1, 1080, 1920, 64) bf16 features: the kernel; no
  MMAs (the row ring, epilogue and stores); no epilogue (the ring and the
  MMAs); the ring alone;
* ``warp_s2d`` on a (1, 270, 480) carry: the kernel and a copy that loads
  no carry tap, each with prev_lr in [0, 1] (the served range, few taps
  in the frame), in [-0.5, 0.5] (most taps in the frame) and equal to 1
  (none in the frame).

A cut copy computes something else; only the kernels as they are are
checked against their plain versions.  Fails without a GPU; prints one
line a measurement and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops.kernels import conv_out_s2d as kmod
from ..ops.kernels import warp_s2d as wmod
from ..ops.kernels._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from ..utils.timing import card, graph_ms

REPS = 50
_NO_MMA = [("ldmatrix_x4(a_base + kt * 32, a);", "a[0] = a[1] = a[2] = a[3] = 0u;"),
           ("for (int u = 0; u < 3; ++u) mma_bf16(r.acc[(P - u + 3) % 3], a, r.bw[u][kt]);",
            ""),
           ("mma_bf16(d, a, r.bd[kt]);", "")]
_NO_EPILOGUE = [("task < C * 4 * TC;", "task < 0;"),
                ("  const int n = min(TC, s.W - s.j0) * (REC * 2 / 16);", "  const int n = 0;")]
CUTS = {
    "conv_out_s2d": {"kernel": [], "no_mma": _NO_MMA, "no_epilogue": _NO_EPILOGUE,
                     "ring_only": _NO_MMA + _NO_EPILOGUE},
    "warp_s2d": {"kernel": [], "no_tap_loads": [
        ("    if (fx >= -1.f && fx <= static_cast<float>(W4 - 1) && fy >= -1.f &&",
         "    if (false && fx <= static_cast<float>(W4 - 1) && fy >= -1.f &&")]},
}
WARP_RANGES = {"served [0, 1]": (0.0, 1.0), "[-0.5, 0.5]": (-0.5, 0.5),
               "all outside (1)": (1.0, 1.0)}


def _build(name: str, cut: str, pairs) -> ctypes.CDLL:
    src = (CSRC / f"{name}.cu").read_text()
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"{name}.cu no longer holds the line the cut "
                               f"{cut!r} replaces: {old!r}")
        src = src.replace(old, new)
    out = BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}-{cut}.cu", out / f"{name}-{cut}.so"
    cu.write_text(src)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation needs a CUDA GPU; none is visible")
    jobs = [(n, c, p) for n, cuts in CUTS.items() for c, p in cuts.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip([(n, c) for n, c, _ in jobs], pool.map(lambda j: _build(*j), jobs)))
    dev = torch.device("cuda", 0)
    smi = card()
    rec = {"card": smi, "reps": REPS, "ms": {}}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)

    feat = torch.rand((1, 1080, 1920, 64), generator=gen, device=dev).bfloat16()
    w = torch.randn((3, 3, 64, 3), generator=gen, device=dev) * 0.05
    b = torch.randn((3,), generator=gen, device=dev) * 0.1
    out = torch.empty((1, 270, 480, 48), dtype=torch.bfloat16, device=dev)
    ref = kmod.conv_out_s2d_reference(feat.float(), w.bfloat16().float(), b)
    for cut in CUTS["conv_out_s2d"]:
        lib = libs["conv_out_s2d", cut]
        lib.conv_out_s2d_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        if lib.conv_out_s2d_init() != 0:
            raise RuntimeError(f"conv_out_s2d {cut}: init failed")
        ms = graph_ms(lambda: lib.conv_out_s2d_launch(
            feat.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 270, 480,
            stream()), REPS)
        if cut == "kernel":
            err = float((out.float() - ref).abs().max())
            if err > 8e-3:
                raise SystemExit(f"conv_out_s2d disagrees with its plain version: {err}")
        rec["ms"][f"conv_out_s2d {cut}"] = ms
        print(f"conv_out_s2d {cut}: {ms:.4f} ms | {smi}", flush=True)

    carry = torch.rand((1, 270, 480, 48), generator=gen, device=dev).bfloat16()
    wout = torch.empty_like(carry)
    for label, (lo, hi) in WARP_RANGES.items():
        prev = torch.rand((1, 270, 480, 3), generator=gen, device=dev) * (hi - lo) + lo
        ref = wmod.warp_s2d_feedback_reference(carry, prev)
        for cut in CUTS["warp_s2d"]:
            lib = libs["warp_s2d", cut]
            lib.warp_s2d_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            ms = graph_ms(lambda: lib.warp_s2d_launch(
                carry.data_ptr(), prev.data_ptr(), wout.data_ptr(), 1, 270, 480,
                stream()), REPS)
            if cut == "kernel":
                err = float((wout.float() - ref).abs().max())
                if err > 4e-3:
                    raise SystemExit(f"warp_s2d disagrees with its plain version: {err}")
            rec["ms"][f"warp_s2d {cut}, prev_lr {label}"] = ms
            print(f"warp_s2d {cut}, prev_lr {label}: {ms:.4f} ms | {smi}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
