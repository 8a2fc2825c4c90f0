"""The benchmark of the PyTorch port on NVIDIA GPUs.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  One run of one cell of ``BENCHMARK.json``:
weights and traffic made on the card from ``--seed``, the program built
(its kernels compiled into ``build/`` at the checkout's root on the first
run there, loaded after), the cell's shapes warmed up, a window of
``--seconds`` measured (``--trace 1``: a traced window, its per-layer
metrics), then what the window served checked against the plain
reference of the configuration's architecture
(``benchmark/architectures/<name>/``).  The numbers compared are printed,
each beside its limit, as the last lines of standard error; the last line
of standard output is the result's JSON.  Exits non-zero, printing no
result, without enough GPUs, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tecogan_tpu")
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3  # mallopt's parameters (malloc.h)


def steady_allocator() -> None:
    """Fix glibc malloc's thresholds for this process: blocks up to 32 MiB
    come from the heap, and freed memory stays there.  Left dynamic, the
    threshold adapts to the first frees of each process differently, so
    some processes map and fault in every 6 MB frame copied to the host
    anew and others reuse memory: the live cell's service time then
    differed by ~2 ms a frame from one process to the next (PERF.md)."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt(M_MMAP_THRESHOLD, 32 << 20)
    libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's (compared whole)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def calibration(cfg: dict, tr: dict, seed: int, device):
    """The seeded calibration clip of ``calibration_frames`` frames at the
    traffic's size, or None where the configuration asks for none."""
    from . import inputs

    if not cfg["calibration_frames"]:
        return None
    return inputs.make_clip(seed, ("calibration",), cfg["calibration_frames"], tr["height"],
                            tr["width"], tr["max_level"], device)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
             config: dict = None, traffic: dict = None, limits: dict = None,
             t_start: float = None, control: bool = False, root: Path = None) -> tuple:
    """One run.  Returns (result dict, the check's lines).  ``control``
    also reads the control's numbers (``result["control"]``), which the
    benchmark's own runs never do.  What the cell names is found under
    the checkout ``root`` (this one's by default)."""
    import torch

    from . import check, drive, spec
    from . import trace as tracing
    from .reference.frames import dequant

    root = spec.ROOT if root is None else Path(root)
    here = root / "benchmark"
    cfg = config or spec.config(bench, cell["config"], root)
    tr = traffic or spec.traffic(cell["traffic"], here)
    lim = limits or spec.limits(cell["name"], here)
    arch = spec.architecture(cfg, here)
    device = torch.device(device)
    H, W = tr["height"], tr["width"]

    params = arch.make_params(seed, cfg, device)
    calib = calibration(cfg, tr, seed, device)
    system = arch.System(cfg, params, device, (1, H, W, 3), calib)
    window_s = min(seconds, tr["trace_seconds"]) if traced else seconds
    if tr["mode"] == "archive":
        data = drive.archive_inputs(tr, seed, device)
        # the head and continuation windows, and the host buffers the sink holds
        system.archive(data["warm"][None], tr["chunk"], lambda host: None)
        if device.type == "cuda":
            shape = (1, tr["chunk"], 4 * H, 4 * W, 3)
            bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                    for _ in range(2 * len(data["keep_windows"]) + 2)]
            del bufs
        warm = None
    else:
        data = drive.live_inputs(tr, seed, window_s, device)
        warm = drive.live_warm(system, tr, data)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - (T0 if t_start is None else t_start)

    spans = drive.Spans(traced)
    prof = tracing.Profiler() if traced else nullcontext()
    with prof:
        with spans.span("window"):
            if tr["mode"] == "archive":
                run = drive.archive(system, tr, data, window_s, spans)
            else:
                run = drive.live(system, tr, data, warm, window_s, spans)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    reduced = prof.reduce() if traced else None

    lr_samples = []
    if tr["mode"] == "archive":
        clip = data["pool"][0]
        lr_samples = [dequant(clip[t][None].to(device)) for t in range(4)]
    ctx = SimpleNamespace(mode=tr["mode"], config=cfg, arch=arch, traffic=tr, setup_s=setup_s,
                          run=run, trace=reduced, lr_samples=lr_samples)
    metrics = {}
    for m in spec.metrics(bench, cell["name"], traced):
        value = spec.reader(m["name"], here)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    del ctx, lr_samples

    if tr["mode"] == "archive":
        attempted, failed = run["frames"], 0
    else:
        attempted = run["offered"]
        failed = run["offered"] - len(run["records"])
    system.close()
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.run(arch, tr["mode"], cfg, tr, lim, params, calib, data, run, warm, device)
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks)
    dev_rec = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if reduced is not None:
        dev_rec["busy_s"] = reduced["busy_s"]
        dev_rec["window_s"] = reduced["window_s"]
    result = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev_rec}
    if reduced is not None:
        result["breakdown"] = reduced["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    if control:
        result["control"] = check.numbers(arch, tr["mode"], cfg, tr, params, calib, data, run,
                                          warm, device, control=True)
    lines = [f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})" for c in checks]
    lines.append(f"correct: {correct}")
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady_allocator()

    from . import spec

    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(spec.ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(spec.ROOT / "build" / "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA GPU(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result, lines = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
