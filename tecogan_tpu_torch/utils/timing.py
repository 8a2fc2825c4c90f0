"""The card's identity and device-side timing, for the GPU scripts."""

from __future__ import annotations

import subprocess
import time

import torch


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up call
    (CUDA events on the current stream)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_issue_ms(fn, reps: int) -> float:
    """Mean host time to issue ``fn`` over ``reps`` calls back to back, no
    synchronise between them, after a warm-up call with the device idle:
    the host's side of a launch, which sets the pace when it exceeds the
    device's time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return t * 1e3


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn`` call when ``reps`` calls replay as
    one CUDA graph (after a warm-up call and a warm-up replay): the
    kernels' own time, without the host's work between launches, which
    ``events_ms`` measures too once it exceeds a short kernel's time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int_mm_ms(m: int, k: int, n: int, reps: int, device) -> float:
    """Device time of ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32) on random
    (m, k) x (k, n) int8 operands (``events_ms``): the yardstick of what
    the library's int8 tensor-core GEMM reaches at an int8 conv layer's
    im2col shape.  It computes no conv; the port never calls it."""
    g = torch.Generator(device=device).manual_seed(7)
    a = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8).t()
    return events_ms(lambda: torch._int_mm(a, b), reps)
