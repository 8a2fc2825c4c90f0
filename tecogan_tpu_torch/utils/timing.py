"""The card's identity and device-side timing, for the GPU scripts."""

from __future__ import annotations

import subprocess

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
