"""The device trace of a traced run (``--trace 1``): ``torch.profiler``
over the window, reduced to what the per-layer readers take.

* busy: the union of every device activity (kernels, copies, memsets)
  inside the window, which is the benchmark's ``bench.window`` range;
* kernels: device seconds and launches by name;
* blocked: host seconds the serving thread spent inside the CUDA
  runtime's synchronising calls (stream, event and device synchronise,
  and ``cudaMemcpy``/``cudaMemcpyAsync``, which wait for the stream when
  the host side is pageable);
* the breakdown: the device operations that took most time, and the
  longest idle gaps of the device, each named by the benchmark span and
  the host operation the serving thread was inside when the gap began.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
            "cudaMemcpy", "cudaMemcpyAsync")
TOP = 10


class Profiler:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def reduce(self) -> dict:
        return reduce_events(self.prof.profiler.kineto_results.events())


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(events: List[tuple], t: int) -> Optional[str]:
    """The shortest of ``events`` (start, end, name) that holds ``t``."""
    best = None
    for s, e, name in events:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return None if best is None else best[2]


def reduce_events(events) -> dict:
    window = None
    for ev in events:
        if ev.name() == "bench.window" and ev.device_type() != torch.autograd.DeviceType.CUDA:
            window = (ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.start_thread_id())
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1, thread = window
    device, spans, host_ops = [], [], []
    kernels: Dict[str, list] = {}
    blocked = 0
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e <= w0 or s >= w1:
            continue
        name = ev.name()
        if name.startswith("bench."):
            # the benchmark's ranges, on the host and mirrored on the device
            if ev.device_type() != torch.autograd.DeviceType.CUDA and \
                    ev.start_thread_id() == thread:
                spans.append((s, e, name[len("bench."):]))
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((max(s, w0), min(e, w1)))
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += (min(e, w1) - max(s, w0)) * 1e-9
            k[1] += 1
        elif ev.start_thread_id() == thread:
            host_ops.append((s, e, name))
            if name in BLOCKING:
                blocked += min(e, w1) - max(s, w0)
    busy = _merge(device)
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    spans = [x for x in spans if x[2] != "window"]
    idle = []
    for length, start in gaps[:TOP]:
        span = _innermost(spans, start) or "window"
        op = _innermost(host_ops, start) or "python"
        idle.append([f"{span}/{op}", length * 1e-9])
    ops = sorted(((v[0], k) for k, v in kernels.items()), reverse=True)[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9, "kernels": kernels,
            "blocked_s": blocked * 1e-9,
            "breakdown": {"device_ops": [[k[:200], s] for s, k in ops], "idle_gaps": idle}}
