"""The program's own spans in a traced run, which ``trace.py``'s reduction
does not read yet.

The port marks its serving path with ``teco.*`` spans (its
``utils/spans.py``): profiler ops on the host thread that enters them,
with no copy on the device's timeline, so ``trace.py`` counts none of
them as device activity.  :func:`program` reduces them:

* ``spans``: for each span name, ``count`` (instances that start in the
  window, on the serving thread), ``host_s`` (their host time, clipped to
  the window), ``device_s`` (every kernel whose launch call began inside
  an instance, children included, clipped to the window as ``trace.py``
  clips) and ``copy_s`` (copies and memsets, likewise), and ``kernels``,
  the device seconds by kernel name of the kernels for which it is the
  innermost span;
* ``claimed``: the share of the window's kernel time launched inside
  some span;
* ``device_mirrors``: events of a span on the device's timeline, which
  the spans never have (``trace.py`` would count one as a kernel);
* ``idle_gaps``: the device's longest idle gaps, named
  ``<bench span>/<innermost teco span>/<host op>`` where a program span
  holds the gap's start, ``<bench span>/<host op>`` where none does.

A kernel is matched to its launch call by the correlation id that kineto
gives both.  :func:`per_frame` divides by the ``frame`` spans that start
in the window.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs the cell traced, as ``benchmark.run --trace 1`` does, and prints its
result line with ``program`` and ``per_frame`` added.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch

from .kernels import is_copy
from .trace import TOP, _innermost, _merge

PREFIX = "teco."
CUDA = torch.autograd.DeviceType.CUDA


def program(events) -> dict:
    """The ``program`` reduction of kineto's ``events``, the trace of a
    run whose window is its ``bench.window`` range."""
    events = list(events)
    window = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.start_thread_id())
              for ev in events if ev.name() == "bench.window" and ev.device_type() != CUDA]
    if not window:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1, thread = window[-1]
    inst: List[Tuple[int, int, str]] = []  # every program span of the serving thread
    bench: List[Tuple[int, int, str]] = []
    host_ops: List[Tuple[int, int, str]] = []
    launch: Dict[int, int] = {}  # correlation id -> its launch call's start
    device: List[Tuple[int, int, int, bool, str]] = []  # (correlation id, start, end, copy, name)
    mirrors = 0
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == CUDA:
            mirrors += name.startswith(PREFIX)
            if not name.startswith(("bench.", PREFIX)) and e > w0 and s < w1:
                device.append((ev.correlation_id(), max(s, w0), min(e, w1), is_copy(name), name))
        elif ev.start_thread_id() == thread:
            if name.startswith(PREFIX):
                inst.append((s, e, name[len(PREFIX):]))
                continue
            if name.startswith("cu"):  # CUDA API calls: cudaLaunchKernel, cuLaunchKernelEx, ...
                launch[ev.correlation_id()] = s
            if e <= w0 or s >= w1 or name == "bench.window":
                continue
            if name.startswith("bench."):
                bench.append((s, e, name[len("bench."):]))
            else:
                host_ops.append((s, e, name))

    spans: Dict[str, dict] = {}
    for s, e, name in inst:
        rec = spans.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                      "copy_s": 0.0, "kernels": {}})
        if w0 <= s < w1:
            rec["count"] += 1
        if e > w0 and s < w1:
            rec["host_s"] += (min(e, w1) - max(s, w0)) * 1e-9

    # one sweep, in time, over the spans' begins and ends and the launches;
    # at one instant ends come first, and an outer span begins before its child
    marks = sorted([(s, 1, s - e, n) for s, e, n in inst] + [(e, 0, 0, n) for _, e, n in inst])
    owned = sorted((launch[c], s, e, copy, name) for c, s, e, copy, name in device
                   if c in launch)
    stack: List[str] = []
    i = 0
    kernel_s = sum((e - s) * 1e-9 for _, s, e, copy, _ in device if not copy)
    claimed_s = 0.0
    for t, s, e, copy, kernel in owned:
        while i < len(marks) and marks[i][0] <= t:
            _, begin, _, n = marks[i]
            if begin:
                stack.append(n)
            else:
                del stack[len(stack) - 1 - stack[::-1].index(n)]
            i += 1
        secs = (e - s) * 1e-9
        for n in set(stack):
            spans[n]["copy_s" if copy else "device_s"] += secs
        if stack and not copy:
            claimed_s += secs
            by_name = spans[stack[-1]]["kernels"]
            by_name[kernel] = by_name.get(kernel, 0.0) + secs

    return {"spans": spans, "kernel_s": kernel_s,
            "claimed": claimed_s / kernel_s if kernel_s else None, "device_mirrors": mirrors,
            "idle_gaps": _idle_gaps(device, w0, w1, bench, inst, host_ops)}


def _idle_gaps(device, w0, w1, bench, inst, host_ops) -> list:
    busy = _merge([(s, e) for _, s, e, _, _ in device])
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    out = []
    for length, start in gaps[:TOP]:
        parts = [_innermost(bench, start) or "window"]
        teco = _innermost(inst, start)
        if teco is not None:
            parts.append(PREFIX + teco)
        parts.append(_innermost(host_ops, start) or "python")
        out.append(["/".join(parts), length * 1e-9])
    return out


def per_frame(prog: dict, top: int = 6) -> Optional[dict]:
    """Each span's device, copy and host ms and instances a frame, and its
    ``top`` kernels' ms a frame, over the ``frame`` spans that start in
    the window; None without one."""
    frames = prog["spans"].get("frame", {}).get("count", 0)
    if not frames:
        return None
    return {"frames": frames,
            "spans": {n: {"device_ms": r["device_s"] / frames * 1e3,
                          "copy_ms": r["copy_s"] / frames * 1e3,
                          "host_ms": r["host_s"] / frames * 1e3,
                          "count": r["count"] / frames,
                          "kernels_ms": {k: v / frames * 1e3 for k, v in sorted(
                              r["kernels"].items(), key=lambda kv: -kv[1])[:top]}}
                      for n, r in prog["spans"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import run, spec, trace

    run.steady_allocator()
    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(spec.ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(spec.ROOT / "build" / "triton")
    if not torch.cuda.is_available():
        print("benchmark.spans needs a CUDA GPU", file=sys.stderr)
        return 3
    held = {}

    class Traced(trace.Profiler):
        def reduce(self):
            events = list(self.prof.profiler.kineto_results.events())
            held["program"] = program(events)
            return trace.reduce_events(events)

    trace.Profiler = Traced  # this process only: run_cell reads the module's name
    result, lines = run.run_cell(bench, cell, args.seed, args.seconds, True,
                                 torch.device("cuda", 0))
    result["program"] = held["program"]
    result["per_frame"] = per_frame(held["program"])
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
