"""The two serving loops a traffic file can ask for, each timed on the host
clock and recording the benchmark's own spans.

* ``archive``: back-to-back clips through the program's chunked loop into
  a host sink.  The window opens before the first clip and closes at the
  first window of frames that reaches the sink at or after its length;
  the frames that reached the sink, over that time, are the rate.
* ``live``: an open loop of independent streams, each at its own frame
  rate and phase, served in due-time order by one loop.  A frame's
  latency runs from its due time to its uint8 SR frame on the host; the
  frames due inside the window are all served, late ones after it closes.
"""

from __future__ import annotations

import heapq
import math
import time
from contextlib import nullcontext
from typing import List

import torch

from . import inputs

LATE_S = 60.0  # a frame due in the window and not served this long after it fails


class StopWindow(Exception):
    pass


class Spans:
    """The benchmark's spans: in a traced run each is a ``record_function``
    range named ``bench.<name>``, which names the device's idle gaps
    (benchmark/trace.py); untraced, nothing."""

    def __init__(self, traced: bool):
        self.traced = traced

    def span(self, name: str):
        return torch.profiler.record_function("bench." + name) if self.traced else nullcontext()


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def sleep_until(t: float) -> None:
    left = t - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.001)
    while time.perf_counter() < t:
        pass


# --------------------------------------------------------------------------- archive


def archive_inputs(traffic: dict, seed: int, device) -> dict:
    """The clip pool (host uint8 tensors) and the check's plan."""
    T, H, W = traffic["clip_frames"], traffic["height"], traffic["width"]
    pool = [inputs.make_clip(seed, ("archive", i), T, H, W, traffic["max_level"],
                             device).cpu() for i in range(traffic["pool_clips"])]
    g = torch.Generator().manual_seed(inputs.sub_seed(seed, "archive-check"))
    windows = -(-T // traffic["chunk"])
    seam = int(torch.randint(1, windows, (1,), generator=g))
    warm = inputs.make_clip(seed, ("archive-warm",), traffic["warm_frames"], H, W,
                            traffic["max_level"], device).cpu()
    return {"pool": pool, "warm": warm, "keep_windows": sorted({seam - 1, seam, windows - 1})}


def archive(system, traffic: dict, data: dict, seconds: float, spans: Spans) -> dict:
    """Runs the window.  Returns the rate's parts and the kept windows of
    the last clip that completed inside it."""
    pool, keep = data["pool"], data["keep_windows"]
    chunk = traffic["chunk"]
    st = {"frames": 0, "win": 0, "t_last": None, "kept": {}}
    done_clip: dict = {}
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def sink(host):
        now = time.perf_counter()
        st["frames"] += host.shape[1]
        st["t_last"] = now
        if st["win"] in keep:
            st["kept"][st["win"]] = host
        st["win"] += 1
        if now >= t_end:
            raise StopWindow

    i = 0
    try:
        while True:
            st["win"], st["kept"] = 0, {}
            with spans.span("archive.clip"):
                system.archive(pool[i % len(pool)][None], chunk, sink)
            done_clip = {"index": i, "windows": st["kept"]}
            i += 1
    except StopWindow:
        pass
    with spans.span("archive.drain"):
        sync()
    window_s = st["t_last"] - t0
    return {"frames": st["frames"], "window_s": window_s, "clips_done": i,
            "check_clip": done_clip, "t0": t0}


# --------------------------------------------------------------------------- live


def live_inputs(traffic: dict, seed: int, seconds: float, device) -> dict:
    """Each stream's frames (host uint8), rate and phase, and the frames
    the check samples."""
    H, W = traffic["height"], traffic["width"]
    rates = traffic["rates_fps"]
    g = torch.Generator().manual_seed(inputs.sub_seed(seed, "live-schedule"))
    streams = []
    for k in range(traffic["streams"]):
        fps = rates[k % len(rates)]
        phase = float(torch.rand((1,), generator=g)) / fps
        n_window = int(math.ceil((seconds - phase) * fps))
        frames = inputs.make_clip(seed, ("live", k), traffic["warm_frames"] + n_window + 1,
                                  H, W, traffic["max_level"], device).cpu()
        # the check's frames: drawn from the last third of the window
        lo = traffic["warm_frames"] + (2 * n_window) // 3
        hi = traffic["warm_frames"] + n_window - 1
        picks = sorted({int(torch.randint(lo, hi + 1, (1,), generator=g))
                        for _ in range(traffic["check_frames_per_stream"])})
        streams.append({"fps": fps, "phase": phase, "frames": frames, "check": picks})
    return {"streams": streams}


def live_warm(system, traffic: dict, data: dict) -> list:
    """Each stream's first frames, outside the window: the stream has
    started before the window opens.  Returns the streams' states and
    the frames served."""
    out = []
    for s in data["streams"]:
        state = system.stream_init()
        served = []
        for j in range(traffic["warm_frames"]):
            state, u8 = system.stream_step(state, s["frames"][j][None])
            served.append(u8.cpu())
        out.append({"state": state, "served": served})
    sync()
    return out


def live(system, traffic: dict, data: dict, warm: list, seconds: float,
         spans: Spans) -> dict:
    """Serves every frame due inside the window, earliest due first."""
    streams = data["streams"]
    t0 = time.perf_counter() + 0.01
    heap = []
    for k, s in enumerate(streams):
        j = traffic["warm_frames"]
        due = t0 + s["phase"]
        heap.append((due, k, j))
    heapq.heapify(heap)
    t_end = t0 + seconds
    states = [w["state"] for w in warm]
    recs = []  # (k, j, due, start, issued, done)
    kept = {}
    while heap:
        due, k, j = heapq.heappop(heap)
        if due >= t_end:
            continue
        if time.perf_counter() > t_end + LATE_S:
            break
        s = streams[k]
        nxt = j + 1
        due_next = t0 + s["phase"] + (nxt - traffic["warm_frames"]) / s["fps"]
        if nxt < s["frames"].shape[0]:
            heapq.heappush(heap, (due_next, k, nxt))
        with spans.span("live.wait"):
            sleep_until(due)
        before = states[k]
        with spans.span("live.issue"):
            start = time.perf_counter()
            states[k], u8 = system.stream_step(before, s["frames"][j][None])
            issued = time.perf_counter()
        with spans.span("live.copy"):
            host = u8.cpu()
            done = time.perf_counter()
        recs.append((k, j, due, start, issued, done))
        if j in s["check"]:
            kept[(k, j)] = {"before": system.stream_carry(before),
                            "after": system.stream_carry(states[k]), "served": host}
    offered = sum(1 for s in streams
                  for j in range(traffic["warm_frames"], s["frames"].shape[0])
                  if t0 + s["phase"] + (j - traffic["warm_frames"]) / s["fps"] < t_end)
    return {"records": recs, "offered": offered, "t0": t0, "window_s": seconds,
            "kept": kept}


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
