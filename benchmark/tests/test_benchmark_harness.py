"""The harness on the CPU: everything found by name, the end-to-end
metrics taken over the whole window, and BENCHMARK.json within the
contract's characters and limits."""

import json
import math
import re
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import drive, spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ---------------------------------------------------------------- found by name


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tecogan-g10-bf16", "source": "https://arxiv.org/abs/1811.09393",
                             "file": "benchmark/configs/tecogan-g10-bf16.json", "reduced": ["num_resblock"],
                             "why": "a shallower generator"})
    cfg = json.loads((HERE / "configs" / "tecogan-g16-bf16.json").read_text())
    cfg.update(name="tecogan-g10-bf16", num_resblock=10)
    (root / "benchmark/configs/tecogan-g10-bf16.json").write_text(json.dumps(cfg))
    tr = dict(spec.traffic("live-streams2"), streams=2)
    (root / "benchmark/traffic/live-streams2.json").write_text(json.dumps(tr))
    bench["workloads"].append({"name": "g10-live", "config": "tecogan-g10-bf16",
                               "traffic": "live-streams2", "chips": 1, "why": "two streams"})
    bench["end_to_end"][1]["workloads"].append("g10-live")
    bench["per_layer"].append({"name": "frames_served.live", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "serving loop",
                               "moves": "live_p95_ms"})
    (root / "benchmark/metrics/frames_served.live.py").write_text(
        "def read(ctx):\n    return len(ctx.run['records']) if ctx.mode == 'live' else None\n")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load(root)
    here = root / "benchmark"
    cell = spec.workload(loaded, "g10-live")
    assert spec.config(loaded, cell["config"], root)["num_resblock"] == 10
    assert spec.traffic(cell["traffic"], here)["streams"] == 2
    names = [m["name"] for m in spec.metrics(loaded, "g10-live", traced=True)]
    assert "frames_served.live" in names and "host_issue_ms.live" in names
    assert "frames_served.live" not in [m["name"] for m in spec.metrics(loaded, "bf16-archive", True)]
    read = spec.reader("frames_served.live", here)
    assert read(SimpleNamespace(mode="live", run={"records": [1, 2, 3]})) == 3
    assert [m["name"] for m in spec.metrics(loaded, "g10-live", traced=False)] == [
        "live_p95_ms", "setup_s"]


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        spec.traffic(w["traffic"])
        lim = spec.limits(w["name"])
        assert all(math.isfinite(v["limit"]) for v in lim.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


# ---------------------------------------------------------------- whole window


class _ArchiveSystem:
    """A stand-in for the program: 16-frame windows at a fixed pace, one
    of them stalled."""

    def __init__(self, stall_s=0.0):
        self.stall_s, self.calls = stall_s, 0

    def archive(self, clip, chunk, sink):
        for pos in range(0, clip.shape[1], chunk):
            self.calls += 1
            time.sleep(0.02 + (self.stall_s if self.calls == 5 else 0.0))
            sink(torch.zeros((1, min(chunk, clip.shape[1] - pos), 4, 4, 3), dtype=torch.uint8))


def _archive_fps(stall_s):
    tr = {"chunk": 16}
    data = {"pool": [torch.zeros((32, 1, 1, 3), dtype=torch.uint8)] * 2, "keep_windows": [0, 1]}
    run = drive.archive(_ArchiveSystem(stall_s), tr, data, 0.6, drive.Spans(False))
    assert run["window_s"] >= 0.6 and run["check_clip"]["windows"]
    return spec.reader("archive_fps")(SimpleNamespace(mode="archive", run=run)), run


def test_archive_fps_counts_every_frame_over_the_whole_window():
    fps, run = _archive_fps(0.0)
    assert fps == run["frames"] / run["window_s"]
    assert run["frames"] % 16 == 0 and fps == pytest.approx(16 / 0.02, rel=0.25)
    stalled, _ = _archive_fps(0.3)
    assert stalled < 0.75 * fps


class _StreamSystem:
    def __init__(self, stall_s=0.0):
        self.stall_s, self.calls = stall_s, 0

    def stream_init(self):
        return torch.zeros(1)

    def stream_step(self, state, frame):
        self.calls += 1
        time.sleep(0.002 + (self.stall_s if self.calls == 20 else 0.0))
        return state + 1, torch.zeros((1, 4, 4, 3), dtype=torch.uint8)

    @staticmethod
    def stream_carry(state):
        return state


def _live(stall_s, seconds=1.5):
    tr = {"height": 10, "width": 10, "rates_fps": [30, 29.97], "streams": 2, "warm_frames": 2,
          "check_frames_per_stream": 2, "max_level": 76}
    data = drive.live_inputs(tr, 5, seconds, "cpu")
    system = _StreamSystem(stall_s)
    warm = drive.live_warm(system, tr, data)
    run = drive.live(system, tr, data, warm, seconds, drive.Spans(False))
    ctx = SimpleNamespace(mode="live", run=run)
    return spec.reader("live_p95_ms")(ctx), run


def test_live_p95_is_the_tail_of_every_frame_due_in_the_window():
    p95, run = _live(0.0)
    assert run["offered"] == len(run["records"]) == pytest.approx(1.5 * 59.97, abs=3)
    assert 2.0 <= p95 < 15.0
    stalled, run_s = _live(0.4)
    assert len(run_s["records"]) == run_s["offered"]
    assert stalled > 100.0  # a stall of 400 ms delays more than 5% of the frames


def test_live_p95_counts_a_frame_never_served_as_late(monkeypatch):
    monkeypatch.setattr(drive, "LATE_S", -1.4)  # give up on everything 0.1 s in
    p95, run = _live(0.0)
    assert len(run["records"]) < run["offered"]
    assert p95 == math.inf


# ---------------------------------------------------------------- the contract


def test_names_units_and_texts_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["benchmark"]
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in BENCH["command"])
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        assert m["better"] in ("lower", "higher")
        names.add(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics(BENCH, w["name"], traced=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics(BENCH, w["name"], traced=True)
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


# ---------------------------------------------------------------- the trace


class _Ev:
    def __init__(self, name, device, start, dur, thread=1):
        self._n, self._d, self._s, self._l, self._t = name, device, start, dur, thread

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._l

    def start_thread_id(self):
        return self._t


def test_trace_reduction_keeps_the_benchmarks_ranges_off_the_device():
    from benchmark.trace import reduce_events

    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Ev("bench.window", CPU, 0, 1000), _Ev("bench.window", CUDA, 0, 1000),
              _Ev("bench.archive.clip", CPU, 0, 900), _Ev("bench.archive.clip", CUDA, 10, 900),
              _Ev("kernel_a", CUDA, 100, 200), _Ev("kernel_a", CUDA, 250, 150),
              _Ev("warp_s2d_kernel", CUDA, 600, 100),
              _Ev("cudaEventSynchronize", CPU, 400, 300), _Ev("aten::conv2d", CPU, 50, 40)]
    r = reduce_events(events)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(400e-9)  # 100-400 and 600-700
    assert r["blocked_s"] == pytest.approx(300e-9)
    assert r["kernels"]["kernel_a"] == [pytest.approx(350e-9), 2]
    assert not any(k.startswith("bench.") for k in r["kernels"])
    gaps = dict((round(s * 1e9), n) for n, s in r["breakdown"]["idle_gaps"])
    assert gaps == {100: "archive.clip/python", 200: "archive.clip/cudaEventSynchronize",
                    300: "archive.clip/python"}
