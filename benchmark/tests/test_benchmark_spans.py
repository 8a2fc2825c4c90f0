"""The reduction of the program's spans (benchmark/spans.py) on synthetic
kineto events, and the accepted reduction (benchmark/trace.py) reading the
same with the spans present."""

import pytest
import torch

from benchmark.spans import per_frame, program
from benchmark.trace import reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Ev:
    def __init__(self, name, device, start, dur, thread=1, corr=0):
        self._n, self._d, self._s, self._l, self._t, self._c = (name, device, start, dur,
                                                                thread, corr)

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

    def correlation_id(self):
        return self._c


def _launch(name, at, corr, start, dur, thread=1):
    """A launch call on the host and the kernel it queued."""
    return [_Ev("cudaLaunchKernel", CPU, at, 5, thread, corr),
            _Ev(name, CUDA, start, dur, corr=corr)]


def _bench():
    """The benchmark's ranges, two frames' kernels, a copy and a sync."""
    return ([_Ev("bench.window", CPU, 0, 2000), _Ev("bench.window", CUDA, 0, 2000),
             _Ev("bench.archive.clip", CPU, 0, 1900),
             _Ev("bench.archive.clip", CUDA, 10, 1800)]
            + _launch("conv_a", 20, 1, 100, 200)     # frame 1: resblocks
            + _launch("conv_b", 40, 2, 300, 100)     # frame 1: upsample
            + _launch("warp_s2d_kernel", 320, 3, 500, 50)  # frame 2: warp
            + _launch("conv_a", 340, 4, 550, 200)    # frame 2: resblocks
            + _launch("elementwise", 900, 5, 950, 40)  # outside every span
            + [_Ev("cudaMemcpyAsync", CPU, 700, 10, corr=6),
               _Ev("Memcpy DtoH (Device -> Pinned)", CUDA, 800, 60, corr=6),
               _Ev("cudaEventSynchronize", CPU, 985, 415), _Ev("aten::conv2d", CPU, 18, 30),
               _Ev("aten::add_", CPU, 390, 20)])


def _teco():
    """The program's spans of two frames and a copy: host ranges only."""
    return [_Ev("teco.frame", CPU, 10, 290), _Ev("teco.trunk", CPU, 15, 280),
            _Ev("teco.trunk.resblocks", CPU, 15, 20), _Ev("teco.trunk.upsample", CPU, 35, 200),
            _Ev("teco.frame", CPU, 310, 300), _Ev("teco.warp", CPU, 315, 10),
            _Ev("teco.trunk", CPU, 330, 270), _Ev("teco.trunk.resblocks", CPU, 330, 20),
            _Ev("teco.copy_start", CPU, 690, 30), _Ev("teco.copy_wait", CPU, 980, 430),
            _Ev("teco.frame", CPU, 1950, 100)]  # starts in the window, ends after it


def test_the_accepted_reduction_reads_the_same_with_the_program_spans():
    plain, spanned = reduce_events(_bench()), reduce_events(_bench() + _teco())
    for key in ("window_s", "busy_s", "kernels", "blocked_s"):
        assert spanned[key] == plain[key], key
    assert spanned["breakdown"]["device_ops"] == plain["breakdown"]["device_ops"]
    assert not any(k.startswith("teco.") for k in spanned["kernels"])


def test_program_attributes_kernels_to_the_spans_that_launched_them():
    p = program(_bench() + _teco())
    s = p["spans"]
    assert s["frame"]["count"] == 3 and s["trunk"]["count"] == 2
    assert s["frame"]["host_s"] == pytest.approx((290 + 300 + 50) * 1e-9)  # clipped at 2000
    assert s["trunk.resblocks"]["device_s"] == pytest.approx(400e-9)
    assert s["trunk.upsample"]["device_s"] == pytest.approx(100e-9)
    assert s["trunk"]["device_s"] == pytest.approx(500e-9)  # children included
    assert s["warp"]["device_s"] == pytest.approx(50e-9)
    # by kernel, in the innermost span only (a child may begin with its parent)
    assert s["trunk.resblocks"]["kernels"] == {"conv_a": pytest.approx(400e-9)}
    assert s["trunk.upsample"]["kernels"] == {"conv_b": pytest.approx(100e-9)}
    assert s["warp"]["kernels"] == {"warp_s2d_kernel": pytest.approx(50e-9)}
    assert s["trunk"]["kernels"] == {} and s["frame"]["kernels"] == {}
    assert s["frame"]["device_s"] == pytest.approx(550e-9)
    assert s["copy_start"]["device_s"] == 0.0
    assert s["copy_start"]["copy_s"] == pytest.approx(60e-9)
    assert s["copy_wait"]["device_s"] == 0.0
    assert p["kernel_s"] == pytest.approx(590e-9)  # copies apart
    assert p["claimed"] == pytest.approx(550 / 590)
    assert p["device_mirrors"] == 0


def test_program_counts_a_mirror_on_the_device():
    p = program(_bench() + _teco() + [_Ev("teco.frame", CUDA, 100, 200)])
    assert p["device_mirrors"] == 1 and p["kernel_s"] == pytest.approx(590e-9)


def test_idle_gaps_gain_the_program_span():
    def gaps(events):
        return sorted((round(s * 1e9), n) for n, s in program(events)["idle_gaps"])

    # idle 0-100, 400-500, 750-800, 860-950 and 990-2000
    assert gaps(_bench() + _teco()) == [
        (50, "archive.clip/python"), (90, "archive.clip/python"),
        (100, "archive.clip/python"), (100, "archive.clip/teco.trunk/aten::add_"),
        (1010, "archive.clip/teco.copy_wait/cudaEventSynchronize")]
    assert gaps(_bench()) == [
        (50, "archive.clip/python"), (90, "archive.clip/python"),
        (100, "archive.clip/aten::add_"), (100, "archive.clip/python"),
        (1010, "archive.clip/cudaEventSynchronize")]


def test_per_frame_divides_by_the_frame_spans():
    f = per_frame(program(_bench() + _teco()))
    assert f["frames"] == 3
    resblocks = f["spans"]["trunk.resblocks"]
    assert resblocks["device_ms"] == pytest.approx(400e-9 / 3 * 1e3)
    assert resblocks["kernels_ms"] == {"conv_a": pytest.approx(400e-9 / 3 * 1e3)}
    assert f["spans"]["trunk"]["count"] == pytest.approx(2 / 3)
    assert per_frame(program(_bench())) is None
