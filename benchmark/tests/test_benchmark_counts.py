"""The yardstick's counts held to the port's FLOP accounting
(tecogan_tpu_torch/utils/flops.py) and to the kernel bounds that PERF.md's
kernel table states."""

import pytest
import torch

from benchmark import counts
from benchmark.architectures.tecogan_df import counts as df
from tecogan_tpu_torch.utils import flops


@pytest.mark.parametrize("hw", [(270, 480), (135, 240), (37, 53)])
@pytest.mark.parametrize("nrb", [16, 2])
def test_frame_counts_match_the_ports(hw, nrb):
    h, w = hw
    assert df.generator_macs_per_frame(h, w, nrb) == flops.generator_macs_per_frame(h, w, nrb)
    assert df.int8_tail_macs_per_frame(h, w, nrb) == flops.int8_tail_macs_per_frame(h, w, nrb)


def test_peaks_match_the_ports():
    assert counts.PEAK_BF16_FLOPS == flops.H100_PEAK_BF16_FLOPS
    assert counts.PEAK_INT8_OPS == flops.H100_PEAK_INT8_OPS


def test_kernel_bounds_match_the_kernel_table():
    # PERF.md's kernel table: conv_out_s2d 0.0829 ms (bytes); a frame's
    # int8_conv3x3 launches 0.852 ms, its int8_up2x launches 0.223 ms
    assert counts.conv_out_s2d_least_s(270, 480) * 1e3 == pytest.approx(0.0829, abs=5e-5)
    s, n = counts.int8_least_s_per_frame(270, 480, False)
    assert (s * 1e3, n) == (pytest.approx(0.852, abs=5e-4), 37)
    s, n = counts.int8_least_s_per_frame(270, 480, True)
    assert (s * 1e3, n) == (pytest.approx(0.223, abs=5e-4), 2)


def test_warp_bytes_follow_the_inputs():
    # the pseudo-flow is an absolute sampling position: R and G in
    # [-0.25, 0.25] put the samples all over the frame, so the bytes lie
    # between those of whole tensors (the table's 0.0079 ms bound) and
    # those of a bright frame, whose samples all fall outside and leave the
    # feedback written and the R, G planes read
    h, w = 270, 480
    g = torch.Generator().manual_seed(0)
    inside = torch.rand((1, h, w, 3), generator=g) * 0.5 - 0.25
    b, _ = counts.warp_s2d_work(inside)
    whole = h * w * 16 * 3 * 2 + h * w * 2 * 4 + h * w * 48 * 2
    assert whole / counts.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0079, abs=3e-4)
    outside = torch.full((1, h, w, 3), 0.9)
    b_out, _ = counts.warp_s2d_work(outside)
    assert b_out == h * w * 2 * 4 + h * w * 48 * 2
    assert b_out < b < whole
    assert counts.warp_s2d_least_s(outside) < counts.warp_s2d_least_s(inside)


def test_mfu_counts_split_the_int8_tail():
    h, w = 270, 480
    bf16 = df.frame_peak_s(h, w, 16, False)
    assert bf16 == pytest.approx(flops.generator_flops_per_frame(h, w) / flops.H100_PEAK_BF16_FLOPS)
    tail = 2.0 * flops.int8_tail_macs_per_frame(h, w)
    q = df.frame_peak_s(h, w, 16, True)
    assert q == pytest.approx((flops.generator_flops_per_frame(h, w) - tail) / 989e12
                              + tail / 1979e12)
