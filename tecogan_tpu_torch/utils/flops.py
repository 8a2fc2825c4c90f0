"""Analytic FLOP accounting for MFU reporting (tecogan_tpu/utils/flops.py).

Counts the useful multiply-accumulates of the generator, the
discriminator and a train step, with transposed convs counted at
input-pixel granularity; elementwise work (warp, sigmoid, relu,
space-to-depth, BN, losses, Adam) is excluded.  The counts are the JAX
package's; the peak is the H100's.
"""

from __future__ import annotations

# NVIDIA H100 SXM dense tensor-core peaks (data sheet, 700 W).
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12


def generator_macs_per_frame(
    h: int, w: int, num_resblock: int = 16, out_channels: int = 3
) -> int:
    """MACs for one generator forward at LR resolution (h, w)."""
    px = h * w
    macs = 0
    macs += 9 * 51 * 64 * px                      # conv_in
    macs += num_resblock * 2 * 9 * 64 * 64 * px   # LR resblocks
    macs += 9 * 64 * 64 * px                      # up1 (convT s2, input px)
    macs += 2 * 9 * 64 * 64 * (4 * px)            # trunk_rb1 @ 2Hx2W
    macs += 9 * (64 * 128 + 128 * 128) * (4 * px)  # trunk_rb2 @ 2Hx2W
    macs += 9 * 128 * 128 * (4 * px)              # up2 (convT s2, input 2Hx2W)
    macs += 9 * 128 * 64 * (16 * px)              # conv_hr @ 4Hx4W
    macs += 9 * 64 * out_channels * (16 * px)     # conv_out @ 4Hx4W
    return macs


def generator_flops_per_frame(h: int, w: int, num_resblock: int = 16) -> float:
    """FLOPs (2 x MACs) of one frame of recurrent inference at LR (h, w)."""
    return 2.0 * generator_macs_per_frame(h, w, num_resblock)


def inference_mfu(fps: float, h: int, w: int, num_resblock: int = 16,
                  peak_flops: float = H100_PEAK_BF16_FLOPS) -> dict:
    """Model-FLOPs utilization of recurrent inference at ``fps`` frames a
    second against the bf16 dense peak."""
    fpf = generator_flops_per_frame(h, w, num_resblock)
    achieved = fps * fpf
    return {"gen_tflop_per_frame": fpf / 1e12, "achieved_tflops": achieved / 1e12,
            "mfu": achieved / peak_flops}


def int8_tail_macs_per_frame(h: int, w: int, num_resblock: int = 16) -> int:
    """MACs of the quantized tail (the int8 convs, engine/quant.py) for one
    frame at LR resolution (h, w): the generator without ``conv_in`` and
    ``conv_out``, transposed convs at input-pixel granularity."""
    return (generator_macs_per_frame(h, w, num_resblock)
            - 9 * 51 * 64 * h * w - 9 * 64 * 3 * 16 * h * w)


def discriminator_macs(h4: int, w4: int, resblocks: int = 4,
                       channels: int = 128) -> int:
    """MACs for one discriminator forward on an (h4, w4) 27-channel
    triplet input (crop_dt crops and pads back, so the size holds)."""
    px = h4 * w4
    C = channels
    macs = 9 * 27 * 64 * px                       # conv_in k3
    macs += 16 * 64 * 64 * (px // 4)              # block1 k4 s2
    macs += resblocks * 2 * 9 * 64 * 64 * (px // 4)
    macs += 16 * 64 * C * (px // 16)              # block2
    macs += resblocks * 2 * 9 * C * C * (px // 16)
    macs += 16 * C * C * (px // 64)               # block3
    macs += resblocks * 2 * 9 * C * C * (px // 64)
    macs += 16 * C * 64 * (px // 256)             # block4
    macs += 16 * 64 * 3 * (px // 1024)            # block5
    macs += 3 * (px // 1024)                      # fc
    return macs


def train_step_macs(batch: int, rnn_n: int, crop: int, num_resblock: int = 16,
                    discrim_resblocks: int = 4, discrim_channels: int = 128,
                    pingpang: bool = False, bug_parity: bool = True) -> int:
    """MACs for one TecoGAN optimizer step (G step + D step), counted as
    the JAX package counts them: a backward costs 2x its forward (1x when
    only input grads are needed, through D to G); G unrolls 2*RNN_N - 1
    frames with ping-pong, else RNN_N; D sees T//3 triplets a branch; the
    D step runs both branches forward and backward; the G objective runs
    the fake branch forward, plus its input grads when the adversarial
    gradient flows (``bug_parity`` off)."""
    t_u = 2 * rnn_n - 1 if pingpang else rnn_n
    gmacs = generator_macs_per_frame(crop, crop, num_resblock)
    dmacs = discriminator_macs(4 * crop, 4 * crop, discrim_resblocks,
                               discrim_channels)
    n_trip = t_u // 3
    total = 3 * batch * t_u * gmacs                      # G fwd+bwd
    total += 2 * batch * n_trip * dmacs * 3              # D step, 2 branches
    total += batch * n_trip * dmacs * (1 if bug_parity else 2)  # G step's D
    return total


def train_mfu(ms_per_step: float, batch: int, rnn_n: int, crop: int,
              num_resblock: int = 16, discrim_resblocks: int = 4,
              discrim_channels: int = 128, pingpang: bool = False,
              bug_parity: bool = True,
              peak_flops: float = H100_PEAK_BF16_FLOPS) -> dict:
    """Model-FLOPs utilization of one training step against the bf16
    dense peak."""
    flops = 2.0 * train_step_macs(batch, rnn_n, crop, num_resblock,
                                  discrim_resblocks, discrim_channels,
                                  pingpang, bug_parity)
    achieved = flops / (ms_per_step / 1e3)
    return {"train_tflop_per_step": flops / 1e12,
            "achieved_tflops": achieved / 1e12,
            "mfu": achieved / peak_flops}
