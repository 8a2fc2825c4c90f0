"""The port's own copy of the JAX package's ``TecoConfig`` dataclass
(tecogan_tpu/config.py): the same field names and defaults, so one
configuration describes a run in either package.  The port reads only a
few of the fields; the rest are kept so that the two stay one contract
(``tests/test_torch_port_config.py`` holds them equal).  The argparse
surface comes with the CLI slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TecoConfig:
    # ---- seeds -----------------------------------------------------------
    rand_seed: int = 1

    # ---- directories -----------------------------------------------------
    input_dir_LR: str = ""
    input_dir_len: int = -1
    input_dir_HR: str = ""
    mode: str = "train"
    output_dir: str = "output"
    output_pre: str = ""
    output_name: str = "output"
    output_ext: str = "jpg"
    summary_dir: str = "summary"
    videotype: str = ".mp4"
    inferencetype: str = "dataset"

    # ---- models ----------------------------------------------------------
    g_checkpoint: Optional[str] = None
    d_checkpoint: Optional[str] = None
    num_resblock: int = 16
    discrim_resblocks: int = 4
    discrim_channels: int = 128
    pre_trained_model: bool = False
    vgg_ckpt: Optional[str] = None

    # ---- machine resources -----------------------------------------------
    cudaID: str = "0"
    queue_thread: int = 8

    # ---- training details ------------------------------------------------
    RNN_N: int = 10
    batch_size: int = 4
    flip: bool = True
    random_crop: bool = True
    movingFirstFrame: bool = True
    crop_size: int = 32
    input_video_dir: str = "../TrainingDataPath"
    input_video_pre: str = "scene"
    str_dir: int = 1000
    end_dir: int = 1400
    end_dir_val: int = 2050
    max_frm: int = 119

    # ---- loss parameters -------------------------------------------------
    vgg_scaling: float = -0.002
    warp_scaling: float = 1.0
    pingpang: bool = False
    pp_scaling: float = 1.0

    # ---- optimizer -------------------------------------------------------
    EPS: float = 1e-12
    learning_rate: float = 1e-4
    decay_step: int = 250
    decay_rate: float = 0.8
    stair: bool = False
    beta: float = 0.9
    adameps: float = 1e-8
    max_epochs: int = 10_000_000

    # ---- Dst parameters --------------------------------------------------
    ratio: float = 0.01
    Dt_mergeDs: bool = True
    Dt_ratio_0: float = 1.0
    Dt_ratio_add: float = 0.0
    Dt_ratio_max: float = 1.0
    Dbalance: float = 0.4
    crop_dt: float = 0.75
    D_LAYERLOSS: bool = True

    # ---- extensions of the JAX package ------------------------------------
    precision: str = "bf16"  # bf16 | fp32 compute (params always fp32)
    bug_parity: bool = True  # reproduce the reference's quirks (exact route)
    data_axis: int = 0
    use_pallas: bool = True  # with bug_parity off: the fused s2d-carry route
    warp_group: int = 4  # fused route: 4 is the s2d route, others the NHWC route
    remat: bool = False
    prefetch: int = 2
    log_every: int = 10
    checkpoint_every: int = 1
    steps_per_epoch: int = -1
    gather_unroll_streams: bool = True  # a TPU gather lowering; no effect here
    steps_per_dispatch: int = 1
    infer_chunk: int = 0
    quantize: str = ""
    quantize_calib: str = "first_clip"
    transfer_dtype: str = "f32"
    adapt_steps: int = 0
    adapt_lr: float = 1e-4
    adapt_consistency: float = 2.0
    adapt_frames: int = 40
    consistency_refine: int = 0
    spatial_shards: int = 0
    rss_limit_gb: float = 0.0
    profile_dir: str = ""
    auto_resume: bool = False
    async_checkpoint: bool = True
    validate_every: int = 0
    jit: bool = True

    # ------------------------------------------------------------------
    @property
    def hr_size(self) -> int:
        return self.crop_size * 4

    @property
    def unrolled_frames(self) -> int:
        """Frames seen by the generator per step (ping-pong doubles the
        sequence to 2N-1)."""
        return self.RNN_N * 2 - 1 if self.pingpang else self.RNN_N

    def replace(self, **kw) -> "TecoConfig":
        return dataclasses.replace(self, **kw)
