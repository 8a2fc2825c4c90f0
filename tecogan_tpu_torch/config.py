"""The port's own copy of the JAX package's ``TecoConfig`` dataclass
(tecogan_tpu/config.py): the same field names and defaults, so one
configuration describes a run in either package.  The port reads only a
few of the fields; the rest are kept so that the two stay one contract
(``tests/test_torch_port_config.py`` holds them equal).  The argparse
surface of the command line (``cli/main.py``) is the JAX package's:
:func:`build_parser` takes the same flags with the same defaults, types,
``nargs`` and choices (``tests/test_torch_port_cli_config.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


def str2bool(v) -> bool:
    """Boolean flag coercion with the reference's spellings."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


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
    cudaID: str = "0"  # accepted for the CLI; the device is the visible card
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
    jit: bool = True  # an XLA switch; no effect here (the port runs eagerly)

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


def build_parser() -> argparse.ArgumentParser:
    """The command line's flags: the reference's (main.py:33-127) and the
    JAX package's extensions, with ``TecoConfig``'s defaults.  ``--cudaID``
    and ``--jit`` are accepted and change nothing: the port runs eagerly on
    the visible card.  ``gather_unroll_streams`` has no flag, as in the
    JAX package."""
    p = argparse.ArgumentParser(description="TecoGAN (PyTorch / CUDA)")
    d = TecoConfig()

    p.add_argument("--rand_seed", default=d.rand_seed, type=int, help="random seed")
    # directories
    p.add_argument("--input_dir_LR", default=d.input_dir_LR, nargs="?")
    p.add_argument("--input_dir_len", default=d.input_dir_len, type=int)
    p.add_argument("--input_dir_HR", default=d.input_dir_HR, nargs="?")
    p.add_argument("--mode", default=d.mode, nargs="?", help="train, or inference")
    p.add_argument("--output_dir", default=d.output_dir)
    p.add_argument("--output_pre", default=d.output_pre, nargs="?")
    p.add_argument("--output_name", default=d.output_name, nargs="?")
    p.add_argument("--output_ext", default=d.output_ext, nargs="?")
    p.add_argument("--summary_dir", default=d.summary_dir, nargs="?")
    p.add_argument("--videotype", default=d.videotype, type=str)
    p.add_argument("--inferencetype", default=d.inferencetype, type=str)
    # models
    p.add_argument("--g_checkpoint", default=d.g_checkpoint)
    p.add_argument("--d_checkpoint", default=d.d_checkpoint, nargs="?")
    p.add_argument("--num_resblock", type=int, default=d.num_resblock)
    p.add_argument("--discrim_resblocks", type=int, default=d.discrim_resblocks)
    p.add_argument("--discrim_channels", type=int, default=d.discrim_channels)
    p.add_argument("--pre_trained_model", type=str2bool, default=d.pre_trained_model)
    p.add_argument("--vgg_ckpt", default=d.vgg_ckpt)
    # machine resources
    p.add_argument("--cudaID", default=d.cudaID, help="accepted; no effect")
    p.add_argument("--queue_thread", default=d.queue_thread, type=int)
    # training details
    p.add_argument("--RNN_N", default=d.RNN_N, type=int, nargs="?")
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--flip", default=d.flip, type=str2bool)
    p.add_argument("--random_crop", default=d.random_crop, type=str2bool)
    p.add_argument("--movingFirstFrame", default=d.movingFirstFrame, type=str2bool)
    p.add_argument("--crop_size", default=d.crop_size, type=int)
    p.add_argument("--input_video_dir", type=str, default=d.input_video_dir)
    p.add_argument("--input_video_pre", default=d.input_video_pre, type=str)
    p.add_argument("--str_dir", default=d.str_dir, type=int)
    p.add_argument("--end_dir", default=d.end_dir, type=int)
    p.add_argument("--end_dir_val", default=d.end_dir_val, type=int)
    p.add_argument("--max_frm", default=d.max_frm, type=int)
    # loss parameters
    p.add_argument("--vgg_scaling", default=d.vgg_scaling, type=float)
    p.add_argument("--warp_scaling", default=d.warp_scaling, type=float)
    p.add_argument("--pingpang", default=d.pingpang, type=str2bool)
    p.add_argument("--pp_scaling", default=d.pp_scaling, type=float)
    # training parameters
    p.add_argument("--EPS", default=d.EPS, type=float)
    p.add_argument("--learning_rate", default=d.learning_rate, type=float)
    p.add_argument("--decay_step", default=d.decay_step, type=int)
    p.add_argument("--decay_rate", default=d.decay_rate, type=float)
    p.add_argument("--stair", default=d.stair, type=str2bool)
    p.add_argument("--beta", default=d.beta, type=float)
    p.add_argument("--adameps", default=d.adameps, type=float)
    p.add_argument("--max_epochs", default=d.max_epochs, type=int)
    # Dst parameters
    p.add_argument("--ratio", default=d.ratio, type=float)
    p.add_argument("--Dt_mergeDs", default=d.Dt_mergeDs, type=str2bool)
    p.add_argument("--Dt_ratio_0", default=d.Dt_ratio_0, type=float)
    p.add_argument("--Dt_ratio_add", default=d.Dt_ratio_add, type=float)
    p.add_argument("--Dt_ratio_max", default=d.Dt_ratio_max, type=float)
    p.add_argument("--Dbalance", default=d.Dbalance, type=float)
    p.add_argument("--crop_dt", default=d.crop_dt, type=float)
    p.add_argument("--D_LAYERLOSS", default=d.D_LAYERLOSS, type=str2bool)
    # the JAX package's extensions
    p.add_argument("--precision", default=d.precision, choices=["bf16", "fp32"])
    p.add_argument("--bug_parity", default=d.bug_parity, type=str2bool)
    p.add_argument("--data_axis", default=d.data_axis, type=int)
    p.add_argument("--use_pallas", default=d.use_pallas, type=str2bool,
                   help="with --bug_parity False: the fused route (hand kernels)")
    p.add_argument("--warp_group", default=d.warp_group, type=int)
    p.add_argument("--remat", default=d.remat, type=str2bool)
    p.add_argument("--prefetch", default=d.prefetch, type=int)
    p.add_argument("--log_every", default=d.log_every, type=int)
    p.add_argument("--checkpoint_every", default=d.checkpoint_every, type=int)
    p.add_argument("--steps_per_epoch", default=d.steps_per_epoch, type=int)
    p.add_argument("--steps_per_dispatch", default=d.steps_per_dispatch, type=int)
    p.add_argument("--infer_chunk", default=d.infer_chunk, type=int)
    p.add_argument("--quantize", default=d.quantize, choices=["", "int8"])
    p.add_argument("--quantize_calib", default=d.quantize_calib,
                   choices=["first_clip", "per_clip"])
    p.add_argument("--transfer_dtype", default=d.transfer_dtype,
                   choices=["f32", "u8"])
    p.add_argument("--adapt_steps", default=d.adapt_steps, type=int)
    p.add_argument("--adapt_lr", default=d.adapt_lr, type=float)
    p.add_argument("--adapt_consistency", default=d.adapt_consistency,
                   type=float)
    p.add_argument("--adapt_frames", default=d.adapt_frames, type=int)
    p.add_argument("--consistency_refine", default=d.consistency_refine,
                   type=int)
    p.add_argument("--spatial_shards", default=d.spatial_shards, type=int)
    p.add_argument("--rss_limit_gb", default=d.rss_limit_gb, type=float)
    p.add_argument("--profile_dir", default=d.profile_dir)
    p.add_argument("--validate_every", default=d.validate_every, type=int)
    p.add_argument("--auto_resume", default=d.auto_resume, type=str2bool)
    p.add_argument("--async_checkpoint", default=d.async_checkpoint, type=str2bool)
    p.add_argument("--jit", default=d.jit, type=str2bool, help="accepted; no effect")
    return p


def parse_config(argv=None) -> TecoConfig:
    ns = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(TecoConfig)}
    return TecoConfig(**{k: v for k, v in vars(ns).items() if k in fields})
