"""Data-parallel training and serving (tecogan_tpu/parallel/dp.py).

JAX jits one SPMD program with the batch sharded over the ``data`` axis
and the state replicated, and XLA inserts the collectives.  Here every
rank runs the single-device builders on its share of the batch, with the
collectives written out:

* training: the step of ``engine.train`` with the mesh's group -- D's
  BatchNorm over the global batch, the gradients and metrics averaged
  over the ranks, one D-balance decision for all (engine/train.py).
  Usage, on every rank::

      state = replicate_state(mesh, init_state(cfg, gen, device=mesh.device))
      lr, hr = shard_batch(mesh, lr_np, hr_np)
      state, metrics, gen_out = dp_step(state, lr, hr)

  ``gen_out`` is this rank's share, as JAX keeps it batch-sharded.
* serving: each rank runs the single-device clip route on its streams
  (the fused route's hand kernels under int8 too); the clips come back
  gathered on every rank.
"""

from __future__ import annotations

from ..config import TecoConfig
from ..engine.inference import build_clip_inference, build_quantized_clip_inference
from ..engine.train import build_multi_train_step, build_train_step
from .collectives import all_gather_cat
from .mesh import Mesh, broadcast_object


def build_dp_train_step(cfg: TecoConfig, mesh: Mesh, vgg_apply=None):
    """``dp_step(state, lr, hr) -> (state, metrics, gen_out)`` on this
    rank's ``B / n`` samples (``shard_batch``); the state replicated
    (``replicate_state``).  The metrics are the global batch's."""
    return build_train_step(cfg, vgg_apply=vgg_apply, device=mesh.device, group=mesh.group)


def build_dp_multi_train_step(cfg: TecoConfig, mesh: Mesh, vgg_apply=None):
    """``cfg.steps_per_dispatch`` data-parallel steps a call, on this
    rank's ``(K, B / n, ...)`` batches (``shard_multi_batch``)."""
    return build_multi_train_step(cfg, vgg_apply=vgg_apply, device=mesh.device,
                                  group=mesh.group)


def build_dp_inference(cfg: TecoConfig, mesh: Mesh):
    """``infer(model, lr_clips) -> sr_clips``: ``lr_clips`` are this rank's
    ``B / n`` streams (``shard_batch``), ``model`` the same weights on
    every rank; returns all ``B`` SR clips, in rank order, on every rank."""
    infer = build_clip_inference(cfg)

    def dp_infer(model, lr_clips):
        return all_gather_cat(infer(model, lr_clips), mesh, 0)

    return dp_infer


def build_dp_quantized_inference(cfg: TecoConfig, mesh: Mesh):
    """int8 (W8A8) serving over the ranks: ``(prepare, infer)`` as
    ``engine.inference.build_quantized_clip_inference``.

    * ``prepare(model, params, calib_clip, frames=8) -> qtail``: rank 0
      calibrates on the whole ``calib_clip`` (one single-device calibration,
      as the JAX package makes) and every rank receives its qtail, on the
      mesh's device.  Every rank must call it.
    * ``infer(model, qtail, lr_clips)``: this rank's streams through the
      int8 route; all ``B`` clips come back on every rank."""
    prepare_one, infer_one = build_quantized_clip_inference(cfg)

    def prepare(model, params, calib_clip, frames: int = 8):
        return calibrate_on_rank0(mesh, prepare_one, model, params, calib_clip, frames)

    def infer(model, qtail, lr_clips):
        return all_gather_cat(infer_one(model, qtail, lr_clips), mesh, 0)

    return prepare, infer


def calibrate_on_rank0(mesh: Mesh, prepare, model, params, calib_clip, frames: int = 8):
    """``prepare(model, params, calib_clip, frames)`` run on rank 0 alone,
    its qtail broadcast to every rank of ``mesh`` and placed on the rank's
    device."""
    from ..engine.quant import qtail_to

    qtail = prepare(model, params, calib_clip, frames) if mesh.rank == 0 else None
    return qtail_to(broadcast_object(mesh, qtail), mesh.device)
