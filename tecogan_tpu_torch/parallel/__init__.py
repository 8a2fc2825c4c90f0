"""Multi-device serving and training over ``torch.distributed`` process
groups (tecogan_tpu/parallel): the (data, model) grid, data parallelism,
channel-sharded tensor parallelism and row-sharded single-stream
serving."""

from .dp import (build_dp_inference, build_dp_multi_train_step,
                 build_dp_quantized_inference, build_dp_train_step)
from .mesh import (Mesh, make_mesh, replicate_state, shard_batch, shard_multi_batch,
                   spawn)
from .spatial import build_spatial_clip_inference, build_spatial_fused_clip_inference
from .tp import build_tp_train_step, gather_state_tp, shard_state_tp, state_shardings

__all__ = ["Mesh", "build_dp_inference", "build_dp_multi_train_step",
           "build_dp_quantized_inference", "build_dp_train_step",
           "build_spatial_clip_inference", "build_spatial_fused_clip_inference",
           "build_tp_train_step", "gather_state_tp", "make_mesh", "replicate_state",
           "shard_batch", "shard_multi_batch", "shard_state_tp", "spawn", "state_shardings"]
