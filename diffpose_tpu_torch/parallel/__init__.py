"""Parallelism on ``torch.distributed``: the counterpart of ``diffpose_tpu/parallel``."""

from diffpose_tpu_torch.parallel.mesh import distributed_init, make_mesh
from diffpose_tpu_torch.parallel.sharding import (
    data_sharding,
    replicated,
    shard_batch,
    make_sharded_train_step,
    make_sharded_eval_step,
    make_sharded_video_eval_step,
    make_sharded_video_train_step,
    shard_windows,
)
from diffpose_tpu_torch.parallel.context import gather_frames, make_cp_video_forward

__all__ = [
    "distributed_init",
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch",
    "make_sharded_train_step",
    "make_sharded_eval_step",
    "make_sharded_video_train_step",
    "make_sharded_video_eval_step",
    "shard_windows",
    "gather_frames",
    "make_cp_video_forward",
]
