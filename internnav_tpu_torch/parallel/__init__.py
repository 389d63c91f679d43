"""Data, FSDP and tensor parallelism of the port on torch.distributed
(the JAX package's `parallel/`): collectives, the device mesh and its
placement rules, FSDP2, and the Megatron tensor-parallel plan for
training (DTensors) and for serving (`tp.apply_serve_tp`: local shards)."""

from internnav_tpu_torch.parallel.collectives import (
    all_reduce_mean,
    get_rank,
    get_world_size,
    grad_allreduce,
    host_broadcast,
    is_main_process,
    psum_mean,
    save_on_master,
)
from internnav_tpu_torch.parallel.mesh import (
    fsdp_param_sharding,
    make_mesh,
    mesh_sizes,
    shard_batch,
)
from internnav_tpu_torch.parallel.tp import qwen_tp_sharding

__all__ = [
    "all_reduce_mean", "get_rank", "get_world_size", "grad_allreduce", "host_broadcast",
    "is_main_process", "psum_mean", "save_on_master", "fsdp_param_sharding", "make_mesh",
    "mesh_sizes", "shard_batch", "qwen_tp_sharding",
]
