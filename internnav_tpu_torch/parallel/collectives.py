"""Collective helpers: the JAX package's dist.py surface on torch.distributed.

Port of internnav_tpu/parallel/collectives.py: `get_rank`,
`get_world_size`, `is_main_process`, `save_on_master`, `all_reduce_mean`
and `host_broadcast` over the default process group; `psum_mean` and
`grad_allreduce`, which JAX runs inside a sharded program over a mesh
axis, as all-reduces over the process group of one dimension of a
`DeviceMesh`. Without an initialised process group every helper is the
identity (rank 0 of 1), as the JAX helpers are in one process.

`psum_forward` is the vocab-parallel loss's reduction: an all-reduce sum
in the forward whose backward passes the gradient through unchanged
(Megatron's reduce-from-tensor-parallel region), because every rank of
the group computes the same loss from the summed value.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def save_on_master(save_fn, *args, **kwargs) -> None:
    """Run a checkpoint or IO function on rank 0 only."""
    if is_main_process():
        save_fn(*args, **kwargs)


def comm_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current CUDA device under NCCL, else the host."""
    if initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean(x: Any) -> Any:
    """Mean of a host value (scalar or array) over every process, in
    float64, returned in x's dtype; x itself in one process."""
    if get_world_size() == 1:
        return x
    arr = np.asarray(x)
    t = torch.as_tensor(arr, dtype=torch.float64, device=comm_device())
    dist.all_reduce(t)
    out = (t / get_world_size()).cpu().numpy().astype(arr.dtype)
    return out if arr.ndim else out[()]


def host_broadcast(x: Any) -> Any:
    """Rank 0's value of a picklable host object, on every rank."""
    if get_world_size() == 1:
        return x
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def mesh_group(mesh, dim: str):
    """The process group of mesh dimension `dim`, or None where there is
    no process group (or no mesh)."""
    if mesh is None or not initialized():
        return None
    return mesh.get_group(dim)


def psum_mean(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Mean of x over mesh dimension `dim` (a new tensor)."""
    group = mesh_group(mesh, dim)
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y.div_(dist.get_world_size(group))


@torch.no_grad()
def grad_allreduce(grads: Iterable[Optional[torch.Tensor]], mesh, dim: str) -> None:
    """Average each gradient over mesh dimension `dim`, in place (a DTensor
    gradient through its local shard). None entries are skipped."""
    group = mesh_group(mesh, dim)
    if group is None:
        return
    n = dist.get_world_size(group)
    for g in grads:
        if g is None:
            continue
        local = g.to_local() if hasattr(g, "to_local") else g
        dist.all_reduce(local, group=group)
        local.div_(n)


class _PsumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over `group` in the forward, the identity in the backward;
    x itself where group is None."""
    if group is None:
        return x
    return _PsumForward.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of x over `group`, without gradient."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y
