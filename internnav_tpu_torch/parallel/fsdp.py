"""FSDP2 over the dp axis, and moving tensors between a layout and full.

`apply_fsdp` puts a layout's dp splits on a model with `fully_shard`
(FSDP2): each group module (bottom-up: the decoder layers, the frozen
vision tower) gathers its own parameters in one collective, and the root
takes every other one. A parameter the layout does not split over dp
(replicated, or split over tp only, as JAX's tp layout leaves the
Megatron-split ones) is FSDP's `ignored_params`: its gradient is averaged
over dp by the trainer (`collectives.grad_allreduce`).

`full_tensor` and `local_part` convert between a parameter's full value
and this rank's part of it under its placements (a DTensor's, or none),
for checkpoints that load into any layout.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from internnav_tpu_torch.parallel.mesh import Layout


def is_dtensor(t: torch.Tensor) -> bool:
    return hasattr(t, "device_mesh") and hasattr(t, "placements")


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local part; any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def apply_fsdp(root: nn.Module, groups: Sequence[nn.Module], layout: Layout, names: Dict[int, str],
               dp_mesh, dp_axis: str = "dp") -> None:
    """fully_shard each module of `groups` (in order, inner ones first)
    holding a parameter that the layout splits over dp_axis, then root.
    names maps id(parameter) → its name in the layout."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    def dims(p):
        return layout[names[id(p)]].get(dp_axis)

    ignored = {p for p in root.parameters() if dims(p) is None}

    def placement(p):
        return Shard(dims(p))

    for module in [*groups, root]:
        # a sharded module's parameters are new DTensor objects, not in names
        if module is root or any(id(p) in names and dims(p) is not None
                                 for p in module.parameters()):
            fully_shard(module, mesh=dp_mesh, shard_placement_fn=placement,
                        ignored_params=ignored)


def shard_groups(t: torch.Tensor):
    """The process groups over which a DTensor is split (one per mesh dim
    it is sharded on); () for a plain tensor."""
    if not is_dtensor(t):
        return ()
    mesh = t.device_mesh
    return tuple(mesh.get_group(i) for i, pl in enumerate(t.placements) if pl.is_shard())


def full_tensor(part: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The full value, on the host, of `part`, this rank's part of a tensor
    placed as `like` (a parameter; a DTensor's local shape). Collective
    where `like` is a DTensor: every rank of its mesh calls it."""
    if not is_dtensor(like):
        return part.detach().cpu()
    from torch.distributed.tensor import DTensor

    if is_dtensor(part):
        return part.detach().full_tensor().cpu()
    dt = DTensor.from_local(part.detach(), like.device_mesh, like.placements,
                            shape=like.shape, stride=like.stride())
    return dt.full_tensor().cpu()


def local_part(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of `full` under `like`'s placements (`full` itself
    for a plain tensor)."""
    if not is_dtensor(like):
        return full
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            full = full.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return full
