"""Device mesh construction and the FSDP placement rule.

Port of internnav_tpu/parallel/mesh.py. `make_mesh` builds a torch
`DeviceMesh` with named dimensions ("dp" data parallel, whose rows FSDP
also shards the parameters over; "tp" tensor parallel) over the ranks of
the process group, which `torchrun` or the caller starts. One axis may be
-1 (the remaining ranks).

A layout is a dict, parameter name → {mesh axis: torch dim}: the dims a
parameter is split on, the torch form of the JAX `PartitionSpec` of the
same leaf; {} is replicated. An axis's value may instead be `Blocks`, each
rank's own span of one dim, where the blocks are not equal (the serving
layout's query heads split 4 + 3) or repeat (a KV head held by the ranks
that share it); `block_of` reads either form. The JAX rule reads a Dense
kernel as (in, out) and a conv kernel as HWIO; the port's `nn.Linear`
weight is (out, in) and `nn.Conv2d` OIHW, so the rules walk each
parameter's dims in JAX order (`jax_dim_order`), and ties break as JAX's
do.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from internnav_tpu_torch.parallel.collectives import get_world_size, initialized


class Blocks(NamedTuple):
    """A split of `dim` whose blocks are not the axis's equal blocks: rank
    r holds [start, start + size) of it, spans[r] = (start, size). Ranks'
    sizes may differ and two ranks may hold the same span."""
    dim: int
    spans: Tuple[Tuple[int, int], ...]


#: a parameter name → {mesh axis: the torch dim split over it in equal
#: blocks, or its `Blocks`}
Layout = Dict[str, Dict[str, Union[int, Blocks]]]
#: parameters below this many elements stay replicated (the JAX rule)
MIN_SHARD_SIZE = 2**14


def mesh_sizes(axes: Optional[Mapping[str, int]], world: int) -> Dict[str, int]:
    """axes (name → size, one may be -1) resolved against `world` ranks;
    raises ValueError when they do not multiply to it."""
    axes = dict(axes or {"dp": -1})
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axes}: at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if world % known:
            raise ValueError(f"{world} ranks not divisible by the fixed axes {axes}")
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} != {world} ranks")
    return dict(zip(axes, sizes))


def make_mesh(axes: Optional[Mapping[str, int]] = None, device_type: Optional[str] = None):
    """A DeviceMesh over every rank of the process group, dims named as
    `axes`; device_type defaults to cuda under NCCL, else cpu."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sizes = mesh_sizes(axes, get_world_size())
    if not initialized():
        raise RuntimeError("make_mesh needs a process group: run under torchrun or call "
                           "torch.distributed.init_process_group first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes.values()), mesh_dim_names=tuple(sizes))


def block_of(split: Union[int, Blocks], shape: Sequence[int], n: int,
             r: int) -> Tuple[int, int, int]:
    """(dim, start, size) of rank r's block of a parameter of `shape`
    under a layout entry's split over an axis of n ranks: an int dim
    gives block r of n equal blocks of that dim, a `Blocks` its span r."""
    if isinstance(split, Blocks):
        return (split.dim, *split.spans[r])
    size = shape[split] // n
    return split, r * size, size


def axis_size(mesh: Any, axis: str) -> int:
    """The size of `axis` in a DeviceMesh or a name → size mapping (1 where
    the axis is absent)."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(axis, 1))
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(axis))) if axis in names else 1


def jax_dim_order(module: nn.Module, tensor: torch.Tensor) -> Tuple[int, ...]:
    """The torch dims of a parameter in the JAX leaf's dim order: a Linear
    weight's (in, out), a Conv2d weight's HWIO, else as they are."""
    if isinstance(module, nn.Linear) and tensor.dim() == 2:
        return (1, 0)
    if isinstance(module, nn.Conv2d) and tensor.dim() == 4:
        return (2, 3, 1, 0)
    return tuple(range(tensor.dim()))


def named_params_with_modules(model: nn.Module):
    """(name, module, parameter) for every parameter of model, once."""
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(prefix=mod_name, recurse=False):
            yield name, mod, p


def largest_divisible_dim(module: nn.Module, p: torch.Tensor, n: int,
                          min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The JAX FSDP choice for one parameter: its largest dim that n
    divides (ties to the later dim in JAX order), or None for a parameter
    under min_size elements or with no such dim."""
    if p.numel() < min_size:
        return None
    order = jax_dim_order(module, p)
    cand = [(p.shape[d], j, d) for j, d in enumerate(order) if p.shape[d] % n == 0]
    if not cand:
        return None
    return max(cand)[2]


def fsdp_param_sharding(model: nn.Module, mesh: Any, axis: str = "dp",
                        min_size: int = MIN_SHARD_SIZE) -> Layout:
    """Shard each parameter of min_size elements or more on its largest dim
    that the axis size divides; replicate the rest (ZeRO-3 style)."""
    n = axis_size(mesh, axis)
    out: Layout = {}
    for name, mod, p in named_params_with_modules(model):
        d = largest_divisible_dim(mod, p, n, min_size)
        out[name] = {} if d is None else {axis: d}
    return out


def row_bounds(rows: int, n: int, i: int) -> Tuple[int, int]:
    """Block i of n over `rows` rows, [i·b, (i + 1)·b) with b = rows / n,
    where n divides rows; else every row, [0, rows). The one row-split
    rule of the port: dp ranks take their block of a batch this way, and
    accumulation its micro-batches."""
    if rows % n:
        return 0, rows
    b = rows // n
    return i * b, (i + 1) * b


def shard_batch(batch: Mapping[str, Any], mesh: Any, axis: str = "dp",
                batch_axis: int = 0) -> Dict[str, Any]:
    """This rank's rows of every array leaf, nested dicts included (its
    `row_bounds` block over the mesh axis, along the leaf's `batch_axis`:
    0 for (B, ...) batches, 1 for time-major (T, N, ...) ones); other
    leaves, and leaves whose rows the axis does not divide, whole."""
    n = 1 if mesh is None else axis_size(mesh, axis)
    r = rank_of(mesh, axis)

    def take(x):
        if isinstance(x, Mapping):
            return {k: take(v) for k, v in x.items()}
        if not hasattr(x, "shape") or len(x.shape) <= batch_axis:
            return x
        a, b = row_bounds(x.shape[batch_axis], n, r)
        if (a, b) == (0, x.shape[batch_axis]):
            return x
        return x[(slice(None),) * batch_axis + (slice(a, b),)]

    return take(batch)


def rank_of(mesh: Any, axis: str) -> int:
    """This process's coordinate on `axis` (0 without a mesh or process group)."""
    if mesh is None or not initialized() or isinstance(mesh, Mapping):
        return 0
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0

