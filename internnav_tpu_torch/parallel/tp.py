"""Tensor-parallel layout of the Qwen System-2 decoder (Megatron's plan).

Port of internnav_tpu/parallel/tp.py (`_TP_RULES`, `qwen_tp_sharding`) on
the port's module names, with the torch dim each rule splits (a Linear
weight is (out, in), so JAX's column split of a (in, out) kernel is dim 0
here):
- q/k/v column-parallel, their biases with them; o row-parallel;
- gate and up column-parallel; down row-parallel;
- `embed_tokens` and the lm_head split over the vocab rows;
- with `fsdp_rest`, every other parameter of 2^14 elements or more split
  over dp on its largest dim that dp divides (the FSDP rule), else
  replicated.

A ruled parameter whose dim the tp size does not divide falls through to
the next rule, as in JAX. `apply_tp` then puts the plan on the modules
with `torch.distributed.tensor.parallel`; it refuses (NotImplementedError,
naming the parameter) a layout whose attention or MLP splits would not be
whole heads or whole columns, where JAX lets GSPMD partition the rest
(tp = 8 at 7B: 3.5 query heads a device). That is the training layout.

The serving layout (`apply_serve_tp`, the JAX package's `qwen_tp_sharding`
under greedy decode) takes the same rules and the same check, and holds
each rank's shards as plain tensors sliced from the full weights, so that
K1's launches and the captured decode step see no DTensor: the model
all-reduces o_proj's and down_proj's partial sums and the vocab-split
embedding over the tp group, and takes the greedy argmax over the
vocab-split lm_head across it (`collectives.vocab_argmax`). The JAX rules
name `kernel` and `embedding` only, so quantized projections (W8A8, W4A8:
`QuantLinear` buffers, not parameters) stay whole on every rank, and their
layers run as unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from internnav_tpu_torch.parallel.mesh import (
    MIN_SHARD_SIZE,
    Layout,
    axis_size,
    largest_divisible_dim,
    named_params_with_modules,
)

#: (module name, parameter) → the torch dim split over tp
_TP_RULES = (
    (("q_proj", "weight"), 0), (("k_proj", "weight"), 0), (("v_proj", "weight"), 0),
    (("q_proj", "bias"), 0), (("k_proj", "bias"), 0), (("v_proj", "bias"), 0),
    (("o_proj", "weight"), 1),
    (("gate_proj", "weight"), 0), (("up_proj", "weight"), 0),
    (("down_proj", "weight"), 1),
    (("lm_head", "weight"), 0),
    (("embed_tokens", "weight"), 0),
)
#: the decoder layer's projections and their parallel style
_COLWISE = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "mlp.gate_proj",
            "mlp.up_proj")
_ROWWISE = ("self_attn.o_proj", "mlp.down_proj")


def _tp_dim(name: str, shape, n_tp: int) -> Optional[int]:
    keys = tuple(name.split("."))
    if keys[0] != "language_model":
        return None
    for suffix, dim in _TP_RULES:
        if keys[-2:] == suffix:
            return dim if shape[dim] % n_tp == 0 else None
    return None


def qwen_tp_sharding(model: nn.Module, mesh: Any, dp_axis: str = "dp", tp_axis: str = "tp",
                     fsdp_rest: bool = False) -> Layout:
    """The layout: the TP rules on the language model, dp-FSDP (with
    fsdp_rest) or replicated elsewhere."""
    n_tp, n_dp = axis_size(mesh, tp_axis), axis_size(mesh, dp_axis)
    out: Layout = {}
    for name, mod, p in named_params_with_modules(model):
        dim = _tp_dim(name, p.shape, n_tp)
        if dim is not None:
            out[name] = {tp_axis: dim}
            continue
        d = largest_divisible_dim(mod, p, n_dp, MIN_SHARD_SIZE) if fsdp_rest else None
        out[name] = {} if d is None else {dp_axis: d}
    return out


def check_whole_heads(model: nn.Module, layout: Layout, n_tp: int, tp_axis: str = "tp") -> None:
    """Raise NotImplementedError, naming the parameter, where the layout
    would give a rank a fraction of an attention head, or where a layer's
    paired projections are not split alike (JAX replicates a ruled
    parameter whose dim tp does not divide, and GSPMD partitions what that
    leaves; the port runs whole local heads only)."""
    lm = model.language_model
    tied = lm.lm_head is None
    head_dim = lm.cfg.head_dim
    for i, layer in enumerate(lm.layers):
        prefix = f"language_model.layers.{i}."
        quantized = {path for path in _COLWISE + _ROWWISE
                     if not isinstance(getattr(layer.get_submodule(path), "weight", None),
                                       nn.Parameter)}
        if quantized and len(quantized) < len(_COLWISE + _ROWWISE):
            raise NotImplementedError(
                f"tensor parallel at tp={n_tp}: {prefix.rstrip('.')} mixes quantized "
                f"projections {sorted(quantized)}, which stay whole, with split ones")
        for path in _COLWISE + _ROWWISE:
            if path in quantized:  # whole on every rank, as JAX's rules leave them
                continue
            name = prefix + path + ".weight"
            w = layer.get_submodule(path).weight
            width = w.shape[1 if path in _ROWWISE else 0]
            whole = width % (n_tp * (head_dim if "self_attn" in path else 1)) == 0
            if tp_axis not in layout.get(name, {}) or not whole:
                raise NotImplementedError(
                    f"tensor parallel at tp={n_tp}: {name} ({tuple(w.shape)}) does not split "
                    f"into whole {'heads' if 'self_attn' in path else 'columns'} a rank")
    if tied and tp_axis in layout.get("language_model.embed_tokens.weight", {}):
        raise NotImplementedError(
            f"tensor parallel at tp={n_tp}: language_model.embed_tokens.weight is also the "
            "lm_head (tied embeddings); a vocab-split tied head is not supported")


def apply_tp(model: nn.Module, layout: Layout, tp_mesh, tp_axis: str = "tp") -> None:
    """Put the layout's tensor-parallel splits on the language model's
    modules (DTensor parameters on `tp_mesh`): the decoder layers'
    projections, and the embedding and lm_head where the layout splits
    their vocab."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    n_tp = tp_mesh.size()
    check_whole_heads(model, layout, n_tp, tp_axis)
    lm = model.language_model
    plan: Dict[str, Any] = {p: ColwiseParallel() for p in _COLWISE}
    plan.update({p: RowwiseParallel() for p in _ROWWISE})
    for layer in lm.layers:
        parallelize_module(layer, tp_mesh, plan)
    if tp_axis in layout.get("language_model.embed_tokens.weight", {}):
        parallelize_module(lm, tp_mesh, {"embed_tokens": RowwiseParallel(
            input_layouts=Replicate(), output_layouts=Replicate())})
    if lm.lm_head is not None and tp_axis in layout.get("language_model.lm_head.weight", {}):
        # this rank's vocab columns of the logits (QwenTextModel.ce_sum)
        parallelize_module(lm, tp_mesh, {"lm_head": ColwiseParallel()})


# ------------------------------------------------------------ serving layout
def serve_tp_layout(lm: nn.Module, n_tp: int, tp_axis: str = "tp") -> Layout:
    """The serving layout of a `QwenTextModel` at tp = n_tp: the TP rules'
    splits of its parameters (names "language_model.<...>", as in
    `qwen_tp_sharding`), refused by `check_whole_heads` where a rank would
    hold a fraction of a head."""
    holder = nn.ModuleDict({"language_model": lm})
    layout = qwen_tp_sharding(holder, {tp_axis: n_tp}, tp_axis=tp_axis)
    check_whole_heads(holder, layout, n_tp, tp_axis)
    return layout


@torch.no_grad()
def apply_serve_tp(lm: nn.Module, group, tp_axis: str = "tp") -> Layout:
    """Lay a whole `QwenTextModel` out for serving over the ranks of
    `group` (a tp group of the mesh), in place: each split parameter
    becomes this rank's block of it (block r of tp equal blocks along the
    rule's dim, a copy when tp > 1), the module widths and the config's head and MLP widths become
    this rank's, and the model is told the group (the attention's and the
    MLP's all-reduce where their row-parallel weight is split, the
    embedding's and the lm_head's first vocab id where theirs is). Every
    rank of the group must hold the same full weights first. Returns the
    layout."""
    n_tp, r = dist.get_world_size(group), dist.get_rank(group)
    layout = serve_tp_layout(lm, n_tp, tp_axis)
    starts = {}
    for name, spec in layout.items():
        if tp_axis not in spec:
            continue
        mod_name, pname = name.removeprefix("language_model.").rsplit(".", 1)
        mod = lm.get_submodule(mod_name)
        p, dim = getattr(mod, pname), spec[tp_axis]
        size = p.shape[dim] // n_tp
        if n_tp > 1:
            p.data = p.data.narrow(dim, r * size, size).clone()
        starts[mod_name] = r * size
        if isinstance(mod, nn.Linear) and pname == "weight":
            mod.out_features, mod.in_features = p.shape
        elif isinstance(mod, nn.Embedding):
            mod.num_embeddings = p.shape[0]
    for i, layer in enumerate(lm.layers):
        if f"layers.{i}.self_attn.o_proj" in starts:
            layer.self_attn.tp_group = group
        if f"layers.{i}.mlp.down_proj" in starts:
            layer.mlp.tp_group = group
    lm.tp_group = group
    lm.embed_start = starts.get("embed_tokens")
    lm.head_start = starts.get("lm_head")
    attn, mlp = lm.layers[0].self_attn, lm.layers[0].mlp
    D = lm.cfg.head_dim
    local = dataclasses.replace(
        lm.cfg, num_attention_heads=attn.q_proj.out_features // D,
        num_key_value_heads=attn.k_proj.out_features // D,
        intermediate_size=mlp.gate_proj.out_features)
    for mod in lm.modules():
        if type(getattr(mod, "cfg", None)) is type(lm.cfg):
            mod.cfg = local
    return layout
