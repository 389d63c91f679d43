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

Where tp does not divide the KV heads but is a multiple of them (tp = 8
at 7B, 4 KV heads: JAX splits q into 3.5 heads a device and k / v into
halves, and GSPMD partitions the rest), the serving layout shares each KV
head between r = tp / KV ranks instead (`shared_kv_spans`): ranks r·g …
r·g + r − 1 hold KV head g whole (k / v rows and biases, replicated over
them) and split its G = H / KV query heads as whole heads, the first
G mod r ranks ceil(G / r) and the rest floor(G / r) (4 + 3 at 7B); q's
rows and bias and o_proj's input columns follow a rank's heads, so
o_proj's blocks are uneven (`mesh.Blocks`). Each rank runs attention on
its own (H_local, 1) heads, all of them over its one KV head, and the
partial sums all-reduce as before; the MLP and vocab splits stay equal. No
query head is padded: a rank holds only weights the checkpoint has. At
most MAX_KV_SHARERS ranks share a KV head; a wider share (tp = 16 at 7B:
four ranks, 1.75 query heads a rank on average) is refused, naming the
parameter, as is every other layout without whole heads. Training keeps
the DTensor plan, which cannot replicate a KV head over a pair of ranks
and sum its gradients over them: `apply_tp` refuses tp = 8 at 7B.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from internnav_tpu_torch.parallel.mesh import (
    MIN_SHARD_SIZE,
    Blocks,
    Layout,
    axis_size,
    block_of,
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
#: the most ranks of the serving layout that share one KV head
MAX_KV_SHARERS = 2


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
    leaves; the port runs whole local heads only). A `Blocks` split is the
    serving layout's whole heads (`shared_kv_spans`)."""
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
            split = layout.get(name, {}).get(tp_axis)
            if isinstance(split, Blocks):
                continue
            w = layer.get_submodule(path).weight
            width = w.shape[1 if path in _ROWWISE else 0]
            attention = "self_attn" in path
            whole = width % (n_tp * (head_dim if attention else 1)) == 0
            if split is None or not whole:
                hint = ""
                if attention and _shares_kv(lm.cfg, n_tp):
                    hint = (" (serving shares each KV head between ranks instead: "
                            "`serve_tp_layout`; training at this tp is ROADMAP §1's first item)")
                raise NotImplementedError(
                    f"tensor parallel at tp={n_tp}: {name} ({tuple(w.shape)}) does not split "
                    f"into whole {'heads' if attention else 'columns'} a rank{hint}")
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
def _shares_kv(cfg, n_tp: int) -> bool:
    """Whether n_tp ranks would share the KV heads: tp a multiple of the
    KV head count that does not divide it."""
    KV = cfg.num_key_value_heads
    return n_tp > 1 and KV % n_tp != 0 and n_tp % KV == 0


def shared_kv_spans(cfg, n_tp: int
                    ) -> Optional[Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[int, int], ...]]]:
    """The serving layout's spans where n_tp ranks share the KV heads
    (`_shares_kv`), else None: per rank its (first row, rows) of q_proj
    (its whole query heads: of KV head g's G = H / KV heads, the first
    G mod r of the r ranks on g take ceil(G / r), the rest floor(G / r))
    and of k_proj / v_proj (KV head g whole). Raises NotImplementedError,
    naming q_proj, where more than MAX_KV_SHARERS ranks would share a KV
    head or a rank would hold no query head."""
    if not _shares_kv(cfg, n_tp):
        return None
    H, KV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    r, G = n_tp // KV, H // KV
    if r > MAX_KV_SHARERS or G < r:
        raise NotImplementedError(
            f"tensor parallel at tp={n_tp}: language_model.layers.0.self_attn.q_proj.weight "
            f"({H * D}, {cfg.hidden_size}): {H} query heads over {KV} KV heads would put {r} "
            f"ranks on a KV head ({H / n_tp:g} query heads a rank); the serving layout shares "
            f"a KV head between at most {MAX_KV_SHARERS}")
    small, big = divmod(G, r)
    q, kv = [], []
    for rank in range(n_tp):
        g, j = divmod(rank, r)
        first = g * G + j * small + min(j, big)
        q.append((first * D, (small + (j < big)) * D))
        kv.append((g * D, D))
    return tuple(q), tuple(kv)


def serve_tp_layout(lm: nn.Module, n_tp: int, tp_axis: str = "tp") -> Layout:
    """The serving layout of a `QwenTextModel` at tp = n_tp: the TP rules'
    splits of its parameters (names "language_model.<...>", as in
    `qwen_tp_sharding`), with q / k / v / o_proj as `Blocks` of whole
    heads where the ranks share the KV heads (`shared_kv_spans`), refused
    by `check_whole_heads` where a rank would hold a fraction of a
    head."""
    holder = nn.ModuleDict({"language_model": lm})
    layout = qwen_tp_sharding(holder, {tp_axis: n_tp}, tp_axis=tp_axis)
    # quantized projections are buffers, whole on every rank: nothing to span
    split_attention = "language_model.layers.0.self_attn.q_proj.weight" in layout
    spans = shared_kv_spans(lm.cfg, n_tp) if split_attention else None
    if spans is not None:
        q, kv = spans
        for i in range(len(lm.layers)):
            prefix = f"language_model.layers.{i}.self_attn."
            for leaf, split in (("q_proj.weight", Blocks(0, q)), ("q_proj.bias", Blocks(0, q)),
                                ("k_proj.weight", Blocks(0, kv)), ("k_proj.bias", Blocks(0, kv)),
                                ("v_proj.weight", Blocks(0, kv)), ("v_proj.bias", Blocks(0, kv)),
                                ("o_proj.weight", Blocks(1, q))):
                if prefix + leaf in layout:  # a parameter: quantized ones stay whole
                    layout[prefix + leaf] = {tp_axis: split}
    check_whole_heads(holder, layout, n_tp, tp_axis)
    return layout


@torch.no_grad()
def apply_serve_tp(lm: nn.Module, group, tp_axis: str = "tp") -> Layout:
    """Lay a whole `QwenTextModel` out for serving over the ranks of
    `group` (a tp group of the mesh), in place: each split parameter
    becomes this rank's block of it (`mesh.block_of`: block r of tp equal
    blocks along the rule's dim, or its span of the shared-KV layout; a
    copy when tp > 1), the module widths and the config's head and MLP
    widths become this rank's, and the model is told the group (the
    attention's and the MLP's all-reduce where their row-parallel weight
    is split, the embedding's and the lm_head's first vocab id where
    theirs is). Every rank of the group must hold the same full weights
    first, or the model is on the meta device and its blocks are loaded
    afterwards: `lm.serve_blocks` maps each split parameter's name (in the
    text model) to this rank's (dim, start, size). Returns the layout."""
    n_tp, r = dist.get_world_size(group), dist.get_rank(group)
    layout = serve_tp_layout(lm, n_tp, tp_axis)
    blocks = {}
    for name, spec in layout.items():
        if tp_axis not in spec:
            continue
        name = name.removeprefix("language_model.")
        mod_name, pname = name.rsplit(".", 1)
        mod = lm.get_submodule(mod_name)
        p = getattr(mod, pname)
        dim, start, size = blocks[name] = block_of(spec[tp_axis], p.shape, n_tp, r)
        if n_tp > 1:
            p.data = p.data.narrow(dim, start, size).clone()
        if isinstance(mod, nn.Linear) and pname == "weight":
            mod.out_features, mod.in_features = p.shape
        elif isinstance(mod, nn.Embedding):
            mod.num_embeddings = p.shape[0]
    for i, layer in enumerate(lm.layers):
        if f"layers.{i}.self_attn.o_proj.weight" in blocks:
            layer.self_attn.tp_group = group
        if f"layers.{i}.mlp.down_proj.weight" in blocks:
            layer.mlp.tp_group = group
    lm.tp_group = group
    lm.embed_start = blocks.get("embed_tokens.weight", (None, None))[1]
    lm.head_start = blocks.get("lm_head.weight", (None, None))[1]
    lm.serve_blocks = blocks
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
