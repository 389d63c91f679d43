"""Reference-format InternVLA-N1 checkpoints → the port's state_dict.

Port of the InternVLA-N1 part of internnav_tpu/model/weights/convert.py:
`load_torch_state_dict` (:26) and the converters `convert_qwen25vl_text`
(:100), `convert_qwen25vl_vision` (:128), `convert_dinov2_vits` (:234),
`_torch_mha` (:593), `_convert_post_norm_decoder` (:729),
`convert_nextdit` (:814), `convert_memory_encoder` (:864),
`convert_qformer` (:883) and `convert_internvla_n1` (:895). The JAX
package goes HF → flax tree (and `from_jax` on to the port); here each
port parameter names its HF source directly (`hf_source`), with the same
layout rules: Linear weights keep torch's (out, in); the vision tower's
conv3d patch embed is flattened to (out, C·t·h·w); a packed q/k/v
projection (DINOv2's `attn.qkv`, torch MultiheadAttention's `in_proj_*`)
is split into thirds along its first axis.

The map is strict (`plan`): every port parameter must find its source,
every HF key must be consumed or named in `SKIPPED`, and a shape that
differs raises (`load_into_`, the one loop that fills a model, the
launchers' through `InternVLAN1Policy.from_pretrained_torch` and the
`convert_*` functions' alike). Both HF key layouts load: `model.language_model.` /
`model.visual.` (transformers >= 4.52) and `model.` / `visual.` (4.51,
which the reference pins). A checkpoint without `lm_head.weight` has tied
embeddings; the caller builds the text model with `tie_word_embeddings`.

`hf_state_dict` is the inverse (port → HF names), for writing an HF-layout
checkpoint from a port model in tests and in chip_smoke.py; no launcher
reaches it.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from internnav_tpu_torch.model.weights.safetensors_io import (
    INDEX_FILE,
    read_safetensors,
)

#: the port's native weights file (`InternVLAN1Policy.save_pretrained`): a
#: name no HF layout uses, so a native directory is told apart by its files
NATIVE_WEIGHTS = "internnav_torch_native.safetensors"
#: the single-file names tried in a checkpoint directory, in the JAX
#: package's order, before its shards
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin", "model.pth")
#: HF keys of a reference InternVLA-N1 checkpoint that no port parameter
#: takes: the QFormer's `visual_proj` (defined, never called), the
#: LuminaNextDiT2DModel image-patch input (`patch_embedder`, `pad_token`:
#: the reference feeds trajectory features past it) and DINOv2's
#: masked-image-modelling token
SKIPPED = re.compile(r"model\.rgb_resampler\.visual_proj\.(weight|bias)"
                     r"|model\.traj_dit\.model\.patch_embedder\..+"
                     r"|model\.traj_dit\.model\.pad_token"
                     r"|model\.rgb_model\.mask_token")
DIT = "model.traj_dit.model."


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format checkpoint as CPU tensors in their stored dtypes:
    a .safetensors / .bin / .pth file, or a directory holding
    `model.safetensors`, `pytorch_model.bin` or `model.pth` (in that
    order), else its safetensors shards (those of
    `model.safetensors.index.json` when present, else every .safetensors
    file but the port's native one). safetensors are memory-mapped;
    .bin / .pth go through `torch.load(weights_only=True, mmap=True)`."""
    if os.path.isdir(path):
        for name in WEIGHT_FILES:
            if os.path.exists(os.path.join(path, name)):
                return load_torch_state_dict(os.path.join(path, name))
        index = os.path.join(path, INDEX_FILE)
        if os.path.exists(index):
            import json

            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
        else:
            shards = sorted(f for f in os.listdir(path)
                            if f.endswith(".safetensors") and f != NATIVE_WEIGHTS)
        if not shards:
            raise FileNotFoundError(f"no reference-format weights in {path}")
        out: Dict[str, torch.Tensor] = {}
        for s in shards:
            out.update(read_safetensors(os.path.join(path, s)))
        return out
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


@dataclasses.dataclass(frozen=True)
class Source:
    """Where a port parameter comes from: the HF key, and `part` 0-2 for
    the q/k/v third of a packed projection (-1: the whole tensor), or
    `flatten` for the conv3d patch embed."""
    key: str
    part: int = -1
    flatten: bool = False


def _linear_qkv(prefix: str, qkv: str, leaf: str) -> Source:
    return Source(f"{prefix}{leaf}", "qkv".index(qkv))


def _mha(prefix: str, proj: str, leaf: str) -> Source:
    """torch nn.MultiheadAttention (`_torch_mha`): q/k/v from the packed
    in_proj, out_proj as it is."""
    if proj == "out":
        return Source(f"{prefix}out_proj.{leaf}")
    return Source(f"{prefix}in_proj_{leaf}", "qkv".index(proj))


#: (port name pattern, its HF source), first match wins; tp / vp are the
#: text and vision prefixes of the checkpoint's key layout
_RULES: Sequence[Tuple[str, Callable[..., Source]]] = (
    # Qwen2.5-VL text (convert_qwen25vl_text)
    (r"language_model\.lm_head\.(.+)", lambda m, tp, vp: Source(f"lm_head.{m[1]}")),
    (r"language_model\.(.+)", lambda m, tp, vp: Source(tp + m[1])),
    # Qwen2.5-VL vision tower (convert_qwen25vl_vision)
    (r"visual\.patch_embed\.weight",
     lambda m, tp, vp: Source(f"{vp}patch_embed.proj.weight", flatten=True)),
    (r"visual\.blocks\.(\d+)\.(qkv|proj)\.(.+)",
     lambda m, tp, vp: Source(f"{vp}blocks.{m[1]}.attn.{m[2]}.{m[3]}")),
    (r"visual\.blocks\.(\d+)\.((?:gate|up|down)_proj\..+)",
     lambda m, tp, vp: Source(f"{vp}blocks.{m[1]}.mlp.{m[2]}")),
    (r"visual\.blocks\.(\d+)\.(norm[12]\..+)",
     lambda m, tp, vp: Source(f"{vp}blocks.{m[1]}.{m[2]}")),
    (r"visual\.merger_ln_q\.(.+)", lambda m, tp, vp: Source(f"{vp}merger.ln_q.{m[1]}")),
    (r"visual\.merger_fc([12])\.(.+)",
     lambda m, tp, vp: Source(f"{vp}merger.mlp.{2 * int(m[1]) - 2}.{m[2]}")),
    # the N1 heads (convert_internvla_n1); memory_proj exists only in
    # configs where 2 x the DINOv2 width differs from the QFormer's
    (r"latent_queries", lambda m, tp, vp: Source("model.latent_queries")),
    (r"(action_encoder|action_decoder|memory_proj)\.(.+)",
     lambda m, tp, vp: Source(f"model.{m[1]}.{m[2]}")),
    (r"cond_projector\.([01])\.(.+)",
     lambda m, tp, vp: Source(f"model.cond_projector.{2 * int(m[1])}.{m[2]}")),
    # NextDiT (convert_nextdit; attn1.to_out is an Identity: nothing to map)
    (r"traj_dit\.caption_fc([12])\.(.+)",
     lambda m, tp, vp: Source(f"{DIT}caption_projection.linear_{m[1]}.{m[2]}")),
    (r"traj_dit\.time_caption_embed\.time_fc([12])\.(.+)",
     lambda m, tp, vp: Source(f"{DIT}time_caption_embed.timestep_embedder.linear_{m[1]}.{m[2]}")),
    (r"traj_dit\.time_caption_embed\.cap_(ln|fc)\.(.+)",
     lambda m, tp, vp: Source(f"{DIT}time_caption_embed.caption_embedder."
                              f"{0 if m[1] == 'ln' else 1}.{m[2]}")),
    (r"traj_dit\.layers\.(\d+)\.norm1_linear\.(.+)",
     lambda m, tp, vp: Source(f"{DIT}layers.{m[1]}.norm1.linear.{m[2]}")),
    (r"traj_dit\.layers\.(\d+)\.norm1_rms\.(.+)",
     lambda m, tp, vp: Source(f"{DIT}layers.{m[1]}.norm1.norm.{m[2]}")),
    (r"traj_dit\.layers\.(\d+)\.to_out\.(.+)",
     lambda m, tp, vp: Source(f"{DIT}layers.{m[1]}.attn2.to_out.0.{m[2]}")),
    (r"traj_dit\.norm_out_linear(2?)\.(.+)",
     lambda m, tp, vp: Source(f"{DIT}norm_out.linear_{2 if m[1] else 1}.{m[2]}")),
    (r"traj_dit\.(.+)", lambda m, tp, vp: Source(DIT + m[1])),
    # DINOv2 ViT-S (convert_dinov2_vits)
    (r"rgb_model\.patch_embed\.(.+)",
     lambda m, tp, vp: Source(f"model.rgb_model.patch_embed.proj.{m[1]}")),
    (r"rgb_model\.block\.(\d+)\.attn\.([qkv])_proj\.(.+)",
     lambda m, tp, vp: _linear_qkv(f"model.rgb_model.blocks.{m[1]}.attn.qkv.", m[2], m[3])),
    (r"rgb_model\.block\.(\d+)\.attn\.out_proj\.(.+)",
     lambda m, tp, vp: Source(f"model.rgb_model.blocks.{m[1]}.attn.proj.{m[2]}")),
    (r"rgb_model\.block\.(\d+)\.mlp_fc([12])\.(.+)",
     lambda m, tp, vp: Source(f"model.rgb_model.blocks.{m[1]}.mlp.fc{m[2]}.{m[3]}")),
    (r"rgb_model\.block\.(\d+)\.(ls[12])",
     lambda m, tp, vp: Source(f"model.rgb_model.blocks.{m[1]}.{m[2]}.gamma")),
    (r"rgb_model\.block\.(\d+)\.(.+)",
     lambda m, tp, vp: Source(f"model.rgb_model.blocks.{m[1]}.{m[2]}")),
    (r"rgb_model\.(.+)", lambda m, tp, vp: Source(f"model.rgb_model.{m[1]}")),
    # MemoryEncoder: torch TransformerEncoder layers (convert_memory_encoder)
    (r"memory_encoder\.layer\.(\d+)\.self_attn\.([qkv]|out)_proj\.(.+)",
     lambda m, tp, vp: _mha(f"model.memory_encoder.encoder.layers.{m[1]}.self_attn.", m[2], m[3])),
    (r"memory_encoder\.layer\.(\d+)\.(.+)",
     lambda m, tp, vp: Source(f"model.memory_encoder.encoder.layers.{m[1]}.{m[2]}")),
    (r"memory_encoder\.(.+)", lambda m, tp, vp: Source(f"model.memory_encoder.{m[1]}")),
    # QFormer: a post-norm torch TransformerDecoder (convert_qformer,
    # _convert_post_norm_decoder)
    (r"rgb_resampler\.decoder\.layer_(\d+)_(self|cross)\.([qkv]|out)_proj\.(.+)",
     lambda m, tp, vp: _mha(f"model.rgb_resampler.decoder.layers.{m[1]}."
                            f"{'self_attn' if m[2] == 'self' else 'multihead_attn'}.", m[3], m[4])),
    (r"rgb_resampler\.decoder\.layer_(\d+)_ff([12])\.(.+)",
     lambda m, tp, vp: Source(f"model.rgb_resampler.decoder.layers.{m[1]}.linear{m[2]}.{m[3]}")),
    (r"rgb_resampler\.decoder\.layer_(\d+)_ln([123])\.(.+)",
     lambda m, tp, vp: Source(f"model.rgb_resampler.decoder.layers.{m[1]}.norm{m[2]}.{m[3]}")),
    (r"rgb_resampler\.(query_tokens|query_pos)",
     lambda m, tp, vp: Source(f"model.rgb_resampler.{m[1]}")),
)
_COMPILED = [(re.compile(p), f) for p, f in _RULES]


def key_layout(hf_keys: Iterable[str]) -> Tuple[str, str]:
    """The (text, vision) key prefixes of a checkpoint: transformers >= 4.52
    writes `model.language_model.` / `model.visual.`, 4.51 `model.` /
    `visual.`."""
    keys = list(hf_keys)
    tp = ("model.language_model." if any(k.startswith("model.language_model.") for k in keys)
          else "model.")
    vp = "model.visual." if any(k.startswith("model.visual.") for k in keys) else "visual."
    return tp, vp


def hf_source(name: str, tp: str, vp: str) -> Source:
    """The HF source of the port parameter `name` (InternVLAN1Model naming)."""
    for pattern, fn in _COMPILED:
        m = pattern.fullmatch(name)
        if m:
            return fn(m, tp, vp)
    raise KeyError(f"port parameter {name} has no HF source rule")


def plan(hf_keys: Iterable[str], port_names: Iterable[str], *, prefix: str = "",
         scope: Optional[Sequence[str]] = None) -> Dict[str, Source]:
    """Each port parameter's HF source, strictly. port_names are the
    module's state_dict names; `prefix` puts them in InternVLAN1Model's
    naming (e.g. "language_model." for a QwenTextModel). Raises KeyError
    when a source is missing from hf_keys, or when a key of the checkpoint
    (those starting with one of `scope`'s prefixes; all by default) is
    neither consumed nor matched by SKIPPED."""
    keys = set(hf_keys)
    tp, vp = key_layout(keys)
    out = {n: hf_source(prefix + n, tp, vp) for n in port_names}
    missing = sorted({f"{n} <- {s.key}" for n, s in out.items() if s.key not in keys})
    if missing:
        raise KeyError(f"checkpoint lacks the sources of {len(missing)} port parameters: "
                       f"{missing[:8]}")
    used = {s.key for s in out.values()}
    left = sorted(k for k in keys - used if (scope is None or k.startswith(tuple(scope)))
                  and not SKIPPED.fullmatch(k))
    if left:
        raise KeyError(f"{len(left)} checkpoint keys are not taken by any port parameter: "
                       f"{left[:8]}")
    return out


def fetch(sd: Mapping[str, torch.Tensor], src: Source) -> torch.Tensor:
    """The tensor `src` names, in its stored dtype and device (a view where
    the layout allows one)."""
    t = sd[src.key]
    if src.part >= 0:
        n = t.shape[0] // 3
        return t[src.part * n:(src.part + 1) * n]
    if src.flatten:
        return t.reshape(t.shape[0], -1)
    return t


@torch.no_grad()
def load_into_(module: nn.Module, sd: Mapping[str, torch.Tensor], *, prefix: str = "",
               scope: Optional[Sequence[str]] = None,
               blocks: Optional[Mapping[str, Tuple[int, int, int]]] = None) -> nn.Module:
    """A reference-format state dict into a built module, one tensor at a
    time through `plan`'s strict map (`prefix`, `scope` as there). A
    quantized projection (a module with `load_weight_`: `QuantLinear`)
    quantizes its weight as it lands, a block of rows at a time, and its
    fp32 bias holds the model dtype's value, as a quantized bf16 Linear's
    does; every other tensor is copied into its parameter, cast to its
    dtype (the fp32 norm scales keep a checkpoint's fp32 values, which the
    JAX package rounds to the model dtype; a bf16 checkpoint's are the
    same). `blocks` (module state name → (dim, start, size): a serving
    layout's `serve_blocks`) takes only that block of a tensor, a view of
    the memory-mapped file. A shape that differs raises."""
    state = module.state_dict(keep_vars=True)
    modules = dict(module.named_modules())
    blocks = blocks or {}
    # a QuantLinear's weight_q and scale_q come from one HF weight
    names = [k.removesuffix("_q") for k in state if not k.endswith(".scale_q")]
    for name, src in plan(sd.keys(), names, prefix=prefix, scope=scope).items():
        value = fetch(sd, src)
        if name in blocks:
            value = value.narrow(*blocks[name])
        parent, _, leaf = name.rpartition(".")
        quantized = hasattr(modules[parent], "load_weight_")
        if quantized and leaf == "weight":
            modules[parent].load_weight_(value)
            continue
        if quantized:
            value = value.to(modules[parent].dtype)
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"{src.key} {tuple(value.shape)} -> {name} "
                             f"{tuple(state[name].shape)}: shape differs")
        state[name].copy_(value)
    return module


def _convert(sd: Mapping[str, torch.Tensor], module: nn.Module, prefix: str,
             scope: Optional[Sequence[str]]) -> Dict[str, torch.Tensor]:
    """`load_into_` a copy of module; its state_dict (module is left as it
    is)."""
    return load_into_(copy.deepcopy(module), sd, prefix=prefix, scope=scope).state_dict()


def convert_qwen25vl_text(sd: Mapping[str, torch.Tensor], module: nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """A Qwen2.5-VL checkpoint's text decoder → a QwenTextModel state_dict
    (module's dtypes). Without `lm_head.weight` the module must be tied."""
    tp, _ = key_layout(sd)
    return _convert(sd, module, "language_model.", (tp, "lm_head."))


def convert_qwen25vl_vision(sd: Mapping[str, torch.Tensor], module: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """A Qwen2.5-VL checkpoint's vision tower → a QwenVisionTower state_dict."""
    _, vp = key_layout(sd)
    return _convert(sd, module, "visual.", (vp,))


def convert_dinov2_vits(sd, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The N1 checkpoint's DINOv2 trunk (`model.rgb_model.`) → a DinoViT
    state_dict; qkv split into q/k/v."""
    return _convert(sd, module, "rgb_model.", ("model.rgb_model.",))


def convert_nextdit(sd, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The N1 checkpoint's `model.traj_dit.model.` → a NextDiT state_dict."""
    return _convert(sd, module, "traj_dit.", (DIT,))


def convert_memory_encoder(sd, module: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.memory_encoder.` (torch TransformerEncoder) → MemoryEncoder."""
    return _convert(sd, module, "memory_encoder.", ("model.memory_encoder.",))


def convert_qformer(sd, module: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.rgb_resampler.` → QFormer; `visual_proj` is skipped."""
    return _convert(sd, module, "rgb_resampler.", ("model.rgb_resampler.",))


def convert_internvla_n1(sd: Mapping[str, torch.Tensor], model: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """A whole reference InternVLA-N1 checkpoint → an InternVLAN1Model
    state_dict: every key of the checkpoint consumed or skipped."""
    return _convert(sd, model, "", None)


def hf_state_dict(model: nn.Module, *, text_prefix: str = "model.language_model.",
                  vision_prefix: str = "model.visual.") -> Dict[str, torch.Tensor]:
    """The inverse map: a bf16 or fp32 InternVLAN1Model's state as a
    reference-format HF state dict (in the given key layout), each tensor
    on the model's device in its dtype; packed projections concatenated,
    the patch embed back in its conv3d shape. For writing HF-layout
    checkpoints in tests and chip_smoke.py."""
    v = model.cfg.vision
    parts: Dict[str, List[Optional[torch.Tensor]]] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, t in model.state_dict().items():
        src = hf_source(name, text_prefix, vision_prefix)
        if src.part >= 0:
            parts.setdefault(src.key, [None] * 3)[src.part] = t
        elif src.flatten:
            out[src.key] = t.reshape(t.shape[0], v.in_channels, v.temporal_patch_size,
                                     v.patch_size, v.patch_size)
        else:
            out[src.key] = t
    for key, ts in parts.items():
        out[key] = torch.cat(ts)
    return out


# ------------------------------------------------ CMA / Seq2Seq (recurrent)
# Reference CMANet / Seq2SeqNet checkpoints (cma_policy.py:131-242,
# seq2seq_policy.py:128-179) → the port's CMANet / Seq2SeqNet, the
# counterparts of the JAX package's convert_cma_policy /
# convert_seq2seq_policy (:407-491); its sub-converters for the towers and
# the RNNs (convert_torchvision_resnet :168, convert_habitat_resnet_encoder
# :201, convert_gru / convert_lstm_bidir :328-348) are the name rules
# `_tv_name`, `_habitat_name` and `_RNN_LEAVES` here. Each port parameter
# names its reference key and a layout rule:
#   "same"     the tensor as it is;
#   "conv1d"   a 1x1 Conv1d (O, I, 1) is the port's Linear (O, I);
#   "spatial"  the reference views its (h·w, d) spatial table as (d, h, w)
#              (resnet_encoders.py:199-216): ours[t, d] = w.flat[d·h·w + t];
#   "flatten"  the reference flattens (B, C, T) channel-major into the
#              Linear, the port token-major: ours[:, t·C + c] = w[:, c·T + t].
_RNN_LEAVES = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
               "b_hh": "bias_hh_l0"}
_BN_LEAVES = {"weight": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _tv_name(rel: str) -> str:
    """A TorchVisionResNet trunk parameter → its torchvision name."""
    m = re.fullmatch(r"stem_(conv|bn)\.(\w+)", rel)
    if m:
        return f"conv1.{m[2]}" if m[1] == "conv" else f"bn1.{_BN_LEAVES[m[2]]}"
    m = re.fullmatch(r"(layer\d\.\d+)\.(conv\d|bn\d|ds_conv|ds_bn)\.(\w+)", rel)
    if not m:
        raise KeyError(f"{rel}: no torchvision name")
    sub = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}.get(m[2], m[2])
    leaf = _BN_LEAVES[m[3]] if "bn" in m[2] else m[3]
    return f"{m[1]}.{sub}.{leaf}"


def _habitat_name(rel: str, bottleneck: bool = True) -> str:
    """A HabitatResNetEncoder parameter → its reference (resnet.py) name:
    a block's Sequential interleaves conv, GroupNorm and ReLU."""
    m = re.fullmatch(r"backbone\.stem_(conv|gn)\.(\w+)", rel)
    if m:
        return f"backbone.conv1.{0 if m[1] == 'conv' else 1}.{m[2]}"
    m = re.fullmatch(r"compress_(conv|gn)\.(\w+)", rel)
    if m:
        return f"compression.{0 if m[1] == 'conv' else 1}.{m[2]}"
    m = re.fullmatch(r"backbone\.(layer\d\.\d+)\.(conv|gn|ds_conv|ds_gn)(\d?)\.(\w+)", rel)
    if not m:
        raise KeyError(f"{rel}: no reference name")
    if m[2].startswith("ds_"):
        return f"backbone.{m[1]}.downsample.{0 if m[2] == 'ds_conv' else 1}.{m[4]}"
    return f"backbone.{m[1]}.convs.{3 * (int(m[3]) - 1) + (m[2] == 'gn')}.{m[4]}"


def recurrent_reference_map(net: nn.Module) -> Dict[str, Tuple[str, str]]:
    """{port name: (reference key, layout rule)} for every tensor of a
    CMANet or Seq2SeqNet."""
    out: Dict[str, Tuple[str, str]] = {}
    for name in net.state_dict():
        rule = "same"
        m = re.fullmatch(r"instruction_encoder\.encoder_rnn_reverse\.(\w+)", name)
        if m:
            key = f"instruction_encoder.encoder_rnn.{m[1]}_reverse"
        elif name.startswith("instruction_encoder."):
            key = name
        elif m := re.fullmatch(r"((?:second_)?state_encoder)\.(\w+)", name):
            key = f"{m[1]}.rnn.{_RNN_LEAVES[m[2]]}"
        elif m := re.fullmatch(r"depth_encoder\.visual_encoder\.(.+)", name):
            key = "depth_encoder.visual_encoder." + _habitat_name(m[1])
        elif m := re.fullmatch(r"(rgb|depth)_encoder\.spatial_embeddings", name):
            key, rule = f"{m[1]}_encoder.spatial_embeddings.weight", "spatial"
        elif m := re.fullmatch(r"depth_encoder\.visual_fc\.(\w+)", name):
            key, rule = f"depth_encoder.visual_fc.1.{m[1]}", "flatten" if m[1] == "weight" else rule
        elif m := re.fullmatch(r"rgb_encoder\.fc\.(\w+)", name):
            key = f"rgb_encoder.fc.1.{m[1]}"
        elif m := re.fullmatch(r"rgb_encoder\.(.+)", name):
            tv = _tv_name(m[1])
            tv = re.sub(r"^(conv1|bn1)\.", lambda s: f"cnn.{0 if s[1] == 'conv1' else 1}.", tv)
            key = "rgb_encoder." + re.sub(r"^layer(\d)\.", lambda s: f"cnn.{3 + int(s[1])}.", tv)
        elif m := re.fullmatch(r"rgb_linear\.(\w+)", name):
            key = f"rgb_linear.2.{m[1]}"
        elif m := re.fullmatch(r"depth_linear\.(\w+)", name):
            key, rule = f"depth_linear.1.{m[1]}", "flatten" if m[1] == "weight" else rule
        elif m := re.fullmatch(r"(rgb_kv|depth_kv|text_k)\.(\w+)", name):
            key, rule = name, "conv1d" if m[2] == "weight" else rule
        elif m := re.fullmatch(r"second_state_compress\.(\w+)", name):
            key = f"second_state_compress.0.{m[1]}"
        elif m := re.fullmatch(r"action_head\.(\w+)", name):
            key = f"action_distribution.linear.{m[1]}"
        elif name == "prev_action_embed.weight":
            key = "prev_action_embedding.weight"
        else:  # state_q, text_q, progress_monitor
            key = name
        out[name] = (key, rule)
    return out


def _flat_tokens(net: nn.Module) -> int:
    return net.depth_encoder.n_tokens


def _from_reference(w: torch.Tensor, rule: str, tokens: int) -> torch.Tensor:
    if rule == "conv1d":
        return w[:, :, 0]
    if rule == "spatial":
        n, d = w.shape
        return w.reshape(d, n).t().contiguous()
    if rule == "flatten":
        out = w.shape[0]
        return w.reshape(out, -1, tokens).transpose(1, 2).reshape(out, -1).contiguous()
    return w


def _to_reference(w: torch.Tensor, rule: str, tokens: int) -> torch.Tensor:
    if rule == "conv1d":
        return w[:, :, None]
    if rule == "spatial":
        n, d = w.shape
        return w.t().contiguous().reshape(n, d)
    if rule == "flatten":
        out = w.shape[0]
        return w.reshape(out, tokens, -1).transpose(1, 2).reshape(out, -1).contiguous()
    return w


def strip_prefixes(sd: Mapping[str, torch.Tensor],
                   prefixes: Sequence[str] = ("module.", "net.")) -> Dict[str, torch.Tensor]:
    """The reference's DDP / policy wrapper prefixes removed from each key."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def convert_recurrent_policy(sd: Mapping[str, torch.Tensor], net: nn.Module
                             ) -> Dict[str, torch.Tensor]:
    """A reference CMANet / Seq2SeqNet state dict → `net`'s state_dict (in
    its dtypes, on the host). Every port tensor must find its key and
    shape (KeyError / ValueError); keys the port does not read, such as
    BatchNorm's `num_batches_tracked`, are left."""
    sd = strip_prefixes(sd)
    target, tokens = net.state_dict(), _flat_tokens(net)
    out: Dict[str, torch.Tensor] = {}
    for name, (key, rule) in recurrent_reference_map(net).items():
        if key not in sd:
            raise KeyError(f"reference checkpoint has no {key} (for {name})")
        value = _from_reference(sd[key], rule, tokens).to(target[name].dtype)
        if tuple(value.shape) != tuple(target[name].shape):
            raise ValueError(f"{key} {tuple(sd[key].shape)} -> {name} "
                             f"{tuple(target[name].shape)}: shape differs")
        out[name] = value.cpu()
    return out


convert_cma_policy = convert_seq2seq_policy = convert_recurrent_policy


def recurrent_reference_state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse map: a CMANet / Seq2SeqNet as a reference-format state
    dict (the keys JAX's convert_cma_policy / convert_seq2seq_policy read),
    on the host. For writing reference-layout checkpoints in tests and
    chip_smoke.py."""
    tokens, state = _flat_tokens(net), net.state_dict()
    return {key: _to_reference(state[name].detach(), rule, tokens).cpu().contiguous()
            for name, (key, rule) in recurrent_reference_map(net).items()}


# ------------------------------------------------------------------ RDP
# Reference RDPNet checkpoints (rdp_policy.py:116-297 module names) → the
# port's RDPNet, the counterpart of the JAX package's convert_rdp_policy
# (:652) with its sub-converters convert_bert_language_encoder (:492),
# convert_longclip_text (encoder/longclip.py), convert_crossmodal_encoder
# (:523), convert_clip_visual (:554), convert_distance_network (:582),
# _torch_mha (:593) and convert_diffusion_transformer (:604). Rules beside
# the recurrent ones:
#   "qkv0" / "qkv1" / "qkv2"  a third of a packed q/k/v projection
#              (torch MultiheadAttention's and CLIP's in_proj_*);
#   "token_type"  RoBERTa's position table, with the type-0 token_type
#              row folded in when the checkpoint has one.
_BERT_SUB = {"q_proj": "self.query", "k_proj": "self.key", "v_proj": "self.value",
             "out_proj": "output.dense"}
_POST_NORM = {"intermediate": "intermediate.dense", "output": "output.dense",
              "out_ln": "output.LayerNorm"}


def _mha_packed(prefix: str, proj: str, leaf: str, packed: str) -> Tuple[str, str]:
    """A MultiHeadAttention projection of the port → its key in a packed
    torch / CLIP attention `packed` (in_proj_* thirds, out_proj whole)."""
    if proj == "out_proj":
        return f"{prefix}{packed}.out_proj.{leaf}", "same"
    return f"{prefix}{packed}.in_proj_{leaf}", f"qkv{'qkv'.index(proj[0])}"


def _rdp_key(name: str) -> Tuple[str, str]:
    """(reference key, rule) of one RDPNet tensor."""
    if name == "instruction_encoder.embeddings.position_embeddings.weight":
        return name, "token_type"
    if name.startswith("instruction_encoder.embeddings."):
        return name, "same"
    if m := re.fullmatch(r"instruction_encoder\.layer\.(\d+)\.(\w+)\.?(\w*)\.(weight|bias)", name):
        i, mod, sub, leaf = m.groups()
        src = f"instruction_encoder.layer.{i}."
        if mod == "attention":
            return f"{src}attention.{_BERT_SUB[sub]}.{leaf}", "same"
        if mod == "attn_ln":
            return f"{src}attention.output.LayerNorm.{leaf}", "same"
        return f"{src}{_POST_NORM[mod]}.{leaf}", "same"
    if m := re.fullmatch(r"instruction_encoder\.(.+)", name):  # LongCLIP
        rel, tt = m[1], "instruction_encoder.text_transformer."
        if b := re.fullmatch(r"resblock\.(\d+)\.(\w+)\.(weight|bias)", rel):
            i, mod, leaf = b.groups()
            sub = {"in_proj": None, "out_proj": "attn.out_proj", "c_fc": "mlp.c_fc",
                   "c_proj": "mlp.c_proj"}.get(mod, mod)
            if sub is None:
                return f"{tt}transformer.resblocks.{i}.attn.in_proj_{leaf}", "same"
            return f"{tt}transformer.resblocks.{i}.{sub}.{leaf}", "same"
        return tt + rel, "same"
    if m := re.fullmatch(r"image_encoder\.visual\.(.+)", name):
        rel, vis = m[1], "image_encoder.image_transformer.visual."
        if b := re.fullmatch(r"block\.(\d+)\.attn\.(\w+)\.(weight|bias)", rel):
            return _mha_packed(f"{vis}transformer.resblocks.{b[1]}.", b[2], b[3], "attn")
        if b := re.fullmatch(r"block\.(\d+)\.(ln_1|ln_2|c_fc|c_proj)\.(weight|bias)", rel):
            sub = b[2] if b[2].startswith("ln") else f"mlp.{b[2]}"
            return f"{vis}transformer.resblocks.{b[1]}.{sub}.{b[3]}", "same"
        return vis + rel, "same"
    if m := re.fullmatch(r"image_encoder\.depth_encoder\.visual_encoder\.(.+)", name):
        return "image_encoder.depth_encoder.visual_encoder." + _habitat_name(m[1]), "same"
    if name == "image_encoder.depth_encoder.spatial_embeddings":
        return "image_encoder.depth_encoder.spatial_embeddings.weight", "spatial"
    if m := re.fullmatch(r"image_encoder\.depth_linear\.(\w+)", name):
        return f"image_encoder.depth_linear.1.{m[1]}", "flatten" if m[1] == "weight" else "same"
    if m := re.fullmatch(r"(img_txt|txt_img)_cross_encoder\.layer\.(\d+)\.(\w+)\.?(\w*)\."
                         r"(weight|bias)", name):
        enc, i, mod, sub, leaf = m.groups()
        src = f"{enc}_cross_encoder.cross_modal_encoder.crossattention.{i}."
        if mod in ("self_attn", "cross_attn"):
            part = "attention" if mod == "self_attn" else "crossattention"
            return f"{src}{part}.{_BERT_SUB[sub]}.{leaf}", "same"
        if mod in ("self_ln", "cross_ln"):
            part = "attention" if mod == "self_ln" else "crossattention"
            return f"{src}{part}.output.LayerNorm.{leaf}", "same"
        return f"{src}{_POST_NORM[mod]}.{leaf}", "same"
    if m := re.fullmatch(r"state_encoder\.(\w+)", name):
        return f"state_encoder.rnn.{_RNN_LEAVES[m[1]]}", "same"
    if m := re.fullmatch(r"(progress_monitor|stop_progress_predictor|distance_pred_net)\."
                         r"fc(\d)\.(weight|bias)", name):
        return f"{m[1]}.network.{2 * (int(m[2]) - 1)}.{m[3]}", "same"
    if m := re.fullmatch(r"action_dp_pred_net\.(.+)", name):
        rel, dp = m[1], "action_dp_pred_net."
        if b := re.fullmatch(r"cond_mlp_(\d)\.(weight|bias)", rel):
            return f"{dp}encoder.{2 * (int(b[1]) - 1)}.{b[2]}", "same"
        if b := re.fullmatch(r"(cond_layer|dec_layer)\.(\d+)\.(self_attn|cross_attn)\.(\w+)\."
                             r"(weight|bias)", rel):
            stack = "encoder" if b[1] == "cond_layer" else "decoder"
            packed = "multihead_attn" if b[3] == "cross_attn" else "self_attn"
            return _mha_packed(f"{dp}{stack}.layers.{b[2]}.", b[4], b[5], packed)
        if b := re.fullmatch(r"(cond_layer|dec_layer)\.(\d+)\.(.+)", rel):
            stack = "encoder" if b[1] == "cond_layer" else "decoder"
            return f"{dp}{stack}.layers.{b[2]}.{b[3]}", "same"
        return dp + rel, "same"
    return name, "same"  # prev_action_embedding*, imu_linear*, action_type_embeds, ...


def rdp_reference_map(net: nn.Module) -> Dict[str, Tuple[str, str]]:
    """{port name: (reference key, layout rule)} for every tensor of an
    RDPNet."""
    return {name: _rdp_key(name) for name in net.state_dict()}


def _rdp_normalized(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The prefixes JAX's converter also accepts, as the map names them: a
    HF CLIP tower under `vision_model.`, a cross encoder's layers without
    `cross_modal_encoder.`."""
    out = {}
    for k, v in strip_prefixes(sd).items():
        k = k.replace("image_encoder.image_transformer.vision_model.",
                      "image_encoder.image_transformer.visual.")
        k = re.sub(r"^(img_txt|txt_img)_cross_encoder\.crossattention\.",
                   r"\1_cross_encoder.cross_modal_encoder.crossattention.", k)
        out[k] = v
    return out


def _convert_by_map(sd: Mapping[str, torch.Tensor], net: nn.Module,
                    ref_map: Dict[str, Tuple[str, str]], tokens: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """The tensors of `net` that the reference state dict `sd` holds (in
    net's dtypes, on the host), each laid out by its map rule; what sd
    lacks is left out for the caller's tolerant merge
    (`model.base.merge_params`), as JAX's converters leave it. A DINOv2
    position table of another grid is resized to net's; any other shape
    that differs raises."""
    target = net.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for name, (key, rule) in ref_map.items():
        if key not in sd:
            continue
        w = sd[key]
        if rule.startswith("qkv"):
            w = w.chunk(3, dim=0)[int(rule[3])]
        elif rule == "token_type":
            tt = key.replace("position_embeddings", "token_type_embeddings")
            w = w + sd[tt][0][None] if tt in sd else w
        elif rule == "dino_pos" and w.shape != target[name].shape:
            g = int(round((target[name].shape[1] - 1) ** 0.5))
            w = interpolate_dino_pos_embed(w, (g, g))
        else:
            w = _from_reference(w, rule, tokens)
        if tuple(w.shape) != tuple(target[name].shape):
            raise ValueError(f"{key} {tuple(sd[key].shape)} -> {name} "
                             f"{tuple(target[name].shape)}: shape differs")
        out[name] = w.to(target[name].dtype).cpu().contiguous()
    return out


def _reference_by_map(net: nn.Module, ref_map: Dict[str, Tuple[str, str]], tokens: int = 0
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of `_convert_by_map`: net as a reference state dict,
    packed q/k/v thirds concatenated back, position tables as they are, on
    the host."""
    state = net.state_dict()
    out: Dict[str, torch.Tensor] = {}
    parts: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, (key, rule) in ref_map.items():
        w = state[name].detach().cpu()
        if rule.startswith("qkv"):
            parts.setdefault(key, {})[int(rule[3])] = w
        else:
            out[key] = _to_reference(w, rule, tokens).contiguous()
    for key, ps in parts.items():
        out[key] = torch.cat([ps[j] for j in range(3)]).contiguous()
    return out


def convert_rdp_policy(sd: Mapping[str, torch.Tensor], net: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """A reference RDPNet state dict → `net`'s tensors that it holds (in
    their dtypes, on the host). As JAX's converter, what the checkpoint
    lacks (the imu linears, the second cross encoder, a head) is left out
    for the caller's tolerant merge (`model.base.merge_params`); a shape
    that differs raises."""
    return _convert_by_map(_rdp_normalized(sd), net, rdp_reference_map(net),
                           net.image_encoder.depth_encoder.n_tokens)


def rdp_reference_state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse map: an RDPNet as a reference-format state dict (the
    keys JAX's convert_rdp_policy reads; the q/k/v thirds packed back, the
    position table without a token_type row), on the host. For writing
    reference-layout checkpoints in tests and chip_smoke.py."""
    return _reference_by_map(net, rdp_reference_map(net),
                             net.image_encoder.depth_encoder.n_tokens)


# ------------------------------------------------------------ NavDP / DPT
# Reference NavDPNet (navdp_policy.py:86-134 and navdp_backbone.py module
# names) and DepthAnythingV2 (dpt.py:38-185) checkpoints → the port's
# NavDPNet and DepthAnythingV2, the counterparts of the JAX package's
# convert_navdp_policy (:768, with _convert_post_norm_decoder :729 and
# _convert_pre_norm_decoder :748), convert_depth_anything_v2 (:298),
# convert_dinov2_vits (:234) and interpolate_dino_pos_embed (:270). Rules
# as RDP's ("qkv0" / "qkv1" / "qkv2" for a third of a packed projection),
# and "dino_pos" for a DINOv2 position table, resized to the port's patch
# grid when the checkpoint's differs (the reference resizes at run time).
_FORMER_SUB = {"self": "self_attn", "cross": "multihead_attn", "ff1": "linear1",
               "ff2": "linear2", "ln1": "norm1", "ln2": "norm2", "ln3": "norm3"}


def _dino_key(prefix: str, rel: str) -> Tuple[str, str]:
    """A DinoViT tensor (`rel`, port naming) → its DINOv2 key under
    `prefix`."""
    if rel == "pos_embed":
        return prefix + rel, "dino_pos"
    if m := re.fullmatch(r"patch_embed\.(\w+)", rel):
        return f"{prefix}patch_embed.proj.{m[1]}", "same"
    if m := re.fullmatch(r"block\.(\d+)\.attn\.([qkv])_proj\.(\w+)", rel):
        return f"{prefix}blocks.{m[1]}.attn.qkv.{m[3]}", f"qkv{'qkv'.index(m[2])}"
    if m := re.fullmatch(r"block\.(\d+)\.attn\.out_proj\.(\w+)", rel):
        return f"{prefix}blocks.{m[1]}.attn.proj.{m[2]}", "same"
    if m := re.fullmatch(r"block\.(\d+)\.mlp_fc([12])\.(\w+)", rel):
        return f"{prefix}blocks.{m[1]}.mlp.fc{m[2]}.{m[3]}", "same"
    if m := re.fullmatch(r"block\.(\d+)\.(ls[12])", rel):
        return f"{prefix}blocks.{m[1]}.{m[2]}.gamma", "same"
    if m := re.fullmatch(r"block\.(\d+)\.(.+)", rel):
        return f"{prefix}blocks.{m[1]}.{m[2]}", "same"
    return prefix + rel, "same"  # cls_token, norm.*


def _navdp_key(name: str) -> Tuple[str, str]:
    """(reference key, rule) of one NavDPNet tensor."""
    if m := re.fullmatch(r"rgbd_encoder\.(rgb_model|depth_model)\.(.+)", name):
        return _dino_key(f"rgbd_encoder.{m[1]}.", m[2])
    if m := re.fullmatch(r"(pixel_encoder\.pixelgoal_encoder|image_encoder\.imagegoal_encoder)"
                         r"\.(.+)", name):
        return _dino_key(m[1] + ".", m[2])
    if m := re.fullmatch(r"rgbd_encoder\.former_net\.layer_(\d+)_(\w+?)\.(.+)", name):
        src = f"rgbd_encoder.former_net.layers.{m[1]}.{_FORMER_SUB[m[2]]}"
        if b := re.fullmatch(r"([qkv]|out)_proj\.(\w+)", m[3]):
            return _mha_packed(src.rsplit(".", 1)[0] + ".", f"{b[1]}_proj", b[2],
                               _FORMER_SUB[m[2]])
        return f"{src}.{m[3]}", "same"
    if m := re.fullmatch(r"decoder\.layer_(\d+)\.(self_attn|cross_attn)\.(\w+)\.(\w+)", name):
        packed = "multihead_attn" if m[2] == "cross_attn" else "self_attn"
        return _mha_packed(f"decoder.layers.{m[1]}.", m[3], m[4], packed)
    if m := re.fullmatch(r"decoder\.layer_(\d+)\.(.+)", name):
        return f"decoder.layers.{m[1]}.{m[2]}", "same"
    if m := re.fullmatch(r"final_ln\.(\w+)", name):
        return f"layernorm.{m[1]}", "same"
    if m := re.fullmatch(r"(cond_pos_embed|out_pos_embed)\.weight", name):
        return f"{m[1]}.position_embedding.weight", "same"
    return name, "same"  # former_query / former_pe / the projections and heads


def navdp_reference_map(net: nn.Module) -> Dict[str, Tuple[str, str]]:
    """{port name: (reference key, layout rule)} for every tensor of a
    NavDPNet."""
    return {name: _navdp_key(name) for name in net.state_dict()}


def _dpt_key(name: str) -> Tuple[str, str]:
    """(reference key, rule) of one DepthAnythingV2 tensor."""
    if m := re.fullmatch(r"pretrained\.(.+)", name):
        return _dino_key("pretrained.", m[1])
    rel, h = name.removeprefix("depth_head."), "depth_head."
    if m := re.fullmatch(r"project_(\d)\.(\w+)", rel):
        return f"{h}projects.{m[1]}.{m[2]}", "same"
    if m := re.fullmatch(r"resize_(\d)\.(\w+)", rel):  # ConvTranspose2d's layout kept
        return f"{h}resize_layers.{m[1]}.{m[2]}", "same"
    if m := re.fullmatch(r"refinenet(\d)\.res([12])\.(.+)", rel):
        return f"{h}scratch.refinenet{m[1]}.resConfUnit{m[2]}.{m[3]}", "same"
    if m := re.fullmatch(r"output_conv2_(\d)\.(\w+)", rel):
        return f"{h}scratch.output_conv2.{m[1]}.{m[2]}", "same"
    return f"{h}scratch.{rel}", "same"  # layer{i}_rn, refinenet{i}.out_conv, output_conv1


def depth_anything_reference_map(net: nn.Module) -> Dict[str, Tuple[str, str]]:
    """{port name: (reference key, layout rule)} for every tensor of a
    DepthAnythingV2."""
    return {name: _dpt_key(name) for name in net.state_dict()}


def interpolate_dino_pos_embed(pos: torch.Tensor, grid_hw, offset: float = 0.1) -> torch.Tensor:
    """DINOv2 position embeddings (1, 1+N, D) resized to a patch grid as the
    reference does at run time (dinov2.py:180-211: bicubic in
    scale-factor form with the +0.1 offset, antialias off); fp32."""
    import math

    import torch.nn.functional as F

    cls_pos, patch_pos = pos[:, :1].float(), pos[:, 1:].float()
    s = int(math.sqrt(patch_pos.shape[1]))
    h, w = grid_hw
    if (h, w) == (s, s):
        return pos
    dim = pos.shape[-1]
    t = patch_pos.reshape(1, s, s, dim).permute(0, 3, 1, 2)
    t = F.interpolate(t, scale_factor=((h + offset) / s, (w + offset) / s), mode="bicubic",
                      antialias=False)
    if tuple(t.shape[-2:]) != (h, w):
        raise ValueError(f"pos_embed {s}x{s} resized to {tuple(t.shape[-2:])}, not {h}x{w}")
    return torch.cat([cls_pos, t.permute(0, 2, 3, 1).reshape(1, h * w, dim)], dim=1)


def convert_navdp_policy(sd: Mapping[str, torch.Tensor], net: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """A reference NavDPNet state dict → `net`'s tensors that it holds. As
    JAX's converter, a checkpoint without the goal towers or the aux heads
    leaves them to the merge."""
    return _convert_by_map(strip_prefixes(sd), net, navdp_reference_map(net))


def navdp_reference_state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse map: a NavDPNet as a reference-format state dict (the keys
    JAX's convert_navdp_policy reads), for writing reference-layout
    checkpoints in tests and chip_smoke.py."""
    return _reference_by_map(net, navdp_reference_map(net))


def convert_depth_anything_v2(sd: Mapping[str, torch.Tensor], net: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """A DepthAnythingV2 checkpoint (`pretrained.*` DINOv2 trunk and
    `depth_head.*` DPT head) → `net`'s tensors; the trunk's position table
    resized to net's patch grid. refinenet4's unused resConfUnit1 is left
    (the port's first fusion block has no skip unit, as JAX's)."""
    return _convert_by_map(strip_prefixes(sd), net, depth_anything_reference_map(net))


def depth_anything_reference_state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse map of `convert_depth_anything_v2`, with refinenet4's
    resConfUnit1 as zeros: the reference module holds that unit and never
    runs it, and JAX's converter reads it."""
    out = _reference_by_map(net, depth_anything_reference_map(net))
    unit = "depth_head.scratch.refinenet4.resConfUnit1."
    for conv in ("conv1", "conv2"):
        for leaf in ("weight", "bias"):
            like = out[f"depth_head.scratch.refinenet4.resConfUnit2.{conv}.{leaf}"]
            out[f"{unit}{conv}.{leaf}"] = torch.zeros_like(like)
    return out
