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
               scope: Optional[Sequence[str]] = None) -> nn.Module:
    """A reference-format state dict into a built module, one tensor at a
    time through `plan`'s strict map (`prefix`, `scope` as there). A
    quantized projection (a module with `load_weight_`: `QuantLinear`)
    quantizes its weight as it lands, a block of rows at a time, and its
    fp32 bias holds the model dtype's value, as a quantized bf16 Linear's
    does; every other tensor is copied into its parameter, cast to its
    dtype (the fp32 norm scales keep a checkpoint's fp32 values, which the
    JAX package rounds to the model dtype; a bf16 checkpoint's are the
    same). A shape that differs raises."""
    state = module.state_dict(keep_vars=True)
    modules = dict(module.named_modules())
    # a QuantLinear's weight_q and scale_q come from one HF weight
    names = [k.removesuffix("_q") for k in state if not k.endswith(".scale_q")]
    for name, src in plan(sd.keys(), names, prefix=prefix, scope=scope).items():
        value = fetch(sd, src)
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
