"""InternVLA-N1 inference policy — System-2 step + System-1 step.

Port of internnav_tpu/model/basemodel/internvla_n1/policy.py
(`SimpleTokenizer`, `InternVLAN1Policy`): keeps the rgb history, builds the
Qwen chat prompt with history frames sampled by np.linspace, runs the fused
System-2 step (vision encode with per-frame caching → embed → bucketed
prefill + greedy decode → traj-latent chunk decode) or the unfused one
(every frame encoded → embed → greedy decode of the unpadded prompt →
`generate_latents`' re-prefill of prompt, generated tokens and traj
queries), and the System-1 NextDiT or NavDP denoise on the latent.

Differences from the JAX policy:
- System-1 frames are fitted to the DinoViT grid per stream: rgb and depth
  are each resized on their own grid mismatch (the JAX policy decides from
  the rgb grid alone and can pass a mismatched depth through);
- `s1_step_latent` takes an optional `x_init` (the denoise's starting
  noise) and, for NavDP, `step_noises` (its per-step ancestral noise);
  without them the noise is drawn from the policy's torch.Generator,
  x_init first;
- `navdp_async` without depth raises ValueError (the JAX policy fails
  there too, converting None to an array); the sync `navdp` reads no
  frames and takes no depth;
- the unfused System-2 step (`s2_step(fused=False)`) decodes through
  `qwen_text.greedy_generate`, whose static caches and decode loop (a
  captured CUDA graph a step on the card) are made for the call, its
  caches as long as the fused step's (the JAX function sizes them to the
  unpadded prompt and the budget: the masked slots change no value), and
  `generate_latents` runs its re-prefill without the lm_head (the JAX
  function computes the prompt's logits and drops them); the latents and
  tokens are the JAX function's;
- checkpoints (`from_pretrained_torch`, `save_pretrained`,
  `from_pretrained`) stream to the device one tensor at a time, and an
  int8 policy quantizes each projection as it lands; the native format is
  the port's state_dict in safetensors (`NATIVE_WEIGHTS`) beside the JAX
  package's config.json, not its params.msgpack; a tokenizer directory
  that fails to load raises instead of falling back to `SimpleTokenizer`;
  `from_pretrained_torch` refuses a NavDP config (the reference-format
  converter maps no NavDP head; the native format carries it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from internnav_tpu_torch import require_cuda
from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import (
    DecodeBuffers,
    StaticCaches,
)
from internnav_tpu_torch.model.basemodel.internvla_n1.model import (
    InternVLAN1Config,
    InternVLAN1Model,
)
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import (
    RMSNorm,
    greedy_decode_grouped,
    greedy_generate,
    quantize_qwen_text_,
)
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_vision import (
    preprocess_images_device,
    rotary_table,
    vision_indices,
)
from internnav_tpu_torch.model.encoder.vit import imagenet_normalize
from internnav_tpu_torch.model.utils.tokenization import has_tokenizer_files, load_hf_tokenizer
from internnav_tpu_torch.model.utils.vln_utils import (
    S1Output,
    S2Output,
    chunk_token,
    parse_actions,
    split_and_clean,
    traj_to_actions,
)
from internnav_tpu_torch.model.weights.convert import (
    NATIVE_WEIGHTS,
    load_into_,
    load_torch_state_dict,
)
from internnav_tpu_torch.model.weights.safetensors_io import read_safetensors, write_safetensors
from internnav_tpu_torch.ops.rope import get_rope_index_25
from internnav_tpu_torch.parallel.tp import apply_serve_tp

IM_START, IM_END = "<|im_start|>", "<|im_end|>"
VISION_START, VISION_END = "<|vision_start|>", "<|vision_end|>"


class SimpleTokenizer:
    """Whitespace tokenizer with Qwen special-token ids — a stand-in with
    the HF tokenizer's encode/decode interface."""

    QWEN_SPECIALS = {
        "<|im_start|>": 151644, "<|im_end|>": 151645,
        "<|vision_start|>": 151652, "<|vision_end|>": 151653,
        "<|image_pad|>": 151655, "<|traj_pad|>": 151667,
    }

    def __init__(self, vocab_size: int = 151680):
        self.vocab_size = vocab_size
        if vocab_size > max(self.QWEN_SPECIALS.values()):
            self.SPECIALS = dict(self.QWEN_SPECIALS)
        else:  # tiny vocab: compact special ids at the top
            self.SPECIALS = {name: vocab_size - len(self.QWEN_SPECIALS) + i
                             for i, name in enumerate(self.QWEN_SPECIALS)}
        self.eos_token_id = self.SPECIALS["<|im_end|>"]
        #: the prompt bucket's pad id (the JAX policy pads with eos_token_id,
        #: the same id unless a caller changes eos_token_id, as a benchmark
        #: does to force the full decode budget)
        self.pad_token_id = self.eos_token_id
        self._cache: Dict[str, int] = {}

    def encode(self, text: str) -> List[int]:
        pattern = "|".join(re.escape(s) for s in self.SPECIALS)
        out = []
        for piece in re.split(f"({pattern})", text):
            if not piece:
                continue
            if piece in self.SPECIALS:
                out.append(self.SPECIALS[piece])
            else:
                for w in piece.split():
                    # crc32: stable across processes, unlike hash()
                    out.append(self._cache.setdefault(
                        w, (zlib.crc32(w.encode()) % (self.vocab_size - 10)) + 3))
        return out

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.SPECIALS.items()}
        return " ".join(inv.get(int(i), f"tok{int(i)}") for i in ids
                        if int(i) not in (self.eos_token_id,))


def _resize_frames(frames: np.ndarray, hw: int) -> np.ndarray:
    """Host-side resize of (..., H, W, C) frames to (hw, hw) with PIL's
    default filter (what the reference agent does to every S1 frame)."""
    arr = np.asarray(frames)
    if arr.shape[-3] == hw and arr.shape[-2] == hw:
        return arr
    from PIL import Image

    lead, c = arr.shape[:-3], arr.shape[-1]
    flat = arr.reshape((-1,) + arr.shape[-3:])
    out = np.empty((flat.shape[0], hw, hw, c), arr.dtype)
    for i, f in enumerate(flat):
        if c == 1:  # PIL has no HxWx1 mode (depth)
            out[i, ..., 0] = np.asarray(Image.fromarray(f[..., 0]).resize((hw, hw)))
        else:
            out[i] = np.asarray(Image.fromarray(f).resize((hw, hw)))
    return out.reshape(lead + (hw, hw, c))


def _fit_s1_grid(frames: np.ndarray, hw: int) -> np.ndarray:
    """Resize only on a patch-grid mismatch: the SAME-padded stride-14
    patch embed feeds a (hw/14)^2 pos embed from any H with ceil(H/14) ==
    hw/14."""
    g0 = hw // 14
    h, w = np.asarray(frames).shape[-3:-1]
    if (-(-h // 14), -(-w // 14)) != (g0, g0):
        return _resize_frames(frames, hw)
    return frames


def to_device(arr, device) -> torch.Tensor:
    """A host array as a tensor on `device`. To a GPU it goes through a
    pinned host buffer with non_blocking=True, so the copy queues behind
    the device's work instead of the host waiting for that work (a
    pageable copy would wait)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)


def build_model(cfg: InternVLAN1Config, device=None) -> InternVLAN1Model:
    """An uninitialized model on `device` (parameters allocated, not set).
    Without a device it goes to the GPU and raises when there is none; pass
    device="cpu" to build it on the host."""
    if device is None:
        device = require_cuda()
    with torch.device("meta"):
        model = InternVLAN1Model(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place: N(0, 0.02) weights, 0 biases, 1 norm scales."""
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "weight" and isinstance(mod, (RMSNorm, nn.LayerNorm)):
                p.fill_(1.0)
            elif name == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return model


#: the JAX package's native weights file, which the port does not read
JAX_NATIVE_WEIGHTS = "params.msgpack"
_TORCH_WEIGHT_SUFFIXES = (".safetensors", ".bin", ".pth")


def checkpoint_format(path: str) -> str:
    """"native" for a directory written by `save_pretrained`, "hf" for a
    reference-format checkpoint (a file or a directory). Raises for a
    missing path, and for a directory that holds the JAX package's
    params.msgpack and no torch weights."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    if not os.path.isdir(path):
        return "hf"
    if os.path.exists(os.path.join(path, NATIVE_WEIGHTS)):
        return "native"
    if os.path.exists(os.path.join(path, JAX_NATIVE_WEIGHTS)) and not any(
            f.endswith(_TORCH_WEIGHT_SUFFIXES) for f in os.listdir(path)):
        raise ValueError(
            f"{path} holds the JAX package's {JAX_NATIVE_WEIGHTS}, which the PyTorch port does "
            "not read: load the reference-format torch checkpoint it was converted from "
            "(InternVLAN1Policy.from_pretrained_torch), or convert that torch source into a "
            "native directory of the port with scripts/torch/convert_checkpoint.py")
    return "hf"


def native_weight_dtype(path: str) -> str:
    """The weight_dtype a native directory's config.json records."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)["weight_dtype"]


def checkpoint_tokenizer(path: str, vocab_size: int):
    """The HF tokenizer of a checkpoint directory that holds tokenizer
    files (raising if they do not load), else `SimpleTokenizer`."""
    if has_tokenizer_files(path):
        return load_hf_tokenizer(path)
    return SimpleTokenizer(vocab_size)


def _with_tied_embeddings(cfg: InternVLAN1Config, tied: bool) -> InternVLAN1Config:
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=tied))


def _serving_model(cfg: InternVLAN1Config, device, tp_group):
    """(model, blocks): an uninitialized model on `device` (`build_model`)
    and {}; with a tp group, its decoder laid out for serving over the
    group on the meta device first (`apply_serve_tp`), so that only this
    rank's blocks are allocated, and those blocks by state name (the
    loader takes only them from the memory-mapped checkpoint)."""
    if tp_group is None:
        return build_model(cfg, device=device), {}
    with torch.device("meta"):
        model = InternVLAN1Model(cfg)
    apply_serve_tp(model.language_model, tp_group)
    blocks = {f"language_model.{n}": b for n, b in model.language_model.serve_blocks.items()}
    return model.to_empty(device=device).eval(), blocks


@torch.no_grad()
def _load_native_(model: InternVLAN1Model, sd, path: str, blocks=None) -> None:
    """The port's own state_dict into a built model: the same names,
    shapes and dtypes, or it raises; `blocks` as in `convert.load_into_`."""
    state = model.state_dict(keep_vars=True)
    if set(sd) != set(state):
        raise KeyError(f"{path}: native weights differ from the model's state: missing "
                       f"{sorted(set(state) - set(sd))[:8]}, unexpected "
                       f"{sorted(set(sd) - set(state))[:8]}")
    for name, target in state.items():
        value = sd[name]
        if blocks and name in blocks:
            value = value.narrow(*blocks[name])
        if value.dtype != target.dtype or value.shape != target.shape:
            raise ValueError(f"{path}: {name} is {value.dtype} {tuple(value.shape)}, the model "
                             f"has {target.dtype} {tuple(target.shape)}")
        target.copy_(value)


class InternVLAN1Policy:
    """An InternVLAN1Model + the host-side prompt and history bookkeeping."""

    #: the reference samples one of seven conjunctions; parity pins the first
    CONJUNCTION = "you can see "
    SYSTEM_PROMPT = (
        "You are an autonomous navigation assistant. Your task is to "
        "<instruction>. Where should you go next to stay on track? Please "
        "output the next waypoint's coordinates in the image. Please output "
        "STOP when you have successfully completed the task."
    )
    CHAT_SYSTEM = "You are a helpful assistant."
    CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
    CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
    #: prompts are right-padded to a multiple of this (pads isolated by
    #: segment ids), as in the JAX policy
    PROMPT_BUCKET = 32

    def __init__(self, model: InternVLAN1Model, seed: int = 0, tokenizer=None):
        self.model = model.eval()
        self.cfg = cfg = model.cfg
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer if tokenizer is not None else SimpleTokenizer(
            cfg.text.vocab_size)
        self.num_history = cfg.num_history
        self.seed = seed
        self._index_cache: Dict[Tuple[int, int, int], tuple] = {}
        #: the decode loop's static caches and captured graphs
        self.decode_buffers = DecodeBuffers()
        #: run the decode loop eagerly on the card instead of replaying its
        #: graph: only for comparing the two (chip_smoke.py)
        self.eager_decode = False
        self.reset()

    @classmethod
    def build(cls, cfg: Optional[InternVLAN1Config] = None, *, device=None,
              seed: int = 0) -> "InternVLAN1Policy":
        """Random-weight policy on `device` (the GPU when None; raises
        without one), drawn from a torch.Generator seeded with `seed` on
        that device. With weight_dtype "int8" or "int4" the bf16 weights are
        drawn as for bf16 and then quantized on the device
        (`quantize_qwen_text_`, each bf16 projection freed as its quantized
        copy lands), so the served scales are those of real weights;
        kv_dtype="int8" gives tuple caches."""
        cfg = cfg or InternVLAN1Config.tiny()
        device = require_cuda() if device is None else device
        text = cfg.text
        bf16_text = dataclasses.replace(text, weight_dtype="bf16", quant_group_size=None)
        model = build_model(dataclasses.replace(cfg, text=bf16_text), device=device)
        init_random_(model, torch.Generator(device=device).manual_seed(seed))
        if text.weight_dtype in ("int8", "int4"):
            quantize_qwen_text_(model.language_model, text.quant_group_size,
                                4 if text.weight_dtype == "int4" else 8)
        model.cfg = cfg
        return cls(model, seed=seed)

    @classmethod
    def from_pretrained_torch(cls, path: str, cfg: InternVLAN1Config, *, device=None,
                              tokenizer=None, seed: int = 0,
                              tp_group=None) -> "InternVLAN1Policy":
        """A reference-format InternVLA-N1 checkpoint (safetensors, sharded
        or not, or .bin / .pth; `convert.load_torch_state_dict`) in cfg's
        formats on `device` (the GPU when None; raises without one). The
        model is allocated in its served format and filled one tensor at a
        time from the memory-mapped file: with weight_dtype "int8" or "int4"
        each decoder projection is quantized as it lands (the arithmetic of
        `quantize_qwen_text_`, bit for bit; under int4 the lm_head at 8
        bits, JAX `policy.py:315-320`), so no bf16 copy of the decoder
        is ever resident. Without `lm_head.weight` the text model ties its
        embeddings. The tokenizer is the directory's (`checkpoint_tokenizer`)
        unless one is given. Any unmatched, missing or misshapen tensor
        raises (`convert.load_into_`). With `tp_group` (a mesh's tp group)
        the decoder is laid out for serving over it (`apply_serve_tp`) and
        this rank reads only its blocks of the split tensors from the
        memory-mapped files: the page cache is shared between the ranks of
        a host, and no rank holds a full copy of its own."""
        device = require_cuda() if device is None else device
        if checkpoint_format(path) == "native":
            raise ValueError(f"{path} is a native directory of the port: load it with "
                             "from_pretrained")
        if "navdp" in cfg.system1:
            raise ValueError(
                f"system1={cfg.system1!r}: a reference-format checkpoint carries no NavDP head "
                "the port can map (the JAX package's convert_internvla_n1 converts System-2 and "
                "the NextDiT System-1 only, and would leave the head random); save a NavDP "
                "policy with save_pretrained and load it with from_pretrained")
        sd = load_torch_state_dict(path)
        cfg = _with_tied_embeddings(cfg, "lm_head.weight" not in sd)
        model, blocks = _serving_model(cfg, device, tp_group)
        load_into_(model, sd, blocks=blocks)
        return cls(model, seed=seed, tokenizer=tokenizer if tokenizer is not None else
                   checkpoint_tokenizer(path, cfg.text.vocab_size))

    def save_pretrained(self, path: str) -> None:
        """A native checkpoint directory: config.json with the JAX
        package's keys (informational, but `from_pretrained` holds the
        weight dtype to it) and the model's state_dict as it is served
        (int8 `weight_q` and fp32 `scale_q` in the int8 format; packed int4
        codes, uint8 (N, K / 2), in the int4 format) in `NATIVE_WEIGHTS`,
        copied to the host one tensor at a time."""
        os.makedirs(path, exist_ok=True)
        text = self.cfg.text
        info = {"policy": "InternVLAN1_Policy", "system1": self.cfg.system1,
                "weight_dtype": text.weight_dtype,
                "text": {k: str(v) for k, v in dataclasses.asdict(text).items()},
                "note": "config.json is informational; pass the InternVLAN1Config to "
                        "from_pretrained"}
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(info, f, indent=2)
        write_safetensors(os.path.join(path, NATIVE_WEIGHTS), self.model.state_dict(),
                          {"format": "pt"})

    @classmethod
    def from_pretrained(cls, path: str, cfg: InternVLAN1Config, *, device=None,
                        tokenizer=None, seed: int = 0, tp_group=None) -> "InternVLAN1Policy":
        """A native `save_pretrained` directory on `device` (the GPU when
        None). cfg must ask for the weight dtype the directory records (the
        JAX package's check and message; config.json must be there); every
        tensor must match the model's name, shape and dtype. `tp_group` as
        in `from_pretrained_torch`."""
        device = require_cuda() if device is None else device
        if checkpoint_format(path) != "native":
            raise ValueError(f"{path} has no {NATIVE_WEIGHTS}: not a native directory of the "
                             "port (a reference-format checkpoint loads through "
                             "from_pretrained_torch)")
        with open(os.path.join(path, "config.json")) as f:
            saved_system1 = json.load(f).get("system1", cfg.system1)
        if saved_system1 != cfg.system1:
            raise ValueError(f"checkpoint at {path} holds a system1={saved_system1!r} policy, "
                             f"the config asks for {cfg.system1!r}")
        saved, want = native_weight_dtype(path), cfg.text.weight_dtype
        if saved != want:
            raise ValueError(
                f"checkpoint at {path} was saved with weight_dtype={saved!r} but the config "
                f"asks for {want!r} — pass a matching InternVLAN1Config (e.g. "
                f"qwen25vl_7b(weight_dtype={saved!r})) or re-convert the checkpoint")
        sd = read_safetensors(os.path.join(path, NATIVE_WEIGHTS))
        cfg = _with_tied_embeddings(
            cfg, not any(k.startswith("language_model.lm_head.") for k in sd))
        model, blocks = _serving_model(cfg, device, tp_group)
        _load_native_(model, sd, path, blocks)
        return cls(model, seed=seed, tokenizer=tokenizer if tokenizer is not None else
                   checkpoint_tokenizer(path, cfg.text.vocab_size))

    @property
    def stop_token_ids(self) -> tuple:
        return (self.tokenizer.eos_token_id,)

    def reset(self) -> None:
        self.rgb_list: List[np.ndarray] = []
        self.episode_idx = 0
        self.llm_output = ""
        self.input_images: List[np.ndarray] = []
        self._frame_keys: List[Optional[int]] = []
        self._vision_cache: Dict[int, torch.Tensor] = {}
        self._generator = torch.Generator(device=self.device).manual_seed(self.seed)

    # --------------------------------------------------------------- vision
    def _vision_host_indices(self, h: int, w: int, n: int = 1):
        """Window/rope index tables of n h x w images, on the device,
        memoized per shape."""
        if (n, h, w) not in self._index_cache:
            v = self.cfg.vision
            idx = vision_indices((v.patch_size, v.spatial_merge_size, v.window_size),
                                 ((1, h // v.patch_size, w // v.patch_size),) * n)
            cos, sin = rotary_table(idx["pos_ids"], v.hidden_size // v.num_heads)
            dev = tuple(torch.as_tensor(a, device=self.device) for a in (
                cos, sin, idx["window_segments"], idx["full_segments"],
                idx["window_index"], idx["reverse_index"]))
            self._index_cache[(n, h, w)] = (dev, (idx["window_block"], idx["full_block"]))
        return self._index_cache[(n, h, w)]

    def _encode_image(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 → (N_tok, D) vision tokens."""
        return self._encode_images(np.asarray(image)[None])[0]

    @torch.no_grad()
    def _encode_images(self, images):
        """(N, H, W, 3) uint8, a host array or a tensor on the device →
        ((N_tok, D) vision tokens, grid_thw (N, 3)), the N images in one
        tower pass; normalization and patchification run on the device."""
        n, h, w = images.shape[:3]
        dev_idx, (wblk, fblk) = self._vision_host_indices(h, w, n)
        raw = images if isinstance(images, torch.Tensor) else to_device(
            np.asarray(images, np.uint8), self.device)
        patches = preprocess_images_device(raw, self.cfg.vision, self.CLIP_MEAN, self.CLIP_STD)
        tokens = self.model.encode_vision(patches, *dev_idx, window_block=wblk, full_block=fblk)
        p = self.cfg.vision.patch_size
        return tokens, np.tile(np.asarray([[1, h // p, w // p]], np.int64), (n, 1))

    def _gather_vision_tokens(self, images: np.ndarray, frame_keys: List[Optional[int]]):
        """Vision tokens of every frame + grid_thw. Each image is encoded on
        its own, so a history frame's tokens are cached (key: its index in
        the episode) and encoded once per episode; key None is never cached."""
        tokens = []
        for img, key in zip(images, frame_keys):
            tok = self._vision_cache.pop(key, None) if key is not None else None
            if tok is None:
                tok = self._encode_image(img)
            if key is not None:
                self._vision_cache[key] = tok  # (re)inserted last: LRU order
                while len(self._vision_cache) > 24:
                    self._vision_cache.pop(next(iter(self._vision_cache)))
            tokens.append(tok)
        p = self.cfg.vision.patch_size
        grid = np.tile(np.asarray([[1, images.shape[1] // p, images.shape[2] // p]]),
                       (len(images), 1))
        return torch.cat(tokens, dim=0), grid

    # --------------------------------------------------------------- prompt
    def _tokens_per_image(self, image_hw: Tuple[int, int]) -> int:
        m, p = self.cfg.vision.spatial_merge_size, self.cfg.vision.patch_size
        return (image_hw[0] // p // m) * (image_hw[1] // p // m)

    def _build_prompt_ids(self, instruction: str, n_images: int,
                          image_hw: Tuple[int, int]) -> np.ndarray:
        """Qwen chat template with expanded image-token runs (the JAX
        policy's `_build_prompt_ids`, byte for byte)."""
        img_block = VISION_START + "<|image_pad|>" * self._tokens_per_image(image_hw) + VISION_END
        value = self.SYSTEM_PROMPT.replace("<instruction>.", instruction)
        history = n_images - 1
        if history > 0:
            value += " These are your historical observations: " + "<image>\n" * history + "."
        value += f" {self.CONJUNCTION}<image>."
        body = "".join(img_block if part == "<image>" else part
                       for part in split_and_clean(value))
        text = (f"{IM_START}system\n{self.CHAT_SYSTEM}{IM_END}\n"
                f"{IM_START}user\n{body}{IM_END}\n{IM_START}assistant\n")
        return np.asarray(self.tokenizer.encode(text), np.int64)[None]

    # ---------------------------------------------------------------- steps
    def s2_step(self, image: np.ndarray, instruction: str, look_down: bool = False,
                max_new_tokens: int = 128, fused: bool = True) -> S2Output:
        """One System-2 step on a new frame (look_down: a transient frame
        appended to the last step's images). fused=True runs `fused_s2`
        (cached vision tokens, bucketed prompt, the latents as a chunk
        decode over the generation's cache); fused=False the JAX policy's
        separate dispatches (`_s2_step_unfused`)."""
        if not look_down:
            self.rgb_list.append(np.asarray(image))
            if self.episode_idx == 0:
                history_id = []
            else:
                history_id = np.unique(np.linspace(0, self.episode_idx - 1, self.num_history,
                                                   dtype=np.int32)).tolist()
            frame_keys = sorted(int(i) for i in history_id) + [len(self.rgb_list) - 1]
            self.input_images = [self.rgb_list[i] for i in frame_keys]
            self._frame_keys = list(frame_keys)
            self.episode_idx += 1
        else:  # look-down frames are transient: encoded fresh, not cached
            self.input_images = self.input_images + [np.asarray(image)]
            self._frame_keys = self._frame_keys + [None]
        images = np.stack(self.input_images)
        input_ids = self._build_prompt_ids(instruction, len(images), images.shape[1:3])
        if not fused:
            return self._s2_step_unfused(images, input_ids, max_new_tokens)
        return self._s2_step_fused(images, input_ids, max_new_tokens, self._frame_keys)

    def _s2_output(self, gen: np.ndarray, latents) -> S2Output:
        """The step's output from its generated tokens: a pixel goal and the
        latents (`latents()`, called only then) when the text holds digits,
        else the parsed actions."""
        self.last_gen_tokens = gen
        self.llm_output = self.tokenizer.decode(gen)
        out = S2Output()
        if re.search(r"\d", self.llm_output):
            coords = [int(c) for c in re.findall(r"\d+", self.llm_output)]
            if len(coords) >= 2:
                out.output_pixel = np.array([coords[1], coords[0]])
            out.output_latent = latents()
        else:
            out.output_action = parse_actions(self.llm_output)
        return out

    @torch.inference_mode()
    def _s2_step_unfused(self, images: np.ndarray, input_ids: np.ndarray,
                         max_new_tokens: int) -> S2Output:
        """The JAX policy's unfused step (its `s2_step(fused=False)`): every
        frame encoded in one tower pass (no vision cache), M-RoPE positions
        of the unpadded prompt, embed, `greedy_generate`, and for a pixel
        goal `generate_latents`' re-prefill."""
        cfg, dev = self.cfg, self.device
        img_tokens, grid = self._encode_images(images)
        pos_ids, rope_deltas = get_rope_index_25(
            input_ids, grid, spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_index)
        embeds = self.model.embed_multimodal(to_device(input_ids, dev), img_tokens)
        # caches as long as the fused step's (its prompt bucket, the budget and
        # the traj queries), so that both decode with the same launch plans
        # (K4's cluster size follows the cache length)
        P = input_ids.shape[1]
        slots = -(-P // self.PROMPT_BUCKET) * self.PROMPT_BUCKET - P + cfg.n_query
        tokens, lengths, _ = greedy_generate(
            self.model.language_model, embeds, to_device(pos_ids, dev),
            rope_deltas=to_device(rope_deltas[:, 0], dev), max_new_tokens=max_new_tokens,
            eos_token_ids=self.stop_token_ids, extra_cache_slots=slots)
        gen = tokens[0, : int(lengths[0])].cpu().numpy()
        return self._s2_output(gen, lambda: self.generate_latents(input_ids, gen, img_tokens,
                                                                  grid))

    @torch.inference_mode()
    def generate_latents(self, input_ids: np.ndarray, generated, img_tokens, grid,
                         bucket: int = 32) -> torch.Tensor:
        """The traj latents by a re-prefill (JAX `generate_latents`): the
        prompt input_ids (1, P), the generated tokens and n_query traj
        tokens, right-padded to a multiple of `bucket` with the pads in
        segment 1 (the real tokens' states equal the unpadded prefill's),
        prefilled once over img_tokens (the prompt's vision tokens, grid
        their grid_thw); returns the final norm's states of the query
        positions, (1, n_query, E)."""
        cfg, dev = self.cfg, self.device
        n_q = cfg.n_query
        real = np.concatenate([np.asarray(input_ids)[0], np.asarray(generated, np.int64),
                               np.full((n_q,), cfg.traj_token_index, np.int64)])
        L = len(real)
        padded_len = -(-L // bucket) * bucket
        full = np.full((1, padded_len), self.tokenizer.pad_token_id, np.int64)
        full[0, :L] = real
        seg = np.zeros((1, padded_len), np.int32)
        seg[0, L:] = 1
        pos_ids, _ = get_rope_index_25(full, grid, spatial_merge_size=cfg.vision.spatial_merge_size,
                                       image_token_id=cfg.image_token_index)
        embeds = self.model.embed_multimodal(to_device(full, dev), img_tokens)
        _, hidden, _ = self.model.prefill(embeds, to_device(pos_ids, dev), to_device(seg, dev),
                                          compute_logits=False)
        return hidden[:, L - n_q:L]

    @torch.inference_mode()
    def _s2_step_fused(self, images: np.ndarray, input_ids: np.ndarray, max_new_tokens: int,
                       frame_keys: List[Optional[int]]) -> S2Output:
        """vision → embed → bucketed prefill + greedy decode → one chunked
        decode of the n_query traj queries over the generation's cache."""
        cfg = self.cfg
        dev = self.device
        img_tokens, grid = self._gather_vision_tokens(images, frame_keys)
        # rope positions on the REAL prompt, then right-pad to the bucket
        pos_ids, rope_deltas = get_rope_index_25(
            input_ids, grid, spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_index)
        B, P = input_ids.shape
        T = -(-P // self.PROMPT_BUCKET) * self.PROMPT_BUCKET
        padded_ids = np.full((B, T), self.tokenizer.pad_token_id, np.int64)
        padded_ids[:, :P] = input_ids
        pad_pos = pos_ids.max() + 1 + np.arange(T - P)
        padded_pos = np.concatenate([pos_ids, np.broadcast_to(pad_pos, (3, B, T - P))], axis=2)
        prompt_seg = np.zeros((B, T), np.int32)
        prompt_seg[:, P:] = 1
        prompt_len = torch.full((B,), P, dtype=torch.long, device=dev)
        deltas = to_device(rope_deltas[:, 0], dev)

        tokens, lengths, latents = self.fused_s2(
            img_tokens, to_device(padded_ids, dev), to_device(padded_pos, dev), deltas, prompt_len,
            to_device(prompt_seg, dev), max_new_tokens)
        gen = tokens[0, : int(lengths[0])].cpu().numpy()
        return self._s2_output(gen, lambda: latents)

    @torch.inference_mode()
    def fused_s2(self, img_tokens, input_ids, pos_ids, rope_deltas, prompt_len, prompt_seg,
                 max_new_tokens: int):
        """embed → bucketed prefill + greedy decode → one chunked decode of
        the n_query traj queries over the generation's cache: `prefill_s2`
        into a cache set of this policy's pool, then `grouped_tail` over that
        one group. All inputs on the device: input_ids (B, T), pos_ids (3,
        B, T), rope_deltas / prompt_len (B,), prompt_seg (B, T). Returns
        (tokens, lengths, latents (B, n_query, E))."""
        caches = self.s2_caches(*input_ids.shape, max_new_tokens)
        try:
            first = self.prefill_s2(img_tokens, input_ids, pos_ids, prompt_len, prompt_seg,
                                    caches)
            return self.grouped_tail([caches], first, rope_deltas, prompt_len, max_new_tokens)
        finally:
            self.decode_buffers.release(caches)

    def s2_caches(self, B: int, T: int, max_new_tokens: int) -> StaticCaches:
        """A free cache set of B rows for a T-token prompt bucket (T +
        max_new_tokens + n_query slots) from this policy's pool; the caller
        releases it (`decode_buffers.release`) once its `grouped_tail` is
        enqueued."""
        return self.decode_buffers.acquire(self.model.language_model.cfg, B,
                                           T + max_new_tokens + self.cfg.n_query, self.device)

    @torch.inference_mode()
    def prefill_s2(self, img_tokens, input_ids, pos_ids, prompt_len, prompt_seg,
                   caches: StaticCaches):
        """The prefill half of `fused_s2`: embed → prefill into `caches`
        (T + max_new_tokens + n_query slots) → the first greedy token (B,).
        Paired with `grouped_tail`, which decodes several cohorts' caches
        with one pass over the weights a token."""
        embeds = self.model.embed_multimodal(input_ids, img_tokens)
        logits, _, _ = self.model.language_model(
            embeds, pos_ids, segment_ids=prompt_seg, logits_indices=prompt_len - 1,
            caches_out=caches.entries)
        return self.model.language_model.greedy_token(logits[:, 0])

    @torch.inference_mode()
    def grouped_tail(self, groups: List[StaticCaches], first_tok, rope_deltas, prompt_len,
                     max_new_tokens: int):
        """Greedy decode (`greedy_decode_grouped`) and the traj-latent chunk
        (`decode_chunk_grouped`) over several groups' prefilled caches, the
        groups' rows stacked in order; row for row what each group gives
        alone. Returns (tokens, lengths, latents)."""
        tokens, lengths = greedy_decode_grouped(
            self.model.language_model, first_tok, groups, prompt_lengths=prompt_len,
            rope_deltas=rope_deltas, max_new_tokens=max_new_tokens,
            eos_token_ids=self.stop_token_ids, buffers=self.decode_buffers,
            eager=self.eager_decode)
        return tokens, lengths, self._latent_chunk([g.entries for g in groups],
                                                   [g.rows for g in groups], prompt_len,
                                                   rope_deltas, lengths)

    def _latent_chunk(self, trees, sizes, prompt_len, rope_deltas, lengths):
        """The n_query traj queries decoded as one chunk over each row's
        cache: query i sits at position prompt_len + lengths + i, and its
        K/V write overwrites the stale eos-pad slot there. trees: per-group
        caches (lists of per-layer entries) of `sizes` rows, stacked in
        order."""
        n_q, lm = self.cfg.n_query, self.model.language_model
        B = prompt_len.shape[0]
        q = self.model.traj_queries()
        pos = (prompt_len + rope_deltas + lengths)[None, :, None] + torch.arange(
            n_q, device=q.device)
        e = q.expand(B, n_q, q.shape[-1]).to(lm.cfg.dtype)
        lens = (prompt_len + lengths).split(list(sizes))
        return lm.decode_chunk_grouped(e, pos.expand(3, B, n_q), trees, lens)[0]

    @torch.inference_mode()
    def s1_step_latent(self, rgb: np.ndarray, depth: Optional[np.ndarray], latent,
                       num_sample_trajs: int = 32, x_init: Optional[torch.Tensor] = None,
                       step_noises: Optional[torch.Tensor] = None,
                       continuous_traj: bool = True) -> S1Output:
        """rgb (B, 2, H, W, 3) [memory frame, current]; depth (B, 2, H, W, 1)
        or None (NavDP's async head needs it); latent from `s2_step`. x_init
        (B·num_sample_trajs, P, 3; NavDP: the first stream's
        num_sample_trajs rows) is the denoise's starting noise and
        step_noises (steps, rows, P, 3) NavDP's ancestral noise, each drawn
        from the policy's generator when None, x_init first. The actions:
        with continuous_traj those of the mean trajectory
        (`traj_to_actions`), else the chunks of one trajectory drawn from
        the policy's generator (`chunk_token`), as the JAX policy does."""
        cfg = self.cfg
        navdp = "navdp" in cfg.system1
        if navdp and "async" in cfg.system1 and depth is None:
            raise ValueError(f"system1={cfg.system1!r} needs depth: the NavDP head encodes an "
                             "RGBD [memory, current] pair")
        rgb = _fit_s1_grid(rgb, self.model.s1_image_hw)
        if depth is not None:  # not read by NextDiT; fitted for the NavDP head
            depth = _fit_s1_grid(depth, self.model.s1_image_hw)
        raw = to_device(np.asarray(rgb, np.uint8), self.device)
        rows = num_sample_trajs if navdp else raw.shape[0] * num_sample_trajs
        if x_init is None:
            x_init = torch.randn((rows, cfg.predict_step_nums, 3), generator=self._generator,
                                 device=self.device)
        x_init = x_init.to(self.device)
        if navdp:
            if step_noises is None:
                step_noises = torch.randn(
                    (self.model.navdp.denoise_steps, rows, cfg.predict_step_nums, 3),
                    generator=self._generator, device=self.device)
            de = None if depth is None else to_device(np.asarray(depth, np.float32), self.device)
            traj = self.model.generate_traj_navdp(latent, raw.float() / 255.0, de, x_init=x_init,
                                                  step_noises=step_noises.to(self.device))
        else:
            images = imagenet_normalize(raw.float() / 255.0)
            traj = self.model.generate_traj_nextdit(latent, images, x_init=x_init,
                                                    num_sample_trajs=num_sample_trajs)
        dp = traj.float().cpu().numpy()
        if continuous_traj:
            action_list = traj_to_actions(dp)
        else:
            choice = int(torch.randint(dp.shape[0], (1,), generator=self._generator,
                                       device=self.device)[0])
            action_list = chunk_token(dp[choice])
        action_list = [a for a in action_list if a != 0]
        return S1Output(idx=action_list[:4], trajectory=dp)
