"""Policy base of the recurrent VLN policies: an `nn.Module` with its
config and device, and persistence.

Port of internnav_tpu/model/base.py (the reference's PreTrainedModel
policies, e.g. cma_policy.py:67-121): a dict-in `forward(batch)` with a
`mode` switch, `save_pretrained` / `from_pretrained` with tolerant partial
loading (the reference logs incompatible keys and goes on).

- The port's native directory holds config.json (the `ModelCfg` dump) and
  the module's state_dict in safetensors (`NATIVE_WEIGHTS`), where the JAX
  package writes params.msgpack.
- A reference-format torch checkpoint (a .pth / .pt / .bin / .safetensors
  file, or a directory of those without the native file) goes through the
  converter `REFERENCE_CONVERTER_NAME` of `model/weights/convert.py`.
- Both land through `merge_params`: a loaded tensor whose name and shape
  match the module's replaces its value; a shape that differs, a name the
  module lacks and the names the checkpoint lacks are logged and keep the
  module's value, as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from internnav_tpu_torch.configs.model import ModelCfg
from internnav_tpu_torch.model.weights.convert import NATIVE_WEIGHTS, load_torch_state_dict
from internnav_tpu_torch.model.weights.safetensors_io import read_safetensors, write_safetensors
from internnav_tpu_torch.utils.logging import get_logger

CONFIG_NAME = "config.json"


def merge_params(init: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
                 logger=None) -> Dict[str, torch.Tensor]:
    """Tolerant merge of state dicts: `loaded` tensors whose name and shape
    match `init` (cast to init's dtype and device); init's value, with a
    warning, otherwise (the JAX package's `merge_params` and messages)."""
    log = (logger or get_logger()).warning
    merged = dict(init)
    for name, v in loaded.items():
        if name not in init:
            log("unexpected key in checkpoint: %s", name.replace(".", "/"))
        elif tuple(v.shape) != tuple(init[name].shape):
            log("shape mismatch for %s: ckpt %s vs model %s — keeping init",
                name.replace(".", "/"), tuple(v.shape), tuple(init[name].shape))
        else:
            merged[name] = v.to(device=init[name].device, dtype=init[name].dtype)
    missing = set(init) - set(loaded)
    if missing:
        log("missing %d keys in checkpoint (kept init), e.g. %s",
            len(missing), sorted(missing)[0].replace(".", "/"))
    return merged


def resolve_device(device=None) -> torch.device:
    """`device`, the GPU when None; "cpu" only when asked for (no fallback)."""
    from internnav_tpu_torch import require_cuda

    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    return require_cuda(device)


class Policy:
    """An nn.Module `net` with its ModelCfg on one device."""

    name = ""
    #: the function of `model/weights/convert.py` mapping a reference
    #: state dict onto this policy's net (`fn(sd, net) -> state_dict`)
    REFERENCE_CONVERTER_NAME: Optional[str] = None
    _TORCH_EXTS = (".pth", ".pt", ".bin", ".safetensors")

    def __init__(self, net: nn.Module, cfg: ModelCfg):
        self.net = net.eval()
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def forward(self, batch: Dict):
        """dict in; mode ∈ {train, inference, features}."""
        raise NotImplementedError

    # --------------------------------------------------------- persistence
    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, CONFIG_NAME), "w") as f:
            json.dump(self.cfg.model_dump(), f, indent=2, default=str)
        write_safetensors(os.path.join(path, NATIVE_WEIGHTS), self.net.state_dict(),
                          {"format": "pt"})

    @classmethod
    def _is_torch_checkpoint(cls, path: str) -> bool:
        """A reference-format torch checkpoint rather than a native one."""
        if os.path.isdir(path):
            if os.path.exists(os.path.join(path, NATIVE_WEIGHTS)):
                return False
            return any(f.endswith(cls._TORCH_EXTS) for f in os.listdir(path))
        return path.endswith(cls._TORCH_EXTS) and os.path.basename(path) != NATIVE_WEIGHTS

    @classmethod
    def load_params_file(cls, path: str, net: nn.Module) -> Dict[str, torch.Tensor]:
        """`net`'s state_dict with the checkpoint at `path` merged in."""
        init = net.state_dict()
        if cls.REFERENCE_CONVERTER_NAME and cls._is_torch_checkpoint(path):
            from internnav_tpu_torch.model.weights import convert

            sd = load_torch_state_dict(path)
            return merge_params(init, getattr(convert, cls.REFERENCE_CONVERTER_NAME)(sd, net))
        weights = os.path.join(path, NATIVE_WEIGHTS) if os.path.isdir(path) else path
        if not os.path.exists(weights):
            raise FileNotFoundError(f"no weights at {weights}")
        return merge_params(init, read_safetensors(weights))

    @classmethod
    def load_config(cls, path: str, default: Optional[ModelCfg] = None) -> ModelCfg:
        """The native config.json beside the weights; `default` when there
        is none or it is not a native ModelCfg dump (a reference config)."""
        cfg_path = os.path.join(path, CONFIG_NAME) if os.path.isdir(path) \
            else os.path.join(os.path.dirname(path), CONFIG_NAME)
        if os.path.exists(cfg_path):
            try:
                with open(cfg_path) as f:
                    raw = json.load(f)
                if not isinstance(raw, dict):
                    raise ValueError("config.json is not a mapping")
                native_keys = set(ModelCfg.model_fields)
                if len(native_keys & set(raw)) < max(1, len(native_keys) // 2):
                    raise ValueError(
                        f"config.json shares {len(native_keys & set(raw))}/{len(native_keys)} "
                        "keys with ModelCfg — not a native config")
                return ModelCfg.model_validate(raw)
            except Exception as e:
                if default is not None:
                    get_logger().warning("config at %s is not a native ModelCfg (%s); using "
                                         "the provided default", cfg_path, e)
                    return default
                raise
        if default is not None:
            return default
        raise FileNotFoundError(cfg_path)
