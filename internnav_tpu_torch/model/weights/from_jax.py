"""JAX param tree → the port's state_dict (`state_dict_from_jax` by rule;
`loco_state_from_jax` for the H1 loco actor; `cma_state_from_jax` /
`seq2seq_state_from_jax` for the recurrent VLN policies).

The port's modules carry the JAX package's submodule and parameter names,
so the mapping is by rule, per leaf:

- Dense `kernel` (in, out)  → `weight` (out, in)
- int8 Dense `kernel_q` (in, out) → `weight_q` (out, in); its `scale_q`
  ((out,) or grouped (in / g, out)) keeps name and layout. An int4
  `kernel_q` (`jnp.int4`, which numpy holds as `ml_dtypes.int4`) is widened
  to int8 codes and packed two a byte (`ops.quant.pack_int4`) into the
  port's uint8 (out, in / 2) `weight_q`
- Conv `kernel` HWIO        → `weight` OIHW
- Embed `embedding`         → `weight`
- RMSNorm/LayerNorm `scale` → `weight`
- `bias` and named params (`latent_queries`, `pos_embed`, `gate`, ...) keep
  their name and layout.

A flax list attribute `name_<i>` is the port's `nn.ModuleList` entry
`name.<i>` when the port has no attribute of the flat name. Any JAX leaf
not consumed, any port parameter left unset and any shape that differs
raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from internnav_tpu_torch.ops.quant import pack_int4

_LIST_ENTRY = re.compile(r"^(.+)_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _convert_leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim} has no torch layout rule")
    if name == "kernel_q":
        if value.ndim != 2:
            raise ValueError(f"kernel_q of rank {value.ndim} has no torch layout rule")
        return "weight_q", value.T
    if name in ("embedding", "scale"):
        return "weight", value
    return name, value


def _resolve(path: tuple, names: set) -> str:
    """Dotted port name for a JAX module path: each `name_<i>` segment is
    tried as is and as a ModuleList entry `name.<i>`."""
    candidates = [""]
    for seg in path:
        nxt = []
        m = _LIST_ENTRY.match(seg)
        for c in candidates:
            base = f"{c}." if c else ""
            nxt.append(base + seg)
            if m:
                nxt.append(base + f"{m.group(1)}.{m.group(2)}")
        candidates = nxt
    hits = [c for c in candidates if c in names]
    if len(hits) != 1:
        raise KeyError(f"JAX leaf {'/'.join(path)} maps to {len(hits)} port "
                       f"parameters: {hits or candidates}")
    return hits[0]


def state_dict_from_jax(params: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a JAX param tree (nested dicts of arrays) into a complete
    state_dict for `module`, in the module's parameter dtypes."""
    target = module.state_dict()
    names = set(target)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        leaf, arr = _convert_leaf(path[-1], value)
        key = _resolve(path[:-1] + (leaf,), names)
        if key in out:
            raise KeyError(f"port parameter {key} set twice (last from {'/'.join(path)})")
        want = target[key]
        if want.dtype == torch.uint8 and leaf == "weight_q":  # packed int4 codes
            value = pack_int4(torch.from_numpy(np.asarray(arr).astype(np.int8)))
        else:
            # through float32: exact for every float and int8 leaf
            value = torch.from_numpy(np.array(arr, np.float32)).to(want.dtype)
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"{'/'.join(path)} {arr.shape} → {key} {tuple(want.shape)}: shape differs")
        out[key] = value
    missing = sorted(names - set(out))
    if missing:
        raise KeyError(f"port parameters not set by the JAX tree: {missing}")
    return out


def load_from_jax(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a JAX param tree into `module` in place (strict)."""
    module.load_state_dict(state_dict_from_jax(params, module), strict=True)
    return module


def loco_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's loco MLP params (flax `Dense_i` with `kernel` (in,
    out) and `bias`, from `make_loco_mlp` or `convert_loco_policy`) as a
    state_dict of `env.internutopia.loco.LocoActor` (`layers.i.weight` (out,
    in), `layers.i.bias`), in float32."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(params)):
        dense = params[f"Dense_{i}"]
        out[f"layers.{i}.weight"] = torch.from_numpy(np.array(dense["kernel"], np.float32).T.copy())
        out[f"layers.{i}.bias"] = torch.from_numpy(np.array(dense["bias"], np.float32))
    return out


_RNN_NAMES = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
              "b_hh": "bias_hh_l0"}


def cma_state_from_jax(params: Mapping[str, Any], net: nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX CMANet / Seq2SeqNet param tree → the port net's state_dict.
    The rule above maps every leaf but the instruction encoder's, which JAX
    keeps flat (`embedding`, `w_ih`, ..., `rev_w_ih`, ...): here they become
    `embedding_layer` and the two directions' `nn.LSTM` (`encoder_rnn`,
    `encoder_rnn_reverse`, `*_l0`)."""
    tree = dict(params)
    enc: Dict[str, Dict[str, Any]] = {"embedding_layer": {}, "encoder_rnn": {}}
    for k, v in tree.pop("instruction_encoder").items():
        if k == "embedding":
            enc["embedding_layer"]["embedding"] = v
        elif k.startswith("rev_"):
            enc.setdefault("encoder_rnn_reverse", {})[_RNN_NAMES[k[4:]]] = v
        else:
            enc["encoder_rnn"][_RNN_NAMES[k]] = v
    tree["instruction_encoder"] = enc
    return state_dict_from_jax(tree, net)


seq2seq_state_from_jax = cma_state_from_jax
