#!/usr/bin/env python3
"""Serving quality of the quantized formats against bf16 at the Qwen2.5-VL-7B width.

Port of bench.py's quality comparison (`bench.py:89-157, 711-929`:
`_quality_prompts`, `_quality_compare`, `bench_compare_quant`,
`bench_compare_quant_sequential`; its flags `:1175-1190, :1212`):

    python scripts/torch/compare_quant.py [--quant-bits 8|4] [--quant-group G]
        [--kv-dtype int8|bf16] [--quant-layers 28] [--sequential]
    python scripts/torch/compare_quant.py --device cpu --tiny    # on the host

Six fixed prompts (224x224 frames from RandomState(7), a saturated 8-frame
history, the stop id pinned to -7 so that both sides decode the full 20
tokens, System-1's generator re-seeded to 1000 + i on both sides of prompt
i, 32 samples) go through one random bf16 policy (`InternVLAN1Policy.build`:
N(0, 0.02) weights, biases 0, norm scales 1, from a seeded generator) and
through its quantized copy: W8A8 (`--quant-bits 8`, per channel unless
`--quant-group`) or W4A8 (`--quant-bits 4`, grouped-128 scales, the lm_head
at 8 bits), with the int8 KV cache unless `--kv-dtype bf16`. The deployment
quantizer makes the copy (`qwen_text.quantize_qwen_text_`); the vision
tower and System-1 are shared. Prints one JSON line, bench.py's schema:
greedy-token agreement, the mean first divergence, the traj latents' and
the waypoints' relative L2 and the waypoints' mean L2.

Co-resident (the default) keeps both decoders on the device at once: the
H100's 80 GB holds the bf16 tree and its quantized decoder at all 28
layers. `--sequential` runs the bf16 pass, frees it, draws the identical
tree again from the same seed and quantizes it in place (each bf16 weight
dropped as its codes land), then runs the quantized pass.

`compare_quant(policy, ...)` is the co-resident comparison of an
already-built bf16 policy. The GPU by default (raises without one);
`--device cpu` runs on the host when asked for, `--tiny` at the tiny
config's size (56-pixel frames, 4 tokens, 4 samples).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import sys
from pathlib import Path
from typing import Callable, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DECODE_TOKENS = 20
IMAGE_HW = 224
NUM_SAMPLE_TRAJS = 32
N_PROMPTS = 6
FULL_LAYERS = 28
#: the prompt settings of `--tiny` (the JAX package's bench smoke test)
TINY = {"image_hw": 56, "decode_tokens": 4, "num_sample_trajs": 4}
QUALITY_INSTRUCTIONS = [
    "walk down the hallway past the kitchen then turn left",
    "go straight through the door and stop at the sofa",
    "turn right at the plant and wait near the staircase",
    "exit the bedroom and move toward the dining table",
    "follow the corridor to the end and stop by the window",
    "enter the office and stand next to the bookshelf",
]
CAVEAT = ("random weights -> near-uniform logits: token agreement is a pessimistic lower "
          "bound vs a trained checkpoint")


def full_n1_config(num_layers: int = FULL_LAYERS, tiny: bool = False):
    """The bf16 config compared: Qwen2.5-VL-7B dims at `num_layers` decoder
    layers (bench.py `_full_n1_config`), or the tiny config in bf16."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config

    if not tiny:
        return InternVLAN1Config.qwen25vl_7b(num_hidden_layers=num_layers)
    cfg = InternVLAN1Config.tiny("nextdit_async", dtype=torch.bfloat16)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             num_hidden_layers=num_layers))


def quality_prompts(policy, n_prompts: int, *, image_hw: int = IMAGE_HW,
                    decode_tokens: int = DECODE_TOKENS,
                    num_sample_trajs: int = NUM_SAMPLE_TRAJS,
                    x_init: Optional[Callable[[int], torch.Tensor]] = None) -> List[dict]:
    """The fixed quality prompts through one policy (bench.py
    `_quality_prompts`): the full decode budget, a saturated 8-frame
    history, System-1's generator seeded with 1000 + i for prompt i (or
    System-1's starting noise `x_init(i)` where given). Host copies of
    {tokens, latent, traj} per prompt. The policy's stop id and state are
    restored afterwards."""
    cfg = policy.cfg
    rs = np.random.RandomState(7)
    eos = policy.tokenizer.eos_token_id
    outs = []
    try:
        policy.tokenizer.eos_token_id = -7  # full decode budget both sides
        for i in range(n_prompts):
            img = rs.randint(0, 255, (image_hw, image_hw, 3)).astype(np.uint8)
            rgb2 = np.stack([img, img])[None]
            instr = QUALITY_INSTRUCTIONS[i % len(QUALITY_INSTRUCTIONS)]
            policy.reset()
            policy.rgb_list = [img] * 8
            policy.episode_idx = 8
            policy._generator = torch.Generator(device=policy.device).manual_seed(1000 + i)
            s2 = policy.s2_step(img, instr, max_new_tokens=decode_tokens)
            latent = s2.output_latent
            if latent is None:
                latent = torch.zeros((1, cfg.n_query, cfg.text.hidden_size),
                                     dtype=cfg.text.dtype, device=policy.device)
            s1 = policy.s1_step_latent(rgb2, None, latent, num_sample_trajs=num_sample_trajs,
                                       x_init=None if x_init is None else x_init(i))
            outs.append({"tokens": np.asarray(policy.last_gen_tokens),
                         "latent": latent.float().cpu().numpy(),
                         "traj": np.asarray(s1.trajectory, np.float32)})
    finally:
        policy.tokenizer.eos_token_id = eos
        policy.reset()
    return outs


def quality_compare(outs_a: list, outs_b: list) -> dict:
    """Token agreement / divergence / latent / waypoint stats between two
    per-prompt output lists of `quality_prompts` (bench.py
    `_quality_compare`, the same keys and rounding)."""
    agree_num = agree_den = 0
    first_div, latent_rel, waypoint_l2, waypoint_rel = [], [], [], []
    for a, b in zip(outs_a, outs_b):
        n = min(len(a["tokens"]), len(b["tokens"]))
        same = a["tokens"][:n] == b["tokens"][:n]
        agree_num += int(same.sum())
        agree_den += n
        first_div.append(int(np.argmax(~same)) if not same.all() else n)
        latent_rel.append(float(
            np.linalg.norm(a["latent"] - b["latent"]) /
            max(np.linalg.norm(a["latent"]), 1e-9)))
        waypoint_l2.append(float(np.mean(
            np.linalg.norm(a["traj"] - b["traj"], axis=-1))))
        waypoint_rel.append(float(
            np.linalg.norm(a["traj"] - b["traj"]) /
            max(np.linalg.norm(a["traj"]), 1e-9)))
    return {
        "token_agreement": round(agree_num / max(agree_den, 1), 4),
        "mean_first_divergence_tok": round(float(np.mean(first_div)), 2),
        "traj_latent_rel_l2": round(float(np.mean(latent_rel)), 5),
        "waypoint_mean_l2_m": round(float(np.mean(waypoint_l2)), 5),
        "waypoint_rel_l2": round(float(np.mean(waypoint_rel)), 5),
    }


def _quant_text_cfg(text, weight_bits: int, group_size: Optional[int], kv_dtype: str):
    return dataclasses.replace(text, weight_dtype="int4" if weight_bits == 4 else "int8",
                               quant_group_size=group_size, kv_dtype=kv_dtype)


@torch.no_grad()
def quantized_copy(policy, weight_bits: int = 8, group_size: Optional[int] = None,
                   kv_dtype: str = "int8"):
    """A policy whose decoder is a quantized copy of `policy`'s bf16 one
    (`quantize_qwen_text_` on a text model that shares the bf16 tensors, so
    the source stays whole) and whose embedding, vision tower and System-1
    are `policy`'s own tensors, with the KV cache in `kv_dtype`."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import (
        QwenTextModel,
        quantize_qwen_text_,
    )

    model = policy.model
    src = model.language_model
    if src.cfg.weight_dtype != "bf16":
        raise ValueError(f"quantized_copy takes a bf16 policy, not {src.cfg.weight_dtype}")
    with torch.device("meta"):
        lm = QwenTextModel(dataclasses.replace(src.cfg, kv_dtype=kv_dtype))
    lm.load_state_dict(src.state_dict(), assign=True)  # the same tensors, no copy
    quantize_qwen_text_(lm, group_size, weight_bits)  # new codes; src's Linears stay
    qmodel = copy.copy(model)  # the other submodules and parameters shared
    qmodel._modules = {**model._modules, "language_model": lm}
    qmodel._parameters = dict(model._parameters)
    qmodel._buffers = dict(model._buffers)
    qmodel.cfg = dataclasses.replace(model.cfg, text=_quant_text_cfg(
        model.cfg.text, weight_bits, group_size, kv_dtype))
    return InternVLAN1Policy(qmodel, seed=policy.seed, tokenizer=policy.tokenizer)


def _line(stats: dict, cfg, *, n_prompts: int, group_size, weight_bits: int, kv_dtype: str,
          decode_tokens: int, sequential: bool, device) -> dict:
    wdt = "int4" if weight_bits == 4 else "int8"
    layers = cfg.text.num_hidden_layers
    if sequential:
        qname = wdt + ("_kv8" if kv_dtype == "int8" else "")
        metric = f"{qname}_vs_bf16_serving_quality_7b_width_sequential"
        scheme = ("sequential (non-co-resident): bf16 pass -> free -> regeneration from the "
                  "same seed -> in-place quantization (quantize_qwen_text_, each bf16 weight "
                  "freed as its codes land) -> quant pass; same prompts, same S1 rng")
    else:
        metric = f"{wdt}_vs_bf16_serving_quality_7b_width"
        scheme = (f"symmetric {wdt} weight-only (deployment quantizer quantize_qwen_text_), "
                  "shared random bf16 source weights, identical S1 rng")
    dev = torch.device(device)
    return {
        "metric": metric,
        "value": stats["token_agreement"],
        "unit": "greedy_token_agreement",
        "vs_baseline": 1.0,
        "detail": {
            "num_layers": layers,
            "group_size": group_size,
            "weight_dtype": wdt,
            "kv_dtype": kv_dtype,
            "n_prompts": n_prompts,
            "decode_tokens": decode_tokens,
            **stats,
            "scheme": scheme,
            "caveat": f"{CAVEAT}; {layers} of the model's {FULL_LAYERS} decoder layers",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        },
    }


def compare_quant(policy, *, n_prompts: int = N_PROMPTS, group_size: Optional[int] = None,
                  weight_bits: int = 8, kv_dtype: str = "int8", outs_bf: Optional[list] = None,
                  image_hw: int = IMAGE_HW, decode_tokens: int = DECODE_TOKENS,
                  num_sample_trajs: int = NUM_SAMPLE_TRAJS, x_init=None):
    """The co-resident comparison of a built bf16 policy and its quantized
    copy (bench.py `bench_compare_quant`). `outs_bf`: the bf16 side's
    outputs of an earlier call with the same prompt settings (not run
    again). Returns (the JSON line's dict, the bf16 outputs, the quantized
    outputs); the quantized copy is freed before it returns."""
    kw = dict(image_hw=image_hw, decode_tokens=decode_tokens,
              num_sample_trajs=num_sample_trajs, x_init=x_init)
    if outs_bf is None:
        outs_bf = quality_prompts(policy, n_prompts, **kw)
    quant = quantized_copy(policy, weight_bits, group_size, kv_dtype)
    outs_q = quality_prompts(quant, n_prompts, **kw)
    line = _line(quality_compare(outs_bf, outs_q), quant.cfg, n_prompts=n_prompts,
                 group_size=group_size, weight_bits=weight_bits, kv_dtype=kv_dtype,
                 decode_tokens=decode_tokens, sequential=False, device=policy.device)
    del quant
    _free(policy.device)
    return line, outs_bf, outs_q


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def compare_quant_sequential(cfg, *, device, seed: int = 0, group_size: Optional[int] = None,
                             weight_bits: int = 8, kv_dtype: str = "int8",
                             image_hw: int = IMAGE_HW, decode_tokens: int = DECODE_TOKENS,
                             num_sample_trajs: int = NUM_SAMPLE_TRAJS):
    """The non-co-resident comparison (bench.py
    `bench_compare_quant_sequential`): the bf16 policy of `cfg`'s dims drawn
    from `seed`, its pass, freed; the identical tree drawn again and
    quantized in place (`InternVLAN1Policy.build` in the quantized format),
    its pass. Only one tree is resident at a time. Returns (the JSON line's
    dict, the bf16 outputs, the quantized outputs)."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    kw = dict(image_hw=image_hw, decode_tokens=decode_tokens,
              num_sample_trajs=num_sample_trajs)
    bf16 = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, weight_dtype="bf16", quant_group_size=None, kv_dtype="bf16"))
    policy = InternVLAN1Policy.build(bf16, device=device, seed=seed)
    outs_bf = quality_prompts(policy, N_PROMPTS, **kw)
    del policy
    _free(device)
    qcfg = dataclasses.replace(cfg, text=_quant_text_cfg(cfg.text, weight_bits, group_size,
                                                         kv_dtype))
    policy = InternVLAN1Policy.build(qcfg, device=device, seed=seed)
    outs_q = quality_prompts(policy, N_PROMPTS, **kw)
    del policy
    _free(device)
    line = _line(quality_compare(outs_bf, outs_q), qcfg, n_prompts=N_PROMPTS,
                 group_size=group_size, weight_bits=weight_bits, kv_dtype=kv_dtype,
                 decode_tokens=decode_tokens, sequential=True, device=device)
    return line, outs_bf, outs_q


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sequential", action="store_true",
                    help="bf16 pass, free, regenerate + quantize in place, quant pass")
    ap.add_argument("--quant-layers", type=int, default=FULL_LAYERS,
                    help="decoder depth (default all 28: the card holds both trees)")
    ap.add_argument("--quant-group", type=int, default=0,
                    help="per-group(g) weight scales (0 = per output channel; int4 takes "
                         "128 then)")
    ap.add_argument("--quant-bits", type=int, default=8, choices=(4, 8),
                    help="8 = W8A8 (default), 4 = W4A8 (grouped-128 scales, lm_head int8)")
    ap.add_argument("--kv-dtype", default="int8", choices=("bf16", "int8"),
                    help="the quantized side's KV cache (default int8, the realtime profile)")
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (no CPU fallback), or cpu when asked for")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config, 56-pixel frames, 4 tokens, 4 samples")
    args = ap.parse_args(argv)

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    device = torch.device(args.device)
    if device.type != "cpu":
        device = require_cuda(device)
    cfg = full_n1_config(args.quant_layers, tiny=args.tiny)
    kw = dict(group_size=args.quant_group or None, weight_bits=args.quant_bits,
              kv_dtype=args.kv_dtype, **(TINY if args.tiny else {}))
    if args.sequential:
        line, _, _ = compare_quant_sequential(cfg, device=device, **kw)
    else:
        policy = InternVLAN1Policy.build(cfg, device=device)
        line, _, _ = compare_quant(policy, **kw)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
