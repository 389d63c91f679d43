"""Convert a reference-format torch checkpoint (InternVLA-N1, CMA,
Seq2Seq, RDP or NavDP) to a native directory of the PyTorch port.

    python scripts/torch/convert_checkpoint.py --model internvla_n1 \
        --src /path/to/InternVLA-N1 --dst converted/n1 [--int8 | --int4]
    python scripts/torch/convert_checkpoint.py --model cma \
        --src checkpoints/r2r/zero_shot/cma --dst converted/cma
    python scripts/torch/convert_checkpoint.py --model rdp \
        --src checkpoints/rdp/model.pth --dst converted/rdp
    python scripts/torch/convert_checkpoint.py --model navdp \
        --src checkpoints/navdp/navdp.ckpt --dst converted/navdp

The port's counterpart of scripts/tools/convert_checkpoint.py's
internvla_n1 branch: `InternVLAN1Policy.from_pretrained_torch` at the
Qwen2.5-VL-7B dims (with --int8 the decoder projections quantized to the
W8A8 `realtime` format as they load; with --int4 to W4A8: packed int4
codes with grouped-128 scales, the lm_head at 8 bits), then
`save_pretrained`, and the
tokenizer assets copied over so that the native directory loads the same
tokenizer. `realworld.serve --ckpt` and the agents load either format
directly; a native directory skips the conversion and, in int8, holds a
bit more than half the bytes. `--model cma` / `seq2seq` / `rdp` / `navdp`
load the reference checkpoint through `from_pretrained` (its converter,
`model/weights/convert.convert_recurrent_policy`, `convert_rdp_policy`
with its LongCLIP text variant, or `convert_navdp_policy`, at the default
config of the model) and save it natively (`save_pretrained`), as the JAX
tool does. The conversion runs on the GPU (`--device`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
from pathlib import Path
from typing import Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

#: the tokenizer and processor files a checkpoint directory carries
TOKENIZER_ASSETS = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "merges.txt",
                    "special_tokens_map.json", "chat_template.json",
                    "preprocessor_config.json", "generation_config.json")


def convert_n1(src: str, dst: str, *, int8: bool = False, int4: bool = False, device,
               cfg=None):
    """`src` (reference format) → the native directory `dst`, bf16, int8
    or int4, at 7B dims or `cfg`'s; returns the loaded policy."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    cfg = cfg if cfg is not None else InternVLAN1Config.qwen25vl_7b()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, weight_dtype="int4" if int4 else "int8" if int8 else "bf16"))
    policy = InternVLAN1Policy.from_pretrained_torch(src, cfg, device=device)
    policy.save_pretrained(dst)
    if os.path.isdir(src):
        for name in TOKENIZER_ASSETS:
            if os.path.exists(os.path.join(src, name)):
                shutil.copy2(os.path.join(src, name), os.path.join(dst, name))
    return policy


def convert_recurrent(model: str, src: str, dst: str, *, device, cfg=None):
    """A reference CMA / Seq2Seq / RDP / NavDP checkpoint `src` → the native
    directory `dst`, at the model's default config or `cfg`; returns the
    policy."""
    from internnav_tpu_torch.model import get_config, get_policy

    policy = get_policy(model).from_pretrained(src, cfg if cfg is not None else get_config(model),
                                               device=device)
    policy.save_pretrained(dst)
    return policy


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    choices=["cma", "seq2seq", "rdp", "navdp", "internvla_n1"])
    ap.add_argument("--src", required=True,
                    help="torch checkpoint (.pth/.bin/.safetensors file or directory)")
    ap.add_argument("--dst", required=True, help="output directory")
    ap.add_argument("--int8", action="store_true",
                    help="quantize the decoder to the W8A8 serving format before saving")
    ap.add_argument("--int4", action="store_true",
                    help="quantize the decoder to W4A8 (int4, grouped-128 scales, the "
                         "lm_head at 8 bits) before saving")
    ap.add_argument("--device", default="cuda", help="a CUDA device, or cpu")
    args = ap.parse_args(argv)
    if args.int8 and args.int4:
        ap.error("--int8 and --int4 are mutually exclusive")
    if (args.int8 or args.int4) and args.model != "internvla_n1":
        ap.error("--int8/--int4 apply only to --model internvla_n1")

    import torch

    from internnav_tpu_torch import require_cuda

    device = torch.device("cpu") if args.device == "cpu" else require_cuda(args.device)
    if args.model == "internvla_n1":
        convert_n1(args.src, args.dst, int8=args.int8, int4=args.int4, device=device)
    else:
        convert_recurrent(args.model, args.src, args.dst, device=device)
    print(f"converted {args.model}: {args.src} -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
