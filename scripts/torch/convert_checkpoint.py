"""Convert a reference-format InternVLA-N1 torch checkpoint to a native
directory of the PyTorch port.

    python scripts/torch/convert_checkpoint.py --model internvla_n1 \
        --src /path/to/InternVLA-N1 --dst converted/n1 [--int8]

The port's counterpart of scripts/tools/convert_checkpoint.py's
internvla_n1 branch: `InternVLAN1Policy.from_pretrained_torch` at the
Qwen2.5-VL-7B dims (with --int8 the decoder projections quantized to the
W8A8 `realtime` format as they load), then `save_pretrained`, and the
tokenizer assets copied over so that the native directory loads the same
tokenizer. `realworld.serve --ckpt` and the agents load either format
directly; a native directory skips the conversion and, in int8, holds a
bit more than half the bytes. The conversion runs on the GPU (`--device`);
`--int4` and the other models of the JAX tool are not ported yet and raise.
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


def convert_n1(src: str, dst: str, *, int8: bool, device, cfg=None):
    """`src` (reference format) → the native directory `dst`, bf16 or
    int8, at 7B dims or `cfg`'s; returns the loaded policy."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    cfg = cfg if cfg is not None else InternVLAN1Config.qwen25vl_7b()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, weight_dtype="int8" if int8 else "bf16"))
    policy = InternVLAN1Policy.from_pretrained_torch(src, cfg, device=device)
    policy.save_pretrained(dst)
    if os.path.isdir(src):
        for name in TOKENIZER_ASSETS:
            if os.path.exists(os.path.join(src, name)):
                shutil.copy2(os.path.join(src, name), os.path.join(dst, name))
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
    ap.add_argument("--int4", action="store_true", help="W4A8 (not yet ported)")
    ap.add_argument("--device", default="cuda", help="a CUDA device, or cpu")
    args = ap.parse_args(argv)
    if args.int8 and args.int4:
        ap.error("--int8 and --int4 are mutually exclusive")
    if (args.int8 or args.int4) and args.model != "internvla_n1":
        ap.error("--int8/--int4 apply only to --model internvla_n1")
    if args.int4:
        raise NotImplementedError("--int4 (W4A8) is not yet ported (ROADMAP §1 item 3)")
    if args.model != "internvla_n1":
        raise NotImplementedError(f"--model {args.model} is not yet ported (ROADMAP §1 item 6)")

    import torch

    from internnav_tpu_torch import require_cuda

    device = torch.device("cpu") if args.device == "cpu" else require_cuda(args.device)
    convert_n1(args.src, args.dst, int8=args.int8, device=device)
    print(f"converted {args.model}: {args.src} -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
