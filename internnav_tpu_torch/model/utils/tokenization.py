"""The HF tokenizer of an InternVLA-N1 checkpoint directory.

Port of `load_hf_tokenizer` (internnav_tpu/model/utils/tokenization.py:
14-31). `transformers` is imported here and nowhere else in the port, and
only when a directory holds tokenizer files (`has_tokenizer_files`): a
checkpoint without them gets the policy's `SimpleTokenizer`, as in the JAX
package. Unlike the JAX policy, which swallows any failure to load the
tokenizer and falls back to `SimpleTokenizer` (its `from_pretrained*`),
a directory whose tokenizer files do not load raises here (ROADMAP §3).
"""

from __future__ import annotations

import os

#: the files of an HF tokenizer; any one of them marks a directory as
#: holding a tokenizer
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "merges.txt",
                   "special_tokens_map.json", "tokenizer.model")
#: the special tokens the prompt builders read, exposed as `SPECIALS`
QWEN_SPECIAL_TOKENS = ("<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|vision_end|>",
                       "<|image_pad|>", "<|traj_pad|>")


def has_tokenizer_files(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f)) for f in TOKENIZER_FILES)


def load_hf_tokenizer(path: str):
    """AutoTokenizer from a local checkpoint directory (never the hub),
    with `SPECIALS` (the Qwen special tokens it has, by id) and a pad id
    (its eos when it names none: the prompt bucket's pads are isolated by
    segment ids, so their id does not reach the output)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    if not hasattr(tok, "SPECIALS"):
        specials = {}
        for name in QWEN_SPECIAL_TOKENS:
            ids = tok.convert_tokens_to_ids(name)
            if isinstance(ids, int) and ids >= 0:
                specials[name] = ids
        tok.SPECIALS = specials
    if tok.pad_token_id is None:
        tok.pad_token = tok.eos_token
    return tok
