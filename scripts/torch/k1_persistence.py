#!/usr/bin/env python3
"""K1 with persistent blocks against K1 with one block per work item.

    python scripts/torch/k1_persistence.py

Builds `csrc/flash_fwd.cu` a second time with -DFLASH_FWD_PERSISTENT=0: the
same kernel, launched with one block per (128-query block, head) item
instead of one block per SM. On each of `chip_smoke.py`'s K1 rows (the
serving shapes, the packed T=8192 training row and the dense causal T=8192
row) it checks that both builds give bitwise the same o and lse, then times
them with `chip_smoke.cuda_ms` in the order persistent, per item, per item,
persistent, and prints one line per row.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def build_per_item():
    """The per-item build's C entry point, bound like the port's own."""
    from internnav_tpu_torch.ops import _build
    from internnav_tpu_torch.ops import flash_attention as fa

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "flash_fwd_per_item.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DFLASH_FWD_PERSISTENT=0",
                           "-o", str(out), str(_build.CSRC / "flash_fwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    own = fa._kernel_entry()
    fn = ctypes.CDLL(str(out)).flash_fwd_bf16
    fn.argtypes, fn.restype = own.argtypes, own.restype
    return own, fn


def main() -> None:
    import torch

    from chip_smoke import TRAIN_LEN, cuda_ms, gpu_line, k1_cases, packed_row, synthetic_store
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.ops import flash_attention as fa

    device = require_cuda()
    persistent, per_item = build_per_item()
    g = torch.Generator(device=device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)

    packed = torch.as_tensor(packed_row(synthetic_store(), TRAIN_LEN)["segment_ids"],
                             device=device)
    rows = k1_cases(device) + [
        (f"{name}_T{TRAIN_LEN}", rnd(1, 28, TRAIN_LEN, 128), rnd(1, 4, TRAIN_LEN, 128),
         rnd(1, 4, TRAIN_LEN, 128), seg, True)
        for name, seg in (("train", packed), ("dense_causal", None))]
    for name, q, k, v, seg, causal in rows:
        tabs = fa.segment_tile_tables(seg)

        def run(entry):
            saved = fa._kernel_entry
            fa._kernel_entry = lambda: entry
            try:
                return fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg,
                                               tile_tables=tabs)
            finally:
                fa._kernel_entry = saved

        (o1, l1), (o2, l2) = run(persistent), run(per_item)
        if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
            raise AssertionError(f"{name}: the two builds disagree")
        times = {"persistent": [], "per_item": []}
        for which in ("persistent", "per_item", "per_item", "persistent"):
            entry = persistent if which == "persistent" else per_item
            times[which].append(cuda_ms(lambda: run(entry)))
        items = q.shape[0] * q.shape[1] * -(-q.shape[2] // fa.FWD_QUERY_BLOCK)
        ratio = statistics.median(times["per_item"]) / statistics.median(times["persistent"])
        print(f"k1 {name}: items={items} persistent_ms={times['persistent']} "
              f"per_item_ms={times['per_item']} per_item_over_persistent={ratio:.4f} "
              f"gpu={gpu_line()!r}")


if __name__ == "__main__":
    main()
