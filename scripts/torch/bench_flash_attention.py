#!/usr/bin/env python3
"""Flash-attention kernel micro-benchmark on the GPU: K1 forward, K2 + K3 backward.

Port of scripts/tools/bench_flash_attention.py. Times the forward kernel
(K1, `csrc/flash_fwd.cu`) and the backward through `FlashAttentionFn`
(`ops/flash_attention.py`: D_i = rowsum(dO * O), then K2 and K3 of
`csrc/flash_bwd.cu`, the forward not included) at the reference's
training shape: B = 1, 28 heads x 128, T = 8192 packed into the segments
of cu = [0, T/3, T/2, T], causal, bf16. Each time is the median of
`--iters` CUDA-event timings after a warm call (chip_smoke.py's
`cuda_ms`: each call queued behind a device sleep, so that the events time
the device's work, not the host's launches).

    python scripts/torch/bench_flash_attention.py [--seq 8192] [--heads 28] [--iters 5]

Prints two lines, the JAX script's: ms and TFLOP/s by its formula (the
causal half of dense attention: 4 FLOP per (q, k) pair x D forward, 10
backward), and beside each the rate over the live (q, k) pairs that the
segments leave (each segment's causal triangle, as chip_smoke.py's
`valid_pairs` counts them), with the same FLOP per pair. At the default
segmentation the formula counts ~2.6x the live pairs, so its rate can read
above the card's 989 TFLOP/s bf16 peak. Needs the card: raises without
CUDA (a kernel benchmark has no host path).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

#: FLOP per (query, key) pair and head dimension: S and P.V forward; the
#: JAX script's five backward products
FWD_FLOP_PER_PAIR = 4
BWD_FLOP_PER_PAIR = 10


def segment_bounds(T: int) -> list:
    """cu_seqlens of the benchmark's packed row: [0, T/3, T/2, T]."""
    return [0, T // 3, T // 2, T]


def live_pairs(cu, causal: bool = True) -> int:
    """(query, key) pairs that segments [cu[i], cu[i+1]) leave unmasked in
    one row and head: c(c+1)/2 a segment of c tokens when causal, c^2
    without."""
    total = 0
    for a, b in zip(cu, cu[1:]):
        c = b - a
        total += c * (c + 1) // 2 if causal else c * c
    return total


def formula_pairs(T: int) -> float:
    """The JAX script's count: the causal half of a dense T x T row."""
    return T * T * 0.5


def run(seq: int = 8192, heads: int = 28, head_dim: int = 128, batch: int = 1,
        iters: int = 5) -> dict:
    """Time K1 and the K2 + K3 backward; returns the numbers printed."""
    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.ops import flash_attention as fa

    device = require_cuda()
    B, H, T, D = batch, heads, seq, head_dim
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.standard_normal((B, H, T, D)).astype(np.float32))
               .to(device, torch.bfloat16) for _ in range(3))
    cu = segment_bounds(T)
    seg = fa.segment_ids_from_cu_seqlens(torch.tensor(cu, device=device), T)[None].expand(
        B, T).contiguous()
    tables = fa.segment_tile_tables(seg, seg)
    fwd_ms = cuda_ms(lambda: fa.flash_attention_cuda(
        q, k, v, causal=True, segment_ids=seg, tile_tables=tables), iters)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = fa.FlashAttentionFn.apply(qg, kg, vg, seg, seg, True, None, tables)
    do = torch.from_numpy(rs.standard_normal((B, H, T, D)).astype(np.float32)).to(
        device, torch.bfloat16)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True),
                     iters)
    formula, live = B * H * D * formula_pairs(T), B * H * D * live_pairs(cu)
    out = {"shape": f"B{B}_H{H}_T{T}_D{D}_cu{cu}_causal", "iters": iters,
           "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
           "fwd_formula_tflops": FWD_FLOP_PER_PAIR * formula / fwd_ms / 1e9,
           "fwd_live_tflops": FWD_FLOP_PER_PAIR * live / fwd_ms / 1e9,
           "bwd_formula_tflops": BWD_FLOP_PER_PAIR * formula / bwd_ms / 1e9,
           "bwd_live_tflops": BWD_FLOP_PER_PAIR * live / bwd_ms / 1e9,
           "live_pairs_per_head": live_pairs(cu), "formula_pairs_per_head": formula_pairs(T),
           "device": torch.cuda.get_device_name(device)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--heads", type=int, default=28)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    r = run(args.seq, args.heads, args.head_dim, args.batch, args.iters)
    for side in ("fwd", "bwd"):
        print(f"{side}  {r[f'{side}_ms']:8.4f} ms   {r[f'{side}_formula_tflops']:6.1f} TFLOP/s "
              f"(formula: causal half of dense)   {r[f'{side}_live_tflops']:6.1f} TFLOP/s "
              f"(live pairs)")
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
