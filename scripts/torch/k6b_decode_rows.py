#!/usr/bin/env python3
"""Device time of K6b's decode launches at the 7B shapes, per decoder layer.

    python scripts/torch/k6b_decode_rows.py [--rows 1 4 12]

For each M, times with `chip_smoke.cuda_ms` (each call queued behind a
device sleep, so the events time device work) the products of one decoder
layer of the realtime profile: q/k/v (3584 + 512 + 512 columns over
K=3584), o (3584 x 3584), gate/up (2 x 18944 over 3584), down (3584 x
18944), and the lm_head (152064 x 3584) at M = 1, twice: warm (the
same weights again, which stay in the 50 MB L2 where they fit: q/k/v and
o) and cold (a 128 MB buffer written before each timed call, as a decode
step meets each layer's weights). Where the tree has
`quant.w8a8_linear_multi`, q/k/v and gate/up are one call each (one launch
at M <= 16); in a tree without it, the separate launches are timed together
in one call, so a parent commit's numbers are its launches summed. Each
row also prints its byte bound (weights, activations, scales, bias and
output once over 3.35 TB/s) and is held equal to the plain version
(per-channel: bit for bit). Run it from a checkout's root; to compare with
a parent commit, copy it into the parent's `git archive` and run both on
one card in turns.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

E, I, KV_W, VOCAB = 3584, 18944, 512, 152064
LAYER = [("qkv", (E, KV_W, KV_W), E, True), ("o", (E,), E, False),
         ("gate_up", (I, I), E, False), ("down", (E,), I, False)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4, 12])
    args = ap.parse_args()

    import torch

    from chip_smoke import PEAK_HBM_BYTES, cuda_ms, gpu_line
    from internnav_tpu_torch.ops import quant

    dev = torch.device("cuda", 0)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def cold_ms(fn, reps: int = 20) -> float:
        """`cuda_ms` with L2 emptied of fn's operands before each call: the
        buffer is written between the device sleep and the start event."""
        fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(10_000_000)
            flush.fill_(1)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    g = torch.Generator(device=dev).manual_seed(3)
    fused = hasattr(quant, "w8a8_linear_multi")
    results = []
    for M in args.rows:
        cases = LAYER + ([("lm_head", (VOCAB,), E, False)] if M == 1 else [])
        total = {"ms": 0.0, "cold_ms": 0.0, "bound_ms": 0.0}
        for name, widths, K, bias in cases:
            xq, a = quant.quantize_rows(torch.randn((M, K), generator=g, device=dev,
                                                    dtype=torch.bfloat16))
            segs = [(torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8),
                     torch.rand(N, generator=g, device=dev) * 1e-3,
                     torch.randn(N, generator=g, device=dev) if bias else None)
                    for N in widths]
            if fused:
                def run():
                    return quant.w8a8_linear_multi(xq, a, segs)
            else:
                def run():
                    return [quant.w8a8_linear_cuda(xq, a, *s) for s in segs]
            ys = run()
            torch.cuda.synchronize()
            for y, s in zip(ys, segs):
                if not torch.equal(y, quant.w8a8_linear_reference(xq, a, *s)):
                    raise AssertionError(f"K6b {name} M={M}: differs from the plain version")
            N = sum(widths)
            nbytes = N * K + M * K + 4 * M + 4 * N + (4 * N if bias else 0) + 2 * M * N
            row = {"M": M, "projection": name, "N": "+".join(map(str, widths)), "K": K,
                   "launches": 1 if fused else len(widths), "ms": cuda_ms(run),
                   "cold_ms": cold_ms(run), "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3}
            if name != "lm_head":
                for k in total:
                    total[k] += row[k]
            results.append(row)
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()))
            del xq, a, segs, ys
        print(f"M={M} layer: " + " ".join(f"{k}={v:.4f}" for k, v in total.items()))
    print(json.dumps({"k6b_decode_rows": results, "fused": fused}))
    print(gpu_line())


if __name__ == "__main__":
    main()
