#!/usr/bin/env python3
"""Device time of K9's and K10's launches at the 7B shapes, per decoder layer.

    python scripts/torch/k9_k10_rows.py [--tree DIR] [--rows 1 4 12 48]

Imports `internnav_tpu_torch` from DIR, the root of a checkout (by default
the one this script is in), so one card can time a parent commit's `git
archive` and this tree in turns; the weights, the bound, the library call
and the timer are this checkout's `chip_smoke.py` (`qgemm_weights`,
`qgemm_bytes`, `w16_library`, `cuda_ms`).

- Layer rows: for each M, the products of one decoder layer, q/k/v (3584 +
  512 + 512 columns over K=3584), o (3584 x 3584), gate/up (2 x 18944 over
  3584) and down (3584 x 18944), for K9 (int8 rows from K6a x grouped-128
  int4 codes), K10 with per-channel int8 codes (W8A16) and K10 with
  grouped-128 int4 codes (W4A16). Where the tree has
  `quant.w4a8_linear_multi` / `w8a16_linear_multi`, q/k/v and gate/up are
  one call each (one launch where the tree fuses); in a tree without them
  the separate launches are timed together in one call, so a parent's
  numbers are its launches summed.
- Single rows: the rows of PERF.md's kernel table, each projection alone:
  K9 gate at 1, 12, 48, 192, 1,088 and 4,864 rows, down and k at 1; K10
  gate int8 at 1, gate int4 at 1, 12, 48 and 192, down int4 at 1, the
  lm_head int8 at 1 and 48 and 8-bit grouped at 1.
- Each row is timed warm and, at M <= 16, with a cold L2 (a 128 MB buffer
  written before each timed call, as a decode step meets each layer's
  weights), and printed with its bound (the codes, scales, bias, input
  rows and output once over 3.35 TB/s, or the operations over the tensor
  cores' peak, whichever is longer) and the library's time on the same
  rows, one call on the projections' codes stacked along N:
  `torch._weight_int4pack_mm` (tinygemm) for int4 codes (for K9 on the
  rows in bf16, the same weight stream), `_weight_int8pack_mm` for
  per-channel int8; none for 8-bit grouped. Each row is held to the plain
  version (K9 per channel bitwise, else within GROUPED_TOL). The port
  never calls the library.
- K6b digests: sha256 of K6b's decode outputs (one layer's projections at
  1, 4 and 12 rows, per channel and grouped-128) from fixed seeds, so two
  trees' lines show whether K6b's bits changed.

Prints one line a row, one JSON object of all rows, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

E, I, KV_W, VOCAB = 3584, 18944, 512, 152064
LAYER = [("qkv", (E, KV_W, KV_W), E, True), ("o", (E,), E, False),
         ("gate_up", (I, I), E, False), ("down", (E,), I, False)]
HERE = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4, 12, 48])
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from internnav_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        raise SystemExit("k9_k10_rows: no CUDA device")
    dev = torch.device("cuda", 0)
    fused = hasattr(quant, "w4a8_linear_multi")

    def row(kernel, label, M, widths, K, bits, group, bias, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        made = [smoke.qgemm_weights(g, dev, N, K, bits, group, bias) for N in widths]
        segs = [seg for _, seg in made]
        x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
        if kernel == "K9":
            xq, a = quant.quantize_rows(x)
            if fused:
                def run():
                    return quant.w4a8_linear_multi(xq, a, segs)
            else:
                def run():
                    return [quant.w4a8_linear_cuda(xq, a, *sg) for sg in segs]
            def plain(r, sg):
                return quant.w4a8_linear_reference(xq[r], a[r], *sg)
            peak = smoke.PEAK_INT8_OPS
        else:
            if fused:
                def run():
                    return quant.w8a16_linear_multi(x, segs)
            else:
                def run():
                    return [quant.w8a16_linear_cuda(x, *sg) for sg in segs]
            def plain(r, sg):
                return quant.w8a16_linear_reference(x[r], *sg)
            peak = smoke.PEAK_BF16_FLOPS
        ys = run()
        # the plain version in blocks of rows (a grouped one holds a
        # (groups, rows, N) float64 tensor)
        block = smoke.PLAIN_ROW_BLOCK
        ref = [torch.cat([plain(slice(i, i + block), sg) for i in range(0, M, block)])
               for sg in segs]
        torch.cuda.synchronize()
        tol = smoke.GROUPED_TOL
        for y, want in zip(ys, ref):
            ok = (torch.equal(y, want) if kernel == "K9" and not group else
                  torch.allclose(y.float(), want.float(), atol=tol, rtol=tol))
            if not ok:
                raise AssertionError(f"{kernel} {label} M={M}: differs from the plain version")
        del ys, ref
        N = sum(widths)
        bound_ms, bound_by = smoke._bytes_bound(smoke.qgemm_bytes(kernel, M, K, bits, segs),
                                                2.0 * M * N * K, peak)
        call, _ = smoke.w16_library(x, torch.cat([c for c, _ in made]),
                                    torch.cat([sg[1] for sg in segs], dim=-1), bits, group)
        out = {"kernel": kernel, "row": label, "M": M, "N": "+".join(map(str, widths)), "K": K,
               "bits": bits, "group": group or 0, "ms": smoke.cuda_ms(run),
               "cold_ms": smoke.cuda_ms(run, cold=True) if M <= 16 else None,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": smoke.cuda_ms(call) if call is not None else None}
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in out.items()), flush=True)
        torch.cuda.empty_cache()
        return out

    results = []
    for M in args.rows:
        for kernel, bits, group in (("K9", 4, 128), ("K10", 8, None), ("K10", 4, 128)):
            if kernel == "K9" and M > 64:
                continue  # the prefill tiles: the single rows below
            total = {"ms": 0.0, "cold_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
            for i, (name, widths, K, bias) in enumerate(LAYER):
                r = row(kernel, f"layer_{name}", M, widths, K, bits, group, bias, seed=100 * M + i)
                results.append(r)
                for k in total:
                    total[k] = None if total[k] is None or r[k] is None else total[k] + r[k]
            print(f"{kernel} int{bits} M={M} layer: " + " ".join(
                f"{k}={v:.4f}" if v is not None else f"{k}=None" for k, v in total.items()))
    singles = [("K9", "gate", M, (I,), E, 4, 128, False) for M in (1, 12, 48, 192, 1088, 4864)]
    singles += [("K9", "down", 1, (E,), I, 4, 128, False), ("K9", "k", 1, (KV_W,), E, 4, 128, True),
                ("K10", "gate", 1, (I,), E, 8, None, False)]
    singles += [("K10", "gate", M, (I,), E, 4, 128, False) for M in (1, 12, 48, 192)]
    singles += [("K10", "down", 1, (E,), I, 4, 128, False),
                ("K10", "lm_head", 1, (VOCAB,), E, 8, None, False),
                ("K10", "lm_head", 1, (VOCAB,), E, 8, 128, False),
                ("K10", "lm_head", 48, (VOCAB,), E, 8, None, False)]
    for j, (kernel, name, M, widths, K, bits, group, bias) in enumerate(singles):
        results.append(row(kernel, name, M, widths, K, bits, group, bias, seed=7 + j))

    digest = hashlib.sha256()
    for M in (1, 4, 12):
        for group in (0, 128):
            for i, (name, widths, K, bias) in enumerate(LAYER):
                g = torch.Generator(device=dev).manual_seed(1000 * M + 10 * i + group)
                xq, a = quant.quantize_rows(torch.randn((M, K), generator=g, device=dev,
                                                        dtype=torch.bfloat16))
                segs = [smoke.qgemm_weights(g, dev, N, K, 8, group, bias)[1] for N in widths]
                for y in quant.w8a8_linear_multi(xq, a, segs):
                    digest.update(y.view(torch.int16).cpu().numpy().tobytes())
    print(f"k6b_decode_digest={digest.hexdigest()}")
    print(json.dumps({"k9_k10_rows": results, "fused": fused,
                      "k6b_decode_digest": digest.hexdigest()}))
    print(smoke.gpu_line())


if __name__ == "__main__":
    main()
