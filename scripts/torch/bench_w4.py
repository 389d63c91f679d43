#!/usr/bin/env python3
"""Decode-shaped weight-stream micro-benchmark on the GPU, by weight format.

Port of scripts/tools/bench_w4.py. Greedy decode of the 7B streams every
decoder weight once a token, so its rate is the weight stream's: this
times M = 16 rows against a K x N = 3584 x 18944 projection (the MLP's
gate / up) over 12 distinct weight buffers (~815 MB of int8, well past the
50 MB L2), one product a buffer, in four formats:

  bf16      torch.matmul of bf16 weights (2 B a weight; a plain product,
            as JAX computes it outside any Pallas kernel)
  s8        K6b through the W8A8 route (`quant.w8a8_linear_multi`: int8
            codes, per-channel scales, int8 activations; 1 B)
  s4        K10 through the W4A16 route (`quant.w8a16_linear_multi` on packed
            int4 codes with 128-group scales, bf16 activations; 0.5 B).
            JAX's s4 row widens a jnp.int4 array in the graph; torch has no
            int4 dtype, and K10 is the port's kernel that reads int4 codes
            against unquantized activations
  s4packed  K9 through the W4A8 route (`quant.w4a8_linear_multi`: the port's
            packed int4 codes, two a byte, 128-group scales, int8
            activations; 0.5 B)

    python scripts/torch/bench_w4.py [--m 16] [--k 3584] [--n 18944] [--bufs 12] [--iters 5]

Each format's time is the best of `--iters` CUDA-event timings of the 12
products (chip_smoke.py's `cuda_ms`: after a warm call, each call queued
behind a device sleep). Prints the weight stream's GB/s and the
s8-equivalent rate (the int8 volume over the time), as the JAX script
does. Needs the card: raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

#: bytes a weight of each format streams
BYTES_PER_WEIGHT = {"bf16": 2.0, "s8": 1.0, "s4": 0.5, "s4packed": 0.5}
INT4_GROUP = 128


def run(m: int = 16, k: int = 3584, n: int = 18944, bufs: int = 12, iters: int = 5) -> dict:
    """Time each format's 12 products; returns {format: {ms, stream_gbs,
    s8_equiv_gbs}} with the device's name."""
    import torch

    from chip_smoke import cuda_ms
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.ops import quant

    device = require_cuda()
    g = torch.Generator(device=device).manual_seed(0)
    M, K, N, NB = m, k, n, bufs
    w8 = [torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=g, device=device)
          for _ in range(NB)]
    s8 = torch.full((N,), 2e-4, device=device)
    wbf = [w.T.contiguous().to(torch.bfloat16) for w in w8]  # (K, N), x @ w
    w4 = [quant.pack_int4(torch.randint(-7, 8, (N, K), dtype=torch.int8, generator=g,
                                        device=device)) for _ in range(NB)]
    s4 = torch.full((K // INT4_GROUP, N), 2e-3, device=device)
    xq = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=g, device=device)
    a_scale = torch.full((M, 1), 1e-2, device=device)
    x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)

    cases = {
        "bf16": lambda: [torch.matmul(x, w) for w in wbf],
        "s8": lambda: [quant.w8a8_linear_multi(xq, a_scale, [(w, s8, None)]) for w in w8],
        "s4": lambda: [quant.w8a16_linear_multi(x, [(w, s4, None)]) for w in w4],
        "s4packed": lambda: [quant.w4a8_linear_multi(xq, a_scale, [(w, s4, None)]) for w in w4],
    }
    eq_gb = NB * K * N * 1.0 / 1e9  # the s8-equivalent weight volume
    out = {"shape": f"M{M}_K{K}_N{N}_bufs{NB}", "iters": iters,
           "device": torch.cuda.get_device_name(device)}
    for name, fn in cases.items():
        ms = cuda_ms(fn, iters, stat=min)
        gb = NB * K * N * BYTES_PER_WEIGHT[name] / 1e9
        out[name] = {"ms": ms, "stream_gbs": gb / ms * 1e3, "s8_equiv_gbs": eq_gb / ms * 1e3}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--k", type=int, default=3584)
    ap.add_argument("--n", type=int, default=18944)
    ap.add_argument("--bufs", type=int, default=12)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    r = run(args.m, args.k, args.n, args.bufs, args.iters)
    for name in BYTES_PER_WEIGHT:
        c = r[name]
        print(f"{name:9s}: {c['ms']:7.3f} ms  stream {c['stream_gbs']:7.1f} GB/s"
              f"  (s8-equiv rate {c['s8_equiv_gbs']:7.1f} GB/s)")
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
