#!/usr/bin/env python3
"""Device time of K6a's SWIGLU prologue at the 7B shapes, and its registers.

    python scripts/torch/k6a_swiglu_rows.py [--tree DIR] [--rows 1 3 48 1088 4864]

Imports `internnav_tpu_torch` (and `chip_smoke.cuda_ms`) from DIR, the root
of a checkout (by default the one this script is in), so one card can time
a parent commit's `git archive` and this tree in turns. For each M: a
random bf16 gate (N(0, 9)) and up (N(0, 1)) of M x 18944, the down
projection's input of a realtime decoder layer; `quant.swiglu_quantize_cuda`
held bitwise equal to its plain version (`swiglu_quantize_reference`) and
both timed (each call queued behind a device sleep, so the events time
device work), beside the byte bound (both inputs read once, the codes and
scales written once, over 3.35 TB/s). Then the ptxas lines of the tree's
SWIGLU instantiations (registers, spills) from the build log, and for each
the blocks an SM holds by registers at the 7B row's thread count (the
register file's 65,536 per SM, allocated 256 a warp; at most 2,048
threads), its theoretical occupancy. Prints one JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

I = 18944  # the 7B intermediate width: the SWIGLU row
PEAK_HBM_BYTES = 3.35e12
REGS_PER_SM, MAX_THREADS_PER_SM, MAX_THREADS = 65536, 2048, 1024


def threads_for(K: int) -> tuple:
    """(vectors a thread, threads a block) of K6a's launch for a bf16 row
    of K: `launch` in csrc/quantize_rows.cu."""
    nvec = K // 8
    nv = -(-nvec // MAX_THREADS)
    return nv, (-(-nvec // nv) + 31) // 32 * 32


def blocks_per_sm(regs: int, threads: int) -> int:
    warp_regs = -(-regs * 32 // 256) * 256
    return min(REGS_PER_SM // (warp_regs * (threads // 32)), MAX_THREADS_PER_SM // threads)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 3, 48, 1088, 4864])
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch

    from chip_smoke import cuda_ms, gpu_line
    from internnav_tpu_torch.ops import _build, quant

    if not torch.cuda.is_available():
        raise SystemExit("k6a_swiglu_rows: no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    for M in args.rows:
        gate = (torch.randn((M, I), generator=g, device="cuda") * 3.0).bfloat16()
        up = torch.randn((M, I), generator=g, device="cuda").bfloat16()
        (q, s), (rq, rs) = quant.swiglu_quantize_cuda(gate, up), \
            quant.swiglu_quantize_reference(gate, up)
        if not (torch.equal(q, rq) and torch.equal(s.view(torch.int32), rs.view(torch.int32))):
            raise AssertionError(f"K6a SWIGLU M={M}: differs from its plain version")
        print(json.dumps({
            "tree": tree, "M": M, "K": I,
            "ms": cuda_ms(lambda: quant.swiglu_quantize_cuda(gate, up)),
            "plain_ms": cuda_ms(lambda: quant.swiglu_quantize_reference(gate, up)),
            "bound_ms": (2 * M * I * 2 + M * I + 4 * M) / PEAK_HBM_BYTES * 1e3,
            "gpu": gpu_line()}), flush=True)
    nv, threads = threads_for(I)
    log = _build.library_path("quantize_rows.cu").with_suffix(".log").read_text()
    # each entry: its mangled name, then its spill line and its register line
    for m in re.finditer(r"Compiling entry function '(\S*quantize_rows_kernelILi2E\S*)'"
                         r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*?(\d+) bytes spill stores, (\d+) bytes "
                         r"spill loads\n[^\n]*Used (\d+) registers", log):
        name, stores, loads, regs = m[1], int(m[2]), int(m[3]), int(m[4])
        vectors = int(re.search(r"Lb[01]ELi(\d)E", name)[1])
        row = {"tree": tree, "prologue": "SWIGLU", "vectors_a_thread": vectors,
               "registers": regs, "spill_store_bytes": stores, "spill_load_bytes": loads}
        if vectors == nv:  # the 7B row's instantiation
            b = blocks_per_sm(regs, threads)
            row.update(threads=threads, blocks_per_sm=b,
                       occupancy=b * threads / MAX_THREADS_PER_SM)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
