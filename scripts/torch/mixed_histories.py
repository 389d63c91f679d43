#!/usr/bin/env python3
"""Decode-graph captures and cycle times of the batched serving path when
the streams' histories are at mixed lengths.

    python scripts/torch/mixed_histories.py [--cycles 16]

chip_smoke.py's serve batched geometry (the 7B realtime policy behind
PipelinedN1Server, 4 cohorts x 12 streams, 224x224 frames, shared grouped
decode of 20 tokens with the stop id pinned to -7, 32 sample
trajectories, 2 System-1 calls a cycle), but every stream runs episodes
of seeded random lengths (EPISODE_STEPS System-2 steps) and starts at a
random step of its first one, so that histories of 1 to 9 frames mix in
every cohort, as in an evaluator whose episodes end at different times.
A stream whose episode ends starts the next one (a new instruction of
the same length) on the next cycle. Each cohort splits into groups by
history length and the shared decode runs once per prompt bucket, so a
cycle meets several decode layouts, each a decode loop of its own.

The same streams (same seed) are served once per run of RUNS: the decode
graphs with the cache-set and loop bounds that `decode_graph` ships, the
graphs with the bounds of 16 sets and 8 loops, and the decode run
eagerly (no captures). Prints per cycle its seconds (host clock, between
the ends of two cycles; the cycle ends in its last fetch), the captures,
the shared decodes (one per prompt bucket), and the cache sets and loops
kept; then per run the cycles with and without captures and their mean
seconds, the captures in all, the peak device memory, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

EPISODE_STEPS = (10, 40)  # an episode's System-2 steps: uniform in [10, 40]
# (name, (MAX_CACHES, MAX_LOOPS) or None for the shipped bounds, eager)
RUNS = (("graph", None, False), ("graph_16_8", (16, 8), False), ("eager", None, True))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=16)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import to_device
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import PipelinedN1Server
    from internnav_tpu_torch.realworld import serve

    device = require_cuda()
    policy = serve.build_policy("realtime", device=device)
    policy.tokenizer.eos_token_id = -7  # no token: the full decode budget
    shipped = (decode_graph.MAX_CACHES, decode_graph.MAX_LOOPS)
    decodes = {"n": 0}
    grouped_tail = policy.grouped_tail

    def counted_tail(*a, **kw):
        decodes["n"] += 1
        return grouped_tail(*a, **kw)

    policy.grouped_tail = counted_tail
    hw, rows, cohorts = cs.BATCH_HW, cs.BATCH_ROWS, cs.BATCH_COHORTS
    print(f"mixed histories: cohorts={cohorts} rows={rows} hw={hw} "
          f"max_new_tokens={cs.BATCH_NEW_TOKENS} episode_steps={EPISODE_STEPS} "
          f"cycles={args.cycles} shipped_bounds={shipped} {cs.gpu_line()}")
    for name, bounds, eager in RUNS:
        decode_graph.MAX_CACHES, decode_graph.MAX_LOOPS = bounds or shipped
        policy.decode_buffers = decode_graph.DecodeBuffers()
        policy.eager_decode = eager
        rng = np.random.default_rng(0)
        pool = rng.integers(0, 256, (16, hw, hw, 3), dtype=np.uint8)
        server = PipelinedN1Server(policy, rows, cohorts=cohorts)
        left = {}  # (cohort, slot) -> System-2 steps left in its episode

        def new_episode(ci, r, step=0):
            length = int(rng.integers(EPISODE_STEPS[0], EPISODE_STEPS[1] + 1))
            server.cohorts[ci].reset_slot(r, cs.own_instruction(int(rng.integers(4)),
                                                                int(rng.integers(12))))
            slot = server.cohorts[ci].slots[r]
            slot.rgb_list = [pool[int(i)] for i in rng.integers(0, 16, step)]
            slot.episode_idx = step
            if step:
                slot.s1_mem_frame = to_device(slot.rgb_list[-1], device)
            left[(ci, r)] = length - step

        for ci in range(cohorts):
            for r in range(rows):
                new_episode(ci, r, int(rng.integers(0, EPISODE_STEPS[0])))
        frames = {}

        def frames_fn(ci, t, ph):
            if (ci, t) not in frames:
                frames[(ci, t)] = pool[rng.integers(0, 16, rows)]
            return frames[(ci, t)]

        marks = [(time.perf_counter(), dict(decode_graph.stats), 0)]

        def on_cycle(ci, t, s2out, s1res):
            for r, s in enumerate(server.cohorts[ci].slots):
                s.s1_mem_feats = None
                left[(ci, r)] -= 1
                if left[(ci, r)] == 0:
                    new_episode(ci, r)
            if ci == cohorts - 1:
                marks.append((time.perf_counter(), dict(decode_graph.stats), decodes["n"]))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        decodes["n"] = 0
        marks[0] = (time.perf_counter(), dict(decode_graph.stats), 0)
        server.serve_stream(frames_fn, args.cycles, max_new_tokens=cs.BATCH_NEW_TOKENS,
                            num_sample_trajs=cs.BATCH_TRAJS, s1_calls=cs.BATCH_S1_CALLS,
                            on_cycle=on_cycle, shared_decode=True)
        with_cap, without = [], []
        for t in range(1, len(marks)):
            (t0, s0, d0), (t1, s1, d1) = marks[t - 1], marks[t]
            caps = s1.get("captures", 0) - s0.get("captures", 0)
            (with_cap if caps else without).append(t1 - t0)
            print(f"run {name} cycle {t - 1}: s={t1 - t0:.4f} captures={caps} "
                  f"shared_decodes={d1 - d0}")
        b = policy.decode_buffers
        mean = (lambda xs: f"{statistics.mean(xs):.4f}" if xs else "none")
        print(f"run {name}: bounds={bounds or shipped} eager={eager} "
              f"cycles_with_captures={len(with_cap)} mean_s={mean(with_cap)} "
              f"cycles_without={len(without)} mean_s={mean(without)} "
              f"captures={marks[-1][1].get('captures', 0) - marks[0][1].get('captures', 0)} "
              f"cache_sets={sum(len(x) for x in b._sets.values())} loops={len(b._loops)} "
              f"peak_mem_gib={torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
              f"{cs.gpu_line()}")
        del server
        policy.decode_buffers = decode_graph.DecodeBuffers()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
