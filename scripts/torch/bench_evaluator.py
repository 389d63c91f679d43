#!/usr/bin/env python3
"""The evaluator-path headline of the PyTorch port on one GPU.

    python3 scripts/torch/bench_evaluator.py

Runs the declared headline configuration of docs/BENCH_METHOD.md ("THE
headline") through the product loop: `VLNPipelinedEvaluator` over
`FakeEnv` (episode loading, simulator stepping, metrics, the resume store
and the progress log) driving `BatchedInternVLAN1Agent` cohorts that share
one policy. The configuration:

- the 7B `realtime` policy (`realworld.serve.build_policy`: W8A8
  projections, int8 KV cache; random weights from seed 0, or `--ckpt`'s);
- 4 cohorts x 12 streams at 224x224, the shared grouped decode, System-1
  per cohort, the barrier env apply (`overlap_apply=False`);
- 20 new tokens with the stop id pinned to -7, which no token is, so every
  System-2 call decodes the full budget (the prompts keep the tokenizer's
  pad id); 32 sample trajectories; episodes of at most 24 steps, built as
  bench.py's `make_episodes` builds them;
- one warm run (the decode graphs' captures), then 3 timed runs of the
  same episodes: the runs visit the same shapes;
- Python's str hash pinned (PYTHONHASHSEED=0, the entry re-executes
  itself with it): FakeEnv seeds each episode's frames with
  hash(path_key), as the JAX package's does, so without the pin every
  process would evaluate other frames, and other episode lengths.

Actions/s counts the live streams' actions over the evaluator's wall time
(`actions_timed` / `wall_clock_s`, as bench.py's `bench_evaluator_path`).
Prints one JSON line: `metric`, `value` (the median of the runs), `unit`,
`vs_baseline` (against the A100 estimate below, whose System-1 is
NextDiT: the nextdit_async head only), and `detail` with the
samples, their spread, the median run, peak device memory and the device
(`nvidia-smi` name and power limit). A failed run raises and exits
non-zero: no value is printed without a measurement.

`--weight-dtype {int8,int4}` and `--kv-dtype {bf16,int8}` pick the
decoder's weight and KV formats, as bench.py's flags (by default the
realtime profile's, int8 and int8; with `--tiny` the tiny model's own); a
native `--ckpt` keeps the weight dtype it records. `--system1
{nextdit_async,navdp_async,navdp}` picks the System-1 head (the agents'
`model_settings["system1"]`, as the JAX evaluator's config passes it;
nextdit_async by default); the NavDP head takes each stream's [memory,
current] RGBD pair, FakeEnv's depth at the rgb resolution.

`--tiny` runs the same loop with the tiny model on the CPU, 2 cohorts x 2
streams (the tests); its numbers are no device measurement and carry no
baseline.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The reference's actions/s on one A100-80GB SXM, estimated per component
# at speed of light (bench.py:33-77, docs/BENCH_METHOD.md; 312 TFLOP/s
# bf16, 2,039 GB/s): an 8-action cycle of ViT encode (9 frames at
# 224x224, ~3.1 TFLOP at 45% MFU), S2 prefill (~700 tokens, 10.6 TFLOP at
# 45%), 20 decode tokens (15.2 GB of weights a token at the full memory
# rate), the reference's second prefill for the latents, and two NextDiT
# denoises. No TPU figure enters it.
REF_A100_MS = {
    "vit_encode_ms": 22.2,
    "s2_prefill_ms": 75.7,
    "decode_20tok_ms": 149.2,
    "generate_latents_ms": 101.0,
    "s1_denoise_2x_ms": 30.0,
}
REF_CYCLE_MS = sum(REF_A100_MS.values())
ACTIONS_PER_CYCLE = 8
REF_ACTIONS_PER_SEC = ACTIONS_PER_CYCLE / (REF_CYCLE_MS / 1e3)  # 21.2

DECODE_TOKENS = 20
NUM_SAMPLE_TRAJS = 32
IMAGE_HW = 224
COHORTS = 4
BATCH = 12
MAX_STEP = 24
RUNS = 3
STOP_ID = -7  # no token: every System-2 call decodes the full budget
HASH_SEED = "0"  # PYTHONHASHSEED of a run: FakeEnv's frames depend on it


def pin_hash_seed(argv: Sequence[str]) -> None:
    """Re-execute this interpreter on argv with PYTHONHASHSEED=HASH_SEED
    unless it already runs with it (the seed is read at start-up only)."""
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable, *argv],
                  {**os.environ, "PYTHONHASHSEED": HASH_SEED})


def median(vals: Sequence[float]) -> float:
    """The median of sorted samples (an even count averages the middle
    two), bench.py's `_median`."""
    mid = len(vals) // 2
    return vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def make_episodes(n: int) -> list:
    """bench.py's benchmark episodes: a 12 m straight reference path, one
    instruction each."""
    from internnav_tpu_torch.env.episodes import Episode

    eps = []
    for i in range(n):
        ref = np.stack([np.linspace(0.0, 12.0, 6), np.zeros(6), np.zeros(6)], axis=1)
        eps.append(Episode(
            episode_id=str(i), trajectory_id=f"t{i}", scene_id="bench",
            instruction_text=("walk down the hallway past the kitchen "
                              f"then turn left and stop at table {i}"),
            instruction_tokens=np.arange(8, dtype=np.int32),
            start_position=np.zeros(3), start_rotation=np.asarray([1.0, 0, 0, 0]),
            reference_path=ref, geodesic_distance=12.0))
    return eps


def headline_cfg(out_dir: str, *, batch: int, cohorts: int, max_step: int, hw: int,
                 max_new_tokens: int, num_sample_trajs: int, system1: str = "nextdit_async"):
    """The evaluator config of the headline: the pipelined evaluator over
    FakeEnv cohorts, shared decode, per-cohort System-1, barrier apply."""
    from internnav_tpu_torch.configs import (
        AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg, MetricCfg, TaskCfg,
    )

    settings = {"batch_size": batch, "max_new_tokens": max_new_tokens,
                "num_sample_trajs": num_sample_trajs, "sys2_max_forward_step": 8,
                "max_local_steps": 4, "system1": system1}
    return EvalCfg(
        agent=AgentCfg(model_name="internvla_n1_batched", model_settings=settings),
        env=EnvCfg(env_type="fake", env_num=batch,
                   env_settings={"rgb_resolution": [hw, hw], "depth_resolution": [hw, hw],
                                 "cohorts": cohorts, "shared_decode": True,
                                 "shared_s1": False, "overlap_apply": False}),
        task=TaskCfg(max_step=max_step, metric_config=MetricCfg(success_distance=3.0)),
        dataset=EvalDatasetCfg(), eval_type="vln_pipelined", output_dir=out_dir)


def evaluator_run(inner, out_dir: str, *, batch: int = BATCH, cohorts: int = COHORTS,
                  max_step: int = MAX_STEP, hw: int = IMAGE_HW,
                  max_new_tokens: int = DECODE_TOKENS,
                  num_sample_trajs: int = NUM_SAMPLE_TRAJS) -> Dict[str, Any]:
    """One evaluation of batch x cohorts episodes through the pipelined
    evaluator on `inner` (an `InternVLAN1Policy`): its actions/s, latency
    percentiles and per-episode records. Raises unless every episode
    ended."""
    from internnav_tpu_torch.agent.internvla_n1_agent import BatchedInternVLAN1Agent
    from internnav_tpu_torch.evaluator.vln_pipelined_evaluator import VLNPipelinedEvaluator
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import BatchedN1Policy

    cfg = headline_cfg(out_dir, batch=batch, cohorts=cohorts, max_step=max_step, hw=hw,
                       max_new_tokens=max_new_tokens, num_sample_trajs=num_sample_trajs,
                       system1=inner.cfg.system1)
    agent = BatchedInternVLAN1Agent(cfg.agent, policy=BatchedN1Policy(inner, batch, seed=0))
    n = batch * cohorts
    ev = VLNPipelinedEvaluator(cfg, episodes=make_episodes(n), agent=agent)
    metrics = ev.eval()
    episodes = [r["info"] for r in ev.store.records()]
    if metrics.get("num_episodes") != n or len(episodes) != n:
        raise RuntimeError(f"the evaluator ended {metrics.get('num_episodes')} of {n} episodes")
    actions = int(metrics.get("actions_timed", 0))
    wall = float(metrics["wall_clock_s"])
    return {
        "actions_per_sec": actions / wall,
        **{k: metrics.get(k) for k in ("action_latency_p50_ms", "action_latency_p90_ms",
                                       "action_latency_p99_ms", "action_latency_mean_ms")},
        "actions_timed": actions,
        "wall_clock_s": wall,
        "episodes": n,
        "episode_steps": sorted(int(e["steps"]) for e in episodes),
        "records": episodes,
    }


def assemble(runs: List[Dict[str, Any]], *, tiny: bool = False,
             extra: Optional[Dict[str, Any]] = None,
             system1: str = "nextdit_async") -> Dict[str, Any]:
    """bench.py's one-line contract for the timed runs: the median
    actions/s, every sample, their spread and the run nearest the median;
    another System-1 head than the headline's names itself in the metric.
    Raises when the median is not positive."""
    vals = sorted(r["actions_per_sec"] for r in runs)
    med = median(vals)
    if not med > 0:
        raise RuntimeError(f"the evaluator path measured {vals} actions/s")
    med_run = min(runs, key=lambda r: abs(r["actions_per_sec"] - med))
    detail = {
        "evaluator_path": {k: v for k, v in med_run.items() if k != "records"},
        "evaluator_path_samples": vals,
        "evaluator_path_spread": {"min": vals[0], "max": vals[-1],
                                  "rel_spread": (vals[-1] - vals[0]) / med},
        **(extra or {}),
    }
    size = "tiny" if tiny else "7b"
    head = "" if system1 == "nextdit_async" else f"_{system1}"
    result = {"metric": f"internvla_n1_dual_system_actions_per_sec_per_chip_{size}"
                        f"_evaluator_median{len(runs)}{head}",
              "value": med, "unit": "actions/s", "detail": detail}
    if not tiny and system1 == "nextdit_async":  # the estimate's System-1 is NextDiT
        result["vs_baseline"] = med / REF_ACTIONS_PER_SEC
    return result


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def build_inner(device, tiny: bool = False, ckpt: Optional[str] = None,
                weight_dtype: Optional[str] = None, kv_dtype: Optional[str] = None,
                system1: str = "nextdit_async"):
    """The headline's policy (7B realtime with the `system1` head, in these
    weight and KV formats where given, random weights from seed 0 or the
    checkpoint `ckpt`), or the tiny test model, with the stop id pinned to
    STOP_ID."""
    import dataclasses

    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.realworld.serve import build_policy

    if tiny:
        cfg = InternVLAN1Config.tiny(system1)
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, weight_dtype=weight_dtype or cfg.text.weight_dtype,
            kv_dtype=kv_dtype or cfg.text.kv_dtype))
        inner = InternVLAN1Policy.build(cfg, device=device)
    else:
        inner = build_policy("realtime", device=device, ckpt=ckpt, weight_dtype=weight_dtype,
                             kv_dtype=kv_dtype, system1=system1)
    inner.tokenizer.eos_token_id = STOP_ID
    return inner


#: the tiny test model's run on the CPU (`--tiny`): 2 cohorts x 2 streams
TINY_SHAPE = {"batch": 2, "cohorts": 2, "max_step": 5, "hw": 56, "max_new_tokens": 4,
              "num_sample_trajs": 4}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test model on the CPU (the tests); no device measurement")
    ap.add_argument("--ckpt", default=None,
                    help="the 7B policy's checkpoint (reference format or native; random "
                         "weights without it)")
    ap.add_argument("--weight-dtype", default=None, choices=("int8", "int4"),
                    help="the decoder projections: int8 = W8A8 (the realtime profile's "
                         "default); int4 = W4A8 (grouped-128 scales, the lm_head at 8 bits)")
    ap.add_argument("--kv-dtype", default=None, choices=("bf16", "int8"),
                    help="the decode KV cache's storage (the realtime profile's int8 by "
                         "default)")
    ap.add_argument("--system1", default="nextdit_async",
                    choices=("nextdit_async", "navdp_async", "navdp"),
                    help="the System-1 head (nextdit_async by default)")
    args = ap.parse_args(argv)
    if args.tiny and args.ckpt:
        ap.error("--ckpt loads the 7B policy; --tiny builds the tiny test model")

    import torch

    from internnav_tpu_torch import require_cuda

    device = torch.device("cpu") if args.tiny else require_cuda()
    inner = build_inner(device, tiny=args.tiny, ckpt=args.ckpt, weight_dtype=args.weight_dtype,
                        kv_dtype=args.kv_dtype, system1=args.system1)
    shape = TINY_SHAPE if args.tiny else {}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="bench_evaluator_", dir=REPO / "build")
    try:
        warm = evaluator_run(inner, f"{tmp}/warm", **shape)
        runs, peaks = [], []
        for i in range(RUNS):
            if not args.tiny:
                torch.cuda.reset_peak_memory_stats(device)
            runs.append(evaluator_run(inner, f"{tmp}/run{i}", **shape))
            if not args.tiny:
                peaks.append(torch.cuda.max_memory_allocated(device) / 2**30)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if any(r["episode_steps"] != warm["episode_steps"] for r in runs):
        raise RuntimeError("the timed runs took other episodes than the warm run")
    config = {"profile": "realtime", "batch": BATCH, "cohorts": COHORTS, "max_step": MAX_STEP,
              "hw": IMAGE_HW, "max_new_tokens": DECODE_TOKENS,
              "num_sample_trajs": NUM_SAMPLE_TRAJS, "weights": args.ckpt or "random (seed 0)",
              "weight_dtype": inner.cfg.text.weight_dtype, "kv_dtype": inner.cfg.text.kv_dtype,
              "system1": inner.cfg.system1}
    if args.tiny:
        config.update(profile="tiny", **TINY_SHAPE)
    extra = {
        "config": {**config, "stop_id": STOP_ID, "shared_decode": True, "shared_s1": False,
                   "overlap_apply": False,
                   "python_hash_seed": os.environ.get("PYTHONHASHSEED", "random")},
        "warm_actions_per_sec": warm["actions_per_sec"],
        "peak_mem_gib": max(peaks) if peaks else "not measured",
        "device": {"platform": "cpu"} if args.tiny else {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "nvidia_smi": gpu_line()},
    }
    print(json.dumps(assemble(runs, tiny=args.tiny, extra=extra, system1=args.system1)))
    return 0


if __name__ == "__main__":
    pin_hash_seed(sys.argv)
    sys.exit(main())
