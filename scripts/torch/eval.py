"""Evaluation entry point of the port (scripts/eval/eval.py; reference
scripts/eval/eval.py:33-49).

    python scripts/torch/eval.py --config scripts/torch/configs/fake_n1_pipelined_cfg.py \
        [--device cpu]
    torchrun --nproc-per-node N scripts/torch/eval.py --config <cfg> [--device cpu]
    scripts/torch/launch_multihost.sh <cfg> [--device cpu]    # torchrun over nodes

The config file is executable python exposing `eval_cfg`, an `EvalCfg` of
`internnav_tpu_torch.configs` (the files in scripts/eval/configs/ import
the JAX package; the port's own are in scripts/torch/configs/). Prints the
metrics as one JSON line; rank 0 also appends them to
`<output_dir>/result.json`.

Under torchrun (its WORLD_SIZE, RANK and LOCAL_RANK in the environment)
each process joins the process group torchrun's rendezvous sets up
(MASTER_ADDR, MASTER_PORT): NCCL with the agent on cuda:LOCAL_RANK, or
gloo with `--device cpu`. The evaluators then shard the episodes
rank::world (`env.episodes.shard_episodes`), `Evaluator.gather_results`
merges every rank's per-episode results and rank 0 alone appends to
result.json; every rank prints the merged metrics. One process without
torchrun starts no process group.

`--device` is where the agent runs: it goes into the agent's
model_settings["device"]. The default is the GPU, and without one the run
raises (no fallback to the host); `--device cpu` runs on the host when
asked for (the tests). With `use_agent_server` the agent runs in the
agent server (`scripts/torch/start_server.py`), which builds it on that
device. eval_type "vln_pe" (the VLN-PE physics protocol,
`evaluator.VLNPEEvaluator`) is first assembled by
`configs.vln_default.get_config`, as the JAX entry point does; its
config `scripts/torch/configs/h1_internvla_n1_async_cfg.py` names the
Isaac backend ("internutopia", which raises without InternUtopia): set
env_settings["backend"] to "fake_physics" for the simulator-free one,
whose H1 loco actors (use_loco) run on env_settings["device"], the GPU
by default. The Habitat
configs (`scripts/torch/configs/habitat_{dual_system,s2,dialog,object}_cfg.py`,
eval_type "habitat_vln" / "habitat_dialog") need habitat for their
simulator: without it they raise the JAX package's ImportError; the
evaluators run over an injected sim from Python (`Evaluator.init(cfg,
sim=..., episodes=...)`, README.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from internnav_tpu_torch import require_cuda  # noqa: E402
from internnav_tpu_torch.configs import load_py_config  # noqa: E402
from internnav_tpu_torch.evaluator import Evaluator  # noqa: E402


def start_process_group(device: str):
    """Join torchrun's process group where its variables are set (and no
    group is up): NCCL on cuda:LOCAL_RANK, or gloo for `device` cpu.
    Returns (the agent's device, cuda:LOCAL_RANK under NCCL; whether a group
    was started here)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device, False
    if device == "cpu":
        dist.init_process_group("gloo")
        return device, True
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    require_cuda(local)
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=local)
    return str(local), True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="python config file exposing eval_cfg")
    ap.add_argument("--device", default="cuda",
                    help="where the agent runs: a CUDA device (no CPU fallback), or cpu when "
                         "asked for")
    args = ap.parse_args(argv)
    cfg = load_py_config(args.config)
    if args.device != "cpu" and not cfg.use_agent_server:
        require_cuda(torch.device(args.device))
    device, started = start_process_group(args.device)
    try:
        cfg.agent.model_settings = {**cfg.agent.model_settings, "device": device}
        if cfg.eval_type == "vln_pe":
            # the VLN-PE defaults assembly (reference eval.py:33-49 applies
            # vln_default_config.get_config)
            from internnav_tpu_torch.configs.vln_default import get_config

            cfg = get_config(cfg)
        metrics = Evaluator.init(cfg).eval()
    finally:
        if started:
            dist.destroy_process_group()
    print(json.dumps(metrics, default=float), flush=True)
    return metrics


if __name__ == "__main__":
    main()
