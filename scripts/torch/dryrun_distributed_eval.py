"""Two-process distributed-evaluation dryrun of the port (world size 2 on
the CPU; the port of scripts/tools/dryrun_distributed_eval.py).

Exercises what a single-process test cannot: the multi-process metric
gather in `Evaluator.gather_results` (internnav_tpu_torch/evaluator/base.py:
`all_gather_object` of JSON payloads when the process group has more than
one rank) and the rank-0-only result.json write, over a sharded FakeEnv
evaluation with the "simple" agent. Reference counterpart:
internnav/evaluator/distributed_base.py:70-149 (per-rank eval_action →
gather → calc_metrics → rank-0 result append).

    python scripts/torch/dryrun_distributed_eval.py

With no arguments it starts two worker processes (a gloo process group on
localhost), waits, and checks:
  * each rank evaluated only its shard (3 of 6 episodes in its store),
  * BOTH ranks' gathered metrics cover the full 6-episode union,
  * exactly rank 0 wrote result.json, with num_episodes == 6,
then prints ONE JSON summary line and exits 0. Any failure exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
N_EPISODES = 6
WORLD = 2


def _episodes():
    import numpy as np

    from internnav_tpu_torch.env.episodes import Episode

    eps = []
    for i in range(N_EPISODES):
        ref = np.stack([np.linspace(0, 1 + i, 4), np.zeros(4), np.zeros(4)], 1)
        eps.append(Episode(
            episode_id=str(i), trajectory_id=f"t{i}", scene_id=f"s{i % 2}",
            instruction_text=f"walk forward {i}",
            instruction_tokens=np.asarray([2, 3, 4 + i], np.int32),
            start_position=np.zeros(3),
            start_rotation=np.asarray([1.0, 0, 0, 0]),
            reference_path=ref, geodesic_distance=float(1 + i)))
    return eps


def worker(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    try:
        from internnav_tpu_torch.configs import AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg, TaskCfg
        from internnav_tpu_torch.evaluator import Evaluator

        cfg = EvalCfg(
            agent=AgentCfg(model_name="simple", model_settings={"mode": "fixed", "action": 1}),
            env=EnvCfg(env_type="fake", env_num=2,
                       env_settings={"rgb_resolution": [32, 32], "depth_resolution": [32, 32]}),
            task=TaskCfg(max_step=4),
            dataset=EvalDatasetCfg(),
            eval_type="vln_batched",
            output_dir=out_dir,
        )
        ev = Evaluator.init(cfg, episodes=_episodes())
        assert ev.world_size == WORLD, ev.world_size
        metrics = ev.eval()  # the product path: eval_action → gather → rank-0 write
        local_keys = sorted(str((rec.get("info") or {}).get("episode_id"))
                            for rec in ev.store.records())
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump({"rank": rank, "world": ev.world_size,
                       "gathered_num_episodes": metrics["num_episodes"],
                       "local_episode_ids": local_keys}, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch() -> int:
    out_dir = tempfile.mkdtemp(prefix="disteval_")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--port", str(port), "--out", out_dir],
        env=env) for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    summary = {"ok": True, "world": WORLD, "episodes": N_EPISODES,
               "out_dir": out_dir, "worker_exit_codes": codes}
    try:
        assert codes == [0, 0], codes
        ranks = []
        for r in range(WORLD):
            with open(f"{out_dir}/rank{r}.json") as f:
                ranks.append(json.load(f))
        # each rank ran only its shard...
        locals_ = [set(r["local_episode_ids"]) for r in ranks]
        assert all(0 < len(s) < N_EPISODES for s in locals_), locals_
        assert not (locals_[0] & locals_[1]), locals_
        assert locals_[0] | locals_[1] == {str(i) for i in range(N_EPISODES)}, locals_
        # ...but BOTH ranks' gathered metrics cover the union
        assert all(r["gathered_num_episodes"] == N_EPISODES for r in ranks), ranks
        # rank 0 wrote exactly one result.json line for the run
        with open(f"{out_dir}/result.json") as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        assert len(lines) == 1 and lines[0]["num_episodes"] == N_EPISODES
        summary["result_json"] = lines[0]
        summary["per_rank_local_episodes"] = [sorted(s) for s in locals_]
    except AssertionError as e:
        summary["ok"] = False
        summary["error"] = str(e)[:500]
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", type=str, default="")
    args = ap.parse_args()
    if args.rank is None:
        raise SystemExit(launch())
    sys.path.insert(0, str(REPO))
    worker(args.rank, args.port, args.out)


if __name__ == "__main__":
    main()
