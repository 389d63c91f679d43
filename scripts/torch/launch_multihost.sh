#!/usr/bin/env bash
# Multi-process, multi-node evaluation launcher of the PyTorch port.
#
# Port of scripts/eval/launch_multihost.sh (reference parity:
# scripts/eval/bash/eval_dual_system.sh, 8-rank srun, and
# eval_vln_distributed.sh). torchrun starts NPROC_PER_NODE processes on
# this node (the node's GPU count by default) and runs
# scripts/torch/eval.py --config <cfg> in each; eval.py joins the process
# group (NCCL on cuda:LOCAL_RANK, or gloo with --device cpu), the
# evaluators shard the episodes rank::world
# (internnav_tpu_torch.env.episodes.shard_episodes), Evaluator.gather_results
# merges the per-episode results and rank 0 alone appends to result.json.
#
# Usage: scripts/torch/launch_multihost.sh <eval_config.py> [eval.py args...]
# Environment (each node runs the same command):
#   NNODES (1), NODE_RANK (0), MASTER_ADDR (127.0.0.1), MASTER_PORT (29500),
#   NPROC_PER_NODE (the visible GPU count, 1 without a GPU), PYTHON (python3)
set -euo pipefail
CONFIG=${1:?usage: launch_multihost.sh <eval_config.py> [eval.py args...]}
shift || true
HERE=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
if [ -z "${NPROC_PER_NODE:-}" ]; then
  NPROC_PER_NODE=$("${PYTHON:-python3}" -c \
    "import torch; print(max(torch.cuda.device_count(), 1))")
fi
exec "${PYTHON:-python3}" -m torch.distributed.run \
  --nnodes "${NNODES:-1}" --node-rank "${NODE_RANK:-0}" \
  --nproc-per-node "$NPROC_PER_NODE" \
  --master-addr "${MASTER_ADDR:-127.0.0.1}" --master-port "${MASTER_PORT:-29500}" \
  "$HERE/eval.py" --config "$CONFIG" "$@"
