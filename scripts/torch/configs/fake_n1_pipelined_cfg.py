"""InternVLA-N1 pipelined multi-cohort evaluation on the offline fake env
(the port's copy of scripts/eval/configs/fake_n1_pipelined_cfg.py, on the
port's classes; loaded by scripts/torch/eval.py).

Tiny random-init config (bf16, as the JAX package's tiny) so that it runs
anywhere; for a real checkpoint set agent.ckpt_path to a reference-format
checkpoint or a native directory and drop model_settings["config"] (the
agent then loads at the 7B dims,
internnav_tpu_torch/agent/internvla_n1_agent.py:_build_n1_policy).
"""

import torch

from internnav_tpu_torch.configs import (
    AgentCfg,
    EnvCfg,
    EvalCfg,
    EvalDatasetCfg,
    MetricCfg,
    TaskCfg,
)
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config

eval_cfg = EvalCfg(
    agent=AgentCfg(
        model_name="internvla_n1_batched",
        model_settings={
            "batch_size": 2,
            "max_new_tokens": 8,
            "num_sample_trajs": 4,
            "config": InternVLAN1Config.tiny("nextdit_async", dtype=torch.bfloat16),
        },
    ),
    env=EnvCfg(env_type="fake", env_num=2,
               env_settings={"rgb_resolution": [56, 56],
                             "depth_resolution": [56, 56],
                             "cohorts": 2}),
    task=TaskCfg(max_step=12, metric_config=MetricCfg(success_distance=3.0)),
    dataset=EvalDatasetCfg(
        base_data_dir="data/fake_r2r",
        split_data_types=["val_unseen"],
        max_episodes=4,
    ),
    eval_type="vln_pipelined",
    output_dir="logs/eval/fake_n1_pipelined",
)
