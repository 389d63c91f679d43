"""CMA on the offline fake env, the minimum end-to-end eval config (the
port's copy of scripts/eval/configs/fake_cma_cfg.py; BASELINE.json
configs[0]). Episodes come from data/fake_r2r (scripts/tools/
make_fake_dataset.py). Random weights unless agent.ckpt_path names a
native directory or a reference-format CMA checkpoint.

    python scripts/torch/eval.py --config scripts/torch/configs/fake_cma_cfg.py [--device cpu]
"""

from internnav_tpu_torch.configs import (
    AgentCfg,
    EnvCfg,
    EvalCfg,
    EvalDatasetCfg,
    MetricCfg,
    TaskCfg,
)

eval_cfg = EvalCfg(
    agent=AgentCfg(model_name="cma", ckpt_path=""),
    env=EnvCfg(env_type="fake", env_num=2),
    task=TaskCfg(max_step=20, metric_config=MetricCfg(success_distance=3.0)),
    dataset=EvalDatasetCfg(
        base_data_dir="data/fake_r2r",
        split_data_types=["val_unseen"],
        max_episodes=4,
    ),
    eval_type="vln_batched",
    output_dir="logs/eval/fake_cma",
)
