"""VLN-PE rdp eval config (the port's copy of
scripts/eval/configs/h1_rdp_cfg.py; reference
scripts/eval/configs/h1_rdp_cfg.py).

Points at the kinematic flash-controller env (FakeEnv, vln_batched) and
the reference's checkpoint path, which the repository does not hold: set
agent.ckpt_path to a reference-format RDP checkpoint or a native
directory of the port, and dataset.base_data_dir to the episodes.

    python scripts/torch/eval.py --config <a config loading this one> [--device cpu]
"""

from internnav_tpu_torch.configs import (
    AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg, MetricCfg, TaskCfg,
)

eval_cfg = EvalCfg(
    agent=AgentCfg(model_name="rdp", ckpt_path="checkpoints/rdp"),
    env=EnvCfg(env_type="fake", env_num=4),
    task=TaskCfg(max_step=195, robot_flash=True,
                 metric_config=MetricCfg(success_distance=3.0)),
    dataset=EvalDatasetCfg(base_data_dir="data/vln_pe/raw_data/r2r",
                           split_data_types=["val_unseen"], filter_stairs=True),
    eval_type="vln_batched",
    output_dir="logs/eval/h1_rdp",
)
