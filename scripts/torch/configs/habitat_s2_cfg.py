"""VLN-CE System-2 + shortest-path-follower eval config (reference
habitat_s2_cfg.py).

The port's copy of scripts/eval/configs/habitat_s2_cfg.py, on the port's
config classes (loaded by scripts/torch/eval.py; the .yaml data files it
names are the JAX package's).
"""

from internnav_tpu_torch.configs import AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg, TaskCfg

eval_cfg = EvalCfg(
    agent=AgentCfg(model_name="internvla_n1", ckpt_path="checkpoints/InternVLA-N1-S2"),
    env=EnvCfg(env_type="habitat",
               env_settings={"habitat_config": "scripts/eval/configs/vln_r2r.yaml"}),
    task=TaskCfg(max_step=195),
    dataset=EvalDatasetCfg(base_data_dir="data/vln_ce/raw_data/r2r",
                           split_data_types=["val_unseen"]),
    eval_type="habitat_vln",
    eval_settings={"mode": "system2"},
    output_dir="logs/eval/habitat_s2",
)
