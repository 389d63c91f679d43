"""VL-LN dialog (IIGN) eval config (reference habitat_dialog_cfg.py).

The port's copy of scripts/eval/configs/habitat_dialog_cfg.py, on the port's
config classes (loaded by scripts/torch/eval.py; the .yaml data files it
names are the JAX package's).
"""

from internnav_tpu_torch.configs import AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg, TaskCfg

eval_cfg = EvalCfg(
    agent=AgentCfg(model_name="dialog",
                   model_settings={"max_questions": 3}),
    env=EnvCfg(env_type="habitat",
               env_settings={
                   "habitat_config": "scripts/eval/configs/instance_dialog.yaml"
               }),
    task=TaskCfg(max_step=195),
    dataset=EvalDatasetCfg(base_data_dir="data/vl_ln", split_data_types=["val_unseen"]),
    eval_type="habitat_vln",
    eval_settings={"mode": "dual_system"},
    output_dir="logs/eval/habitat_dialog",
)
