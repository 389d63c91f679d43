"""Habitat ObjectNav (HM3D) eval config — the VL-LN Bench objectnav task
(reference scripts/eval/configs/habitat_object_cfg.py: dialog agent in
system2 mode with dialog disabled, habitat_dialog evaluator, 500-step
episodes).

The port's copy of scripts/eval/configs/habitat_object_cfg.py, on the port's
config classes (loaded by scripts/torch/eval.py; the .yaml data files it
names are the JAX package's).
"""

from internnav_tpu_torch.configs import AgentCfg, EnvCfg, EvalCfg, TaskCfg

eval_cfg = EvalCfg(
    agent=AgentCfg(
        server_port=8087,
        model_name="dialog",
        ckpt_path="",
        model_settings={
            "mode": "system2",        # dual_system | system2
            "dialog_enabled": False,  # objectnav runs the NPC-free path
            "append_look_down": True,
            "num_history": 8,
            "resize_w": 384,
            "resize_h": 384,
            "max_new_tokens": 128,
        },
    ),
    env=EnvCfg(
        env_type="habitat",
        env_settings={
            "habitat_config": "scripts/eval/configs/objectnav_hm3d.yaml",
        },
    ),
    task=TaskCfg(task_name="objectnav", max_step=500),
    eval_type="habitat_dialog",
    eval_settings={
        "eval_split": "val",
        "turn": 5,
        "save_video": False,
        "scene_summary": "data/vl_ln_bench/raw_data/mp3d/scene_summary",
    },
    output_dir="logs/habitat/object",
)
