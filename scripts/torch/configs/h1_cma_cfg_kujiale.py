"""VLN-PE CMA eval on the Kujiale (InteriorNav) scene set (reference
scripts/eval/configs/h1_cma_cfg_kujiale.py: kujiale scenes, no stair
filtering, 2 envs x 4 sim procs).

The port's copy of scripts/eval/configs/h1_cma_cfg_kujiale.py, for
`python scripts/torch/eval.py --config <cfg>` where <cfg> loads this
file and sets env_settings["backend"] to "fake_physics" (the Isaac
backend "internutopia" raises without InternUtopia), agent.ckpt_path
and the episodes, as for h1_internvla_n1_async_cfg.py (README.md). As in
the JAX package, the run stops where the "cma" agent is built: the
VLN-PE defaults (`configs.vln_default.get_config`) put the model's
config into model_settings as plain dicts, which the recurrent agent
sets on its config (ROADMAP §3, F28).
"""

from internnav_tpu_torch.configs import (
    AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg, MetricCfg, SceneCfg, TaskCfg,
)

eval_cfg = EvalCfg(
    agent=AgentCfg(model_name="cma",
                   ckpt_path="checkpoints/r2r/fine_tuned/cma"),
    env=EnvCfg(
        env_type="internutopia",
        env_settings={"backend": "internutopia",
                      "sim_settings": {"use_fabric": False, "headless": True}},
        env_num=2,
        proc_num=4,
    ),
    task=TaskCfg(
        task_name="cma_kujiale_eval",
        scene=SceneCfg(scene_type="kujiale",
                       scene_data_dir="interiornav_data/scene_data"),
        robot_name="h1",
        robot_flash=True,
        max_step=195,
        camera_resolution=[256, 256],
        metric_config=MetricCfg(success_distance=3.0),
    ),
    dataset=EvalDatasetCfg(
        dataset_type="kujiale",
        base_data_dir="interiornav_data/raw_data",
        split_data_types=["val_unseen"],
        filter_stairs=False,
    ),
    eval_type="vln_pe",
    output_dir="logs/eval/h1_cma_kujiale",
)
