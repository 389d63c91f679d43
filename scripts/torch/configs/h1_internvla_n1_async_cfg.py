"""VLN-PE flagship config: InternVLA-N1 dual-system async agent on the
Isaac/InternUtopia physics protocol (reference
scripts/eval/configs/h1_internvla_n1_async_cfg.py).

Set env.env_settings['backend'] = 'fake_physics' to run the identical
protocol without a simulator (kinematic physics, procedural frames).

The port's copy of scripts/eval/configs/h1_internvla_n1_async_cfg.py, on
the port's config classes (loaded by scripts/torch/eval.py). Its 640x480
camera is no whole number of 28-pixel merges in height, which the
InternVLA-N1 policy's image preprocessing refuses in both packages: run
it with a camera whose sides are multiples of 28 (ROADMAP F21).
"""

from internnav_tpu_torch.configs import (
    AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg, MetricCfg, SceneCfg, TaskCfg,
)

eval_cfg = EvalCfg(
    agent=AgentCfg(
        server_port=8023,
        model_name="internvla_n1",
        ckpt_path="checkpoints/InternVLA-N1-DualVLN",
        model_settings={
            "camera_intrinsic": [[585.0, 0.0, 320.0],
                                 [0.0, 585.0, 240.0],
                                 [0.0, 0.0, 1.0]],
            "width": 640, "height": 480, "hfov": 79,
            "resize_w": 384, "resize_h": 384,
            "max_new_tokens": 128,
            "num_history": 8,
            "num_future_steps": 4,
            "predict_step_nums": 32,
            "continuous_traj": True,
            # sync | partial_async — partial_async is better for this model
            "infer_mode": "partial_async",
            "async_s2": True,
            "sys2_max_forward_step": 8,
        },
    ),
    env=EnvCfg(
        env_type="internutopia",
        env_settings={
            "backend": "internutopia",  # 'fake_physics' for simulator-free
            "sim_settings": {"use_fabric": False, "headless": True},
        },
        env_num=1,
    ),
    task=TaskCfg(
        task_name="test_n1",
        scene=SceneCfg(scene_type="mp3d", scene_data_dir="data/scene_data/mp3d_pe"),
        robot_name="h1",
        robot_flash=True,  # flash (teleport) mode; False = physical mode
        max_step=1000,     # flash default 1000; physical mode uses 50000
        warm_up_step=10,
        camera_resolution=[640, 480],
        metric_config=MetricCfg(success_distance=3.0),
    ),
    dataset=EvalDatasetCfg(
        dataset_type="mp3d",
        base_data_dir="data/vln_pe/raw_data/r2r",
        split_data_types=["val_unseen"],
        filter_stairs=True,
    ),
    eval_type="vln_pe",
    eval_settings={"save_to_json": True, "vis_output": False},
    use_agent_server=False,
    output_dir="logs/eval/h1_internvla_n1_async",
)
