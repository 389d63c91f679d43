"""CMA training config (reference scripts/train/base_train/configs/cma.py) — the port's copy of
scripts/train/configs/cma_cfg.py, for scripts/torch/train.py --config."""

from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model import get_config

exp_cfg = ExpCfg(
    name="cma_train",
    model_name="cma",
    output_dir="checkpoints/cma_train/ckpts",
    tensorboard_dir="checkpoints/cma_train/tensorboard",
    log_dir="checkpoints/cma_train/logs",
    seed=0,
    il=IlCfg(
        epochs=80,
        batch_size=2,
        lr=1e-4,
        weight_decay=1e-5,
        warmup_ratio=0.05,
        use_iw=True,
        inflection_weight_coef=3.2,
        load_from_ckpt=False,
        ckpt_to_load=None,
        lerobot_features_dir="data/vln_pe/traj_data/r2r",
        filter_failure={"use": True, "min_rgb_nums": 15},
        report_to="tensorboard",
    ),
    model=get_config("cma"),
)
