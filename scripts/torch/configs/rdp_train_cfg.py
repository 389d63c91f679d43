"""RDP training config (reference rdp.py) — the port's copy of
scripts/train/configs/rdp_cfg.py, for scripts/torch/train.py --config."""

from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model import get_config

exp_cfg = ExpCfg(
    name="rdp_train",
    model_name="rdp",
    output_dir="checkpoints/rdp_train/ckpts",
    tensorboard_dir="checkpoints/rdp_train/tensorboard",
    log_dir="checkpoints/rdp_train/logs",
    seed=0,
    il=IlCfg(
        epochs=100,
        batch_size=8,
        lr=1e-4,
        weight_decay=1e-5,
        warmup_ratio=0.05,
        use_ema=True,
        lerobot_features_dir="data/vln_pe/traj_data/r2r",
        filter_failure={"use": True, "min_rgb_nums": 15},
        report_to="tensorboard",
    ),
    model=get_config("rdp"),
)
