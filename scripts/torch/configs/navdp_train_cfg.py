"""NavDP training config (reference navdp.py) — the port's copy of
scripts/train/configs/navdp_cfg.py, for scripts/torch/train.py --config."""

from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model import get_config

exp_cfg = ExpCfg(
    name="navdp_train",
    model_name="navdp",
    output_dir="checkpoints/navdp_train/ckpts",
    tensorboard_dir="checkpoints/navdp_train/tensorboard",
    log_dir="checkpoints/navdp_train/logs",
    seed=0,
    il=IlCfg(
        epochs=100,
        batch_size=16,
        lr=1e-4,
        use_ema=True,
        dataset_root_dir="data/navdp",
        report_to="tensorboard",
    ),
    model=get_config("navdp"),
)
