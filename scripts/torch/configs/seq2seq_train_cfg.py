"""Seq2Seq training config (reference seq2seq.py) — the port's copy of
scripts/train/configs/seq2seq_cfg.py, for scripts/torch/train.py --config."""

from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model import get_config

exp_cfg = ExpCfg(
    name="seq2seq_train",
    model_name="seq2seq",
    output_dir="checkpoints/seq2seq_train/ckpts",
    tensorboard_dir="checkpoints/seq2seq_train/tensorboard",
    log_dir="checkpoints/seq2seq_train/logs",
    seed=0,
    il=IlCfg(
        epochs=80,
        batch_size=2,
        lr=1e-4,
        weight_decay=1e-5,
        warmup_ratio=0.05,
        use_iw=True,
        inflection_weight_coef=3.2,
        lerobot_features_dir="data/vln_pe/traj_data/r2r",
        filter_failure={"use": True, "min_rgb_nums": 15},
        report_to="tensorboard",
    ),
    model=get_config("seq2seq"),
)
