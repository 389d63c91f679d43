"""Seq2Seq-plus finetune config (reference seq2seq_plus.py): warm-start
from the zero-shot Seq2Seq checkpoint.

The port's copy of scripts/train/configs/seq2seq_plus_cfg.py, for
`python scripts/torch/train.py --config scripts/torch/configs/seq2seq_plus_cfg.py
--store <store>`: the warm start loads il.ckpt_to_load (a native
directory or a reference-format checkpoint), which the repository
does not hold; `--ckpt-to-load` stands in for it.
"""

from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model import get_config

exp_cfg = ExpCfg(
    name="seq2seq_plus_train",
    model_name="seq2seq",
    output_dir="checkpoints/seq2seq_plus_train/ckpts",
    tensorboard_dir="checkpoints/seq2seq_plus_train/tensorboard",
    log_dir="checkpoints/seq2seq_plus_train/logs",
    seed=0,
    il=IlCfg(
        epochs=55,
        batch_size=2,
        lr=1e-4,
        weight_decay=1e-5,
        warmup_ratio=0.05,
        use_iw=True,
        inflection_weight_coef=3.2,
        load_from_ckpt=True,
        ckpt_to_load="checkpoints/r2r/zero_shot/seq2seq",
        lerobot_features_dir="data/vln_pe/traj_data/r2r",
        filter_failure={"use": True, "min_rgb_nums": 15},
        report_to="tensorboard",
    ),
    model=get_config("seq2seq"),
)
