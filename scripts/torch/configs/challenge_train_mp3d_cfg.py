"""IROS-challenge RDP finetune on MP3D (reference
challenge_train_mp3d_cfg.py).

The port's copy of scripts/train/configs/challenge_train_mp3d_cfg.py, for
`python scripts/torch/train.py --config scripts/torch/configs/challenge_train_mp3d_cfg.py
--store <store>`: the warm start loads il.ckpt_to_load (a native
directory or a reference-format checkpoint), which the repository
does not hold; `--ckpt-to-load` stands in for it.
"""

from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model import get_config

exp_cfg = ExpCfg(
    name="challenge_rdp_mp3d",
    model_name="rdp",
    output_dir="checkpoints/challenge_rdp_mp3d/ckpts",
    tensorboard_dir="checkpoints/challenge_rdp_mp3d/tensorboard",
    log_dir="checkpoints/challenge_rdp_mp3d/logs",
    seed=0,
    il=IlCfg(
        epochs=50,
        batch_size=8,
        lr=5e-5,
        use_ema=True,
        load_from_ckpt=True,
        ckpt_to_load="checkpoints/r2r/fine_tuned/rdp",
        lerobot_features_dir="data/vln_pe/traj_data/mp3d",
        filter_failure={"use": True, "min_rgb_nums": 15},
        report_to="tensorboard",
    ),
    model=get_config("rdp"),
)
