"""Training entry point of the port for the small VLN policies: CMA,
Seq2Seq, RDP and NavDP (scripts/train/train.py; reference
scripts/train/base_train/train.py:75-325).

    python scripts/torch/train.py --model-name cma --store data/trajectories.bin \
        --steps 1000 --batch-size 2 [--config scripts/torch/configs/cma_train_cfg.py] \
        [--ckpt-to-load <native dir or reference .pth>] [--device cpu]

A store for cma / seq2seq comes from a reference LMDB through
`scripts/torch/lmdb_to_store.py`; RDP reads stores with positions and yaws
(`dataset.rdp_dataset.write_synthetic_rdp_dataset` writes one), and so
does NavDP, with RGB-D frames (`dataset.navdp_dataset.
write_synthetic_navdp_dataset`). A config file is python exposing
`exp_cfg`, an `ExpCfg` of `internnav_tpu_torch.configs.trainer` (the
port's copies of the JAX configs are
scripts/torch/configs/{cma,seq2seq,rdp,navdp}_train_cfg.py);
without one the model's default config is used. `--ckpt-to-load` (or
`il.ckpt_to_load`) warm-starts from a native directory or a
reference-format checkpoint (`from_pretrained`). The trainer
(`trainer/{cma,rdp,navdp}_trainer.py`) checkpoints under
`<output_dir>/<checkpoint_folder>` and resumes from the newest step; the
trained policy is written with `save_pretrained` to
`<output_dir>/<name>_final`.

Training runs on the GPU unless `--device cpu` asks for the host (no
fallback), in fp32 with TF32 off, at the reference's frames: the cma /
seq2seq loader resizes to RGB 224 and depth 256, and an RDP store must
hold frames of those sizes; a NavDP store holds frames of the model's
`image_size`, and its samples take the model's memory_size and
predict_size (JAX's loader keeps its defaults, 8 and 24).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def build_policy(cfg, device):
    """The policy of `cfg.model_name`: from `cfg.il.ckpt_to_load` when set
    (a native directory or a reference-format checkpoint), else built at
    random from `cfg.seed`."""
    from internnav_tpu_torch.model import get_policy

    policy_cls = get_policy(cfg.model_name)
    if cfg.il.ckpt_to_load:
        kw = {"seed": cfg.seed} if cfg.model_name == "rdp" else {}
        return policy_cls.from_pretrained(cfg.il.ckpt_to_load, cfg.model, device=device, **kw)
    return policy_cls.build(cfg.model, device=device, seed=cfg.seed)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", default="exp")
    ap.add_argument("--model-name", default="cma", choices=["cma", "seq2seq", "rdp", "navdp"])
    ap.add_argument("--config", default=None, help="python file exposing exp_cfg")
    ap.add_argument("--store", required=False, help="trajectory store path")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--output-dir", default=None, help="overrides the config's output_dir")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="start at step 0 even when a checkpoint is saved")
    ap.add_argument("--ckpt-to-load", default=None,
                    help="warm-start checkpoint (native save_pretrained dir or "
                         "reference-format torch .pth/.safetensors; overrides "
                         "cfg.il.ckpt_to_load)")
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (no CPU fallback), or cpu when asked for")
    args = ap.parse_args(argv)

    import torch

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.configs import load_py_config
    from internnav_tpu_torch.configs.trainer import ExpCfg
    from internnav_tpu_torch.dataset.base import Prefetcher, repeat_forever
    from internnav_tpu_torch.model import get_config

    device = torch.device("cpu") if args.device == "cpu" else require_cuda(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.config:
        cfg: ExpCfg = load_py_config(args.config, attr="exp_cfg")
    else:
        cfg = ExpCfg(name=args.name, model_name=args.model_name,
                     model=get_config(args.model_name))
    if args.lr:
        cfg.il.lr = args.lr
    if args.output_dir:
        cfg.output_dir = args.output_dir
    cfg.il.batch_size = args.batch_size
    if args.ckpt_to_load:
        cfg.il.ckpt_to_load = args.ckpt_to_load
    policy = build_policy(cfg, device)

    if cfg.model_name in ("cma", "seq2seq"):
        from internnav_tpu_torch.dataset.vln_dataset import make_vln_dataloader
        from internnav_tpu_torch.trainer.cma_trainer import CMATrainer, Seq2SeqTrainer

        make_epoch = make_vln_dataloader(args.store, cfg.il.batch_size)
        trainer_cls = CMATrainer if cfg.model_name == "cma" else Seq2SeqTrainer
    elif cfg.model_name == "rdp":
        from internnav_tpu_torch.dataset.rdp_dataset import make_rdp_dataloader
        from internnav_tpu_torch.trainer.rdp_trainer import RDPTrainer

        make_epoch = make_rdp_dataloader(args.store, cfg.il.batch_size)
        trainer_cls = RDPTrainer
    else:
        from internnav_tpu_torch.dataset.navdp_dataset import make_navdp_dataloader
        from internnav_tpu_torch.trainer.navdp_trainer import NavDPTrainer

        make_epoch = make_navdp_dataloader(
            args.store, cfg.il.batch_size, memory_size=getattr(cfg.model, "memory_size", 8),
            predict_size=getattr(cfg.model, "predict_size", 24))
        trainer_cls = NavDPTrainer

    data = Prefetcher(repeat_forever(make_epoch))
    trainer = trainer_cls(cfg, policy, dataset=data, total_steps=args.steps)
    metrics = trainer.train(resume=args.resume)
    print("final:", metrics)
    policy.save_pretrained(f"{cfg.output_dir}/{cfg.name}_final")
    return metrics


if __name__ == "__main__":
    main()
