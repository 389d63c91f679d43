"""InternVLA-N1 dual-system finetune entry point of the port.

    python -m internnav_tpu_torch.trainer.train_n1 --store data/sft_store.bin \
        --steps 1000 --max-len 8192 --remat --ce-chunk 1024 --opt-state-dtype bf16

Port of scripts/train/train_n1.py with the same flags plus `--device`: a
config file or `--name` gives the ExpCfg, the policy is built
at `--tiny` or full Qwen2.5-VL-7B dims, from `--ckpt` (a reference-format
checkpoint, or a bf16 native directory of the port) or with random
weights (seed 0), and packed SFT rows from the trajectory store feed
`InternVLAN1Trainer`. `--device` defaults to `cuda` and refuses without a
GPU; `--device cpu` runs the tiny config on the CPU (the plain attention
path):

    python -m internnav_tpu_torch.trainer.train_n1 --tiny --device cpu \
        --store /tmp/n1_store.bin --steps 2 --batch-size 2 --max-len 256

Sharded training runs one process a GPU under torchrun (NCCL on CUDA,
gloo on the CPU; each rank on cuda:LOCAL_RANK), with the JAX launcher's
meshes: `--fsdp` is {"dp": -1} with FSDP, `--tp N` {"dp": -1, "tp": N}
with the decoder tensor-parallel and FSDP for the rest; `--grad-accum`
micro-batches a step. A batch is one packed row, as in the JAX launcher,
so every rank and micro-batch computes it whole (rows that do not divide
accum x dp are not split):

    torchrun --nproc-per-node 8 -m internnav_tpu_torch.trainer.train_n1 \
        --store data/sft_store.bin --tp 2 --grad-accum 2 --remat --ce-chunk 1024

Without torchrun (no process group) the trainer runs on its one device.
An int8 native directory is refused: training needs bf16 weights.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", default="n1_finetune")
    ap.add_argument("--config", default=None,
                    help="python file exposing exp_cfg (ExpCfg); CLI flags override its "
                         "il/mesh fields")
    ap.add_argument("--store", required=True, help="trajectory store file")
    ap.add_argument("--ckpt", default=None,
                    help="reference-format checkpoint or bf16 native directory to start from")
    ap.add_argument("--tiny", action="store_true", help="tiny dims smoke config")
    ap.add_argument("--system1", default="nextdit", choices=["nextdit", "nextdit_async"])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="samples per packed batch (pre-packing)")
    ap.add_argument("--max-len", type=int, default=2048, help="packed sequence length")
    ap.add_argument("--grad-accum", type=int, default=None,
                    help="gradient accumulation microbatches")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--tune-llm", action="store_true", default=True)
    ap.add_argument("--no-tune-llm", dest="tune_llm", action="store_false")
    ap.add_argument("--tune-mm-vision", action="store_true", default=False)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    ap.add_argument("--fsdp", action="store_true", help="FSDP sharding over every rank")
    ap.add_argument("--remat", action="store_true", default=False,
                    help="recompute decoder layers in backward")
    ap.add_argument("--opt-state-dtype", default=None, choices=["bf16", "fp32"],
                    help="Adam m/v storage dtype")
    ap.add_argument("--ce-chunk", type=int, default=0,
                    help="chunked full-vocab CE per N tokens (0 = full logits)")
    ap.add_argument("--num-history", type=int, default=None)
    ap.add_argument("--image-hw", type=int, default=None,
                    help="square frame size fed to the vision tower "
                         "(default: 28 at --tiny, 224 at full dims)")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--no-resume", dest="resume", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device; a CUDA device unless `cpu` is asked for")
    return ap


def build_policy(cfg_model, device, ckpt: Optional[str] = None):
    """The policy to train, in bf16 (or the tiny config's dtype): from
    `ckpt` (`from_pretrained_torch`, or `from_pretrained` for a native
    directory, which must record bf16 weights), else random (seed 0)."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
        InternVLAN1Policy,
        checkpoint_format,
        native_weight_dtype,
    )

    if not ckpt:
        return InternVLAN1Policy.build(cfg_model, device=device)
    if checkpoint_format(ckpt) == "native":
        wdt = native_weight_dtype(ckpt)
        if wdt != "bf16":
            raise ValueError(f"--ckpt {ckpt} records {wdt} weights: training needs bf16 "
                             "weights (pass the reference-format checkpoint)")
        return InternVLAN1Policy.from_pretrained(ckpt, cfg_model, device=device)
    return InternVLAN1Policy.from_pretrained_torch(ckpt, cfg_model, device=device)


def make_batch_iter(store_path: str, policy, cfg_model, batch_size: int, max_len: int,
                    num_history: int, image_hw: int):
    """Infinite iterator of packed SFT batches over the store (every rank
    reads the same batches)."""
    from internnav_tpu_torch.dataset.internvla_n1_dataset import (
        N1SampleDataset,
        n1_packed_collate_fn,
        tokenize_sample,
    )

    tpi = policy._tokens_per_image((image_hw, image_hw))
    ds = N1SampleDataset(store_path, predict_step_nums=cfg_model.predict_step_nums,
                         num_history=num_history)

    def collate(rows):
        return n1_packed_collate_fn(rows, max_len=max_len,
                                    predict_step_nums=cfg_model.predict_step_nums)

    while True:
        rows = []
        for s in ds:
            rows.append(tokenize_sample(s, policy.tokenizer, tokens_per_image=tpi,
                                        n_query=cfg_model.n_query))
            if len(rows) == batch_size:
                yield collate(rows)
                rows = []
        if rows:
            yield collate(rows)


def init_distributed(device: str) -> bool:
    """Start the process group of a torchrun launch (its RANK / WORLD_SIZE /
    MASTER_ADDR environment): NCCL for a CUDA device, gloo for the CPU.
    Returns whether it started one (False outside torchrun, or when one
    exists)."""
    import os

    import torch.distributed as dist

    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    dist.init_process_group("gloo" if device == "cpu" else "nccl")
    return True


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_argparser().parse_args(argv)

    import os

    import torch

    from internnav_tpu_torch import require_cuda

    device = torch.device(args.device)
    if device.type != "cpu":
        if "LOCAL_RANK" in os.environ and device.index is None:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        device = require_cuda(device)
        if device.index is not None:
            torch.cuda.set_device(device)
    started = init_distributed(device.type)
    try:
        return _train(args, device)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, device) -> dict:
    from internnav_tpu_torch.configs.trainer import ExpCfg, MeshCfg
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.parallel import is_main_process
    from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer

    if args.config:
        import runpy

        exp = runpy.run_path(args.config)["exp_cfg"]
        if not isinstance(exp, ExpCfg):
            exp = ExpCfg.model_validate(exp.model_dump() if hasattr(exp, "model_dump") else exp)
    else:
        exp = ExpCfg(name=args.name, model_name="internvla_n1")
    if args.output_dir:
        exp.output_dir = args.output_dir
    if args.lr is not None:
        exp.il.lr = args.lr
    if args.grad_accum is not None:
        exp.il.grad_accum_steps = args.grad_accum
    exp.il.batch_size = args.batch_size
    if args.remat:
        exp.il.remat = True
    if args.ce_chunk:
        exp.il.ce_chunk = args.ce_chunk
    if args.opt_state_dtype:
        exp.il.opt_state_dtype = args.opt_state_dtype
    if args.tp > 1:
        exp.mesh = MeshCfg(axes={"dp": -1, "tp": args.tp}, param_sharding="tp", fsdp_rest=True)
    elif args.fsdp:
        exp.mesh = MeshCfg(axes={"dp": -1}, param_sharding="fsdp")

    image_hw = args.image_hw or (28 if args.tiny else 224)
    if args.tiny:
        # the tiny DinoViT follows the frame size, as the JAX tiny config's
        # init does (its s1_image_hw is unset)
        cfg_model = dataclasses.replace(InternVLAN1Config.tiny(args.system1),
                                        s1_image_hw=image_hw)
    else:
        cfg_model = InternVLAN1Config.qwen25vl_7b(args.system1)
    if args.num_history is not None:
        cfg_model = dataclasses.replace(cfg_model, num_history=args.num_history)
    policy = build_policy(cfg_model, device, args.ckpt)
    trainer = InternVLAN1Trainer(exp, policy, total_steps=args.steps,
                                 tune_llm=args.tune_llm, tune_mm_vision=args.tune_mm_vision)
    raw = make_batch_iter(args.store, policy, cfg_model, args.batch_size, args.max_len,
                          cfg_model.num_history, image_hw)
    trainer.dataset = (trainer.prepare_batch(b) for b in raw)
    if args.resume:
        trainer.maybe_restore()
    metrics = trainer.train(resume=False)
    if is_main_process():
        print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
