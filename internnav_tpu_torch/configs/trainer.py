"""Trainer / experiment config schemas.

Copy of internnav_tpu/configs/trainer.py (ExpCfg, IlCfg, MeshCfg,
TrainEvalCfg) with the same field names and defaults, so an experiment
config written for the JAX trainer validates here. `ExpCfg.model` is the
port's `ModelCfg`, as in JAX (the recurrent and RDP trainers read it; the
N1 trainer reads none of it).

`MeshCfg` lays the trainer out over the ranks of a process group
(`trainer/base.py`: "replicated", "fsdp", or "tp" with `fsdp_rest`); with
no process group the trainer runs on its one device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import BaseModel, ConfigDict

from internnav_tpu_torch.configs.model import ModelCfg


class _Cfg(BaseModel):
    model_config = ConfigDict(extra="allow")


class MeshCfg(_Cfg):
    """Device-mesh layout: axis name → size; -1 means 'all remaining'
    ranks."""

    axes: Dict[str, int] = {"dp": -1}
    # partitioning strategy for params: 'replicated' | 'fsdp' | 'tp'
    param_sharding: str = "replicated"
    fsdp_axis: str = "dp"
    tp_axis: Optional[str] = None
    fsdp_rest: bool = False
    remat: bool = False


class IlCfg(_Cfg):
    epochs: int = 10
    batch_size: int = 8
    lr: float = 1e-4
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"  # cosine | linear | constant
    max_grad_norm: float = 1.0
    #: microbatches accumulated per optimizer step
    grad_accum_steps: int = 1
    use_ema: bool = False
    lmdb_features_dir: Optional[str] = None
    lerobot_features_dir: Optional[str] = None
    dataset_root_dir: Optional[str] = None
    dataset_type: str = "lmdb"  # lmdb | lerobot | fake
    filter_failure: Dict[str, Any] = {"use": True, "min_rgb_nums": 5}
    inflection_weight_coef: float = 3.2
    use_iw: bool = True
    ckpt_to_load: Optional[str] = None
    load_from_ckpt: bool = False
    load_from_pretrain: bool = False
    num_workers: int = 1
    save_interval_steps: int = 500
    log_interval_steps: int = 10
    report_to: str = "none"  # none | tensorboard
    seed: int = 0
    #: recompute decoder layers in backward instead of keeping activations
    remat: bool = False
    #: >0: full-vocab cross-entropy per `ce_chunk`-token chunk, never the
    #: (B, T, vocab) logits; 0 = the full-logits loss
    ce_chunk: int = 0
    #: storage dtype of Adam's m/v ("bf16" halves the optimizer's memory;
    #: the moments are still updated in fp32). None/"fp32" stores fp32
    opt_state_dtype: Optional[str] = None


class TrainEvalCfg(_Cfg):
    use_ckpt_config: bool = False
    save_results: bool = True
    split: List[str] = ["val_unseen"]
    max_steps: int = 195
    sample: bool = False
    success_distance: float = 3.0


class ExpCfg(_Cfg):
    name: str = "exp"
    model_name: str = "cma"
    torch_gpu_id: int = 0
    output_dir: str = "logs/train"
    checkpoint_folder: str = "checkpoints"
    tensorboard_dir: str = "logs/tb"
    log_dir: str = "logs"
    seed: int = 0
    eval: TrainEvalCfg = TrainEvalCfg()
    il: IlCfg = IlCfg()
    model: ModelCfg = ModelCfg()
    mesh: MeshCfg = MeshCfg()
