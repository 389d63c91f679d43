"""InternVLA-N1 finetuning trainer.

Port of internnav_tpu/trainer/internvla_n1_trainer.py: selective
unfreezing (tune_llm / tune_mm_vision, System-1 always trainable), packed
batches whose segment ids confine attention to each sample (the flash
kernels' segment mask on CUDA), the LM cross-entropy on label-masked
tokens (chunked with `il.ce_chunk`) plus the flow-matching System-1 loss.
The frozen vision tower encodes the images on the host side of the step
(`prepare_batch`), outside the autograd graph.

The System-1 loss's random draws (timesteps and noise) come from the
trainer's torch.Generator, or are handed in (`draws`) so that a test can
give both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from internnav_tpu_torch.dataset.internvla_n1_dataset import IGNORE_INDEX
from internnav_tpu_torch.ops.rope import get_rope_index_25
from internnav_tpu_torch.trainer.base import Trainer

#: the System-1 loss's draws for one batch: (timesteps (N,) int, noise (N, P, 3))
S1Draws = Tuple[torch.Tensor, torch.Tensor]


def trainability_labels(model: torch.nn.Module, *, tune_llm: bool = False,
                        tune_mm_vision: bool = False) -> Dict[str, str]:
    """'train' / 'freeze' per parameter name: the language model trains
    with tune_llm, the vision tower with tune_mm_vision, everything else
    (System-1 heads, latent queries) always."""
    def label(name: str) -> str:
        root = name.split(".", 1)[0]
        if root == "language_model":
            return "train" if tune_llm else "freeze"
        if root == "visual":
            return "train" if tune_mm_vision else "freeze"
        return "train"

    return {name: label(name) for name, _ in model.named_parameters()}


def gather_traj_blocks(hidden, input_ids, traj_poses, traj_mask,
                       traj_token_index: int, n_query: int):
    """Align traj-token hidden states with their per-sample targets.

    A stable sort puts the traj-token positions first, so the k-th
    traj-bearing sample's n_query block lands in slot k; the targets are
    compacted by the same stable sort of the samples' traj mask, and the
    trailing slots get loss mask 0. Returns (traj_hidden (N, n_query, D),
    traj_poses (N, P, 3), loss_mask (N,)) with N = traj_poses.shape[0]."""
    n_rows = traj_poses.shape[0]
    B, T, D = hidden.shape
    flat_hidden = hidden.reshape(B * T, D)
    not_traj = (input_ids != traj_token_index).reshape(-1).to(torch.uint8)
    take = torch.argsort(not_traj, stable=True)[: n_rows * n_query]
    traj_hidden = flat_hidden[take].reshape(n_rows, n_query, D)
    has_traj = traj_mask.bool()
    rows = torch.argsort((~has_traj).to(torch.uint8), stable=True)
    return traj_hidden, traj_poses[rows], has_traj[rows].float()


class InternVLAN1Trainer(Trainer):
    def __init__(self, cfg, policy, dataset=None, total_steps: Optional[int] = None,
                 tune_llm: bool = True, tune_mm_vision: bool = False):
        self.tune_llm = tune_llm
        self.tune_mm_vision = tune_mm_vision
        # il.remat applies at the trainer/config boundary: a policy built
        # without it (the serving default) recomputes its decoder layers in
        # backward here; the parameters are untouched
        if cfg.il.remat and not policy.cfg.text.remat:
            text = dataclasses.replace(policy.cfg.text, remat=True)
            policy.cfg = policy.model.cfg = dataclasses.replace(policy.cfg, text=text)
            policy.model.language_model.cfg = text
        super().__init__(cfg, policy, dataset, total_steps)

    def set_trainable(self) -> None:
        labels = trainability_labels(self.model, tune_llm=self.tune_llm,
                                     tune_mm_vision=self.tune_mm_vision)
        for name, p in self.model.named_parameters():
            p.requires_grad_(labels[name] == "train")

    # ------------------------------------------------------------ host prep
    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Encode the images (frozen tower, no grad) and build the M-RoPE
        position ids; returns the step's tensors on the policy's device."""
        pol = self.policy
        cfg = pol.cfg
        dev = pol.device
        images = [np.asarray(imgs) for imgs in batch["images"]]
        if len({im.shape[1:] for im in images}) == 1:
            # one tower pass over every frame of the row: the tower encodes
            # each image on its own, so this equals per-sample encodes
            tokens, grid = pol._encode_images(np.concatenate(images))
        else:
            parts = [pol._encode_images(im) for im in images]
            tokens = torch.cat([t for t, _ in parts])
            grid = np.concatenate([g for _, g in parts])
        input_ids = np.asarray(batch["input_ids"])
        pos_ids, _ = get_rope_index_25(input_ids, grid,
                                       spatial_merge_size=cfg.vision.spatial_merge_size,
                                       image_token_id=cfg.image_token_index)
        seg = batch.get("segment_ids")
        return {
            "input_ids": torch.as_tensor(input_ids, device=dev),
            "labels": torch.as_tensor(np.asarray(batch["labels"]), device=dev),
            "segment_ids": None if seg is None else torch.as_tensor(
                np.asarray(seg, np.int32), device=dev),
            "position_ids": torch.as_tensor(pos_ids, device=dev),
            "image_embeds": tokens,
            "traj_poses": torch.as_tensor(np.asarray(batch["traj_poses"], np.float32), device=dev),
            "traj_mask": torch.as_tensor(np.asarray(batch["traj_mask"], np.float32), device=dev),
        }

    # -------------------------------------------------------------- loss
    def s1_draws(self, n: int) -> S1Draws:
        """Timesteps uniform in [0, num_train_timesteps) and N(0, 1) noise
        for n trajectories, from the trainer's generator."""
        cfg = self.policy.cfg
        dev = self.policy.device
        u = torch.rand((n,), generator=self.generator, device=dev)
        t = (u * self.model.noise_scheduler.num_train_timesteps).int()
        noise = torch.randn((n, cfg.predict_step_nums, 3), generator=self.generator, device=dev)
        return t, noise

    def loss_fn(self, batch, draws: Optional[S1Draws] = None):
        model = self.model
        cfg = self.policy.cfg
        input_ids, labels = batch["input_ids"], batch["labels"]
        ce_chunk = int(self.cfg.il.ce_chunk or 0)

        embeds = model.embed_multimodal(input_ids, batch["image_embeds"])
        logits, hidden, _ = model.prefill(embeds, batch["position_ids"],
                                          segment_ids=batch["segment_ids"],
                                          compute_logits=ce_chunk == 0)
        if ce_chunk:
            lm_loss = model.language_model.chunked_ce(hidden, labels, ignore_index=IGNORE_INDEX,
                                                      chunk=ce_chunk)
        else:
            shift_logits, shift_labels = logits[:, :-1], labels[:, 1:]
            valid = shift_labels != IGNORE_INDEX
            ce = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                                 torch.where(valid, shift_labels, 0).reshape(-1).long(),
                                 reduction="none").reshape(valid.shape)
            lm_loss = (ce * valid).sum() / valid.sum().clamp(min=1)

        s1_loss = torch.zeros((), device=hidden.device)
        n_traj_rows = batch["traj_poses"].shape[0]
        if "nextdit" in cfg.system1 and n_traj_rows:
            traj_hidden, traj_poses, loss_mask = gather_traj_blocks(
                hidden, input_ids, batch["traj_poses"], batch["traj_mask"],
                cfg.traj_token_index, cfg.n_query)
            t, noise = draws if draws is not None else self.s1_draws(n_traj_rows)
            s1_loss = model.traj_loss_nextdit(traj_hidden, traj_poses, t=t.to(hidden.device),
                                              noise=noise.to(hidden.device), loss_mask=loss_mask)
        return lm_loss + s1_loss, {"lm_loss": lm_loss, "s1_loss": s1_loss}

    def train_on_batches(self, batches: List[Dict[str, Any]],
                         draws: Optional[Sequence[S1Draws]] = None) -> Dict[str, float]:
        """Prepare and train on each raw batch in turn; returns the last
        step's metrics. draws[i], when given, is batch i's System-1 draws."""
        metrics: Dict[str, torch.Tensor] = {}
        for i, raw in enumerate(batches):
            metrics = self.train_step(self.prepare_batch(raw),
                                      None if draws is None else draws[i])
        return {k: float(v) for k, v in metrics.items()}
