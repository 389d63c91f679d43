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
give both packages the same numbers: one set per micro-batch, over the
micro-batch's samples, the same on every rank (JAX draws once for the
global batch); a rank takes the slots of its rows' trajectory blocks.

Splitting a packed batch (micro-batches, dp ranks) applies the JAX rule
"split the rows where they divide, else take the whole batch" per sample
row: a row's input ids, labels, segment ids, position ids, image tokens
and trajectory blocks go together. The JAX trainer splits each leaf on its
own leading axis instead, which breaks when the rows divide (F19: the
(3, B, T) position ids replicate whole, the image tokens split by count).
The losses are the token mean and the trajectory mean over the whole
step (`term_counts`), as JAX's are over its batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from internnav_tpu_torch.dataset.internvla_n1_dataset import IGNORE_INDEX
from internnav_tpu_torch.ops.rope import get_rope_index_25
from internnav_tpu_torch.parallel.mesh import row_bounds
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
    TERM_FLOORS = {"lm_loss": 1.0, "s1_loss": 1e-6}

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

    def fsdp_groups(self) -> List[torch.nn.Module]:
        """The decoder layers, then the vision tower, each gathered on its
        own under FSDP."""
        return [*self.model.language_model.layers, self.model.visual]

    # ------------------------------------------------------------ host prep
    def encode_images(self, images):
        """The policy's vision encode (frozen tower, no grad); under FSDP
        as a forward of the root module, which gathers the tower."""
        if self._root is not None:
            return self._root.encode(images)
        return self.policy._encode_images(images)

    @torch.no_grad()
    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Encode the images (frozen tower, no grad) and build the M-RoPE
        position ids; returns the step's tensors on the policy's device."""
        pol = self.policy
        cfg = pol.cfg
        dev = pol.device
        images = [np.asarray(imgs) for imgs in batch["images"]]
        if len({im.shape[1:] for im in images}) == 1:
            # one tower pass over every frame of the batch: the tower encodes
            # each image on its own, so this equals per-sample encodes
            tokens, grid = self.encode_images(np.concatenate(images))
        else:
            parts = [self.encode_images(im) for im in images]
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

    # ------------------------------------------------------------ splitting
    def micro_batches(self, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
        """This rank's rows of each micro-batch: rows i·mb … (i+1)·mb − 1 of
        micro-batch i where the B rows divide accum × dp, else all B; then a
        dp rank's block of those where dp divides them. Each piece carries
        `draw_rows` (the micro-batch's samples, which its System-1 draws
        cover) and `draw_slots` (the draws of this piece's samples)."""
        B = batch["input_ids"].shape[0]
        accum, dp, r = self.accum, self.dp, self.dp_rank
        pieces = []
        for i in range(accum):
            m0, m1 = row_bounds(B, accum, i) if B % (accum * dp) == 0 else (0, B)
            a, b = row_bounds(m1 - m0, dp, r)
            pieces.append(split_rows(batch, m0 + a, m0 + b, (m0, m1),
                                     self.policy.cfg.image_token_index))
        return pieces

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

    def _has_s1_loss(self, batch) -> bool:
        return "nextdit" in self.policy.cfg.system1 and batch["traj_poses"].shape[0] > 0

    def term_counts(self, batch) -> Dict[str, torch.Tensor]:
        """The valid next-token labels and the trajectory-bearing samples."""
        lm = (batch["labels"][:, 1:] != IGNORE_INDEX).sum()
        s1 = batch["traj_mask"].sum() if self._has_s1_loss(batch) else torch.zeros_like(lm)
        return {"lm_loss": lm, "s1_loss": s1}

    def loss_terms(self, batch, draws: Optional[S1Draws] = None):
        """The LM cross-entropy summed over the valid labels and the
        flow-matching loss summed over the trajectory-bearing samples
        (`traj_loss_nextdit_sum`) of this piece."""
        model = self.model
        cfg = self.policy.cfg
        input_ids, labels = batch["input_ids"], batch["labels"]
        ce_chunk = int(self.cfg.il.ce_chunk or 0)
        lm = model.language_model

        embeds = model.embed_multimodal(input_ids, batch["image_embeds"])
        logits, hidden, _ = model.prefill(embeds, batch["position_ids"],
                                          segment_ids=batch["segment_ids"],
                                          compute_logits=ce_chunk == 0)
        if ce_chunk:
            lm_num, _ = lm.chunked_ce_sum(hidden, labels, ignore_index=IGNORE_INDEX,
                                          chunk=ce_chunk)
        else:
            lm_num, _ = lm.ce_sum(logits[:, :-1], labels[:, 1:], IGNORE_INDEX)

        s1_num = torch.zeros((), device=hidden.device)
        n_rows = batch.get("draw_rows", batch["traj_poses"].shape[0])
        if "nextdit" in cfg.system1 and n_rows:
            # drawn for the micro-batch's samples on every rank alike
            t, noise = draws if draws is not None else self.s1_draws(n_rows)
        if self._has_s1_loss(batch):
            slots = batch.get("draw_slots")
            if slots is not None:
                t, noise = t[slots.to(t.device)], noise[slots.to(noise.device)]
            traj_hidden, traj_poses, loss_mask = gather_traj_blocks(
                hidden, input_ids, batch["traj_poses"], batch["traj_mask"],
                cfg.traj_token_index, cfg.n_query)
            s1_num = model.traj_loss_nextdit_sum(traj_hidden, traj_poses, t=t.to(hidden.device),
                                                 noise=noise.to(hidden.device),
                                                 loss_mask=loss_mask)
        return {"lm_loss": lm_num, "s1_loss": s1_num}, {}

    def loss_fn(self, batch, draws: Optional[S1Draws] = None):
        """The batch's loss on this rank, unsplit: (lm_loss + s1_loss,
        {"lm_loss", "s1_loss"})."""
        terms, _ = self.loss_terms(batch, draws)
        counts = self.term_counts(batch)
        parts = {n: terms[n] / counts[n].float().clamp(min=self.TERM_FLOORS[n]) for n in terms}
        return parts["lm_loss"] + parts["s1_loss"], parts

    def train_on_batches(self, batches: List[Dict[str, Any]],
                         draws: Optional[Sequence[Any]] = None) -> Dict[str, float]:
        """Prepare and train on each raw batch in turn; returns the last
        step's metrics. draws[i], when given, is batch i's System-1 draws
        (a list of one set per micro-batch, or one set at accum 1)."""
        metrics: Dict[str, torch.Tensor] = {}
        for i, raw in enumerate(batches):
            metrics = self.train_step(self.prepare_batch(raw),
                                      None if draws is None else draws[i])
        return {k: float(v) for k, v in metrics.items()}


def split_rows(batch: Dict[str, Any], a: int, b: int, micro: Tuple[int, int],
               image_token_index: int) -> Dict[str, Any]:
    """Rows a … b − 1 of a prepared packed batch with everything that
    belongs to them: their position ids, image tokens (in reading order)
    and trajectory blocks (samples in row order; a row's samples are its
    segment ids 0 … k − 1, one sample a row without segment ids), with
    `draw_rows` and `draw_slots` of the micro-batch rows micro = (m0, m1)
    that holds them."""
    ids = batch["input_ids"]
    B = ids.shape[0]
    if (a, b) == (0, B) and micro == (0, B):
        return batch
    seg = batch["segment_ids"]
    img = [0] + np.cumsum((ids == image_token_index).sum(1).tolist()).tolist()
    per_row = [1] * B if seg is None else (seg.amax(1) + 1).clamp(min=0).tolist()
    smp = [0] + np.cumsum(per_row).tolist()
    if smp[-1] != batch["traj_poses"].shape[0]:
        raise ValueError(f"{batch['traj_poses'].shape[0]} trajectory blocks for {smp[-1]} "
                         "samples in the rows: the batch cannot be split by row")
    has_traj = [0] + np.cumsum(batch["traj_mask"].tolist()).tolist()
    m0, m1 = micro
    s0, s1 = smp[a], smp[b]
    offset = int(round(has_traj[s0] - has_traj[smp[m0]]))
    return {
        "input_ids": ids[a:b],
        "labels": batch["labels"][a:b],
        "segment_ids": None if seg is None else seg[a:b],
        "position_ids": batch["position_ids"][:, a:b],
        "image_embeds": batch["image_embeds"][img[a]:img[b]] if img[b] > img[a] else None,
        "traj_poses": batch["traj_poses"][s0:s1],
        "traj_mask": batch["traj_mask"][s0:s1],
        "draw_rows": smp[m1] - smp[m0],
        "draw_slots": torch.arange(offset, offset + s1 - s0),
    }
