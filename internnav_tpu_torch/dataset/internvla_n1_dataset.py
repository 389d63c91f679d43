"""InternVLA-N1 SFT dataset: supervision mining, chat tokenization, packing.

Port of internnav_tpu/dataset/internvla_n1_dataset.py (numpy, host side),
reading and writing stores through the port's pure-Python `TrajStore`. The
same store gives the same samples, token rows and packed batches as the
JAX package. The packed collate's segment ids (pads in segment -1) feed
the flash-attention kernels' segment mask.

Reference parity (internnav/dataset/internvla_n1_lerobot_dataset.py):
- NavPixelGoalDataset mines per-episode tuples (:822-1133): pixel-goal
  samples for goals ≥3 steps ahead, turn-action samples, stop samples x5
  (:870-940); history placeholder images; trajectory targets interpolated
  and converted to the relative frame with Δxyt encoding (:571-720);
- preprocess_qwen_2_visual tokenization with label masking (:189) —
  only assistant-turn tokens are supervised (labels = -100 elsewhere);
- DataCollatorForSupervisedDataset splices TRAJ-token blocks (:1150-1282);
- FlattenedDataCollatorForSupervisedDataset packs samples into one row
  with cu_seqlens (:1283-1331) — here emitted as segment ids for the
  Pallas flash-attention packed path (ops.flash_attention).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from internnav_tpu_torch.dataset.base import TrajectoryDataset
from internnav_tpu_torch.dataset.navdp_dataset import resample_path
from internnav_tpu_torch.utils.geometry import to_local_coords, wrap_angle

IGNORE_INDEX = -100
IM_START, IM_END = "<|im_start|>", "<|im_end|>"
VISION_START, VISION_END = "<|vision_start|>", "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"
TRAJ_PAD = "<|traj_pad|>"

SYSTEM_PROMPT = (
    "You are an autonomous navigation assistant. Your task is to "
    "{instruction}. Devise an action sequence to follow the instruction "
    "using the four actions: TURN LEFT (←) or TURN RIGHT (→) by 15 degrees, "
    "MOVE FORWARD (↑) by 25 centimeters, or STOP."
)


@dataclass
class N1Sample:
    images: np.ndarray  # (n_img, H, W, 3)
    prompt: str  # user text with <image> placeholders
    answer: str  # assistant target text
    traj: Optional[np.ndarray] = None  # (P, 3) relative Δxyt, when pixel-goal
    has_traj: bool = False


def relative_traj(positions: np.ndarray, yaws: np.ndarray, t: int, goal_t: int,
                  n_points: int) -> np.ndarray:
    """Future path in the frame of step t, resampled, as (P, 3) Δ(x, y, yaw)
    steps (reference :571-720 interpolate/relative/delta encoding)."""
    local = to_local_coords(positions[t : goal_t + 1], positions[t], yaws[t])
    path = resample_path(local, n_points + 1)
    dxy = np.diff(path, axis=0)
    yaw_seg = np.interp(np.linspace(t, goal_t, n_points + 1),
                        np.arange(len(yaws)), np.unwrap(yaws))
    dyaw = np.diff(yaw_seg)[:, None]
    return np.concatenate([dxy, wrap_angle(dyaw)], axis=1).astype(np.float32)


class N1SampleDataset:
    """Mines (pixel-goal | turn | stop) supervision from episode records."""

    def __init__(self, store_path: str, rank: int = 0, world_size: int = 1,
                 num_history: int = 8, predict_step_nums: int = 32,
                 min_goal_steps: int = 3, seed: int = 0):
        self.ds = TrajectoryDataset(store_path, rank, world_size, seed=seed)
        self.num_history = num_history
        self.predict_step_nums = predict_step_nums
        self.min_goal_steps = min_goal_steps
        self.rs = np.random.RandomState(seed)

    def _history_images(self, rgb: np.ndarray, t: int) -> np.ndarray:
        if t == 0:
            return rgb[t : t + 1]
        hist = np.unique(np.linspace(0, t - 1, self.num_history, dtype=np.int32))
        return rgb[np.concatenate([hist, [t]])]

    def __iter__(self) -> Iterator[N1Sample]:
        for traj in self.ds:
            rgb = np.asarray(traj["rgb"])
            actions = np.asarray(traj["actions"], np.int32)
            positions = np.asarray(traj["positions"], np.float64)
            yaws = np.asarray(traj["yaws"], np.float64)
            pixel_goals = traj.get("pixel_goals")  # (T, 2) or None
            instruction = traj.get("instruction_text", "follow the path")
            T = rgb.shape[0]
            arrows = {0: "STOP", 1: "↑", 2: "←", 3: "→"}

            for t in range(T):
                images = self._history_images(rgb, t)
                n_hist = images.shape[0] - 1
                prompt = SYSTEM_PROMPT.format(instruction=instruction)
                if n_hist:
                    prompt += (" These are your historical observations: "
                               + "<image>" * n_hist + ".")
                prompt += " you can see <image>."

                goal_t = min(t + self.rs.randint(self.min_goal_steps, 12), T - 1)
                if actions[t] == 0:
                    # stop samples x5 (reference :934-940 repeats stops)
                    for _ in range(5):
                        yield N1Sample(images=images, prompt=prompt, answer="STOP")
                elif pixel_goals is not None and goal_t - t >= self.min_goal_steps:
                    px = np.asarray(pixel_goals[goal_t], np.int64)
                    answer = f"[{int(px[0])}, {int(px[1])}]" + TRAJ_PAD
                    tr = relative_traj(positions, yaws, t, goal_t, self.predict_step_nums)
                    yield N1Sample(images=images, prompt=prompt, answer=answer,
                                   traj=tr, has_traj=True)
                else:
                    # turn/forward action-sequence sample
                    seq = "".join(arrows[a] for a in actions[t : t + 4])
                    yield N1Sample(images=images, prompt=prompt, answer=seq)


def tokenize_sample(sample: N1Sample, tokenizer, tokens_per_image: int,
                    n_query: int = 4) -> Dict[str, np.ndarray]:
    """Chat-template tokenization with label masking (reference
    preprocess_qwen_2_visual :189 + TRAJ-block splicing :1150-1282)."""
    img_block = VISION_START + IMAGE_PAD * tokens_per_image + VISION_END
    user_text = sample.prompt.replace("<image>", img_block)
    prefix = f"{IM_START}user\n{user_text}{IM_END}\n{IM_START}assistant\n"
    answer = sample.answer.replace(TRAJ_PAD, TRAJ_PAD * n_query)
    full = prefix + answer + IM_END
    prefix_ids = tokenizer.encode(prefix)
    full_ids = tokenizer.encode(full)
    labels = np.full((len(full_ids),), IGNORE_INDEX, np.int64)
    labels[len(prefix_ids):] = full_ids[len(prefix_ids):]
    traj_id = tokenizer.SPECIALS.get(TRAJ_PAD, 151667) if hasattr(tokenizer, "SPECIALS") else 151667
    ids = np.asarray(full_ids, np.int64)
    labels[ids == traj_id] = IGNORE_INDEX  # traj queries are not LM targets
    return {
        "input_ids": ids,
        "labels": labels,
        "images": sample.images,
        "traj": sample.traj if sample.traj is not None else np.zeros((0, 3), np.float32),
        "has_traj": np.asarray(sample.has_traj),
    }


def n1_collate_fn(rows: List[Dict[str, np.ndarray]], pad_id: int = 151645,
                  predict_step_nums: int = 32) -> Dict[str, Any]:
    """Right-padded batch (reference DataCollatorForSupervisedDataset)."""
    B = len(rows)
    L = max(len(r["input_ids"]) for r in rows)
    input_ids = np.full((B, L), pad_id, np.int64)
    labels = np.full((B, L), IGNORE_INDEX, np.int64)
    attn = np.zeros((B, L), np.int32)
    for i, r in enumerate(rows):
        n = len(r["input_ids"])
        input_ids[i, :n] = r["input_ids"]
        labels[i, :n] = r["labels"]
        attn[i, :n] = 1
    trajs = np.stack([
        r["traj"] if r["traj"].shape[0] == predict_step_nums
        else np.zeros((predict_step_nums, 3), np.float32)
        for r in rows
    ])
    return {
        "input_ids": input_ids,
        "labels": labels,
        "attention_mask": attn,
        "images": [r["images"] for r in rows],
        "traj_poses": trajs,
        "traj_mask": np.asarray([bool(r["has_traj"]) for r in rows]),
    }


def n1_packed_collate_fn(rows: List[Dict[str, np.ndarray]], max_len: int = 2048,
                         pad_id: int = 151645,
                         predict_step_nums: int = 32) -> Dict[str, Any]:
    """Sequence packing: concatenate samples into one row + segment ids
    (reference FlattenedDataCollator :1283-1331, cu_seqlens → the Pallas
    segment-id packed-attention path)."""
    ids, labels, seg = [], [], []
    images, trajs, traj_mask = [], [], []
    for s_idx, r in enumerate(rows):
        n = len(r["input_ids"])
        if sum(map(len, ids)) + n > max_len:
            break
        ids.append(r["input_ids"])
        labels.append(r["labels"])
        seg.append(np.full((n,), s_idx, np.int32))
        images.append(r["images"])
        trajs.append(r["traj"] if r["traj"].shape[0] == predict_step_nums
                     else np.zeros((predict_step_nums, 3), np.float32))
        traj_mask.append(bool(r["has_traj"]))
    total = sum(map(len, ids))
    pad = max_len - total
    input_ids = np.concatenate(ids + [np.full((pad,), pad_id, np.int64)])[None]
    lab = np.concatenate(labels + [np.full((pad,), IGNORE_INDEX, np.int64)])[None]
    segments = np.concatenate(seg + [np.full((pad,), -1, np.int32)])[None]
    return {
        "input_ids": input_ids,
        "labels": lab,
        "segment_ids": segments,
        "images": images,
        "traj_poses": np.stack(trajs),
        "traj_mask": np.asarray(traj_mask),
        "num_packed": len(ids),
    }


def stack_packed_rows(batches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Packed batches of one row each (`n1_packed_collate_fn`, the same
    max_len) as one batch of len(batches) rows: the rows stacked, the
    samples' images, trajectories and masks in row order (each row's
    segment ids number its own samples from 0)."""
    if len(batches) == 1:
        return batches[0]
    out = {k: np.concatenate([b[k] for b in batches]) for k in
           ("input_ids", "labels", "segment_ids", "traj_poses", "traj_mask")}
    out["images"] = [im for b in batches for im in b["images"]]
    out["num_packed"] = sum(b["num_packed"] for b in batches)
    return out


def write_synthetic_n1_dataset(path: str, n_episodes: int = 3, T: int = 10,
                               hw: int = 56, seed: int = 0) -> str:
    from internnav_tpu_torch.dataset.traj_store import TrajStore

    rs = np.random.RandomState(seed)
    store = TrajStore(path, writable=True)
    for i in range(n_episodes):
        t = rs.randint(6, T + 1)
        yaws = np.cumsum(rs.uniform(-0.2, 0.2, t))
        steps = 0.25 * np.stack([np.cos(yaws), np.sin(yaws)], 1)
        positions = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, 0)[:-1]], 0)
        actions = rs.randint(0, 4, t).astype(np.int32)
        actions[-1] = 0
        store.put_tree(f"ep{i:04d}", {
            "rgb": rs.randint(0, 255, (t, hw, hw, 3)).astype(np.uint8),
            "actions": actions,
            "positions": positions.astype(np.float32),
            "yaws": yaws.astype(np.float32),
            "pixel_goals": rs.randint(0, hw, (t, 2)).astype(np.int32),
            "instruction_text": f"walk along corridor {i}",
        })
    return path
