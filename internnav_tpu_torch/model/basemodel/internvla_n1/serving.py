"""Batched multi-episode, multi-cohort dual-system serving.

Port of internnav_tpu/model/basemodel/internvla_n1/serving.py (the
nextdit and navdp System-1 heads). Every decoded token streams the
whole decoder's weights whatever the batch, so stepping B episode streams
through one System-2 call, and several cohorts through one shared decode,
multiplies actions per second per GPU.

- `BatchedN1Policy` keeps B per-episode histories on the host. Rows are
  grouped by history length (a uniform image-token layout per group),
  padded to a compute bucket from {2^k} ∪ {3·2^k} (`_pow2_bucket`), and
  their prompts right-padded to a shared 32-token bucket with the pads in
  their own segment (equal to the unpadded single stream). Each slot's
  frames' vision tokens are cached, so a step encodes only the new frames,
  in one batched ViT call. Prompt metadata goes to the device once per
  content (`_device_meta`, an LRU of 16 by digest).
- Uploads go through pinned host buffers with non_blocking=True
  (`policy.to_device`): they queue behind the device's work. `s2_collect`
  and `s1_collect` fetch results and wait for the device; the decode
  loop's chunked all-done check (`decode_graph`) waits for its own steps.
- `shared_decode_handles` decodes several cohorts' prefilled caches with
  one pass over the weights a token (`InternVLAN1Policy.grouped_tail`);
  `s1_grouped_dispatch` denoises several cohorts' System-1 rows at once,
  each cohort block with its own noise draw (NavDP: its starting noise and
  its per-step ancestral noise, joined along the rows). Both are row for
  row what the per-cohort calls give.
- NavDP cohorts take explicit [memory, current] RGBD pairs, rgb (B, 2, H,
  W, 3) uint8 and depth (B, 2, H, W, 1) fp32, padded to the compute bucket
  by repeating row 0 and not resized (as the JAX module); the sync `navdp`
  reads the latents alone.
- `PipelinedN1Server` interleaves the cohorts' phases on one host thread:
  while the host prepares one cohort, the device runs the others' queued
  work.

Differences from the JAX module: a cohort draws its System-1 noise from
its own `torch.Generator` (or from `noise_fn`, which tests set to hand in
the JAX draws), NavDP's starting noise first, then its step noise; the
constructors take an `InternVLAN1Policy`.
"""

from __future__ import annotations

import collections
import hashlib
import re
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
    InternVLAN1Policy,
    to_device,
)
from internnav_tpu_torch.model.encoder.vit import imagenet_normalize
from internnav_tpu_torch.model.utils.vln_utils import (
    S1Output,
    S2Output,
    parse_actions,
    traj_to_actions,
)
from internnav_tpu_torch.ops.rope import get_rope_index_25

#: device copies of prompt metadata kept per cohort (`_device_meta`)
META_CACHE = 16


class _Slot:
    """Host-side state of one episode stream."""

    __slots__ = ("rgb_list", "episode_idx", "instruction", "vision_cache", "active",
                 "llm_output", "s1_mem_frame", "s1_mem_feats", "prompt_cache")

    #: device vision-token entries kept per slot (least recently used goes;
    #: an evicted frame is encoded again from rgb_list on a miss)
    CACHE_CAP = 24

    def __init__(self) -> None:
        self.reset("")

    def reset(self, instruction: str) -> None:
        self.rgb_list: List[np.ndarray] = []
        self.episode_idx = 0
        self.instruction = instruction
        self.vision_cache: Dict[int, torch.Tensor] = {}
        self.active = True
        self.llm_output = ""
        # System-1's memory frame on the device: the uint8 frame that made
        # the current latent (uploaded at S2 time), and its DINOv2 features
        # (computed by the first S1 call of the latent, reused by the rest)
        self.s1_mem_frame: Optional[torch.Tensor] = None
        self.s1_mem_feats: Optional[torch.Tensor] = None
        #: (instruction, n_images, hw) -> (ids, rope positions, rope delta)
        self.prompt_cache: Dict[Any, Any] = {}

    def cache_get(self, k):
        v = self.vision_cache.pop(k, None)
        if v is not None:
            self.vision_cache[k] = v  # least recently used goes first
        return v

    def cache_put(self, k, v) -> None:
        self.vision_cache[k] = v
        while len(self.vision_cache) > self.CACHE_CAP:
            self.vision_cache.pop(next(iter(self.vision_cache)))


class BatchedN1Policy:
    """B-slot batched InternVLA-N1 dual-system policy (see the module doc).
    `inner` holds the model, its vision index tables and the decode
    loop's static caches and graphs; several cohorts share one."""

    def __init__(self, inner: InternVLAN1Policy, batch_size: int, seed: int = 0) -> None:
        self.inner = inner
        self.cfg = inner.cfg
        self.device = inner.device
        self.batch_size = batch_size
        self.slots = [_Slot() for _ in range(batch_size)]
        self.seed = seed
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        #: when set, shape -> a System-1 noise draw of one call: the
        #: starting noise (rows, P, 3) and, for NavDP, then the step noise
        #: (steps, rows, P, 3) (tests hand in the JAX package's draws);
        #: else `_generator` draws
        self.noise_fn: Optional[Callable[[tuple], torch.Tensor]] = None
        self._meta_cache: "collections.OrderedDict" = collections.OrderedDict()

    # ------------------------------------------------------------ lifecycle
    def reset_slot(self, i: int, instruction: str) -> None:
        self.slots[i].reset(instruction)

    def reset(self, instructions: List[str]) -> None:
        assert len(instructions) == self.batch_size
        for s, ins in zip(self.slots, instructions):
            s.reset(ins)

    # --------------------------------------------------------------- vision
    def _slot_frame_keys(self, slot: _Slot) -> List[int]:
        """History frame indices + current, as the single-stream policy
        (np.linspace over episode_idx, num_history samples)."""
        if slot.episode_idx == 0:
            hist: List[int] = []
        else:
            hist = np.unique(np.linspace(0, slot.episode_idx - 1, self.inner.num_history,
                                         dtype=np.int32)).tolist()
        return sorted(int(k) for k in hist) + [len(slot.rgb_list) - 1]

    def _encode_new_frames(self, slots: List[int], dev_current: Optional[torch.Tensor] = None,
                           current_row: Optional[Dict[int, int]] = None) -> None:
        """One batched ViT call over every slot's frames not yet cached.
        dev_current is the (B, H, W, 3) uint8 device stack of this step's
        frames (row current_row[slot]): at the steady state the only new
        frame of a slot is the current one, so nothing else is uploaded;
        frames seeded on the host go up in one upload."""
        todo, parts, host_imgs = [], [], []
        for i in slots:
            s = self.slots[i]
            for k in self._slot_frame_keys(s):
                if s.cache_get(k) is not None:
                    continue
                if dev_current is not None and current_row is not None \
                        and k == len(s.rgb_list) - 1 and i in current_row:
                    parts.append(("dev", current_row[i]))
                else:
                    parts.append(("host", len(host_imgs)))
                    host_imgs.append(s.rgb_list[k])
                todo.append((i, k))
        if not todo:
            return
        host_dev = to_device(np.stack(host_imgs).astype(np.uint8), self.device) \
            if host_imgs else None
        stack = torch.stack([dev_current[r] if kind == "dev" else host_dev[r]
                             for kind, r in parts])
        tokens, _ = self.inner._encode_images(stack)
        per = tokens.shape[0] // len(todo)
        for j, (i, k) in enumerate(todo):
            self.slots[i].cache_put(k, tokens[j * per:(j + 1) * per])

    # ---------------------------------------------------------------- steps
    @staticmethod
    def _pow2_bucket(n: int) -> int:
        """The smallest compute batch >= n from {2^k} ∪ {3·2^k}: a decode
        step costs about the same at any batch, so 24 or 48 rows should
        not pad to 32 or 64 (a third of the batch-linear prefill and
        System-1 work wasted)."""
        b = 1
        while True:
            if b >= n:
                return b
            if 3 * (b // 2) >= n and b >= 2:
                return 3 * (b // 2)
            b *= 2

    def _prep_group(self, rows: List[int], n_images: int, hw, frame_keys: Dict[int, list]
                    ) -> Dict[str, Any]:
        """Host-side prompt, rope and token assembly of one history-length
        group: ids and M-RoPE indices (memoized per slot), the compute
        bucket's padding rows (row 0 repeated), the prompt bucket's pads,
        the image tokens gathered in reading order."""
        inner, cfg = self.inner, self.cfg
        h, w = hw[0] // cfg.vision.patch_size, hw[1] // cfg.vision.patch_size
        ids_rows, pos_rows, deltas, tok_rows = [], [], [], []
        for i in rows:
            s = self.slots[i]
            # ids and rope indices depend on (instruction, n_images, hw)
            # alone: the same every step at the steady state
            pkey = (s.instruction, n_images, tuple(hw))
            cached = s.prompt_cache.get(pkey)
            if cached is None:
                ids = inner._build_prompt_ids(s.instruction, n_images, tuple(hw))
                grid = np.tile(np.asarray([[1, h, w]]), (n_images, 1))
                pos, delta = get_rope_index_25(ids, grid,
                                               spatial_merge_size=cfg.vision.spatial_merge_size,
                                               image_token_id=cfg.image_token_index)
                cached = (ids[0], np.asarray(pos)[:, 0], int(np.asarray(delta)[0, 0]))
                s.prompt_cache = {pkey: cached}  # one live entry
            ids_row, pos_row, delta_v = cached
            ids_rows.append(ids_row)
            pos_rows.append(pos_row)
            deltas.append(delta_v)
            tok_rows.append([s.cache_get(k) for k in frame_keys[i]])
        Bg = self._pow2_bucket(len(rows))
        while len(ids_rows) < Bg:
            ids_rows.append(ids_rows[0])
            pos_rows.append(pos_rows[0])
            deltas.append(deltas[0])
            tok_rows.append(tok_rows[0])
        bucket = inner.PROMPT_BUCKET
        T = -(-max(len(r) for r in ids_rows) // bucket) * bucket
        padded_ids = np.full((Bg, T), inner.tokenizer.pad_token_id, np.int64)
        padded_pos = np.zeros((3, Bg, T), np.int64)
        prompt_seg = np.zeros((Bg, T), np.int32)
        prompt_len = np.zeros((Bg,), np.int64)
        for r, (ids, pos) in enumerate(zip(ids_rows, pos_rows)):
            P = len(ids)
            padded_ids[r, :P] = ids
            padded_pos[:, r, :P] = pos
            padded_pos[:, r, P:] = pos.max() + 1 + np.arange(T - P)
            prompt_seg[r, P:] = 1
            prompt_len[r] = P
        img_tokens = torch.cat([t for row in tok_rows for t in row], dim=0)
        return dict(rows=rows, n_images=n_images, T=T, img_tokens=img_tokens,
                    padded_ids=padded_ids, padded_pos=padded_pos,
                    deltas=np.asarray(deltas, np.int64), prompt_len=prompt_len,
                    prompt_seg=prompt_seg)

    def _device_meta(self, g: Dict[str, Any]):
        """Device copies of a group's prompt metadata (ids, M-RoPE
        positions, rope deltas, prompt lengths, pad segments), memoized by
        a digest of their bytes, shapes and dtypes: at the steady state they
        are the same every step, so nothing goes up again."""
        hsh = hashlib.blake2b(digest_size=16)
        names = ("padded_ids", "padded_pos", "deltas", "prompt_len", "prompt_seg")
        for name in names:
            a = g[name]
            hsh.update(a.tobytes())
            hsh.update(str(a.shape).encode())
            hsh.update(a.dtype.str.encode())
        key = hsh.digest()
        cached = self._meta_cache.pop(key, None)
        if cached is None:
            cached = tuple(to_device(g[name], self.device) for name in names)
            while len(self._meta_cache) >= META_CACHE:
                self._meta_cache.popitem(last=False)
        self._meta_cache[key] = cached  # (re)inserted last: least recently used goes first
        return cached

    def _stage_s2(self, images: np.ndarray, slot_ids: Optional[List[int]]):
        """The host half of an S2 step: one upload of this step's frames,
        the histories, the new frames' vision tokens, the groups."""
        if slot_ids is None:
            slot_ids = list(range(self.batch_size))
        assert images.shape[0] == len(slot_ids)
        dev_imgs = to_device(np.asarray(images, np.uint8), self.device)
        current_row = {i: r for r, i in enumerate(slot_ids)}
        for r, i in enumerate(slot_ids):
            self.slots[i].rgb_list.append(np.asarray(images[r]))
        frame_keys = {i: self._slot_frame_keys(self.slots[i]) for i in slot_ids}
        self._encode_new_frames(slot_ids, dev_imgs, current_row)
        for i in slot_ids:
            self.slots[i].episode_idx += 1
        groups: Dict[int, List[int]] = {}
        for i in slot_ids:
            groups.setdefault(len(frame_keys[i]), []).append(i)
        hw = images.shape[1:3]
        prepped = [self._prep_group(rows, n, hw, frame_keys)
                   for n, rows in sorted(groups.items())]
        return prepped, {"dev_imgs": dev_imgs, "current_row": current_row,
                         "slot_ids": slot_ids}

    @torch.inference_mode()
    def s2_submit(self, images: np.ndarray, max_new_tokens: int = 128,
                  slot_ids: Optional[List[int]] = None) -> Dict[str, Any]:
        """Host prep, uploads and the fused System-2 call of each group
        (`InternVLAN1Policy.fused_s2`); returns a handle for `s2_collect`.
        The decode loop's all-done checks wait for its own steps; nothing
        else here waits for the device."""
        prepped, handle = self._stage_s2(images, slot_ids)
        pending = []
        for g in prepped:
            ids_d, pos_d, deltas_d, plen_d, seg_d = self._device_meta(g)
            tokens, _, latents = self.inner.fused_s2(
                g["img_tokens"], ids_d, pos_d, deltas_d, plen_d, seg_d, max_new_tokens)
            pending.append((g["rows"], tokens, latents))
        handle["pending"] = pending
        return handle

    @torch.inference_mode()
    def s2_prefill_submit(self, images: np.ndarray, max_new_tokens: int = 128,
                          slot_ids: Optional[List[int]] = None) -> Dict[str, Any]:
        """The prefill half of `s2_submit`: each group prefills into a cache
        set of the policy's pool (`InternVLAN1Policy.s2_caches`), held until
        `shared_decode_handles` decodes it and gives it back, after which
        `s2_collect` takes the handle as it takes `s2_submit`'s."""
        prepped, handle = self._stage_s2(images, slot_ids)
        inner = self.inner
        for g in prepped:
            ids_d, pos_d, deltas_d, plen_d, seg_d = self._device_meta(g)
            caches = inner.s2_caches(*g["padded_ids"].shape, max_new_tokens)
            g.update(first=inner.prefill_s2(g["img_tokens"], ids_d, pos_d, plen_d, seg_d, caches),
                     caches=caches, deltas_d=deltas_d, plen_d=plen_d)
        handle.update(pgroups=prepped, max_new_tokens=max_new_tokens)
        return handle

    def s2_collect(self, handle: Dict[str, Any]) -> List[S2Output]:
        """Fetch and parse an S2 handle's results (waits for the device).
        The lengths are the first stop token's index, found here in the
        fetched tokens."""
        inner = self.inner
        by_slot: Dict[int, S2Output] = {}
        for rows, tokens, latents in handle["pending"]:
            tokens_h = tokens.cpu().numpy()
            hit = np.isin(tokens_h, inner.stop_token_ids)
            lengths_h = np.where(hit.any(axis=1), hit.argmax(axis=1), tokens_h.shape[1])
            for r, i in enumerate(rows):
                text = inner.tokenizer.decode(tokens_h[r][: int(lengths_h[r])])
                self.slots[i].llm_output = text
                out = S2Output(idx=i)
                if re.search(r"\d", text):
                    coords = [int(c) for c in re.findall(r"\d+", text)]
                    if len(coords) >= 2:
                        out.output_pixel = np.array([coords[1], coords[0]])
                    out.output_latent = latents[r:r + 1]
                    # this step's frame, already on the device, becomes the
                    # System-1 memory frame of the new latent
                    self.slots[i].s1_mem_frame = handle["dev_imgs"][handle["current_row"][i]]
                    self.slots[i].s1_mem_feats = None
                else:
                    out.output_action = parse_actions(text)
                by_slot[i] = out
        return [by_slot[i] for i in handle["slot_ids"]]

    def s2_step(self, images: np.ndarray, max_new_tokens: int = 128,
                slot_ids: Optional[List[int]] = None) -> List[S2Output]:
        """One blocking S2 step. images (N, H, W, 3) uint8, a new frame per
        stepped slot; slot_ids selects which slots step (default all).
        Returns S2Outputs aligned with slot_ids."""
        return self.s2_collect(self.s2_submit(images, max_new_tokens, slot_ids))

    # ------------------------------------------------------------- System-1
    @staticmethod
    def _s1_norm(raw: torch.Tensor) -> torch.Tensor:
        return imagenet_normalize(raw.float() / 255.0)

    def _pad_rows(self, t: torch.Tensor, Bp: int) -> torch.Tensor:
        if t.shape[0] == Bp:
            return t
        return torch.cat([t, t[:1].expand(Bp - t.shape[0], *t.shape[1:])], dim=0)

    def _noise(self, shape: tuple) -> torch.Tensor:
        """One System-1 noise draw of `shape` (`noise_fn`'s or the
        generator's)."""
        if self.noise_fn is not None:
            return self.noise_fn(shape).to(self.device)
        return torch.randn(shape, generator=self._generator, device=self.device)

    def _draw(self, rows: int, nst: int) -> torch.Tensor:
        """One call's starting noise (rows*nst, P, 3)."""
        return self._noise((rows * nst, self.cfg.predict_step_nums, 3))

    def _check_system1(self) -> None:
        if "nextdit" not in self.cfg.system1 and "navdp" not in self.cfg.system1:
            raise NotImplementedError(f"batched serving takes the nextdit and navdp System-1, got "
                                      f"system1={self.cfg.system1!r}")

    @torch.inference_mode()
    def s1_submit(self, rgb: np.ndarray, latents, num_sample_trajs: int = 32,
                  slot_ids: Optional[List[int]] = None, depth=None) -> Dict[str, Any]:
        """Dispatch one batched System-1 denoise; returns a handle for
        `s1_collect`. nextdit: rgb (B, H, W, 3), the current frames (the
        serving path; each slot's memory frame and its features are on the
        device), or rgb (B, 2, H, W, 3), explicit [memory, current] pairs
        (the single-stream policy's form); depth is not read. navdp: rgb
        (B, 2, H, W, 3) uint8 and depth (B, 2, H, W, 1) [memory, current]
        RGBD pairs (the sync variant reads neither)."""
        self._check_system1()
        if "nextdit" in self.cfg.system1 and np.ndim(rgb) == 5:
            B = rgb.shape[0]
            Bp = self._pow2_bucket(B)
            lat = self._pad_rows(latents, Bp)
            pairs = self._pad_rows(to_device(np.asarray(rgb, np.uint8), self.device), Bp)
            dp = self.inner.model.generate_traj_nextdit(
                lat, self._s1_norm(pairs), x_init=self._draw(Bp, num_sample_trajs),
                num_sample_trajs=num_sample_trajs)
            return {"B": B, "Bp": Bp, "nst": num_sample_trajs, "dp": dp}
        spec = self.s1_prepare(rgb, latents, num_sample_trajs, slot_ids, depth=depth)
        self._s1_dispatch(spec)
        return spec["handle"]

    @torch.inference_mode()
    def s1_prepare(self, rgb: np.ndarray, latents, num_sample_trajs: int = 32,
                   slot_ids: Optional[List[int]] = None, depth=None) -> Dict[str, Any]:
        """Host prep, uploads and the noise draws of one cohort's System-1,
        without the denoise: the spec goes to `_s1_dispatch` (this cohort
        alone) or, with other cohorts' specs, to `s1_grouped_dispatch`.
        Mode `full` encodes the memory frames too (the first call of a
        latent), `cached` reuses their features, `noimg` (a non-async
        NextDiT) reads the latents alone; `navdp` and `navdp_noimg` are
        the NavDP head's (`_s1_navdp_prepare`)."""
        self._check_system1()
        if "navdp" in self.cfg.system1:
            return self._s1_navdp_prepare(rgb, depth, latents, num_sample_trajs)
        B = rgb.shape[0]
        if slot_ids is None:
            slot_ids = list(range(B))
        assert np.ndim(rgb) == 4, f"rgb must be (B, H, W, 3), got {rgb.shape}"
        Bp = self._pow2_bucket(B)
        spec: Dict[str, Any] = {"handle": {"B": B, "Bp": Bp, "nst": num_sample_trajs},
                                "latents": self._pad_rows(latents, Bp), "Bp": Bp,
                                "nst": num_sample_trajs, "policy": self,
                                "x_init": self._draw(Bp, num_sample_trajs)}
        if "async" not in self.cfg.system1:
            spec["mode"] = "noimg"
            return spec
        slots = [self.slots[i] for i in slot_ids]
        assert all(s.s1_mem_frame is not None for s in slots), (
            "current-frames-only System-1 needs a cached memory frame: run an S2 step first")
        spec["cur"] = self._pad_rows(to_device(np.asarray(rgb, np.uint8), self.device), Bp)
        spec["hw"] = tuple(rgb.shape[1:])
        if any(s.s1_mem_feats is None for s in slots):
            spec["mode"] = "full"
            spec["mem"] = self._pad_rows(torch.stack([s.s1_mem_frame for s in slots]), Bp)
            spec["slots"] = slots
        else:
            spec["mode"] = "cached"
            spec["mem"] = self._pad_rows(torch.stack([s.s1_mem_feats for s in slots]), Bp)
        return spec

    def _s1_navdp_prepare(self, rgb, depth, latents, num_sample_trajs: int) -> Dict[str, Any]:
        """The NavDP spec: latents padded to the compute bucket, the starting
        noise and then the step noise drawn for the bucket's rows, and for
        `navdp_async` the RGBD pairs uploaded (uint8 pixels, scaled to [0,
        1] on the device; fp32 depth), padded by repeating row 0. No grid
        fitting: the frames must already be on the head's grid."""
        B = latents.shape[0]
        Bp = self._pow2_bucket(B)
        rows, P = Bp * num_sample_trajs, self.cfg.predict_step_nums
        spec: Dict[str, Any] = {"handle": {"B": B, "Bp": Bp, "nst": num_sample_trajs},
                                "latents": self._pad_rows(latents, Bp), "Bp": Bp,
                                "nst": num_sample_trajs, "policy": self}
        spec["x_init"] = self._noise((rows, P, 3))
        spec["step_noises"] = self._noise((self.inner.model.navdp.denoise_steps, rows, P, 3))
        if "async" not in self.cfg.system1:
            spec["mode"] = "navdp_noimg"
            return spec
        if rgb is None or depth is None or np.ndim(rgb) != 5:
            raise ValueError(f"system1={self.cfg.system1!r} takes rgb (B, 2, H, W, 3) and depth "
                             f"(B, 2, H, W, 1) pairs, got rgb "
                             f"{None if rgb is None else np.shape(rgb)} and depth "
                             f"{None if depth is None else np.shape(depth)}")
        spec["mode"] = "navdp"
        spec["rgb"] = self._pad_rows(to_device(np.asarray(rgb, np.uint8), self.device), Bp)
        spec["depth"] = self._pad_rows(to_device(np.asarray(depth, np.float32), self.device), Bp)
        spec["hw"] = tuple(np.shape(rgb)[1:])
        return spec

    def _s1_run(self, spec: Dict[str, Any]):
        """The denoise of one spec's mode (or of several specs' inputs
        joined) → (trajectories, the memory features computed in `full`
        mode or None)."""
        model, mode, nst = self.inner.model, spec["mode"], spec["nst"]
        lat, x_init = spec["latents"], spec["x_init"]
        if mode == "navdp":
            return model.generate_traj_navdp_batched(
                lat, spec["rgb"].float() / 255.0, spec["depth"], x_init=x_init,
                step_noises=spec["step_noises"], sample_num=nst), None
        if mode == "navdp_noimg":
            return model.generate_traj_navdp_batched(
                lat, x_init=x_init, step_noises=spec["step_noises"], sample_num=nst), None
        if mode == "noimg":
            return model.generate_traj_nextdit(lat, None, x_init=x_init,
                                               num_sample_trajs=nst), None
        feats = model.rgb_feats(self._s1_norm(spec["mem"])) if mode == "full" else spec["mem"]
        dp = model.generate_traj_nextdit_cached(lat, feats, self._s1_norm(spec["cur"]),
                                                x_init=x_init, num_sample_trajs=nst)
        return dp, feats if mode == "full" else None

    @torch.inference_mode()
    def _s1_dispatch(self, spec: Dict[str, Any]) -> None:
        """Run one cohort's prepared System-1 (fills spec["handle"]["dp"];
        `full` mode caches the memory features on the slots)."""
        dp, feats = self._s1_run(spec)
        if feats is not None:
            for r, s in enumerate(spec["slots"]):
                s.s1_mem_feats = feats[r]
        spec["handle"]["dp"] = dp

    def s1_collect(self, handle: Dict[str, Any]) -> List[S1Output]:
        """Fetch and discretize an `s1_submit`'s results (waits for the
        device)."""
        dp = handle["dp"].float().cpu().numpy()
        return self._s1_outputs(dp, handle["B"], handle["Bp"], handle["nst"])

    def s1_step_latent(self, rgb: np.ndarray, latents, num_sample_trajs: int = 32,
                       slot_ids: Optional[List[int]] = None, depth=None) -> List[S1Output]:
        """Blocking batched System-1 denoise (see `s1_submit`)."""
        return self.s1_collect(self.s1_submit(rgb, latents, num_sample_trajs, slot_ids,
                                              depth=depth))

    @staticmethod
    def _s1_outputs(dp: np.ndarray, B: int, Bp: int, num_sample_trajs: int) -> List[S1Output]:
        dp = dp.reshape(Bp, num_sample_trajs, dp.shape[-2], 3)
        outs = []
        for i in range(B):
            action_list = [a for a in traj_to_actions(dp[i]) if a != 0]
            outs.append(S1Output(idx=action_list[:4], trajectory=dp[i]))
        return outs


#: a spec's tensors joined along the rows by `s1_grouped_dispatch` (NavDP's
#: step noise along axis 1: its leading axis is the step)
_S1_ROW_INPUTS = ("latents", "mem", "cur", "x_init", "rgb", "depth")


@torch.inference_mode()
def s1_grouped_dispatch(specs: List[Optional[Dict[str, Any]]]) -> None:
    """Complete `s1_prepare` specs of several cohorts with one denoise per
    (mode, frame shape, samples) bucket. Each cohort block keeps its own
    noise draws and every op is row-independent, so the rows equal the
    per-cohort `_s1_dispatch` up to the products' summation order at the
    larger batch."""
    buckets: Dict[tuple, list] = {}
    for s in specs:
        if s is not None:
            buckets.setdefault((s["mode"], s.get("hw"), s["nst"]), []).append(s)
    for (mode, _, nst), items in buckets.items():
        pol = items[0]["policy"]
        if len(items) == 1:
            pol._s1_dispatch(items[0])
            continue
        joined = {"mode": mode, "nst": nst}
        for name in _S1_ROW_INPUTS:
            if name in items[0]:
                joined[name] = torch.cat([s[name] for s in items])
        if "step_noises" in items[0]:
            joined["step_noises"] = torch.cat([s["step_noises"] for s in items], dim=1)
        dp, feats = pol._s1_run(joined)
        rows = b = 0
        for s in items:
            Bp = s["Bp"]
            s["handle"]["dp"] = dp[rows:rows + Bp * nst]
            if feats is not None:
                for r, sl in enumerate(s["slots"]):
                    sl.s1_mem_feats = feats[b + r]
            rows += Bp * nst
            b += Bp


def shared_decode_handles(inner: InternVLAN1Policy, handles: List[Dict[str, Any]]) -> None:
    """Complete `s2_prefill_submit` handles with one grouped decode and
    traj-latent chunk (`InternVLAN1Policy.grouped_tail`) per (prompt
    bucket T, max_new_tokens) set: every cohort's decode streams the
    weights once a token. Each handle is rewritten in place into the
    `s2_collect` form, and its cache sets go back to the pool; each row's
    results equal the per-cohort `s2_submit`'s. A bucket's groups go to
    the decode largest first (in submission order among equals), so that a
    layout of group sizes meets the loop it captured before whichever
    cohorts hold which size."""
    buckets: Dict[tuple, list] = {}
    for h in handles:
        for g in h.get("pgroups", ()):
            buckets.setdefault((g["T"], h["max_new_tokens"]), []).append((h, g))
    for (_, mnt), items in buckets.items():
        items.sort(key=lambda hg: -hg[1]["first"].shape[0])
        try:
            tokens, _, latents = inner.grouped_tail(
                [g["caches"] for _, g in items], torch.cat([g["first"] for _, g in items]),
                torch.cat([g["deltas_d"] for _, g in items]),
                torch.cat([g["plen_d"] for _, g in items]), mnt)
        finally:
            for _, g in items:
                inner.decode_buffers.release(g["caches"])
        r = 0
        for h, g in items:
            Bg = g["first"].shape[0]
            h.setdefault("pending", []).append((g["rows"], tokens[r:r + Bg], latents[r:r + Bg]))
            r += Bg
    for h in handles:
        h.pop("pgroups", None)


class SharedDecodePool:
    """Cross-cohort grouped-decode coordinator for coroutine schedulers:
    agents register their prefill handles, and the first to resume
    flushes one grouped decode over every pending cohort."""

    def __init__(self, inner: InternVLAN1Policy) -> None:
        self.inner = inner
        self.pending: List[Dict[str, Any]] = []

    def add(self, handle: Dict[str, Any]) -> None:
        self.pending.append(handle)

    def flush(self) -> None:
        if self.pending:
            shared_decode_handles(self.inner, self.pending)
            self.pending = []


class SharedS1Pool:
    """The System-1 counterpart of `SharedDecodePool`: agents register
    their `s1_prepare` specs, and a flush dispatches one grouped denoise
    per bucket over every pending cohort."""

    def __init__(self) -> None:
        self.pending: List[Dict[str, Any]] = []

    def add(self, spec: Dict[str, Any]) -> None:
        self.pending.append(spec)

    def flush(self) -> None:
        if self.pending:
            s1_grouped_dispatch(self.pending)
            self.pending = []


def _split_frames(frames):
    """frames_fn gives rgb alone or an (rgb, depth) tuple."""
    return frames if isinstance(frames, tuple) else (frames, None)


class PipelinedN1Server:
    """Multi-cohort serving on one host thread, the cohorts interleaved by
    phase: while the host prepares one cohort (prompts, uploads, parsing),
    the device runs the work the others have queued. Cohorts are disjoint
    episode sets, and each stream's results equal blocking single-cohort
    serving. All cohorts share one `InternVLAN1Policy` (weights, decode
    caches and graphs)."""

    def __init__(self, policy: InternVLAN1Policy, batch_size: int, cohorts: int = 2) -> None:
        self.inner = policy
        self.cfg = policy.cfg
        self.batch_size = batch_size
        self.cohorts = [BatchedN1Policy(policy, batch_size, seed=ci) for ci in range(cohorts)]

    def _zero_latent(self) -> torch.Tensor:
        return torch.zeros((1, self.cfg.n_query, self.cfg.text.hidden_size),
                           dtype=self.cfg.text.dtype, device=self.inner.device)

    def _latents(self, s2out: List[S2Output], fallback=None, ci: int = 0) -> torch.Tensor:
        rows = []
        for o in s2out:
            if o.output_latent is not None:
                rows.append(o.output_latent)
            elif fallback is not None:
                rows.append(fallback(ci)[o.idx:o.idx + 1])
            else:
                rows.append(self._zero_latent())
        return torch.cat(rows, dim=0)

    def serve_macro_cycle(self, frames_fn, max_new_tokens: int = 128,
                          num_sample_trajs: int = 32, s1_calls: int = 2, latent_fallback=None):
        """One phase-interleaved macro-cycle over all cohorts.
        frames_fn(cohort, phase) -> (B, H, W, 3) uint8 frames (phase 0 the
        S2 step, 1.. the S1 calls); latent_fallback(cohort) -> (B, n_q, E)
        for slots whose S2 gave no latent. Returns per cohort (s2_outputs,
        [s1_outputs per call])."""
        n = len(self.cohorts)
        s2h = [pol.s2_submit(frames_fn(ci, 0), max_new_tokens)
               for ci, pol in enumerate(self.cohorts)]
        s2out, lat, s1h = [None] * n, [None] * n, [None] * n
        s1res: List[List[Any]] = [[] for _ in range(n)]
        for ci, pol in enumerate(self.cohorts):
            s2out[ci] = pol.s2_collect(s2h[ci])
            lat[ci] = self._latents(s2out[ci], latent_fallback, ci)
            rgb_f, depth_f = _split_frames(frames_fn(ci, 1))
            s1h[ci] = pol.s1_submit(rgb_f, lat[ci], num_sample_trajs, depth=depth_f)
        for call in range(1, s1_calls + 1):
            nxt = [None] * n
            for ci, pol in enumerate(self.cohorts):
                s1res[ci].append(pol.s1_collect(s1h[ci]))
                if call < s1_calls:
                    rgb_f, depth_f = _split_frames(frames_fn(ci, call + 1))
                    nxt[ci] = pol.s1_submit(rgb_f, lat[ci], num_sample_trajs, depth=depth_f)
            s1h = nxt
        return [(s2out[ci], s1res[ci]) for ci in range(n)]

    def serve_stream(self, frames_fn, n_cycles: int, max_new_tokens: int = 128,
                     num_sample_trajs: int = 32, s1_calls: int = 2, on_cycle=None,
                     shared_decode: bool = False, shared_s1: bool = False,
                     host_stats: Optional[Dict[str, list]] = None):
        """Continuous pipelined serving for n_cycles macro-cycles: as soon
        as a cohort's last S1 of cycle t is collected, its S2 of cycle t+1
        is submitted. frames_fn(cohort, cycle, phase) -> frames;
        on_cycle(cohort, cycle, s2_outputs, s1_results) as each cohort
        finishes a cycle. shared_decode: every cohort's prefill, then one
        grouped decode (`shared_decode_handles`); shared_s1: one grouped
        System-1 denoise a micro-step (`s1_grouped_dispatch`).
        host_stats collects each call's host seconds under s2_submit,
        s2_collect, s1_submit, s1_collect, shared_decode and s1_grouped:
        submits are host prep, uploads and dispatch (the shared decode
        includes its all-done waits), collects include the wait for the
        device."""
        n = len(self.cohorts)
        s2h, lat, s2out = [None] * n, [None] * n, [None] * n
        s1res: List[List[Any]] = [[] for _ in range(n)]

        def timed(key, fn, *a, **kw):
            if host_stats is None:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host_stats.setdefault(key, []).append(time.perf_counter() - t0)
            return out

        def submit_s2(ci, t):
            pol = self.cohorts[ci]
            submit = pol.s2_prefill_submit if shared_decode else pol.s2_submit
            s2h[ci] = timed("s2_submit", submit, frames_fn(ci, t, 0), max_new_tokens)

        def submit_s1(ci, t, call):
            rgb_f, depth_f = _split_frames(frames_fn(ci, t, call))
            pol = self.cohorts[ci]
            submit = pol.s1_prepare if shared_s1 else pol.s1_submit
            return timed("s1_submit", submit, rgb_f, lat[ci], num_sample_trajs, depth=depth_f)

        def flush_s1(specs):
            if not shared_s1:
                return specs
            timed("s1_grouped", s1_grouped_dispatch, specs)
            return [s["handle"] for s in specs]

        for ci in range(n):
            submit_s2(ci, 0)
        for t in range(n_cycles):
            if shared_decode:
                timed("shared_decode", shared_decode_handles, self.inner, s2h)
            s1h = [None] * n
            for ci, pol in enumerate(self.cohorts):
                s2out[ci] = timed("s2_collect", pol.s2_collect, s2h[ci])
                lat[ci] = self._latents(s2out[ci])
                s1res[ci] = []
                s1h[ci] = submit_s1(ci, t, 1)
            s1h = flush_s1(s1h)
            for call in range(1, s1_calls + 1):
                nxt = [None] * n
                for ci, pol in enumerate(self.cohorts):
                    s1res[ci].append(timed("s1_collect", pol.s1_collect, s1h[ci]))
                    if call < s1_calls:
                        nxt[ci] = submit_s1(ci, t, call + 1)
                        continue
                    if on_cycle is not None:
                        on_cycle(ci, t, s2out[ci], s1res[ci])
                    if t + 1 < n_cycles:
                        # the cycle boundary is pipelined: the next S2 goes
                        # into the queue before the other cohorts' collects
                        submit_s2(ci, t + 1)
                if call < s1_calls:
                    nxt = flush_s1(nxt)
                s1h = nxt
