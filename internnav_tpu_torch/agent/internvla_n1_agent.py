"""InternVLA-N1 dual-system agents — System-2 planner + System-1 actor.

Port of internnav_tpu/agent/internvla_n1_agent.py:
- `InternVLAN1Agent` (registered "internvla_n1", built from an `AgentCfg`
  as the JAX agent is, its policy by `_build_n1_policy` unless one is
  handed in) and its `S2Mailbox`: an optional background System-2 thread
  fed through a latest-wins mailbox, the 'partial_async' and 'sync'
  re-planning schedules, the look-down protocol, and System-1 on the
  latent with the pixel-goal memory frame + current frame. The System-2
  thread and `step`'s System-1 take turns on the policy (`policy_lock`):
  one policy on the card has one set of decode buffers and graphs, and
  the agent server runs each request on a thread of its own. A plan still
  in flight when the episode is reset is dropped when it arrives (each
  request carries its episode's number);
- `BatchedInternVLAN1Agent` (registered "internvla_n1_batched"): B episode
  slots stepped through one batched System-2 call and one batched System-1
  denoise a macro-step (`serving.BatchedN1Policy`), with the JAX agent's
  per-slot schedule, and `step_coroutine`, the form the pipelined
  evaluator interleaves across cohorts, its policy built by
  `_build_n1_policy` (from `AgentCfg.ckpt_path` when set). With the
  navdp System-1 it hands the policy [memory, current] RGBD pairs per
  slot: depth x depth_scale clamped to depth_clip_m (zeros where the
  observation has none), the current depth standing in for the memory
  frame's, as in the JAX agent.

Deviation: the JAX agent turns any exception in System-2 into a STOP
action, which hides a kernel or device failure. Here an exception raised
by `s2_step` — in the background thread or inline — is re-raised by
`step()`, so the caller (e.g. the HTTP server, as a 500) sees it; the
agent serves the next step.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.model.utils.vln_utils import S2Input, S2Output

LOOK_DOWN_ACTION = 5
S2Result = Union[S2Output, Exception]
#: (the request's episode number, its result): what the System-2 thread publishes
S2Published = Tuple[int, S2Result]


def _build_n1_policy(cfg: AgentCfg, settings: Dict[str, Any]):
    """The dual-system agents' policy (the JAX package's `_build_n1_policy`),
    through `realworld.serve.build_policy`: model_settings["profile"]'s
    formats ("realtime" by default; model_settings["weight_dtype"], "int8"
    or "int4", and ["kv_dtype"] stand in for the profile's where given), at
    7B dims or model_settings["config"] (W8A16 decode through its
    `decode_act_dtype`);
    from cfg.ckpt_path when it is set (a native directory keeps its recorded
    weight dtype, ROADMAP F4; a reference-format checkpoint is quantized on
    load under an int8 profile; a path that does not exist raises: there is
    no fallback to random weights), else random weights (seed 0). On
    model_settings["device"]: the GPU by default, "cpu" when asked for."""
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.realworld.serve import build_policy

    dev = settings.get("device")
    device = torch.device("cpu") if dev == "cpu" else require_cuda(dev)
    return build_policy(settings.get("profile", "realtime"), device=device,
                        ckpt=cfg.ckpt_path or None,
                        system1=settings.get("system1"),
                        config=settings.get("config"),
                        weight_dtype=settings.get("weight_dtype"),
                        kv_dtype=settings.get("kv_dtype"))


class S2Mailbox:
    """SPSC mailbox: latest-wins request slot + result slot."""

    def __init__(self):
        self._req: "queue.Queue[S2Input]" = queue.Queue(maxsize=1)
        self._res: "queue.Queue[S2Published]" = queue.Queue(maxsize=1)

    @staticmethod
    def _replace(q: queue.Queue, item) -> None:
        try:  # the latest item wins
            q.get_nowait()
        except queue.Empty:
            pass
        q.put(item)

    def submit(self, item: S2Input) -> None:
        self._replace(self._req, item)

    def take_request(self, timeout: float = 0.1) -> Optional[S2Input]:
        try:
            return self._req.get(timeout=timeout)
        except queue.Empty:
            return None

    def publish(self, out: S2Published) -> None:
        self._replace(self._res, out)

    def poll(self) -> Optional[S2Published]:
        try:
            return self._res.get_nowait()
        except queue.Empty:
            return None

    def wait(self) -> S2Published:
        return self._res.get()


@Agent.register("internvla_n1")
class InternVLAN1Agent(Agent):
    """Single-stream dual-system agent over an `InternVLAN1Policy`.

    cfg.model_settings (the JAX agent's keys and defaults): infer_mode
    ("partial_async": re-plan when sys2_max_forward_step actions ran since
    the last plan or nothing is left to run; "sync": whenever the action
    queue is empty), sys2_max_forward_step (8), max_local_steps (actions
    taken from one System-1 call, 4), depth_scale (raw depth units →
    metres, 10.0), depth_clip_m (5.0), continuous_traj (True: actions from
    the mean trajectory; False: one sampled trajectory's chunks), async_s2
    (True: System-2 in a background thread while the robot runs its queued
    actions), and those of `_build_n1_policy` where no policy is given."""

    def __init__(self, cfg: AgentCfg, policy=None):
        super().__init__(cfg)
        settings = cfg.model_settings or {}
        if policy is None:
            policy = _build_n1_policy(cfg, settings)
        self.policy = policy
        self.mode = settings.get("infer_mode", "partial_async")
        if self.mode not in ("partial_async", "sync"):
            raise ValueError(f"unknown infer_mode {self.mode!r}")
        self.sys2_max_forward_step = int(settings.get("sys2_max_forward_step", 8))
        self.max_local_steps = int(settings.get("max_local_steps", 4))
        self.depth_scale = float(settings.get("depth_scale", 10.0))
        self.depth_clip_m = float(settings.get("depth_clip_m", 5.0))
        self.continuous_traj = bool(settings.get("continuous_traj", True))
        self.async_s2 = bool(settings.get("async_s2", True))
        self.mailbox = S2Mailbox()
        self.policy_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.reset()
        if self.async_s2:
            self._start_s2_thread()

    @classmethod
    def with_policy(cls, policy, **settings) -> "InternVLAN1Agent":
        """The agent over a built policy, with these model_settings."""
        return cls(AgentCfg(model_name="internvla_n1", model_settings=settings), policy)

    # ------------------------------------------------------------ lifecycle
    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        """A new episode (the one stream; reset_index is the evaluators'
        argument)."""
        with self.policy_lock:
            self.policy.reset()
        self.action_queue: List[int] = []
        self.latent = None
        self.last_trajectory: Optional[np.ndarray] = None
        self.memory_frame: Optional[np.ndarray] = None
        self.steps_since_s2 = 0
        self.pending_s2 = False
        self.force_look_down = False
        self._episode = getattr(self, "_episode", -1) + 1

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _start_s2_thread(self) -> None:
        def run():
            while not self._stop.is_set():
                req = self.mailbox.take_request(timeout=0.1)
                if req is None:
                    continue
                try:
                    out: S2Result = self._infer_s2(req)
                except Exception as e:  # handed to step(), which re-raises it
                    out = e
                self.mailbox.publish((req.idx, out))

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- helpers
    def _infer_s2(self, req: S2Input) -> S2Output:
        with self.policy_lock:
            return self.policy.s2_step(req.rgb, req.instruction, look_down=req.look_down)

    def _take_s2(self, block: bool) -> Optional[S2Result]:
        """This episode's System-2 result from the mailbox (waiting for it
        with block), or None; a result of an earlier episode is dropped."""
        while True:
            got = self.mailbox.wait() if block else self.mailbox.poll()
            if got is None:
                return None
            idx, res = got
            if idx == self._episode:
                return res

    def should_infer_s2(self) -> bool:
        if self.force_look_down:
            return True
        if self.mode == "sync":
            return len(self.action_queue) == 0
        # re-plan when the budget is spent or nothing is queued
        return (self.steps_since_s2 >= self.sys2_max_forward_step
                or (len(self.action_queue) == 0 and self.latent is None))

    def _preprocess_depth(self, depth: np.ndarray) -> np.ndarray:
        d = np.asarray(depth, np.float32) * self.depth_scale
        return np.clip(d, 0.0, self.depth_clip_m)

    def _consume_s2(self, out: S2Result, obs: Dict[str, Any]) -> None:
        if isinstance(out, Exception):
            raise out
        if out.output_action:
            acts = list(out.output_action)
            if LOOK_DOWN_ACTION in acts:
                self.force_look_down = True
                acts = [a for a in acts if a != LOOK_DOWN_ACTION]
            self.action_queue.extend(acts)
            self.latent = None
        if out.output_latent is not None:
            self.latent = out.output_latent
            self.memory_frame = np.asarray(obs["rgb"])
        self.steps_since_s2 = 0

    def _run_s1(self, obs: Dict[str, Any]) -> None:
        rgb = np.asarray(obs["rgb"])
        mem = self.memory_frame if self.memory_frame is not None else rgb
        depth = obs.get("depth")
        depth2 = None
        if depth is not None:
            d = self._preprocess_depth(depth)
            if d.ndim == 2:
                d = d[..., None]
            depth2 = np.stack([d, d])[None]
        with self.policy_lock:
            s1 = self.policy.s1_step_latent(np.stack([mem, rgb])[None], depth2, self.latent,
                                            continuous_traj=self.continuous_traj)
        self.last_trajectory = s1.trajectory
        self.action_queue.extend(s1.idx[: self.max_local_steps])

    # ------------------------------------------------------------------ api
    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        if len(obs) != 1:
            raise ValueError(f"the dual-system agent is single-stream, got {len(obs)} observations")
        o = obs[0]
        instruction = o.get("instruction_text") or o.get("instruction", "")
        if not isinstance(instruction, str):
            instruction = " ".join(map(str, np.asarray(instruction).ravel().tolist()))
        if self.should_infer_s2():
            req = S2Input(rgb=np.asarray(o["rgb"]), depth=o.get("depth"),
                          instruction=instruction, look_down=self.force_look_down,
                          idx=self._episode)
            self.force_look_down = False
            if self.async_s2:
                self.mailbox.submit(req)
                self.pending_s2 = True
            else:
                self._consume_s2(self._infer_s2(req), o)

        if self.async_s2 and self.pending_s2:
            # block only when there is nothing else to execute
            res = self._take_s2(block=not self.action_queue and self.latent is None)
            if res is not None:
                self.pending_s2 = False
                self._consume_s2(res, o)

        if not self.action_queue and self.latent is not None:
            self._run_s1(o)

        action = self.action_queue.pop(0) if self.action_queue else 0
        self.steps_since_s2 += 1
        out: Dict[str, Any] = {"action": [int(action)], "ideal_flag": True}
        if self.last_trajectory is not None:
            out["trajectory"] = self.last_trajectory
        return [out]


class _DualState:
    """Per-slot dual-system bookkeeping (mirrors the single agent)."""

    __slots__ = ("action_queue", "latent", "memory_frame", "steps_since_s2",
                 "last_trajectory", "force_look_down")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.action_queue: List[int] = []
        self.latent = None
        self.memory_frame: Optional[np.ndarray] = None
        self.steps_since_s2 = 10**9  # force S2 on the first step
        self.last_trajectory: Optional[np.ndarray] = None
        self.force_look_down = False


@Agent.register("internvla_n1_batched")
class BatchedInternVLAN1Agent(Agent):
    """Batched dual-system agent: B episode slots step through ONE S2 call
    and ONE batched S1 denoise per macro-step (serving.BatchedN1Policy).
    Per-slot scheduling is the JAX agent's: InternVLAN1Agent's
    partial_async mode with synchronous S2 ('sync' re-plans whenever a
    slot's queue is empty).

    policy=None builds the policy with `_build_n1_policy`: the
    model_settings["profile"]'s formats ("realtime" by default), from
    cfg.ckpt_path when set, else random 7B weights; on the GPU unless
    model_settings["device"] is "cpu"."""

    def __init__(self, cfg: AgentCfg, policy=None):
        super().__init__(cfg)
        settings = cfg.model_settings or {}
        self.batch_size = int(settings.get("batch_size", 8))
        if policy is None:
            from internnav_tpu_torch.model.basemodel.internvla_n1.serving import BatchedN1Policy

            policy = BatchedN1Policy(_build_n1_policy(cfg, settings), self.batch_size,
                                     seed=int(settings.get("seed", 0)))
        self.policy = policy
        self.mode = settings.get("infer_mode", "partial_async")
        self.sys2_max_forward_step = int(settings.get("sys2_max_forward_step", 8))
        self.max_local_steps = int(settings.get("max_local_steps", 4))
        self.max_new_tokens = int(settings.get("max_new_tokens", 128))
        self.continuous_traj = bool(settings.get("continuous_traj", True))
        self.num_sample_trajs = int(settings.get("num_sample_trajs", 32))
        self.depth_scale = float(settings.get("depth_scale", 10.0))
        self.depth_clip_m = float(settings.get("depth_clip_m", 5.0))
        self.states = [_DualState() for _ in range(self.batch_size)]
        self._instructions = [""] * self.batch_size
        #: optional serving.SharedDecodePool — when set (by a multi-cohort
        #: scheduler), S2 submits prefill-only calls and the pool batches
        #: every cohort's greedy decode into one grouped decode (one
        #: decoder weight stream per token for all cohorts)
        self.decode_pool = None
        #: optional serving.SharedS1Pool — when set, System-1 denoises are
        #: prepared per cohort and dispatched as ONE grouped denoise for
        #: every pooled cohort (serving.s1_grouped_dispatch)
        self.s1_pool = None

    # ------------------------------------------------------------ lifecycle
    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        ids = range(self.batch_size) if reset_index is None else reset_index
        for i in ids:
            self.states[i].reset()
            self.policy.reset_slot(i, self._instructions[i])

    def close(self) -> None:
        pass

    # -------------------------------------------------------------- helpers
    def _should_infer_s2(self, st: _DualState) -> bool:
        if self.mode == "sync":
            return len(st.action_queue) == 0
        return (st.steps_since_s2 >= self.sys2_max_forward_step
                or (len(st.action_queue) == 0 and st.latent is None))

    def _consume_s2(self, st: _DualState, out: S2Output, rgb: np.ndarray) -> None:
        if out.output_action:
            acts = [a for a in out.output_action if a != LOOK_DOWN_ACTION]
            st.action_queue.extend(acts)
            st.latent = None
        if out.output_latent is not None:
            st.latent = out.output_latent
            st.memory_frame = np.asarray(rgb)
        st.steps_since_s2 = 0

    def _rgbd_pairs(self, obs, s1_ids, cur):
        """(rgb (N, 2, H, W, 3), depth (N, 2, H, W, 1)): each slot's memory
        frame (its current frame when it has none) and current frame, and
        its current depth x depth_scale clamped to [0, depth_clip_m] (zeros
        without one) for both frames."""
        rgb_pairs, depth_pairs = [], []
        for k, i in enumerate(s1_ids):
            mem = self.states[i].memory_frame
            rgb_pairs.append(np.stack([cur[k] if mem is None else mem, cur[k]]))
            d = obs[i].get("depth")
            if d is None:
                d = np.zeros(cur[k].shape[:2] + (1,), np.float32)
            d = np.clip(np.asarray(d, np.float32) * self.depth_scale, 0.0, self.depth_clip_m)
            if d.ndim == 2:
                d = d[..., None]
            depth_pairs.append(np.stack([d, d]))
        return np.stack(rgb_pairs), np.stack(depth_pairs)

    # ------------------------------------------------------------------ api
    def step_coroutine(self, obs: List[Dict[str, Any]]):
        """Generator form of `step`: yields where a device submit has
        returned (the work queued on the device, not finished), letting a
        scheduler run another cohort's host work, or simulator stepping,
        meanwhile. Drive with `next()` until StopIteration, whose value is
        the step result. `step()` runs it to completion."""
        assert len(obs) == self.batch_size, (
            f"expected {self.batch_size} slots, got {len(obs)}")
        for i, o in enumerate(obs):
            instr = o.get("instruction_text") or o.get("instruction", "")
            if not isinstance(instr, str):
                instr = " ".join(map(str, np.asarray(instr).ravel().tolist()))
            if instr and instr != self.policy.slots[i].instruction:
                self.policy.slots[i].instruction = instr
                self._instructions[i] = instr

        # ---- batched S2 for every slot whose schedule demands it
        s2_ids = [i for i, st in enumerate(self.states) if self._should_infer_s2(st)]
        if s2_ids:
            imgs = np.stack([np.asarray(obs[i]["rgb"]) for i in s2_ids])
            if self.decode_pool is not None:
                handle = self.policy.s2_prefill_submit(
                    imgs, max_new_tokens=self.max_new_tokens, slot_ids=s2_ids)
                self.decode_pool.add(handle)
                yield  # prefill queued; the pool gathers the other cohorts'
                # the first cohort to resume runs the grouped decode of
                # every pooled prefill (the scheduler has advanced all
                # cohorts past their submits by now)
                self.decode_pool.flush()
            else:
                handle = self.policy.s2_submit(
                    imgs, max_new_tokens=self.max_new_tokens, slot_ids=s2_ids)
                yield  # S2 prefill and decode queued
            outs = self.policy.s2_collect(handle)
            for i, out in zip(s2_ids, outs):
                self._consume_s2(self.states[i], out, np.asarray(obs[i]["rgb"]))

        # ---- batched S1 for every slot holding a latent and no queue;
        # only the CURRENT frames are shipped — each slot's memory frame
        # (and its DINOv2 features) stays on the device in the policy
        s1_ids = [i for i, st in enumerate(self.states)
                  if not st.action_queue and st.latent is not None]
        if s1_ids:
            system1 = getattr(getattr(self.policy, "cfg", None), "system1", "") or ""
            cur = np.stack([np.asarray(obs[i]["rgb"]) for i in s1_ids])
            lat = torch.cat([torch.as_tensor(self.states[i].latent, device=self.policy.device)
                             for i in s1_ids], dim=0)
            rgbd = {}
            if "navdp" in system1:
                # the NavDP head takes explicit [memory, current] RGBD pairs
                cur, rgbd["depth"] = self._rgbd_pairs(obs, s1_ids, cur)
            if self.s1_pool is not None:
                spec = self.policy.s1_prepare(
                    cur, lat, num_sample_trajs=self.num_sample_trajs, slot_ids=s1_ids, **rgbd)
                self.s1_pool.add(spec)
                yield  # uploads queued; the pool gathers the other cohorts' denoises
                # the first cohort to resume dispatches the grouped denoise
                # of every pooled spec
                self.s1_pool.flush()
                h1 = spec["handle"]
            else:
                h1 = self.policy.s1_submit(
                    cur, lat, num_sample_trajs=self.num_sample_trajs, slot_ids=s1_ids, **rgbd)
                yield  # S1 denoise queued
            s1_outs = self.policy.s1_collect(h1)
            for i, s1 in zip(s1_ids, s1_outs):
                st = self.states[i]
                st.last_trajectory = s1.trajectory
                st.action_queue.extend(s1.idx[: self.max_local_steps])

        # ---- pop one action per slot
        result: List[Dict[str, Any]] = []
        for st in self.states:
            action = st.action_queue.pop(0) if st.action_queue else 0
            st.steps_since_s2 += 1
            out: Dict[str, Any] = {"action": [int(action)], "ideal_flag": True}
            if st.last_trajectory is not None:
                out["trajectory"] = st.last_trajectory
            result.append(out)
        return result

    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        gen = self.step_coroutine(obs)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value
