"""InternutopiaEnv — the Isaac Sim / InternUtopia VLN-PE environment.

Reference parity: internnav/env/internutopia_env.py:13-83 — builds episodes
via the resumable loader, generates one task config per path_key, wraps the
InternUtopia vectorized Env (optionally Ray-distributed), and passes
per-env `{robot: {controller: args}}` action dicts straight through.

Backends:
- "internutopia": the real Isaac Sim path. Import-guarded exactly like the
  reference (:16-26) — raises RuntimeError with the same guidance when the
  InternUtopia stack is absent. The extension registrations (VLNEvalTask,
  VLNCamera, VLNH1Robot, controllers) happen inside `import_extensions`.
- "fake_physics": FakePhysicsVecEnv — same vec-env interface and
  substep/finish_action protocol, kinematic physics. This is the testable
  backend (no simulator in this environment) and the contract the Isaac
  adapter is written against.

Copy of internnav_tpu/env/internutopia/env.py,
kept in the port so that it imports nothing of the JAX package, except
that env_settings["device"] names where the fake_physics backend's loco
actors run (use_loco): the GPU when it is absent, "cpu" when asked for.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from internnav_tpu_torch.configs.evaluator import EnvCfg, TaskCfg
from internnav_tpu_torch.env.base import Env
from internnav_tpu_torch.env.episodes import (
    ResumableEpisodeLoader,
    load_r2r_episodes,
    shard_episodes,
)
from internnav_tpu_torch.env.task_gen import generate_vln_episodes


def import_extensions() -> None:
    """Register the Isaac-side extensions with InternUtopia's registries
    (reference internutopia_extension/__init__.py pattern). Only callable
    when internutopia is importable; the fake_physics backend embeds the
    same task semantics natively."""
    from internnav_tpu_torch.env.internutopia import isaac_ext

    isaac_ext.register()


@Env.register("internutopia")
class InternutopiaEnv(Env):
    def __init__(self, env_cfg: EnvCfg, task_cfg: Optional[TaskCfg] = None,
                 episodes=None):
        super().__init__(env_cfg, task_cfg)
        s = env_cfg.env_settings
        backend = s.get("backend", "internutopia")

        if episodes is None:
            episodes = self._load_episodes(env_cfg)
        store = s.get("resume_store")
        if store is not None:
            loader = ResumableEpisodeLoader(episodes, store=store,
                                            retry_list=s.get("retry_list", []))
            episodes = loader.pending()
        self.episodes = episodes
        self.task_specs = generate_vln_episodes(episodes, self.task_cfg)
        if len(self.task_specs) == 0 and backend != "fake_physics":
            # reference behavior (:40-42); the fake backend instead reports
            # every slot terminated so resume-twice eval loops exit cleanly
            print("No episodes found for the given configuration.")
            raise SystemExit(0)

        if backend == "fake_physics":
            from internnav_tpu_torch.env.internutopia.vec_env import FakePhysicsVecEnv

            kw = dict(
                env_num=env_cfg.env_num,
                robot_name=self.task_cfg.robot_name,
                rgb_hw=tuple(self.task_cfg.camera_resolution),
                use_loco=bool(s.get("use_loco", False)),
                one_step_stand_still=self.task_cfg.one_step_stand_still,
                device=s.get("device"),
            )
            dist = s.get("distribution_config")
            if dist and int(dist.get("proc_num", 1)) > 1:
                # Ray-equivalent sim process distribution (reference
                # internutopia_env.py:54-56): proc_num workers, env_num
                # envs each, task specs dealt round-robin
                from internnav_tpu_torch.env.internutopia.proc_pool import (
                    ProcessVecEnv,
                    make_fake_physics_env,
                )

                n = int(dist["proc_num"])
                shards = [self.task_specs[i::n] for i in range(n)]
                self.env = ProcessVecEnv(
                    make_fake_physics_env,
                    shard_args=[(sh,) for sh in shards],
                    shard_kwargs=[dict(kw) for _ in range(n)],
                    env_num_per_proc=env_cfg.env_num,
                )
            else:
                self.env = FakePhysicsVecEnv(self.task_specs, **kw)
            self.env_num = self.env.env_num  # pool total = proc_num * env_num
        else:
            try:
                from internutopia.core.config import Config, SimConfig
                from internutopia.core.vec_env import Env as UtopiaEnv
            except ImportError as e:  # same message as the reference
                raise RuntimeError(
                    "InternUtopia modules could not be imported. "
                    "Make sure both repositories are installed and on PYTHONPATH."
                ) from e
            import_extensions()
            from internnav_tpu_torch.env.internutopia import isaac_ext

            sim_settings = dict(s.get("sim_settings", {}))
            config = Config(
                simulator=SimConfig(**sim_settings),
                env_num=env_cfg.env_num,
                env_offset_size=s.get("offset_size", 10.0),
                task_configs=[isaac_ext.task_cfg_from_spec(spec)
                              for spec in self.task_specs],
            )
            if "distribution_config" in s:
                from internutopia.core.config.distribution import RayDistributionCfg

                config = config.distribute(RayDistributionCfg(**s["distribution_config"]))
            self.env = UtopiaEnv(config)

    @staticmethod
    def _load_episodes(env_cfg: EnvCfg):
        s = env_cfg.env_settings
        ds = s.get("dataset", {})
        base = ds.get("base_data_dir")
        if not base:
            raise ValueError("env_settings['dataset']['base_data_dir'] required")
        eps = []
        import os

        for split in ds.get("split_data_types", ["val_unseen"]):
            for ext in (".json.gz", ".json"):
                p = f"{base}/{split}/{split}{ext}"
                if os.path.exists(p):
                    eps.extend(load_r2r_episodes(
                        p, split, ds.get("filter_stairs", True),
                        ds.get("max_episodes")))
                    break
        return shard_episodes(eps, s.get("rank", 0), s.get("world_size", 1))

    # -------------------------------------------- vec-env surface (5-tuple)
    def reset(self, reset_index: Optional[List[int]] = None):
        return self.env.reset(reset_index)

    def step(self, actions: List[Any]):
        return self.env.step(actions)

    def get_observation(self) -> List[Dict[str, Any]]:
        return self.env.get_observations()

    def render_frames(self):
        """Side-effect-free capture passthrough (backends that can't render
        outside the macro-step protocol simply don't expose it)."""
        fn = getattr(self.env, "render_frames", None)
        return fn() if fn is not None else None

    @property
    def is_running(self) -> bool:
        return True

    @property
    def exhausted(self) -> bool:
        return getattr(self.env, "exhausted", False)

    def close(self) -> None:
        self.env.close()
        self._is_running = False
