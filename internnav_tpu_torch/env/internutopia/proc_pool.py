"""Simulator process pool — the Ray-distribution equivalent.

Reference parity: InternUtopia's vectorized env distributes simulator
instances across worker processes via RayDistributionCfg (reference
internnav/env/internutopia_env.py:54-56; proc_num x env_num in
vln_default_config.py:321-326). Here the same fan-out runs on
`multiprocessing` (spawn): each worker owns a vec-env shard built from a
picklable factory, the parent scatters actions / gathers the 5-tuple, so
slow host-side physics (50 substeps per macro action) runs in parallel
across cores while the policy batch-steps on the GPU.

The pooled object speaks the same internutopia vec-env surface as
FakePhysicsVecEnv / Isaac (`reset(reset_index) -> (obs, infos)`,
`step(actions) -> (obs, reward, terminated, truncated, info)`), so
InternutopiaEnv and VLNPEEvaluator are oblivious to the distribution.
The start method stays `spawn`: a CUDA context cannot cross a fork, and a
worker whose envs run the loco actor on the GPU opens its own.

Copy of internnav_tpu/env/internutopia/proc_pool.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def _worker(conn, factory, factory_args, factory_kwargs):
    env = factory(*factory_args, **factory_kwargs)
    try:
        while True:
            cmd, payload = conn.recv()
            if cmd == "reset":
                conn.send(env.reset(payload))
            elif cmd == "step":
                conn.send(env.step(payload))
            elif cmd == "get_observations":
                conn.send(env.get_observations())
            elif cmd == "exhausted":
                conn.send(getattr(env, "exhausted", False))
            elif cmd == "attr":
                conn.send(getattr(env, payload, None))
            elif cmd == "close":
                env.close()
                conn.send(None)
                break
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        conn.close()


class ProcessVecEnv:
    """N worker processes x M envs each, presented as one vec env of N*M."""

    def __init__(self, factory: Callable, shard_args: Sequence[tuple],
                 shard_kwargs: Optional[Sequence[dict]] = None,
                 env_num_per_proc: int = 1, start_method: str = "spawn"):
        ctx = mp.get_context(start_method)
        self.proc_num = len(shard_args)
        self.env_per = env_num_per_proc
        self.env_num = self.proc_num * env_num_per_proc
        shard_kwargs = shard_kwargs or [{}] * self.proc_num
        self._conns, self._procs = [], []
        for args, kwargs in zip(shard_args, shard_kwargs):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker,
                            args=(child, factory, args, kwargs), daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)

    # ----------------------------------------------------------- scatter/gather
    def _split(self, items: Sequence[Any]) -> List[List[Any]]:
        return [list(items[i * self.env_per:(i + 1) * self.env_per])
                for i in range(self.proc_num)]

    def reset(self, reset_index: Optional[List[int]] = None):
        if reset_index is None:
            per = [None] * self.proc_num
        else:
            per = [[] for _ in range(self.proc_num)]
            for gi in reset_index:
                per[gi // self.env_per].append(gi % self.env_per)
            per = [idx if idx else None for idx in per]
        live = [i for i in range(self.proc_num)
                if reset_index is None or per[i] is not None]
        for i in live:
            self._conns[i].send(("reset", per[i]))
        results: Dict[int, Tuple] = {i: self._conns[i].recv() for i in live}
        obs: List[Any] = []
        infos: List[Any] = []
        for i in range(self.proc_num):
            if i in results:
                o, inf = results[i]
                obs.extend(o)
                infos.extend(inf)
            else:
                self._conns[i].send(("get_observations", None))
                obs.extend(self._conns[i].recv())
                infos.extend([None] * self.env_per)
        return obs, infos

    def step(self, actions: Sequence[Any]):
        assert len(actions) == self.env_num, (len(actions), self.env_num)
        for conn, chunk in zip(self._conns, self._split(actions)):
            conn.send(("step", chunk))
        obs, rew, term, trunc, infos = [], [], [], [], []
        for conn in self._conns:
            o, r, t, tr, inf = conn.recv()
            obs.extend(o)
            rew.extend(r)
            term.extend(t)
            trunc.extend(tr)
            infos.extend(inf)
        return obs, rew, term, trunc, infos

    def get_observations(self):
        for conn in self._conns:
            conn.send(("get_observations", None))
        out: List[Any] = []
        for conn in self._conns:
            out.extend(conn.recv())
        return out

    @property
    def exhausted(self) -> bool:
        for conn in self._conns:
            conn.send(("exhausted", None))
        return all(conn.recv() for conn in self._conns)

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("close", None))
                conn.recv()
            except (BrokenPipeError, EOFError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()


def make_fake_physics_env(specs, **kwargs):
    """Picklable worker factory for FakePhysicsVecEnv shards."""
    from internnav_tpu_torch.env.internutopia.vec_env import FakePhysicsVecEnv

    return FakePhysicsVecEnv(specs, **kwargs)
