"""The port's "navdp" agent against the JAX package's on the CPU, at
tests/test_vn.py's small size (image 28, memory 2, predict 6, a 1-layer
decoder, 2 samples a replan; towers of 2 blocks, as
tests/test_torch_navdp_policy.py's `small_towers` builds them), the same
weights, and the agent's draws
replaced by JAX's (the key split a replan, x_init and the step noises as
JAX's policy draws them):

- the actions over three replan cycles (replan_every 3, a depth frame of
  another size resized nearest, the memory padded with the first frame):
  the waypoints and velocities within TRAJ_TOL;
- a VN pointgoal run (`VNPointGoalEvaluator`, tests/test_vn.py's slow
  navdp test) with each package's agent: the same per-episode records and
  metrics, the distances within TRAJ_TOL;
- `Agent.init` builds the agent on the CPU from model_settings, and its
  default draws come from its own generator, seeded by model_settings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internnav_tpu import configs as jconfigs
from internnav_tpu.agent.navdp_agent import NavDPAgent as JNavDPAgent
from internnav_tpu.evaluator import vn_evaluator as jvn
from internnav_tpu.model import get_config as jget_config
from internnav_tpu.model.basemodel import navdp as jnavdp
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.agent.base import Agent as TAgent
from internnav_tpu_torch.agent.navdp_agent import NavDPAgent
from internnav_tpu_torch.evaluator import vn_evaluator as tvn
from internnav_tpu_torch.model.basemodel import navdp as tnavdp
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from test_torch_navdp_policy import in_small_towers, small_towers
from test_torch_system1 import random_jax_params

torch.set_num_threads(2)
#: waypoints of trajectories denoised from identical draws, absolute
TRAJ_TOL = 1e-4
S, M, P = 28, 2, 6
SETTINGS = {"image_size": S, "memory_size": M, "predict_size": P, "temporal_depth": 1,
            "sample_num": 2, "replan_every": 3}


def tiny(get_config):
    c = get_config("navdp")
    c.memory_size, c.predict_size, c.temporal_depth, c.image_size = M, P, 1, S
    return c


@functools.lru_cache(maxsize=None)
@in_small_towers
def policies():
    """(JAX NavDPPolicy, the port's NavDPPolicy) on the same numpy weights;
    the JAX policy's jitted pointgoal inference is shared by the tests."""
    jm = jnavdp.NavDPNet(cfg=tiny(jget_config))
    z = lambda *shape: jnp.zeros(shape)  # noqa: E731
    shapes = jax.eval_shape(lambda k: jm.init(
        k, z(1, 3), z(1, S, S, 6), z(1, S, S, 7), z(1, M, S, S, 3), z(1, M, S, S, 1),
        z(1, P, 3), z(1, P, 3), jax.random.PRNGKey(1)), jax.random.PRNGKey(0))
    params = random_jax_params(shapes["params"], 8)
    net = tnavdp.NavDPNet(tiny(tmodel_zoo.get_config), image_size=S).eval()
    load_from_jax(net, params)
    return (jnavdp.NavDPPolicy(jm, params, tiny(jget_config)),
            tnavdp.NavDPPolicy(net, tiny(tmodel_zoo.get_config)))


def agents(seed=0):
    """The JAX agent, and the port's with its draw replaced by the JAX
    agent's: the key split a replan, x_init normal(sub) and the step noises
    normal(fold_in(sub, 1))."""
    jpol, tpol = policies()
    settings = dict(SETTINGS, seed=seed)
    jagent = JNavDPAgent(jconfigs.AgentCfg(model_name="navdp", model_settings=settings),
                         policy=jpol)
    tagent = NavDPAgent(tconfigs.AgentCfg(model_name="navdp", model_settings=settings),
                        policy=tpol)
    rng = [jax.random.PRNGKey(seed)]

    def draw(rows):
        rng[0], sub = jax.random.split(rng[0])
        return {"x_init": torch.from_numpy(np.array(jax.random.normal(sub, (rows, P, 3)))),
                "noises": torch.from_numpy(np.array(jax.random.normal(
                    jax.random.fold_in(sub, 1), (10, rows, P, 3))))}

    tagent.draw = draw
    return jagent, tagent


def frames(n, seed):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d_hw = (S, S) if i != 2 else (40, 36)  # one depth frame resized nearest
        out.append({"rgb": r.integers(0, 256, (S, S, 3)).astype(np.uint8),
                    "depth": r.uniform(0.2, 4.0, d_hw).astype(np.float32),
                    "pointgoal": np.asarray([2.0 - 0.1 * i, 0.3, 0.0], np.float32)})
    return out


def test_actions_over_replan_cycles_equal_jax():
    jagent, tagent = agents(seed=3)
    seen = []
    for i, o in enumerate(frames(8, 1)):
        with small_towers():  # JAX traces its inference at the first replan
            want = jagent.step([o])[0]
        got = tagent.step([o])[0]
        assert got["action"] == want["action"] == [1] and got["ideal_flag"]
        np.testing.assert_allclose(got["waypoint"], want["waypoint"], atol=TRAJ_TOL)
        np.testing.assert_allclose(got["velocity"], want["velocity"], atol=4 * TRAJ_TOL)
        seen.append(tuple(got["waypoint"]))
        assert len(tagent.rgb_memory) == min(i + 1, M)
    assert len(set(seen)) == len(seen)  # each step executes another delta
    jagent.reset()
    tagent.reset()
    assert tagent.plan == [] and tagent.rgb_memory == []


def test_vn_pointgoal_run_with_the_navdp_agent_equals_jax(tmp_path):
    """tests/test_vn.py's navdp run (one open episode, max_step 5) and one
    cluttered episode, with each package's evaluator and agent."""
    got = {}
    for side, cfgs, mod, agent in (("jax", jconfigs, jvn, 0), ("port", tconfigs, tvn, 1)):
        eps = [mod.VNEpisode(episode_id="0", start_xy=np.asarray([0.5, 3.0]),
                             goal_xy=np.asarray([2.0, 3.0]), geodesic=1.5),
               *mod.make_cluttered_episodes(n=1, seed=4)]
        cfg = cfgs.EvalCfg(agent=cfgs.AgentCfg(model_name="simple"),
                           env=cfgs.EnvCfg(env_type="fake",
                                           env_settings={"rgb_resolution": [S, S]}),
                           task=cfgs.TaskCfg(max_step=5), eval_type="vn_pointgoal",
                           output_dir=str(tmp_path / side))
        ev = mod.VNPointGoalEvaluator(cfg, episodes=eps, agent=agents(seed=5)[agent])
        with small_towers():
            got[side] = ev.eval_action()
    assert len(got["port"]) == len(got["jax"]) == 2
    for want, rec in zip(got["jax"], got["port"]):
        assert set(rec) == set(want)
        for k, v in want.items():
            if isinstance(v, float):
                assert rec[k] == pytest.approx(v, abs=TRAJ_TOL), k
            else:
                assert rec[k] == v, k
    assert got["port"][0]["TL"] > 0  # the agent moved


def test_agent_init_builds_on_the_cpu_and_draws_from_its_seed():
    cfg = tconfigs.AgentCfg(model_name="navdp", model_settings=dict(
        SETTINGS, device="cpu", seed=2))
    with small_towers():
        agent = TAgent.init(cfg)
    assert isinstance(agent, NavDPAgent) and agent.policy.device.type == "cpu"
    assert (agent.sample_num, agent.replan_every, agent.goal_mode) == (2, 3, "pointgoal")
    assert agent.policy.cfg.memory_size == M and agent.image_size == S
    o = frames(1, 3)[0]
    first = agent.step([o])[0]["waypoint"]
    with small_towers():
        again = TAgent.init(cfg)
    again.policy.net.load_state_dict(agent.policy.net.state_dict())
    assert again.step([o])[0]["waypoint"] == first
    assert NavDPAgent(tconfigs.AgentCfg(model_name="navdp", model_settings=dict(
        SETTINGS, device="cpu")), policy=agent.policy).generator.initial_seed() == 0
