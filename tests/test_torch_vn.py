"""The port's VN pointgoal evaluator and path planners against the JAX
package's, on the CPU: `make_cluttered_episodes` and `VNEpisode.blocked`
exactly equal; `VNPointGoalEvaluator` with an oracle waypoint agent (and a
straight-ahead one that collides) gives the JAX run's per-episode records
and metrics; the planners' grid transforms, obstacle inflation, continuous
A* paths and discrete action plans on seeded grids exactly equal.

The VN run with the standalone "navdp" agent (tests/test_vn.py's slow
test) is tests/test_torch_navdp_agent.py's.
"""

import numpy as np
import pytest

from internnav_tpu import configs as jconfigs
from internnav_tpu.agent.base import Agent as JAgent
from internnav_tpu.evaluator import vn_evaluator as jvn
from internnav_tpu.evaluator.utils import planners as jplan
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.agent.base import Agent as TAgent
from internnav_tpu_torch.evaluator import vn_evaluator as tvn
from internnav_tpu_torch.evaluator.utils import planners as tplan


def test_cluttered_episodes_equal_jax():
    for seed in (0, 1, 7):
        t, j = tvn.make_cluttered_episodes(n=4, seed=seed), jvn.make_cluttered_episodes(n=4,
                                                                                        seed=seed)
        for te, je in zip(t, j):
            assert (te.episode_id, te.geodesic, te.resolution) == \
                (je.episode_id, je.geodesic, je.resolution)
            for name in ("start_xy", "goal_xy", "occupancy", "origin"):
                np.testing.assert_array_equal(getattr(te, name), getattr(je, name))
            assert not te.blocked(te.start_xy) and not te.blocked(te.goal_xy)
            pts = np.random.default_rng(seed).uniform(-1, 7, (200, 2))
            assert [te.blocked(p) for p in pts] == [je.blocked(p) for p in pts]


def oracle(base, step_m=0.3):
    """An agent stepping straight to the pointgoal, at most step_m a step
    (tests/test_vn.py's OracleAgent), built on `base`."""

    class Oracle(base):
        def __init__(self):
            pass

        def reset(self, reset_index=None):
            pass

        def step(self, obs):
            goal = np.asarray(obs[0]["pointgoal"])
            step = goal[:2]
            n = np.linalg.norm(step)
            if n > step_m:
                step = step / n * step_m
            return [{"action": [1], "waypoint": [float(step[0]), float(step[1]), 0.05]}]

    return Oracle()


def vn_cfg(cfgs, out_dir, max_step):
    return cfgs.EvalCfg(agent=cfgs.AgentCfg(model_name="simple"),
                        env=cfgs.EnvCfg(env_type="fake",
                                        env_settings={"rgb_resolution": [32, 32]}),
                        task=cfgs.TaskCfg(max_step=max_step), eval_type="vn_pointgoal",
                        eval_settings={"success_radius": 0.4}, output_dir=str(out_dir))


@pytest.mark.parametrize("step_m", [0.3, 0.9], ids=["oracle", "long_strides"])
def test_vn_evaluator_equals_jax(tmp_path, step_m):
    """One open episode and the cluttered ones: per-episode records and the
    metrics equal; the oracle reaches the open goal; long strides through
    the clutter collide."""
    got = {}
    for side, cfgs, mod, base in (("jax", jconfigs, jvn, JAgent), ("port", tconfigs, tvn, TAgent)):
        eps = [mod.VNEpisode(episode_id="open", start_xy=np.asarray([0.5, 3.0]),
                             goal_xy=np.asarray([4.0, 3.0]), geodesic=3.5),
               *mod.make_cluttered_episodes(n=3, seed=2)]
        ev = mod.VNPointGoalEvaluator(vn_cfg(cfgs, tmp_path / side, 40), episodes=eps,
                                      agent=oracle(base, step_m))
        records = ev.eval_action()
        metrics = ev.eval()
        got[side] = (records, {k: v for k, v in metrics.items() if k != "wall_clock_s"})
    assert got["port"] == got["jax"]
    records = got["port"][0]
    if step_m == 0.3:
        assert records[0]["success"] == 1.0 and records[0]["spl"] > 0.9
    else:
        assert any(r["collided"] for r in records)


# -------------------------------------------------------------- planners
def grid(seed, size=40, n=12):
    r = np.random.default_rng(seed)
    occ = np.zeros((size, size), bool)
    for _ in range(n):
        i, j = r.integers(4, size - 4, 2)
        k = int(r.integers(1, 4))
        occ[i - k:i + k, j - k:j + k] = True
    occ[:4, :4] = occ[-5:, -5:] = False
    return occ


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planners_equal_jax(seed):
    occ = grid(seed)
    origin, res = (-1.0, 0.5), 0.1
    r = np.random.default_rng(seed)
    for xy in r.uniform(-2, 4, (20, 2)):
        ij = tplan.world_to_grid(xy, origin, res)
        assert ij == jplan.world_to_grid(xy, origin, res)
        assert tplan.grid_to_world(ij, origin, res) == jplan.grid_to_world(ij, origin, res)
    for radius in (0, 1, 3):
        np.testing.assert_array_equal(tplan.inflate_obstacles(occ, radius),
                                      jplan.inflate_obstacles(occ, radius))
    start = (origin[0] + 0.1, origin[1] + 0.1)
    goals = [(origin[0] + 3.6, origin[1] + 3.6), *r.uniform(-0.5, 3.0, (3, 2)) + origin]
    paths = 0
    for goal in goals:
        for kw in ({}, {"inflate_radius_m": 0.1, "angle_cost": 0.5}):
            tp = tplan.AStarPlanner(occ, origin, res, **kw).plan(start, goal)
            jp = jplan.AStarPlanner(occ, origin, res, **kw).plan(start, goal)
            assert (tp is None) == (jp is None)
            if tp is not None:
                np.testing.assert_array_equal(tp, jp)
                paths += 1
        ta = tplan.plan_and_get_actions_discrete(occ, start, 0.3, goal, origin=origin,
                                                 resolution=res)
        ja = jplan.plan_and_get_actions_discrete(occ, start, 0.3, goal, origin=origin,
                                                 resolution=res)
        assert ta == ja
        assert ta is None or set(ta) <= {1, 2, 3}
    assert paths >= 2
    tc = tplan.plan_and_get_actions_continuous(occ, start, goals[0], origin=origin,
                                               resolution=res)
    jc = jplan.plan_and_get_actions_continuous(occ, start, goals[0], origin=origin,
                                               resolution=res)
    np.testing.assert_array_equal(tc, jc)
