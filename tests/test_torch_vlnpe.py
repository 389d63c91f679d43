"""The port's VLN-PE layer (InternUtopia physics protocol) against the JAX
package's, on the CPU.

- Host copies: `env/checkers`, `env/occupancy`, `env/task_gen`, the Isaac
  task config of `isaac_ext`, `evaluator/utils/result_logger` (its files)
  and `evaluator/utils/visualize` (its frames and pngs): exactly equal.
- The H1 loco controller: `build_obs` and `DynamicHeightSamples` exactly
  equal; `H1SpeedController.forward` over 12 substeps with the JAX actor's
  weights carried by `loco_state_from_jax` within LOCO_ATOL;
  `convert_loco_policy` of a `torch.jit.script`-saved MLP equal to the JAX
  package's conversion of the same file.
- `FakePhysicsVecEnv` in flash and in physical mode (with the loco
  actors): observations, poses, finish_action and metrics exactly equal
  under the same action sequence, the joint targets within LOCO_ATOL.
- `VLNPEEvaluator` with the "simple" agent: metrics and the result store
  equal to JAX's, and the resume; with a tiny "internvla_n1" agent (the
  tiny fp32 policies of tests/test_torch_slice.py, decode scripted as in
  tests/test_torch_habitat.py, System-1 on the JAX draws): the same actions
  step for step, the same metrics; the re-reset slot's first observation
  (the port's one difference, see `vln_pe_evaluator`).
- `VLNPEBatchAdapter` and the pipelined evaluator's internutopia cohorts:
  the adapter's observation lists equal to JAX's; two cohorts give the
  same per-episode metrics as `VLNPEEvaluator` and as JAX's pipelined run;
  slot rotation, the resume and the `env_factory` hook.
- `scripts/torch/eval.py --device cpu` on the h1 config set to
  fake_physics; the "internutopia" backend's error without InternUtopia,
  the same in both packages; the process pool at 2 spawned workers.
"""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu import configs as jconfigs
from internnav_tpu.agent.internvla_n1_agent import InternVLAN1Agent as JN1Agent
from internnav_tpu.env import checkers as jcheck
from internnav_tpu.env import episodes as jepisodes
from internnav_tpu.env import occupancy as jocc
from internnav_tpu.env import task_gen as jtask
from internnav_tpu.env.internutopia import batch_adapter as jadapt
from internnav_tpu.env.internutopia import isaac_ext as jisaac
from internnav_tpu.env.internutopia import loco as jloco
from internnav_tpu.env.internutopia import vec_env as jvec
from internnav_tpu.env.internutopia.env import InternutopiaEnv as JInternutopiaEnv
from internnav_tpu.evaluator import Evaluator as JEvaluator
from internnav_tpu.evaluator.utils import result_logger as jlog
from internnav_tpu.evaluator.utils import visualize as jvis
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent as TN1Agent
from internnav_tpu_torch.env import checkers as tcheck
from internnav_tpu_torch.env import episodes as tepisodes
from internnav_tpu_torch.env import occupancy as tocc
from internnav_tpu_torch.env import task_gen as ttask
from internnav_tpu_torch.env.internutopia import batch_adapter as tadapt
from internnav_tpu_torch.env.internutopia import isaac_ext as tisaac
from internnav_tpu_torch.env.internutopia import loco as tloco
from internnav_tpu_torch.env.internutopia import vec_env as tvec
from internnav_tpu_torch.env.internutopia.env import InternutopiaEnv as TInternutopiaEnv
from internnav_tpu_torch.evaluator import Evaluator as TEvaluator
from internnav_tpu_torch.evaluator.utils import result_logger as tlog
from internnav_tpu_torch.evaluator.utils import visualize as tvis
from internnav_tpu_torch.model.weights.from_jax import loco_state_from_jax
from test_torch_habitat import scripted_pair
from test_torch_slice import policies  # noqa: F401

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
H1_CONFIG = REPO / "scripts" / "torch" / "configs" / "h1_internvla_n1_async_cfg.py"
#: the loco actor on the CPU against JAX's jitted Flax MLP: fp32 products
#: summed in another order, 4 layers of 128-512 terms
LOCO_ATOL = 1e-5
PKG = {"jax": (jconfigs, jepisodes, JEvaluator, jvec, jtask),
       "port": (tconfigs, tepisodes, TEvaluator, tvec, ttask)}


def episode(mod, i: int, k: int = 3, yaw=None):
    """tests/test_vlnpe.py's `_episode` built with `mod`'s Episode (a path
    of k seeded segments from the origin); `yaw` turns the start."""
    rs = np.random.RandomState(i)
    th = rs.uniform(-1, 1, size=k)
    steps = rs.uniform(0.4, 1.0, size=(k, 1)) * np.stack([np.cos(th), np.sin(th)], axis=1)
    path = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)], axis=0)
    ref = np.concatenate([path, np.zeros((k + 1, 1))], axis=1)
    rot = np.array([1.0, 0, 0, 0]) if yaw is None else np.array(
        [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    return mod.Episode(
        episode_id=str(i), trajectory_id=str(100 + i), scene_id=f"s{i % 2}",
        instruction_text=f"episode {i} go past the door", instruction_tokens=np.arange(5),
        start_position=ref[0], start_rotation=rot, reference_path=ref,
        geodesic_distance=float(np.linalg.norm(np.diff(path, axis=0), axis=1).sum()))


def specs(side, n, max_step=5, warm_up=3, flash=False):
    cfgs, eps, _, _, task = PKG[side]
    cfg = cfgs.TaskCfg(max_step=max_step, warm_up_step=warm_up, robot_flash=flash)
    return task.generate_vln_episodes([episode(eps, i) for i in range(n)], cfg)


def plain(x):
    """Observations and infos as comparable python values."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tolist())
    if hasattr(x, "data") and isinstance(getattr(x, "data"), dict):  # a reset info
        return plain(x.data)
    if isinstance(x, np.generic):
        return x.item()
    return x


# ------------------------------------------------------------ host copies
def test_checkers_equal_jax():
    r = np.random.default_rng(3)
    pos = np.cumsum(r.uniform(-0.05, 0.08, (200, 3)) * [1, 1, 0], axis=0) + [0, 0, 1.0]
    yaw = np.cumsum(r.uniform(-0.05, 0.05, 200))
    quats = [np.array([np.cos(a / 2), np.sin(b / 2), 0.0, np.sin(a / 2)])
             for a, b in zip(yaw, r.uniform(-2.4, 2.4, 200))]
    js, ts = jcheck.StuckChecker(window=7), tcheck.StuckChecker(window=7)
    assert [ts.update(p, y) for p, y in zip(pos, yaw)] == \
        [js.update(p, y) for p, y in zip(pos, yaw)]
    for p, q in zip(pos[:40], quats[:40]):
        for h in (None, 0.3):
            assert tcheck.check_robot_fall(p, q, h) == jcheck.check_robot_fall(p, q, h)
    jd = jcheck.DoneChecker(max_step=30, stuck_window=5)
    td = tcheck.DoneChecker(max_step=30, stuck_window=5)
    got = [(td.update(int(a), p, y, q), jd.update(int(a), p, y, q))
           for a, p, y, q in zip(r.integers(-1, 4, 60), pos, yaw, quats)]
    assert all(a == b for a, b in got)
    assert {a[1] for a, _ in got} >= {"", "robot_fall"}


def test_occupancy_equal_jax():
    r = np.random.default_rng(4)
    for W, H in ((100, 100), (120, 80)):
        cam = tuple(r.uniform(-3, 3, 2))
        for xy in r.uniform(-5, 5, (10, 2)):
            px = tocc.world_to_map_pixel(xy, cam, 200.0, W, H)
            assert px == jocc.world_to_map_pixel(xy, cam, 200.0, W, H)
            assert tocc.map_pixel_to_world(px, cam, 200.0, W, H) == \
                jocc.map_pixel_to_world(px, cam, 200.0, W, H)
        depth = r.uniform(0.0, 12.0, (H, W)).astype(np.float32)
        for robot, ankle in (("h1", None), ("aliengo", 0.05)):
            np.testing.assert_array_equal(
                tocc.free_map_from_topdown_depth(depth, 0.4, robot, ankle),
                jocc.free_map_from_topdown_depth(depth, 0.4, robot, ankle))
            checks = [m.make_occupancy_checker(
                lambda: depth, lambda: cam, lambda: 0.4, (W, H), robot_type=robot,
                get_ankle_height=(lambda: 0.05) if ankle else None) for m in (tocc, jocc)]
            for xy in r.uniform(-8, 8, (30, 2)):
                assert checks[0](*xy) == checks[1](*xy)


def test_task_gen_equal_jax(tmp_path):
    for scene, name in (("s0", "fixed.usd"), ("s1", "mesh.glb")):
        (tmp_path / scene / "sub").mkdir(parents=True)
        (tmp_path / scene / "sub" / name).write_text("")
    for scene_dir in (None, str(tmp_path)):
        got = {}
        for side in ("jax", "port"):
            cfgs, eps, _, _, task = PKG[side]
            cfg = cfgs.TaskCfg(max_step=9, warm_up_step=4, robot_flash=True,
                               metric_config=cfgs.MetricCfg(success_distance=2.5))
            episodes = [episode(eps, i) for i in range(3)]
            episodes[2].scene_id = "missing"  # skipped when scenes are resolved
            got[side] = [(s.path_key, s.start_position.tolist(), s.start_rotation.tolist(),
                          s.scene_asset, s.metric.success_distance, s.max_step,
                          s.warm_up_step, s.robot_name, s.robot_flash)
                         for s in task.generate_vln_episodes(episodes, cfg, scene_dir)]
        assert got["port"] == got["jax"] and len(got["port"]) == (3 if scene_dir is None else 2)
    assert ttask.load_scene_asset(str(tmp_path), "s1") == \
        jtask.load_scene_asset(str(tmp_path), "s1")


def test_isaac_task_cfg_equals_jax():
    for j, t in zip(specs("jax", 3), specs("port", 3)):
        assert tisaac.task_cfg_from_spec(t) == jisaac.task_cfg_from_spec(j)


def test_result_logger_files_equal_jax(tmp_path):
    from internnav_tpu.evaluator.utils.data_collector import EpisodeResultStore as JStore
    from internnav_tpu_torch.evaluator.utils.data_collector import EpisodeResultStore as TStore

    r = np.random.default_rng(5)
    records = [(rank, i, {"split": ["val_seen", "val_unseen"][i % 2], "episode_id": f"{rank}{i}",
                          **{k: float(v) for k, v in zip(
                              ("success", "spl", "osr", "NE", "TL", "ndtw", "steps"),
                              r.uniform(0, 5, 7))}})
               for rank in range(2) for i in range(4)]
    for side, store_cls, mod in (("jax", JStore, jlog), ("port", TStore, tlog)):
        root = tmp_path / side / "resume"
        for rank, i, info in records:
            store_cls(root=str(root), rank=rank).save_eval_result(key=f"{rank}_{i}",
                                                                  fail_reason="", info=info)
        agg = mod.ResultLogger(str(root), str(tmp_path / side / "out")).report()
        assert set(agg) == {"val_seen", "val_unseen", "all"}
    for name in ("aggregate_result.json", "aggregate_result.txt"):
        assert (tmp_path / "port" / "out" / name).read_text() == \
            (tmp_path / "jax" / "out" / name).read_text()


def test_visualize_frames_and_files_equal_jax(tmp_path):
    r = np.random.default_rng(6)
    frame = r.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    for a in (0, 1, 2, 3, 5, 9):
        np.testing.assert_array_equal(tvis.draw_action(frame, a), jvis.draw_action(frame, a))
    traj, ref = np.cumsum(r.uniform(-1, 1, (6, 3)), 0), np.cumsum(r.uniform(-1, 1, (5, 3)), 0)
    np.testing.assert_array_equal(tvis.draw_trajectory_map(traj, ref),
                                  jvis.draw_trajectory_map(traj, ref))
    import cv2

    for side, mod in (("jax", jvis), ("port", tvis)):
        vis = mod.VisualizeUtil(str(tmp_path / side))
        for a in (1, 2, 3, 0):
            vis.add_step("ep0", {"rgb": frame}, a)
        vis.add_step("ep0", {"rgb": np.zeros(3)}, 1)  # no frame: skipped
        assert vis.save_trajectory("ep0", reference_path=ref, trajectory=traj,
                                   video=False) == str(tmp_path / side / "ep0")
    names = sorted(p.name for p in (tmp_path / "port" / "ep0").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "ep0").iterdir())
    assert names == ["0000.png", "0001.png", "0002.png", "0003.png", "map.png"]
    for n in names:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / "ep0" / n)),
                                      cv2.imread(str(tmp_path / "jax" / "ep0" / n)))


# ------------------------------------------------------------------ loco
def robot_states(mod, n, seed=0, pointcloud=True):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        yaw = 0.2 * i
        q = np.array([np.cos(yaw / 2), 0.02 * r.standard_normal(), 0.02 * r.standard_normal(),
                      np.sin(yaw / 2)])
        base = np.array([0.1 * i, -0.05 * i, 1.05])
        pc = None
        if pointcloud and i % 3 == 0:
            pc = np.c_[base[:2] + r.uniform(-3.5, 3.5, (300, 2)), r.uniform(-0.3, 0.3, 300)]
        out.append(mod.H1RobotState(
            base_position=base, torso_position=base + [0.0, 0.0, 0.2], torso_quat=q,
            imu_quat=q, imu_ang_vel=r.standard_normal(3),
            joint_positions=(mod.DEFAULT_DOF_POS + 0.1 * r.standard_normal(19)).astype(np.float32),
            joint_velocities=r.standard_normal(19).astype(np.float32),
            ankle_height=0.1, pointcloud=pc))
    return out


def test_loco_obs_and_height_samples_equal_jax():
    for name in ("JOINT_NAMES_SIM", "JOINT_NAMES_GYM", "SIM2GYM", "GYM2SIM", "DEFAULT_DOF_POS"):
        np.testing.assert_array_equal(getattr(tloco, name), getattr(jloco, name))
    np.testing.assert_array_equal(tloco.init_height_points(), jloco.init_height_points())
    r = np.random.default_rng(7)
    q, v = r.standard_normal(4), r.standard_normal(3)
    np.testing.assert_array_equal(tloco.quat_rotate_inverse(q, v), jloco.quat_rotate_inverse(q, v))
    pts = r.standard_normal((9, 3))
    np.testing.assert_array_equal(tloco.quat_apply_yaw(q, pts), jloco.quat_apply_yaw(q, pts))
    th, jh = tloco.DynamicHeightSamples(), jloco.DynamicHeightSamples()
    for i in range(4):
        cloud = np.c_[r.uniform(-4, 4, (200, 2)) + i, r.uniform(0, 1, 200)]
        robot = np.array([i, 0.5 * i, 0.0])
        th.set_heights(cloud, robot)
        jh.set_heights(cloud, robot)
        np.testing.assert_array_equal(th.height_map, jh.height_map)
        query = r.uniform(-6, 6, (50, 2))
        np.testing.assert_array_equal(th.get_heights(query), jh.get_heights(query))
    tc = tloco.H1SpeedController(device="cpu")
    jc = jloco.H1SpeedController(policy_fwd=lambda p, x: None)
    for tst, jst in zip(robot_states(tloco, 9), robot_states(jloco, 9)):
        cmd = tuple(r.uniform(-1, 1, 3))
        np.testing.assert_array_equal(tc.build_obs(tst, cmd), jc.build_obs(jst, cmd))


def test_loco_controller_forward_matches_jax():
    """12 substeps: the actor runs on substeps 0, 4 and 8, the targets
    repeat in between; the JAX actor's weights through loco_state_from_jax."""
    _, params, fwd = jloco.make_loco_mlp()
    actor = tloco.LocoActor()
    actor.load_state_dict(loco_state_from_jax(params))
    tc, jc = tloco.H1SpeedController(actor=actor), jloco.H1SpeedController(fwd, params)
    assert tc.device.type == "cpu"
    r = np.random.default_rng(8)
    for tst, jst in zip(robot_states(tloco, 12, 1), robot_states(jloco, 12, 1)):
        act = r.uniform(-1, 1, 3)
        got, want = tc.action_to_control(tst, act), jc.action_to_control(jst, act)
        np.testing.assert_allclose(got, want, atol=LOCO_ATOL, rtol=0)
        # the last actions (x 4) enter the next observation
        np.testing.assert_allclose(tc._old_joint_positions, jc._old_joint_positions,
                                   atol=4 * LOCO_ATOL, rtol=0)
    assert tc.policy_calls == 3
    assert tc.get_obs() == jc.get_obs() == {"finished": True}


def test_convert_loco_policy_equals_jax(tmp_path):
    class MLP(torch.nn.Module):
        def __init__(self, dims):
            super().__init__()
            layers = [m for a, b in zip(dims[:-1], dims[1:])
                      for m in (torch.nn.Linear(a, b), torch.nn.ELU())]
            self.actor = torch.nn.Sequential(*layers[:-1])

        def forward(self, x):
            return self.actor(x)

    torch.manual_seed(0)
    path = tmp_path / "h1_loco_jit_policy.pt"
    torch.jit.script(MLP([492, 512, 256, 128, 19])).save(str(path))
    actor = tloco.convert_loco_policy(str(path), device="cpu")
    params = jloco.convert_loco_policy(str(path))
    for i, layer in enumerate(actor.layers):
        dense = params[f"Dense_{i}"]
        np.testing.assert_array_equal(layer.weight.detach().numpy(), dense["kernel"].T)
        np.testing.assert_array_equal(layer.bias.detach().numpy(), dense["bias"])
    _, _, fwd = jloco.make_loco_mlp()
    x = np.random.default_rng(9).standard_normal((4, 492)).astype(np.float32)
    np.testing.assert_allclose(actor(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(fwd(params, x)), atol=LOCO_ATOL, rtol=0)
    bad = tmp_path / "bad.pt"
    torch.jit.script(MLP([492, 256, 19])).save(str(bad))
    with pytest.raises(ValueError, match="layers"):
        tloco.convert_loco_policy(str(bad), device="cpu")


# -------------------------------------------------------- physics protocol
def action_script(flash: bool, r):
    """A macro-step sequence: warm-up stand_still, moves, a speed command,
    a stop; each entry (controller, args, ticks)."""
    move = "move_by_flash" if flash else "move_by_discrete"
    seq = [("stand_still", [], 3)]
    for a in r.integers(1, 4, 6):
        seq.append((move, [int(a)], 1 if flash else 50))
    seq += [("vln_move_by_speed", [0.4, 0.0, 0.3], 5), (move, [1], 1 if flash else 50),
            ("stop", [], 1), (move, [1], 1)]
    return seq


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "physical"])
def test_fake_physics_equals_jax(flash):
    """Two envs, three episodes (the third enters through a partial reset):
    every tick's observations, poses, finish_action, terminations, metrics
    equal; in physical mode the loco actors' joint targets within LOCO_ATOL
    of JAX's (the JAX actor's weights carried across)."""
    use_loco = not flash
    envs = {"jax": jvec.FakePhysicsVecEnv(specs("jax", 3, max_step=40, flash=flash), env_num=2,
                                          rgb_hw=(28, 28), use_loco=use_loco),
            "port": tvec.FakePhysicsVecEnv(specs("port", 3, max_step=40, flash=flash),
                                           env_num=2, rgb_hw=(28, 28), use_loco=use_loco,
                                           device="cpu")}
    if use_loco:
        for jc, tc in zip(envs["jax"].loco, envs["port"].loco):
            tc.actor.load_state_dict(loco_state_from_jax(jc._params))
    log = {side: [plain(env.reset())] for side, env in envs.items()}
    seq = action_script(flash, np.random.default_rng(10))
    for side, env in envs.items():
        for k, (name, args, ticks) in enumerate(seq):
            for _ in range(ticks):
                acts = [{"h1": {name: args}}, {"h1": {name: args}}]
                log[side].append(plain(env.step(acts)))
            if k == 4:
                log[side].append(plain(env.reset([0])))
                log[side].append(plain(env.render_frames()))
        log[side].append((env.exhausted, env.loco_calls, [s.pose.tolist() for s in env.slots]))
    assert log["port"] == log["jax"]
    if use_loco:
        assert envs["port"].loco_calls > 100
        for jc, tc in zip(envs["jax"].loco, envs["port"].loco):
            np.testing.assert_allclose(tc._applied, jc._applied, atol=LOCO_ATOL, rtol=0)
            assert tc.policy_calls > 25
    fresh = tvec.FakePhysicsVecEnv(specs("port", 1), env_num=1)
    fresh.reset()
    with pytest.raises(ValueError, match="invalid action name"):
        fresh.step([{"h1": {"fly": []}}])


def test_fake_physics_loco_path_counts_calls():
    """tests/test_vlnpe.py::test_fake_physics_loco_path_runs on the port."""
    env = tvec.FakePhysicsVecEnv(specs("port", 1, max_step=50, warm_up=1), env_num=1,
                                 use_loco=True, device="cpu")
    env.reset()
    env.step([{"h1": {"stand_still": []}}])
    for _ in range(8):
        env.step([{"h1": {"vln_move_by_speed": [0.5, 0.0, 0.0]}}])
    assert env.loco_calls == 8 and env.loco[0].policy_calls == 2


# ------------------------------------------------------------- evaluators
def pe_cfg(cfgs, out_dir, env_num=2, flash=False, agent=None, max_step=4, hw=32,
           eval_type="vln_pe", cohorts=None, **settings):
    env_settings = {"backend": "fake_physics", "device": "cpu", **settings}
    if cohorts is not None:
        env_settings["cohorts"] = cohorts
    return cfgs.EvalCfg(
        agent=agent or cfgs.AgentCfg(model_name="simple",
                                     model_settings={"mode": "random", "seed": 1}),
        env=cfgs.EnvCfg(env_type="internutopia", env_settings=env_settings, env_num=env_num),
        task=cfgs.TaskCfg(max_step=max_step, warm_up_step=2, robot_flash=flash,
                          camera_resolution=[hw, hw]),
        eval_type=eval_type, output_dir=str(out_dir))


def store_infos(ev):
    return sorted((rec["key"], rec.get("fail_reason"), json.dumps(rec["info"], sort_keys=True))
                  for rec in ev.store.records())


def drop_time(m):
    return {k: v for k, v in m.items() if k != "wall_clock_s"}


def test_vlnpe_evaluator_simple_agent_equals_jax_and_resumes(tmp_path):
    """tests/test_vlnpe.py::test_vlnpe_evaluator_full_fsm_and_resume on both
    packages: 5 episodes over 2 envs (slots rotate), physical mode."""
    runs = {}
    for side in ("jax", "port"):
        cfgs, eps, Ev, _, _ = PKG[side]
        ev = Ev.init(pe_cfg(cfgs, tmp_path / side), episodes=[episode(eps, i) for i in range(5)])
        m = ev.eval()
        again = Ev.init(pe_cfg(cfgs, tmp_path / side),
                        episodes=[episode(eps, i) for i in range(5)])
        m2 = again.eval()
        runs[side] = (drop_time(m), store_infos(ev), ev.results, drop_time(m2), again.results)
    assert runs["port"] == runs["jax"]
    m, _, results, m2, again = runs["port"]
    assert m["num_episodes"] == m2["num_episodes"] == 5 and len(results) == 5
    assert again == [] and m2 == m  # the resume re-ran nothing


def n1_run(side, policy, out_dir, flash, n_eps, seed_offset=0, max_step=10):
    cfgs, eps, Ev, _, _ = PKG[side]
    agent_cls = TN1Agent if side == "port" else JN1Agent
    cfg = pe_cfg(cfgs, out_dir, env_num=1, flash=flash, max_step=max_step, hw=56,
                 agent=cfgs.AgentCfg(model_name="internvla_n1",
                                     model_settings={"async_s2": False,
                                                     "infer_mode": "partial_async",
                                                     "sys2_max_forward_step": 4}))
    agent = agent_cls(cfg.agent, policy=policy)
    seen, step = [], agent.step

    def recorded(obs):
        out = step(obs)
        seen.append((obs[0].get("instruction"), np.asarray(obs[0]["rgb"]).copy(),
                     out[0]["action"][0]))
        return out

    agent.step = recorded
    ev = Ev.init(cfg, episodes=[episode(eps, seed_offset + i, yaw=0.3 * i)
                                for i in range(n_eps)], agent=agent)
    return drop_time(ev.eval()), store_infos(ev), seen, ev


#: the scripted decode: a pixel goal (System-1), an action list, a pixel goal
N1_SCRIPT = ("12 20", "↑ ↑ ← ↑", "30 8", "↑ → ↑")


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "physical"])
def test_vlnpe_evaluator_n1_agent_equals_jax(policies, tmp_path, flash):  # noqa: F811
    """One episode of at most 10 steps at a 56-pixel camera: the agent's
    observations and actions step for step, the metrics and the store."""
    with scripted_pair(*policies, script=N1_SCRIPT) as (jpol, tpol):
        runs = {side: n1_run(side, pol, tmp_path / side, flash, 1)
                for side, pol in (("jax", jpol), ("port", tpol))}
        assert tpol.s1_calls > 0 and tpol.tokenizer.decoded == jpol.tokenizer.decoded >= 2
    (jm, jstore, jseen, _), (tm, tstore, tseen, _) = runs["jax"], runs["port"]
    assert [a for *_, a in tseen] == [a for *_, a in jseen] and len(tseen) >= 5
    assert set(a for *_, a in tseen) <= {0, 1, 2, 3}
    for (ti, trgb, _), (ji, jrgb, _) in zip(tseen, jseen):
        assert ti == ji
        np.testing.assert_array_equal(trgb, jrgb)
    assert tm == jm and tstore == jstore and tm["num_episodes"] == 1
    assert all(np.isfinite(v) for v in tm.values())


def test_vlnpe_rereset_slot_starts_from_its_new_episode(policies, tmp_path):  # noqa: F811
    """env_num 1, two episodes, the first ended by STOP: the port's agent
    starts episode 2 from its own frame and instruction (the env's render
    at the start pose); the JAX evaluator hands it episode 1's last
    observation, which after a stop holds no frame (KeyError)."""
    script = ("↑ ← STOP",)
    with scripted_pair(*policies, script=script) as (jpol, tpol):
        tm, _, seen, ev = n1_run("port", tpol, tmp_path / "port", True, 2, max_step=6)
        with pytest.raises(KeyError, match="rgb"):
            n1_run("jax", jpol, tmp_path / "jax", True, 2, max_step=6)
    assert tm["num_episodes"] == 2
    firsts = [i for i, (ins, _, _) in enumerate(seen) if ins != seen[0][0]]
    assert firsts and seen[firsts[0]][0] == "episode 1 go past the door"
    from internnav_tpu_torch.env.fake_env import procedural_frame

    spec = next(s for s in ev.env.env.specs if s.episode.episode_id == "1")
    pose = np.array([*spec.start_position[:2], tvec._quat_or_yaw(spec.start_rotation)])
    rgb, _ = procedural_frame(pose, abs(hash(spec.path_key)) % (2**31), 56, 56)
    np.testing.assert_array_equal(seen[firsts[0]][1], rgb)


# --------------------------------------------------- batched / pipelined
def test_batch_adapter_equals_jax():
    """The adapter's obs lists, status and results over a scripted run with
    a partial re-reset, in physical mode."""
    got = {}
    for side, adapt, vec in (("jax", jadapt, jvec), ("port", tadapt, tvec)):
        env = vec.FakePhysicsVecEnv(specs(side, 3, max_step=4, warm_up=2), env_num=2,
                                    rgb_hw=(28, 28))
        ad = adapt.VLNPEBatchAdapter(env, "h1", robot_flash=False, rgb_hw=(28, 28))
        log = [plain(ad.reset())]
        for acts in ([1, 2], [3, 1], [0, 1], [1, -1], [2, 0], [1, 1], [1, 1]):
            obs = ad.step(acts)
            log.append(plain(obs))
            done = [i for i, o in enumerate(obs) if o is not None and o["done"]]
            if done:
                log.append(plain(ad.reset(done)))
            log.append((ad.status.tolist(), ad.is_running))
        got[side] = (log, ad.episode_results)
    assert got["port"] == got["jax"]
    assert len(got["port"][1]) == 3


def pipe_cfg(cfgs, out_dir, eval_type, env_num=2, cohorts=2):
    """tests/test_pipelined_real_env.py's config: flash mode, the "simple"
    agent always forward."""
    return pe_cfg(cfgs, out_dir, env_num=env_num, flash=True, eval_type=eval_type,
                  cohorts=cohorts,
                  agent=cfgs.AgentCfg(model_name="simple",
                                      model_settings={"mode": "fixed", "action": 1}))


def by_episode(results):
    return {str(r["episode_id"]): r for r in results}


def test_pipelined_fake_physics_cohorts_match_vlnpe_and_jax(tmp_path):
    """tests/test_pipelined_real_env.py:40-89 on the port: 2 cohorts x 2
    envs give VLNPEEvaluator's per-episode metrics (4 envs, the same
    episodes), and JAX's pipelined run's records."""
    eps = [episode(tepisodes, i) for i in range(4)]
    ref = TEvaluator.init(pipe_cfg(tconfigs, tmp_path / "ref", "vln_pe", env_num=4),
                          episodes=eps)
    ref.eval()
    pipe = TEvaluator.init(pipe_cfg(tconfigs, tmp_path / "pipe", "vln_pipelined"), episodes=eps)
    m = pipe.eval()
    assert m["num_episodes"] == 4 and m["actions_timed"] > 0
    assert len(pipe._prebuilt_envs) == 2
    assert all(isinstance(e, tadapt.VLNPEBatchAdapter) for e in pipe._prebuilt_envs)
    got = by_episode([rec["info"] for rec in pipe.store.records()])
    want = by_episode(ref.results)
    assert set(got) == set(want)
    for k, r in want.items():
        for key in ("success", "NE", "spl", "osr", "TL", "steps", "ndtw"):
            assert got[k][key] == r[key], (k, key)
    jpipe = JEvaluator.init(pipe_cfg(jconfigs, tmp_path / "jpipe", "vln_pipelined"),
                            episodes=[episode(jepisodes, i) for i in range(4)])
    jm = jpipe.eval()
    assert store_infos(pipe) == store_infos(jpipe)
    timing = ("wall_clock_s", "action_latency_p50_ms", "action_latency_p90_ms",
              "action_latency_p99_ms", "action_latency_mean_ms")
    assert {k: v for k, v in m.items() if k not in timing} == \
        {k: v for k, v in jm.items() if k not in timing}


def test_pipelined_real_env_rotation_and_resume(tmp_path):
    """7 episodes over 2 cohorts of 2 slots rotate through the slots and all
    end; a second run over the same output_dir re-runs nothing."""
    cfg = pipe_cfg(tconfigs, tmp_path, "vln_pipelined")
    ev = TEvaluator.init(cfg, episodes=[episode(tepisodes, i) for i in range(7)])
    m = ev.eval()
    assert m["num_episodes"] == 7
    assert {str(rec["info"]["episode_id"]) for rec in ev.store.records()} == \
        {str(i) for i in range(7)}
    again = TEvaluator.init(cfg, episodes=[episode(tepisodes, i) for i in range(7)])
    assert all(len(e.episodes) == 0 for e in again._prebuilt_envs)
    m2 = again.eval()
    assert m2["num_episodes"] == 7 and m2["success"] == m["success"]


@pytest.mark.parametrize("where", ["argument", "env_settings"])
def test_pipelined_env_factory_hook(tmp_path, where):
    """env_factory (the constructor's, or env_settings["env_factory"]) wins
    over the default cohort env and gets (idx, env_cfg, task_cfg,
    share)."""
    calls = []

    def factory(idx, env_cfg, task_cfg, share):
        calls.append((idx, len(share)))
        env = TInternutopiaEnv(env_cfg, task_cfg, episodes=share)
        return tadapt.VLNPEBatchAdapter(env, robot_name=task_cfg.robot_name,
                                        robot_flash=task_cfg.robot_flash, episodes=share,
                                        rgb_hw=task_cfg.camera_resolution)

    cfg = pipe_cfg(tconfigs, tmp_path, "vln_pipelined")
    kwargs = {}
    if where == "argument":
        kwargs["env_factory"] = factory
    else:
        cfg.env.env_settings["env_factory"] = factory
    ev = TEvaluator.init(cfg, episodes=[episode(tepisodes, i) for i in range(4)], **kwargs)
    assert ev.eval()["num_episodes"] == 4
    assert sorted(c[0] for c in calls) == [0, 1] and sum(c[1] for c in calls) == 4


def test_pipelined_prebuilt_envs(tmp_path):
    """envs= sets the cohort count and each env keeps its own episodes."""
    cfg = pipe_cfg(tconfigs, tmp_path, "vln_pipelined", cohorts=5)
    eps = [episode(tepisodes, i) for i in range(6)]
    envs = [tadapt.VLNPEBatchAdapter(TInternutopiaEnv(cfg.env, cfg.task, episodes=eps[c::3]),
                                     "h1", robot_flash=True, rgb_hw=(32, 32))
            for c in range(3)]
    ev = TEvaluator.init(cfg, episodes=eps, envs=envs)
    assert ev.cohort_count == 3
    assert ev.eval()["num_episodes"] == 6


# ---------------------------------------------------------- entry points
def test_eval_cli_runs_vln_pe_on_the_cpu(tmp_path, monkeypatch):
    """scripts/torch/eval.py --device cpu on the h1 InternVLA-N1 config with
    the fake_physics backend, a 56-pixel camera and the tiny model in place
    of the 7B dims (get_config's assembly dumps model_settings, so the
    model's size cannot ride in them): the "internvla_n1" agent's realtime
    policy of random weights, the evaluator; the metrics and result.json."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config

    tiny = InternVLAN1Config.tiny("nextdit_async")
    monkeypatch.setattr(InternVLAN1Config, "qwen25vl_7b", staticmethod(lambda: tiny))
    spec = importlib.util.spec_from_file_location("port_eval", REPO / "scripts/torch/eval.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from internnav_tpu_torch.configs import load_py_config\n"
        f"eval_cfg = load_py_config({str(H1_CONFIG)!r})\n"
        "eval_cfg.env.env_settings['backend'] = 'fake_physics'\n"
        "eval_cfg.task.camera_resolution = [56, 56]\n"
        "eval_cfg.task.max_step = 5\n"
        "eval_cfg.task.warm_up_step = 2\n"
        "eval_cfg.agent.ckpt_path = ''\n"
        "eval_cfg.agent.model_settings['async_s2'] = False\n"
        f"eval_cfg.dataset.base_data_dir = {str(REPO / 'data' / 'fake_r2r')!r}\n"
        "eval_cfg.dataset.max_episodes = 2\n"
        f"eval_cfg.output_dir = {str(tmp_path / 'out')!r}\n")
    metrics = cli.main(["--config", str(cfg), "--device", "cpu"])
    assert metrics["num_episodes"] == 2
    assert all(np.isfinite(v) for v in metrics.values())
    with open(tmp_path / "out" / "result.json") as f:
        assert json.loads(f.read().splitlines()[-1])["num_episodes"] == 2


def test_internutopia_backend_raises_as_jax():
    """Without InternUtopia the Isaac backend and the extension registration
    raise the same error in both packages."""
    errors = []
    for cfgs, eps, env_cls, isaac in ((jconfigs, jepisodes, JInternutopiaEnv, jisaac),
                                      (tconfigs, tepisodes, TInternutopiaEnv, tisaac)):
        with pytest.raises(RuntimeError) as e1:
            isaac.register()
        with pytest.raises(RuntimeError) as e2:
            env_cls(cfgs.EnvCfg(env_type="internutopia", env_settings={}), cfgs.TaskCfg(),
                    episodes=[episode(eps, 0)])
        errors.append((str(e1.value), type(e1.value.__cause__), str(e2.value),
                       type(e2.value.__cause__)))
    assert errors[0] == errors[1]
    assert "InternUtopia modules could not be imported" in errors[1][0]
    assert errors[1][1] is ModuleNotFoundError


def test_process_pool_two_spawned_workers(tmp_path):
    """distribution_config proc_num 2: 2 spawned workers x 2 envs behind the
    vec-env surface; the evaluator's results equal the in-process run's."""
    eps = [episode(tepisodes, i) for i in range(6)]
    t0 = time.perf_counter()
    cfg = pe_cfg(tconfigs, tmp_path / "pool", distribution_config={"proc_num": 2})
    ev = TEvaluator.init(cfg, episodes=eps)
    assert ev.env_num == 4
    try:
        m = ev.eval()
    finally:
        ev.env.close()
    assert m["num_episodes"] == 6
    assert all(not p.is_alive() for p in ev.env.env._procs)
    assert time.perf_counter() - t0 < 60
