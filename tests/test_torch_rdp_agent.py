"""The port's RDP agent and the entry points of this family on the CPU, at
tests/test_torch_rdp.py's small widths:

- the "rdp" agent step for step against JAX's `RdpAgent` on the same
  weights and the same act draws (the port's `draw_fn` hands it JAX's keys'
  x_init and step noises): actions, waypoints (within WP_TOL) and stops,
  over two act calls, a reset of one env and a stop threshold that STOPs
  some envs; `step_coroutine` against `step`; the agent built from a
  reference-layout checkpoint;
- `scripts/torch/eval.py` on the port's h1_rdp_cfg.py (tiny widths through
  model_settings, FakeEnv, 4 episodes) to its end on the host;
- `scripts/torch/train.py` for cma and rdp: two steps from a store, the
  trainer's checkpoint, and the saved policy reloading to the trained
  weights through `from_pretrained`.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from internnav_tpu.agent import rdp_agent as jagent_mod
from internnav_tpu.configs import AgentCfg as JAgentCfg
from internnav_tpu.model import get_config as jget_config
from internnav_tpu.model.basemodel.rdp import RDPPolicy as JRDPPolicy
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.agent import Agent
from internnav_tpu_torch.agent.rdp_agent import RdpAgent
from internnav_tpu_torch.configs import AgentCfg
from internnav_tpu_torch.model.basemodel import rdp as trdp
from internnav_tpu_torch.model.weights import convert as tconvert
from test_torch_rdp import _jax_rdp, _port_rdp, tiny

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
#: waypoints in metres after 20 DDPM steps (TRAJ_TOL scaled by the action
#: range, 0.25-0.27)
WP_TOL = 1e-4


def _frames(rs, n):
    return [{"instruction": list(rs.randint(2, 1000, rs.randint(4, 20))),
             "rgb": rs.randint(0, 255, (224, 224, 3)).astype(np.uint8),
             "depth": rs.uniform(0, 1, (256, 256, 1)).astype(np.float32),
             "imu": rs.randn(3).astype(np.float32)} for _ in range(n)]


def jax_act_draws(seed=0):
    """JAX's agent's act draws for the port: its key split once an act
    call, x_init from the sub key, the step noises from fold_in(sub, 1)."""
    key = [jax.random.PRNGKey(seed)]

    def draw(n):
        key[0], sub = jax.random.split(key[0])
        noises = jax.random.normal(jax.random.fold_in(sub, 1), (20, n, 8, 3))
        return {"x_init": torch.from_numpy(np.array(jax.random.normal(sub, (n, 8, 3)))),
                "noises": torch.from_numpy(np.array(noises))}

    return draw


def agents(monkeypatch, stop_threshold):
    jm, params, _ = _jax_rdp()
    cfg_j = tiny(jget_config)
    monkeypatch.setattr(jagent_mod, "get_config", lambda name: cfg_j)
    monkeypatch.setattr(jagent_mod, "get_policy", lambda name: type(
        "Tiny", (), {"build": staticmethod(lambda cfg: JRDPPolicy(jm, params, cfg))}))
    settings = {"stop_threshold": stop_threshold}
    jag = jagent_mod.RdpAgent(JAgentCfg(model_name="rdp", model_settings=settings))
    pol = trdp.RDPPolicy(_port_rdp(params), tiny(tmodel_zoo.get_config))
    tag = RdpAgent(AgentCfg(model_name="rdp", model_settings=settings), policy=pol)
    tag.draw_fn = jax_act_draws()
    return jag, tag


def _first_stop_progress(pol, frames):
    """stop-progress of the first act call (zero states, first step)."""
    ag = RdpAgent(AgentCfg(model_name="rdp"), policy=pol)
    obs = {k: torch.from_numpy(np.asarray(v)) for k, v in ag._build_obs(frames).items()}
    n = len(frames)
    out = pol.forward({"observations": obs, "rnn_states": torch.zeros(n, 1, 32),
                       "prev_actions": torch.zeros(n, 4, 3), "masks": torch.zeros(n),
                       "mode": "act", "draws": jax_act_draws()(n)})
    return out[3].reshape(-1).numpy()


def test_agent_steps_as_jax(monkeypatch):
    rs = np.random.RandomState(0)
    frames = [_frames(rs, 3) for _ in range(7)]
    _, params, _ = _jax_rdp()
    sp = _first_stop_progress(trdp.RDPPolicy(_port_rdp(params), tiny(tmodel_zoo.get_config)),
                              frames[0])
    threshold = float(np.sort(sp)[1])  # the env with the largest one STOPs
    jag, tag = agents(monkeypatch, threshold)
    stops = 0
    for i, obs in enumerate(frames):
        if i == 2:
            jag.reset([1])
            tag.reset([1])
        want, got = jag.step(obs), tag.step(obs)
        for w, g in zip(want, got):
            assert g["action"] == w["action"] and g["stop"] == w["stop"], (i, w, g)
            np.testing.assert_allclose(g["waypoint"], w["waypoint"], atol=WP_TOL)
        stops += sum(g["stop"] for g in got)
    assert stops >= 1
    assert {a for o in got for a in o["action"]} <= {0, 1, 2, 3}
    assert isinstance(tag._states, torch.Tensor) and tag._states.device == tag.policy.device


def test_step_coroutine_equals_step(monkeypatch):
    rs = np.random.RandomState(1)
    frames = [_frames(rs, 2) for _ in range(5)]
    _, params, _ = _jax_rdp()
    pol = trdp.RDPPolicy(_port_rdp(params), tiny(tmodel_zoo.get_config))
    a, b = (RdpAgent(AgentCfg(model_name="rdp"), policy=pol) for _ in range(2))
    a.draw_fn, b.draw_fn = jax_act_draws(), jax_act_draws()
    for obs in frames:
        gen = b.step_coroutine(obs)
        assert next(gen, "done") is None  # the yield with the device work queued
        with pytest.raises(StopIteration) as stop:
            next(gen)
        assert stop.value.value == a.step(obs)


def test_agent_builds_from_a_reference_checkpoint(tmp_path):
    _, params, _ = _jax_rdp()
    src = _port_rdp(params)
    torch.save(tconvert.rdp_reference_state_dict(src), tmp_path / "rdp.pth")
    cfg = tiny(tmodel_zoo.get_config)
    settings = {"device": "cpu", "seed": 3, **{k: getattr(cfg, k) for k in (
        "text_encoder", "state_encoder", "cross_modal_encoder", "diffusion_policy",
        "vit_width", "vit_layers", "vit_heads")}}
    agent = Agent.init(AgentCfg(model_name="rdp", ckpt_path=str(tmp_path / "rdp.pth"),
                                model_settings=settings))
    assert isinstance(agent, RdpAgent) and agent.policy.device == torch.device("cpu")
    got = agent.policy.net.state_dict()
    for name, t in src.state_dict().items():
        assert torch.equal(got[name], t), name
    out = agent.step(_frames(np.random.RandomState(2), 2))
    assert len(out) == 2 and all(np.isfinite(o["waypoint"]).all() for o in out)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"port_{name}", REPO / "scripts/torch" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY_SETTINGS = '''
from internnav_tpu_torch.configs.model import (
    CrossModalEncoderCfg, DiffusionPolicyCfg, StateEncoderCfg, TextEncoderCfg)
from internnav_tpu_torch.model import get_config
_m = get_config("rdp")
_m.text_encoder.num_l_layers, _m.text_encoder.vocab_size = 1, 1000
_m.state_encoder.hidden_size = 32
_m.cross_modal_encoder.num_x_layers = 1
_m.diffusion_policy.n_layer, _m.diffusion_policy.n_emb = 1, 32
TINY = {"text_encoder": _m.text_encoder, "state_encoder": _m.state_encoder,
        "cross_modal_encoder": _m.cross_modal_encoder,
        "diffusion_policy": _m.diffusion_policy,
        "vit_width": 48, "vit_layers": 1, "vit_heads": 2}
'''


def test_eval_cli_runs_the_h1_rdp_config_on_the_cpu(tmp_path):
    cli = _load_script("eval")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from internnav_tpu_torch.configs import load_py_config\n" + TINY_SETTINGS +
        f"eval_cfg = load_py_config({str(REPO / 'scripts/torch/configs/h1_rdp_cfg.py')!r})\n"
        "eval_cfg.agent.ckpt_path = ''\n"
        "eval_cfg.agent.model_settings = dict(TINY)\n"
        "eval_cfg.env.env_num = 2\n"
        "eval_cfg.task.max_step = 6\n"
        "eval_cfg.dataset.max_episodes = 4\n"
        f"eval_cfg.dataset.base_data_dir = {str(REPO / 'data' / 'fake_r2r')!r}\n"
        "eval_cfg.dataset.filter_stairs = False\n"
        f"eval_cfg.output_dir = {str(tmp_path / 'out')!r}\n")
    got = cli.main(["--config", str(cfg), "--device", "cpu"])
    assert got["num_episodes"] == 4
    assert np.isfinite([got[k] for k in ("success", "spl", "NE")]).all()
    assert (tmp_path / "out" / "result.json").exists()


@pytest.mark.parametrize("model", ["cma", "rdp"])
def test_train_cli_trains_two_steps_and_saves_a_policy_that_reloads(tmp_path, model):
    from internnav_tpu_torch.dataset.rdp_dataset import write_synthetic_rdp_dataset
    from internnav_tpu_torch.dataset.vln_dataset import write_synthetic_dataset

    store = str(tmp_path / "store.bin")
    if model == "cma":
        write_synthetic_dataset(store, n_episodes=4, T=6, hw=32)  # resized to 224 / 256
        body = ('m = get_config("cma")\n'
                'm.text_encoder.vocab_size, m.text_encoder.embedding_size = 1000, 8\n'
                'm.text_encoder.rnn_hidden_size = 8\n'
                'm.image_encoder.rgb.model_name, m.image_encoder.rgb.output_size = '
                '"resnet18", 16\n'
                'm.image_encoder.depth.output_size, m.state_encoder.hidden_size = 16, 32\n')
    else:
        write_synthetic_rdp_dataset(store, n_episodes=2, T=10, hw=224, depth_hw=256)
        body = TINY_SETTINGS + "m = _m\nm.vit_width, m.vit_layers, m.vit_heads = 48, 1, 2\n"
    (tmp_path / "cfg.py").write_text(
        "from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg\n"
        "from internnav_tpu_torch.model import get_config\n" + body +
        f"exp_cfg = ExpCfg(name='t', model_name={model!r}, output_dir={str(tmp_path / 'o')!r},"
        " il=IlCfg(lr=1e-3), model=m)\n")
    cli = _load_script("train")
    metrics = cli.main(["--config", str(tmp_path / "cfg.py"), "--store", store, "--steps", "2",
                        "--batch-size", "2", "--device", "cpu"])
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    ckpt = tmp_path / "o" / "checkpoints" / "2" / "state.pt"
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 2 and ("ema" in state) == (model == "rdp")
    policy_cls = tmodel_zoo.get_policy(model)
    pol = policy_cls.from_pretrained(str(tmp_path / "o" / "t_final"), device="cpu")
    for name, t in pol.net.state_dict().items():
        assert torch.equal(t, state["params"][name]), name
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(tmp_path / "cfg.py"), "--store", store, "--steps", "1"])
