"""The port's recurrent VLN policies and their agents against the JAX
package's on the CPU, at tests/test_torch_cma.py's small widths:

- the policy's forward modes, its native save / load, a reference
  checkpoint through `from_pretrained`, `merge_params`' partial loads and
  their log;
- the "cma" / "seq2seq" agents step for step against JAX's through
  `VLNBatchedEvaluator` and two `VLNPipelinedEvaluator` cohorts sharing
  one policy, `reset` slices, the device the agent builds on, and its
  resizes against cv2 (the JAX agent's `cv2.resize`).
"""

import cv2
import numpy as np
import pytest
import torch

from internnav_tpu import configs as jconfigs
from internnav_tpu.agent import recurrent_agent as jagents
from internnav_tpu.env import episodes as jepisodes
from internnav_tpu.evaluator import vln_evaluator as jvln
from internnav_tpu.evaluator import vln_pipelined_evaluator as jpipe
from internnav_tpu.model import base as jbase
from internnav_tpu.model import get_config as jget_config
from internnav_tpu.model.basemodel import cma as jcma
from internnav_tpu.model.basemodel import seq2seq as jseq
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.agent import recurrent_agent as tagents
from internnav_tpu_torch.env import episodes as tepisodes
from internnav_tpu_torch.evaluator import vln_evaluator as tvln
from internnav_tpu_torch.evaluator import vln_pipelined_evaluator as tpipe
from internnav_tpu_torch.model import base as tbase
from internnav_tpu_torch.model.weights import convert as tconvert
from internnav_tpu_torch.model.weights.from_jax import cma_state_from_jax, seq2seq_state_from_jax
from test_torch_cma import (
    DEPTH,
    NET_TOL,
    RGB,
    B,
    close,
    jax_net,
    jax_params,
    net_inputs,
    small_cfg,
    t_,
)
from test_torch_evaluator import episodes

torch.set_num_threads(2)


def _policy(name, cfg, depth=DEPTH, seed=0):
    pol = tmodel_zoo.get_policy(name).build(cfg, device="cpu", seed=seed, depth_hw=depth)
    assert pol.device == torch.device("cpu")
    return pol


def test_policy_forward_modes_and_native_round_trip(tmp_path):
    cfg = small_cfg(tmodel_zoo.get_config, "cma")
    pol = _policy("cma", cfg)
    obs, states, pa, masks = net_inputs(np.random.RandomState(12), 2)
    batch = {"observations": t_(obs), "rnn_states": torch.from_numpy(states),
             "prev_actions": torch.from_numpy(pa), "masks": torch.from_numpy(masks)}
    logits, st, prog = pol.forward({**batch, "mode": "train"})
    assert logits.requires_grad and logits.shape == (B, 4) and st.shape == (B, 2, 32)
    feats, _, _ = pol.forward(batch)  # "features" by default
    assert not feats.requires_grad
    close(feats, logits, tol=1e-6)  # the autograd kernels round apart in the last bits
    acts, _, prog2 = pol.forward({**batch, "mode": "inference"})
    assert acts.shape == (B, 1) and torch.equal(acts[:, 0], feats.argmax(-1))
    close(prog2, prog, tol=1e-6)
    pol.save_pretrained(str(tmp_path / "native"))
    back = tmodel_zoo.get_policy("cma").from_pretrained(str(tmp_path / "native"), device="cpu",
                                                        depth_hw=DEPTH)
    assert back.cfg.model_dump() == cfg.model_dump()  # the saved config wins
    for k, v in pol.net.state_dict().items():
        assert torch.equal(back.net.state_dict()[k], v), k
    other = _policy("cma", cfg, seed=1)
    assert not torch.equal(other.net.action_head.weight, pol.net.action_head.weight)


@pytest.mark.parametrize("name", ["cma", "seq2seq"])
def test_from_pretrained_reads_a_reference_checkpoint(name, tmp_path):
    cfg = small_cfg(tmodel_zoo.get_config, name)
    pol = _policy(name, cfg, depth=256, seed=3)
    sd = tconvert.recurrent_reference_state_dict(pol.net)
    torch.save(sd, tmp_path / "model.pth")
    (tmp_path / "config.json").write_text('{"architectures": ["CMANet"]}')  # not native
    back = tmodel_zoo.get_policy(name).from_pretrained(str(tmp_path), cfg, device="cpu")
    for k, v in pol.net.state_dict().items():
        assert torch.equal(back.net.state_dict()[k], v), k
    assert tbase.Policy._is_torch_checkpoint(str(tmp_path))
    pol.save_pretrained(str(tmp_path / "native"))
    assert not tbase.Policy._is_torch_checkpoint(str(tmp_path / "native"))


class _Log:
    def __init__(self):
        self.lines = []

    def warning(self, msg, *args):
        self.lines.append(msg % args)


def test_merge_params_logs_partial_loads_as_jax():
    """A shape that differs and a name the module lacks keep the module's
    values; the missing names are counted: the JAX package's messages
    (with its '/' paths)."""
    init = {"a.w": torch.zeros(2, 3), "a.b": torch.zeros(3), "c": torch.ones(4)}
    loaded = {"a.w": torch.full((2, 3), 2.0), "a.b": torch.ones(5), "extra.x": torch.ones(1)}
    tlog, jlog = _Log(), _Log()
    merged = tbase.merge_params(init, loaded, logger=tlog)
    jinit = {"a": {"w": np.zeros((2, 3), np.float32), "b": np.zeros(3, np.float32)},
             "c": np.ones(4, np.float32)}
    jloaded = {"a": {"w": np.full((2, 3), 2.0, np.float32), "b": np.ones(5, np.float32)},
               "extra": {"x": np.ones(1, np.float32)}}
    jmerged = jbase.merge_params(jinit, jloaded, logger=jlog)
    assert sorted(tlog.lines) == sorted(jlog.lines)
    assert len(tlog.lines) == 3
    assert torch.equal(merged["a.w"], torch.full((2, 3), 2.0))
    assert torch.equal(merged["a.b"], torch.zeros(3)) and torch.equal(merged["c"], torch.ones(4))
    np.testing.assert_array_equal(np.asarray(jmerged["a"]["w"]), merged["a.w"].numpy())


# ------------------------------------------------------------ the agents
def test_resizes_equal_cv2():
    rs = np.random.RandomState(13)
    for src, dst in (((480, 640), (256, 256)), ((100, 90), (256, 256)), ((300, 300), (256, 256)),
                     ((57, 31), (224, 224)), ((480, 640), (224, 224)), ((240, 320), (224, 224))):
        depth = rs.uniform(0, 10, src).astype(np.float32)
        np.testing.assert_array_equal(tagents.resize_nearest(depth, dst),
                                      cv2.resize(depth, dst[::-1], interpolation=cv2.INTER_NEAREST))
        rgb = rs.randint(0, 256, src + (3,)).astype(np.float32)
        # cv2's float path rounds its interpolation weights (up to 0.0127
        # apart at 480x640 → 224x224): within 255 * 2^-14
        np.testing.assert_allclose(tagents.resize_bilinear(rgb, dst),
                                   cv2.resize(rgb, dst[::-1], interpolation=cv2.INTER_LINEAR),
                                   atol=255 * 2.0 ** -14)


STREAMS, COHORTS, MAX_STEP = 2, 2, 6


def agent_cfg(cfgs, out_dir, name, eval_type, small):
    settings = {"text_encoder": small.text_encoder, "image_encoder": small.image_encoder,
                "state_encoder": small.state_encoder, "device": "cpu"}
    return cfgs.EvalCfg(
        agent=cfgs.AgentCfg(model_name=name, model_settings=settings),
        env=cfgs.EnvCfg(env_type="fake", env_num=STREAMS,
                        env_settings={"rgb_resolution": [RGB, RGB],
                                      "depth_resolution": [DEPTH, DEPTH], "cohorts": COHORTS}),
        task=cfgs.TaskCfg(max_step=MAX_STEP), eval_type=eval_type, output_dir=str(out_dir))


def small_agent_class(base):
    """`base` at the small frames, recording each step's actions."""
    class Small(base):
        rgb_size, depth_size = (RGB, RGB), (DEPTH, DEPTH)
        log = []

        def step_coroutine(self, obs):
            out = yield from super().step_coroutine(obs)
            Small.log.append([o["action"][0] for o in out])
            return out

    return Small


@pytest.fixture(scope="module", params=["cma", "seq2seq"])
def pair(request):
    """A JAX policy (jitted forward) and the port's with its weights. With
    random weights every env's features sit near one point and the argmax
    never moves: the action head is centred on the mean logits of a few
    random inputs and widened, so that it does."""
    name = request.param
    cfg_j, cfg_t = small_cfg(jget_config, name), small_cfg(tmodel_zoo.get_config, name)
    layers = 2 if name == "cma" else 1
    obs, states, pa, masks = net_inputs(np.random.RandomState(14), layers, n=STREAMS)
    jm = jax_net(name, cfg_j)
    p = jax_params(jm, obs, states, pa, masks, seed=15)
    convert = cma_state_from_jax if name == "cma" else seq2seq_state_from_jax
    tpol = _policy(name, cfg_t)
    tpol.net.load_state_dict(convert(p, tpol.net))
    obs, states, pa, masks = net_inputs(np.random.RandomState(16), layers, n=8)
    with torch.no_grad():
        logits, _, _ = tpol.net(t_(obs), torch.from_numpy(states), torch.from_numpy(pa),
                                torch.ones(8))
    head = p["action_head"]
    head["bias"] = 20.0 * (head["bias"] - logits.mean(0).numpy())
    head["kernel"] = 20.0 * head["kernel"]
    tpol.net.load_state_dict(convert(p, tpol.net))
    jpol = (jcma.CMAPolicy if name == "cma" else jseq.Seq2SeqPolicy)(jm, p, cfg_j)
    return name, jpol, tpol, cfg_t


def run(pair, tmp, mod, pipelined):
    name, jpol, tpol, small = pair
    is_jax = mod == "jax"
    cfgs, agents = (jconfigs, jagents) if is_jax else (tconfigs, tagents)
    cls = small_agent_class(agents.CmaAgent if name == "cma" else agents.Seq2SeqAgent)
    cfg = agent_cfg(cfgs, tmp / f"{mod}_{pipelined}", name,
                    "vln_pipelined" if pipelined else "vln_batched", small)
    if is_jax:
        cfg.agent.model_settings.pop("device")
    agent = cls(cfg.agent, policy=jpol if is_jax else tpol)
    eps = episodes(jepisodes if is_jax else tepisodes, 4)
    if pipelined:
        ev = (jpipe if is_jax else tpipe).VLNPipelinedEvaluator(cfg, episodes=eps, agent=agent)
    else:
        ev = (jvln if is_jax else tvln).VLNBatchedEvaluator(cfg, episodes=eps, agent=agent)
    metrics = ev.eval()
    return metrics, {r["key"]: r["info"] for r in ev.store.records()}, cls.log


@pytest.mark.parametrize("pipelined", [False, True])
def test_agents_act_as_jax(pair, tmp_path, pipelined):
    """Every step's actions, every episode's record and the metrics equal
    JAX's; pipelined cohorts share cohort 0's policy object."""
    jm, jrec, jlog = run(pair, tmp_path, "jax", pipelined)
    tm, trec, tlog = run(pair, tmp_path, "port", pipelined)
    assert tlog == jlog
    assert len({a for step in tlog for a in step}) > 1  # the argmax moves
    assert trec.keys() == jrec.keys() and len(trec) == 4
    for k in trec:
        assert trec[k] == jrec[k], k
    for k in ("success", "spl", "osr", "NE", "TL", "ndtw", "steps", "num_episodes"):
        assert tm[k] == pytest.approx(jm[k]), k


def test_pipelined_cohorts_share_one_policy(pair, tmp_path):
    name, _, tpol, small = pair
    cfg = agent_cfg(tconfigs, tmp_path, name, "vln_pipelined", small)
    agent = small_agent_class(tagents.CmaAgent if name == "cma" else tagents.Seq2SeqAgent)(
        cfg.agent, policy=tpol)
    ev = tpipe.VLNPipelinedEvaluator(cfg, episodes=episodes(tepisodes, 4), agent=agent)
    other = ev._make_cohort_agent(1)
    assert type(other) is type(agent) and other.policy is tpol and other is not agent


def test_agent_reset_slices_equal_jax(pair):
    name, jpol, tpol, small = pair
    jcls = jagents.CmaAgent if name == "cma" else jagents.Seq2SeqAgent
    tcls = tagents.CmaAgent if name == "cma" else tagents.Seq2SeqAgent
    jcfg = agent_cfg(jconfigs, "unused", name, "vln_batched", small).agent
    jcfg.model_settings.pop("device")
    ja = small_agent_class(jcls)(jcfg, policy=jpol)
    ta = small_agent_class(tcls)(agent_cfg(tconfigs, "unused", name, "vln_batched",
                                           small).agent, policy=tpol)
    rs = np.random.RandomState(17)
    for step in range(4):
        obs = [{"instruction": rs.randint(1, 50, rs.randint(1, 9)),
                "rgb": rs.randint(0, 255, (RGB, RGB, 3)).astype(np.uint8),
                "depth": rs.uniform(0, 1, (DEPTH, DEPTH, 1)).astype(np.float32)}
               for _ in range(3)]
        assert ta.step(obs) == ja.step(obs)
        if step == 1:
            ja.reset([1])
            ta.reset([1])
            assert not ta._states[1].any() and ta._not_done.tolist() == [1.0, 0.0, 1.0]
        np.testing.assert_allclose(ja._states, ta._states.numpy(), atol=NET_TOL, rtol=NET_TOL)
        np.testing.assert_array_equal(ja._prev_actions, ta._prev_actions.numpy())
        np.testing.assert_array_equal(ja._not_done, ta._not_done.numpy())
    ta.reset()
    assert not ta._states.any() and not ta._not_done.any()


def test_agent_builds_on_the_device_it_is_given(monkeypatch):
    """No policy handed in: "cpu" builds on the host; without a device the
    GPU is asked for, and without one the agent raises (no fallback)."""
    small = small_cfg(tmodel_zoo.get_config, "seq2seq")
    cfg = agent_cfg(tconfigs, "unused", "seq2seq", "vln_batched", small).agent
    agent = tagents.Seq2SeqAgent(cfg)
    assert agent.policy.device == torch.device("cpu") and agent.num_layers == 1
    assert agent.model_cfg.state_encoder.hidden_size == 32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg.model_settings.pop("device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tagents.Seq2SeqAgent(cfg)
