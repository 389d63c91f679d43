"""`BatchedInternVLAN1Agent` of the port against the JAX package's, the
torch bench entry of the evaluator path, and the port's `graft_entry`.

- Scheduling: both agents over the same scripted stub policies (System-2
  answers a latent, actions with a look-down, or nothing; System-1 a few
  actions) take the same actions, call System-2 and System-1 for the same
  slots at the same steps and yield at the same points, with and without
  the shared decode and System-1 pools, through slot resets. This mirrors
  tests/test_batched_agent_e2e.py, which holds the JAX batched agent to
  the single-stream one.
- The bench entry (`scripts/torch/bench_evaluator.py`): its JSON (median,
  samples, spread, metric name, the baseline) on stub runs; the whole
  entry on the CPU with the tiny model; a run that fails, or a machine
  without a GPU, exits non-zero and prints no value; run as a script it
  pins Python's str hash.
- `graft_entry.entry()`: the small-config forward runs on the CPU when
  asked, and asks for the GPU otherwise; in fp32 on the JAX model's
  weights it equals the JAX model at the same config.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu.agent.internvla_n1_agent import BatchedInternVLAN1Agent as JAgent
from internnav_tpu.configs import AgentCfg as JAgentCfg
from internnav_tpu.model.utils.vln_utils import S1Output as JS1, S2Output as JS2
from internnav_tpu_torch import graft_entry
from internnav_tpu_torch.agent.internvla_n1_agent import BatchedInternVLAN1Agent as TAgent
from internnav_tpu_torch.configs import AgentCfg as TAgentCfg
from internnav_tpu_torch.model.utils.vln_utils import S1Output as TS1, S2Output as TS2

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
B = 3


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench_evaluator", REPO / "scripts" / "torch" / "bench_evaluator.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _bench()


class _Script:
    """Per-slot System-2 and System-1 answers keyed by call count, in
    either package's output types; every call is logged."""

    S2 = ("latent", "actions", "look_down", "latent", "nothing")

    def __init__(self, s2_cls, s1_cls):
        self.s2_cls, self.s1_cls = s2_cls, s1_cls
        self.calls = {"s2": {}, "s1": {}}
        self.log = []

    def s2(self, slot):
        n = self.calls["s2"][slot] = self.calls["s2"].get(slot, 0) + 1
        kind = self.S2[(n + slot) % len(self.S2)]
        if kind == "latent":
            return self.s2_cls(idx=slot, output_pixel=np.array([5, 7]),
                               output_latent=np.full((1, 2, 4), slot + n, np.float32))
        if kind == "actions":
            return self.s2_cls(idx=slot, output_action=[1, 2, 1][: 1 + n % 3])
        if kind == "look_down":
            return self.s2_cls(idx=slot, output_action=[5, 3])
        return self.s2_cls(idx=slot, output_action=[])

    def s1(self, slot):
        n = self.calls["s1"][slot] = self.calls["s1"].get(slot, 0) + 1
        return self.s1_cls(idx=[1, 3, 2, 1, 1, 2][n % 3:n % 3 + 2 + n % 4],
                           trajectory=np.full((4, 8, 3), slot * 10 + n, np.float32))


class _Slot:
    def __init__(self):
        self.instruction = ""


class _StubPolicy:
    """The batched policy's interface, answering from a `_Script`."""

    device = torch.device("cpu")

    def __init__(self, script):
        self.script = script
        self.slots = [_Slot() for _ in range(B)]

    def reset_slot(self, i, instruction):
        self.script.log.append(("reset", i, instruction))
        self.slots[i].instruction = instruction

    def s2_submit(self, images, max_new_tokens=128, slot_ids=None):
        self.script.log.append(("s2", tuple(slot_ids), images.shape, max_new_tokens))
        return {"slot_ids": slot_ids}

    s2_prefill_submit = s2_submit

    def s2_collect(self, handle):
        return [self.script.s2(i) for i in handle["slot_ids"]]

    def s1_submit(self, rgb, latents, num_sample_trajs=32, slot_ids=None):
        lat = np.asarray(latents)
        self.script.log.append(("s1", tuple(slot_ids), rgb.shape, lat.shape,
                                float(lat.sum()), num_sample_trajs))
        return {"slot_ids": slot_ids}

    def s1_prepare(self, rgb, latents, num_sample_trajs=32, slot_ids=None):
        return {"handle": self.s1_submit(rgb, latents, num_sample_trajs, slot_ids)}

    def s1_collect(self, handle):
        return [self.script.s1(i) for i in handle["slot_ids"]]


class _Pool:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def add(self, item):
        self.log.append((self.name, "add"))

    def flush(self):
        self.log.append((self.name, "flush"))


def _obs(t, i):
    r = np.random.default_rng(100 * t + i)
    return {"rgb": r.integers(0, 256, (8, 8, 3)).astype(np.uint8),
            "depth": r.uniform(0, 1, (8, 8, 1)).astype(np.float32),
            "instruction_text": f"go to the door {i}" if t < 9 else f"now the sofa {i}"}


def _drive(agent_cls, cfg_cls, s2_cls, s1_cls, settings, pools):
    script = _Script(s2_cls, s1_cls)
    agent = agent_cls(cfg_cls(model_name="internvla_n1_batched",
                              model_settings={**settings, "batch_size": B}),
                      policy=_StubPolicy(script))
    if pools:
        agent.decode_pool = _Pool(script.log, "decode_pool")
        agent.s1_pool = _Pool(script.log, "s1_pool")
    steps = []
    for t in range(16):
        if t in (6, 11):
            agent.reset([t % B])
        gen, yields = agent.step_coroutine([_obs(t, i) for i in range(B)]), 0
        while True:
            try:
                next(gen)
                yields += 1
                script.log.append(("yield", t))
            except StopIteration as stop:
                outs = stop.value
                break
        steps.append((yields, [(o["action"], o["ideal_flag"], None if "trajectory" not in o
                                else o["trajectory"].tolist()) for o in outs]))
    return steps, script.log, [st.steps_since_s2 for st in agent.states]


@pytest.mark.parametrize("pools", [False, True])
@pytest.mark.parametrize("settings", [
    {"infer_mode": "partial_async", "sys2_max_forward_step": 3, "max_local_steps": 2},
    {"infer_mode": "partial_async", "sys2_max_forward_step": 8, "max_local_steps": 4,
     "max_new_tokens": 20, "num_sample_trajs": 5},
    {"infer_mode": "sync", "max_local_steps": 3}])
def test_scheduling_equals_the_jax_agent(settings, pools):
    got = _drive(TAgent, TAgentCfg, TS2, TS1, settings, pools)
    want = _drive(JAgent, JAgentCfg, JS2, JS1, settings, pools)
    assert got == want
    log = got[1]
    assert any(e[0] == "s1" for e in log) and any(e[0] == "s2" for e in log)
    assert any(a != [0] for _, outs in got[0] for a, _, _ in outs)


def test_step_runs_the_coroutine_to_its_end():
    script = _Script(TS2, TS1)
    agent = TAgent(TAgentCfg(model_settings={"batch_size": B}), policy=_StubPolicy(script))
    outs = agent.step([_obs(0, i) for i in range(B)])
    assert len(outs) == B and all(len(o["action"]) == 1 for o in outs)
    assert agent.decode_pool is None and agent.s1_pool is None


# ------------------------------------------------------------ bench entry
def _run(aps, steps=(24, 24)):
    return {"actions_per_sec": aps, "action_latency_p50_ms": 1.0, "actions_timed": 48,
            "wall_clock_s": 48 / aps if aps else 1.0, "episodes": 2, "episode_steps": list(steps),
            "records": [{}]}


def test_bench_assembles_the_headline_line():
    runs = [_run(40.0), _run(30.0), _run(35.0)]
    out = bench.assemble(runs, extra={"peak_mem_gib": 11.5})
    assert out["metric"] == "internvla_n1_dual_system_actions_per_sec_per_chip_7b_evaluator_median3"
    assert out["value"] == 35.0 and out["unit"] == "actions/s"
    assert out["vs_baseline"] == 35.0 / bench.REF_ACTIONS_PER_SEC
    d = out["detail"]
    assert d["evaluator_path_samples"] == [30.0, 35.0, 40.0]
    assert d["evaluator_path_spread"] == {"min": 30.0, "max": 40.0, "rel_spread": 10.0 / 35.0}
    assert d["evaluator_path"]["actions_per_sec"] == 35.0 and "records" not in d["evaluator_path"]
    assert d["peak_mem_gib"] == 11.5
    assert bench.median([1.0, 2.0, 4.0, 8.0]) == 3.0
    tiny = bench.assemble(runs[:2], tiny=True)
    assert tiny["metric"].endswith("_tiny_evaluator_median2") and "vs_baseline" not in tiny
    with pytest.raises(RuntimeError, match="actions/s"):
        bench.assemble([_run(0.0)])


def test_bench_constants_equal_bench_py():
    """The entry copies bench.py's baseline and headline constants (it may
    not import bench.py, which imports the JAX package)."""
    import bench as jbench

    assert bench.REF_A100_MS == jbench.REF_A100
    assert bench.REF_ACTIONS_PER_SEC == jbench.REF_ACTIONS_PER_SEC
    assert round(bench.REF_ACTIONS_PER_SEC, 1) == 21.2
    assert (bench.DECODE_TOKENS, bench.NUM_SAMPLE_TRAJS, bench.IMAGE_HW,
            bench.ACTIONS_PER_CYCLE) == (jbench.DECODE_TOKENS, jbench.NUM_SAMPLE_TRAJS,
                                         jbench.IMAGE_HW, jbench.ACTIONS_PER_CYCLE)


def test_bench_entry_runs_the_tiny_evaluator_on_the_cpu(capsys):
    assert bench.main(["--tiny"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["metric"].endswith("_tiny_evaluator_median3") and out["value"] > 0
    d = out["detail"]
    assert len(d["evaluator_path_samples"]) == 3
    assert d["evaluator_path"]["episodes"] == 4 and d["device"] == {"platform": "cpu"}
    assert d["config"]["shared_decode"] and not d["config"]["overlap_apply"]
    assert d["peak_mem_gib"] == "not measured"


def test_bench_entry_runs_the_navdp_system1_on_the_cpu(capsys):
    """`--system1 navdp_async`: the agents hand the NavDP head RGBD pairs;
    the metric names the head and carries no baseline (the A100
    estimate's System-1 is NextDiT)."""
    assert bench.main(["--tiny", "--system1", "navdp_async"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"].endswith("_tiny_evaluator_median3_navdp_async") and out["value"] > 0
    assert out["detail"]["config"]["system1"] == "navdp_async"
    seven_b = bench.assemble([_run(20.0)], system1="navdp_async")
    assert seven_b["metric"].endswith("_7b_evaluator_median1_navdp_async")
    assert "vs_baseline" not in seven_b


def test_a_failing_bench_run_prints_no_value(monkeypatch, capsys):
    run = bench.evaluator_run

    def broken(*args, **kwargs):
        out = run(*args, **kwargs)
        return {**out, "actions_per_sec": 0.0}

    monkeypatch.setattr(bench, "evaluator_run", broken)
    with pytest.raises(RuntimeError, match="measured"):
        bench.main(["--tiny"])
    assert capsys.readouterr().out == ""


def test_bench_entry_without_a_gpu_exits_non_zero():
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "torch" / "bench_evaluator.py")],
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_bench_entry_pins_the_str_hash(tmp_path):
    """Run as a script, the entry re-executes itself with PYTHONHASHSEED
    pinned: FakeEnv seeds its frames with hash(path_key), so every process
    then evaluates the same frames."""
    script = tmp_path / "hashes.py"
    script.write_text(
        "import importlib.util, os, sys\n"
        f"spec = importlib.util.spec_from_file_location('b', {str(bench.__file__)!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "m.pin_hash_seed(sys.argv)\n"
        "print(os.environ['PYTHONHASHSEED'], hash('bench_t0_0'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    outs = [subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                           timeout=120, env={**env, **extra}, check=True).stdout
            for extra in ({}, {}, {"PYTHONHASHSEED": "random"})]
    assert outs[0].split()[0] == bench.HASH_SEED and outs[0] == outs[1] == outs[2]


# ------------------------------------------------------------ graft entry
def test_graft_entry_forward_on_the_cpu_when_asked(monkeypatch):
    fn, args = graft_entry.entry(device="cpu")
    logits, traj = fn(*args)
    cfg = graft_entry.small_n1_config()
    assert logits.shape == (1, 64, cfg.text.vocab_size) and torch.isfinite(logits).all()
    assert traj.shape == (4, cfg.predict_step_nums, 3) and torch.isfinite(traj).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_graft_entry_forward_equals_the_jax_model(monkeypatch):
    """entry(device="cpu") in fp32 on the JAX model's weights (through
    `from_jax`) against the JAX model at the same config: the prefill's
    logits and the trajectories denoised from the same starting noise
    within 1e-4 (fp32, other summation orders)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
    from internnav_tpu.model.basemodel.internvla_n1.qwen_text import QwenTextConfig
    from internnav_tpu.model.basemodel.internvla_n1.qwen_vision import QwenVisionConfig
    from test_torch_system1 import F32NextDiTConfig, n1_params

    monkeypatch.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
    t = graft_entry.small_n1_config(torch.float32)
    text = QwenTextConfig(**{f.name: getattr(t.text, f.name) for f in dataclasses.fields(
        QwenTextConfig) if f.name in ("vocab_size", "hidden_size", "intermediate_size",
                                      "num_hidden_layers", "num_attention_heads",
                                      "num_key_value_heads", "head_dim", "mrope_section")},
                          dtype=jnp.float32)
    vision = QwenVisionConfig(**{f.name: getattr(t.vision, f.name) for f in dataclasses.fields(
        QwenVisionConfig) if f.name in ("depth", "hidden_size", "intermediate_size",
                                        "num_heads", "window_size", "fullatt_block_indexes",
                                        "out_hidden_size")}, dtype=jnp.float32)
    cfg = jmodel.InternVLAN1Config(text=text, vision=vision, system1=t.system1,
                                   n_query=t.n_query, predict_step_nums=t.predict_step_nums,
                                   image_token_index=t.image_token_index,
                                   traj_token_index=t.traj_token_index)
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, cfg, seed=2)
    fn, args = graft_entry.entry(device="cpu", dtype=torch.float32, params=params)
    logits, traj = fn(*args)
    ids, img, pos, x_init = (jnp.asarray(a.numpy()) for a in args)

    def forward(mdl):
        logits, hidden, _ = mdl.prefill(mdl.embed_multimodal(ids, img), pos)
        traj = mdl.generate_traj_nextdit(hidden[:, -cfg.n_query:, :], x_init=x_init,
                                         num_inference_steps=4, num_sample_trajs=4)
        return logits, traj

    want = jax.jit(lambda p: jm.apply({"params": p}, method=forward))(params)
    for got, ref in zip((logits, traj), want):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
