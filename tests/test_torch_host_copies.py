"""The port's copies of the JAX package's host-only modules held equal to
their originals on the CPU: `utils/misc.py` (batch_obs, unbatch_obs,
set_seed; `tree_device_put` onto a torch device), `utils/metric_logger.py`
(SmoothedValue, MetricLogger and its log_every lines; the cross-process
sum over a two-rank gloo group), `utils/profiling.py` (PhaseTimer,
TensorBoardWriter's bytes; the torch.profiler trace and its ranges),
`realworld/env.py` with injected camera and command functions,
`realworld/agilex.py` (the recorder; hardware imports only in
constructors) and `dataset/vlln_dataset.py` (its samples and the
combined stream)."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu import configs as jconfigs
from internnav_tpu.dataset import vlln_dataset as jvlln
from internnav_tpu.realworld import agilex as jagilex
from internnav_tpu.realworld import env as jenv
from internnav_tpu.utils import metric_logger as jml
from internnav_tpu.utils import misc as jmisc
from internnav_tpu.utils import profiling as jprof
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.dataset import vlln_dataset as tvlln
from internnav_tpu_torch.dataset.traj_store import TrajStore
from internnav_tpu_torch.env.base import env_registry
from internnav_tpu_torch.realworld import agilex as tagilex
from internnav_tpu_torch.realworld import env as tenv
from internnav_tpu_torch.utils import metric_logger as tml
from internnav_tpu_torch.utils import misc as tmisc
from internnav_tpu_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parents[1]


def _obs(rs, i):
    return {"rgb": rs.randint(0, 255, (4, 4, 3)).astype(np.uint8), "depth": rs.rand(4, 4, 1),
            "instruction": np.arange(i, i + 3), "text": f"go {i}", "step": i, "flag": i % 2 == 0,
            "scale": 0.5 * i, "nested": {"pose": rs.rand(3), "name": f"n{i}"}}


def _equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_batch_obs_and_seed_equal_jax():
    rs = np.random.RandomState(0)
    obs = [_obs(rs, i) for i in range(3)]
    j, t = jmisc.batch_obs(obs, {"depth": np.float32}), tmisc.batch_obs(obs, {"depth": np.float32})
    _equal(j, t)
    assert t["depth"].dtype == np.float32 and t["text"] == ["go 0", "go 1", "go 2"]
    for i in range(3):
        _equal(jmisc.unbatch_obs(j, i), tmisc.unbatch_obs(t, i))
    assert tmisc.batch_obs([]) == jmisc.batch_obs([]) == {}
    tmisc.set_seed(5)
    a = (np.random.rand(), __import__("random").random())
    jmisc.set_seed(5)
    assert a == (np.random.rand(), __import__("random").random())
    dev = tmisc.tree_device_put(t, torch.device("cpu"))
    assert torch.is_tensor(dev["rgb"]) and dev["rgb"].dtype == torch.uint8
    assert torch.equal(dev["nested"]["pose"], torch.from_numpy(t["nested"]["pose"]))
    assert dev["text"] == t["text"]


class _Clock:
    """time.time stand-in: 0.5 s a call."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.5
        return self.t


@pytest.mark.parametrize("total", [None, 5])
def test_metric_logger_equals_jax(monkeypatch, total):
    lines = {}
    for name, mod in (("jax", jml), ("port", tml)):
        monkeypatch.setattr(mod.time, "time", _Clock())
        log = mod.MetricLogger(delimiter=" | ")
        out = []
        for i in log.log_every(range(5), 2, header="train", total=total,
                               logger=type("L", (), {"info": staticmethod(out.append)})):
            log.update(loss=1.0 / (i + 1), lr=1e-3 * i)
        log.synchronize_between_processes()  # one process: no-op
        sv = mod.SmoothedValue(window_size=3)
        for v in (4.0, 1.0, 3.0, 2.0):
            sv.update(v, n=2)
        lines[name] = (out, str(log), log.loss.global_avg, str(sv), sv.median, sv.avg, sv.max,
                       sv.value, sv.count, sv.total)
        with pytest.raises(AttributeError):
            log.nope
    assert lines["port"] == lines["jax"]


_SYNC = """
import sys, torch.distributed as dist
sys.path.insert(0, {repo!r})
from internnav_tpu_torch.utils.metric_logger import MetricLogger
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", rank=rank, world_size=2)
log = MetricLogger()
for v in range(rank + 1):
    log.update(loss=float(v + 10 * rank))
log.synchronize_between_processes()
print(log.loss.count, log.loss.total, flush=True)
dist.destroy_process_group()
"""


def test_metric_logger_sums_over_a_process_group():
    """Two gloo ranks: counts 1 and 2, totals 0 and 10 + 11; each rank
    then holds the sums (3, 21), as the reference's all_reduce gives."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = _SYNC.format(repo=str(REPO), port=port)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
                              text=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["3", "21.0"], ["3", "21.0"]]


def test_phase_timer_equals_jax(monkeypatch):
    got = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        ticks = iter(np.arange(0.0, 10.0, 0.25))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(ticks)))
        pt = mod.PhaseTimer()
        for phase in ("env_step", "agent_step", "env_step"):
            with pt.phase(phase):
                pass
        got[name] = pt.summary()
    assert got["port"] == got["jax"]
    assert got["port"]["env_step"]["count"] == 2


def test_tensorboard_writer_bytes_equal_jax(tmp_path, monkeypatch):
    data = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
        tb = mod.TensorBoardWriter(str(tmp_path / name))
        for step, value in ((1, 1.5), (2, 1.25), (300, -0.125)):
            tb.add_scalar("train/loss", value, step=step)
        tb.close()
        (f,) = os.listdir(tmp_path / name)
        data[name] = (f, (tmp_path / name / f).read_bytes())
    assert data["port"] == data["jax"]
    assert tprof._masked_crc32(b"abc") == jprof._masked_crc32(b"abc")


def test_trace_writes_a_profile_with_named_ranges(tmp_path):
    with tprof.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    with tprof.trace(str(tmp_path / "on")):
        with tprof.annotate("policy_step"):
            torch.ones(8).sum()
    text = (tmp_path / "on" / "trace.json").read_text()
    assert "policy_step" in text


def test_realworld_env_equals_jax():
    """The same injected camera and command sink: the same observations
    and velocity commands, the env registered as "realworld"."""
    got = {}
    for name, mod, cfgs in (("jax", jenv, jconfigs), ("port", tenv, tconfigs)):
        commands = []
        frames = iter(range(1, 10_000))
        env = mod.RealWorldEnv(cfgs.EnvCfg(env_type="realworld", env_settings={
            "camera_fn": lambda: {"rgb": np.full((8, 8, 3), 7, np.uint8), "n": next(frames)},
            "command_fn": lambda v, w, d: commands.append((v, w, d)),
            "capture_hz": 200, "action_duration_s": 0.01}))
        obs = env.reset()
        steps = [env.step([a]) for a in (1, 2, 3, {"action": [0]}, 9)]
        env.close()
        strip = [{k: v for k, v in o[0].items() if k != "n"} for o in [obs, *steps]]
        got[name] = (commands, strip, env.is_running)
    assert got["port"][0] == got["jax"][0]
    assert len(got["port"][1]) == len(got["jax"][1])
    for a, b in zip(got["port"][1], got["jax"][1]):
        _equal(a, b)
    assert env_registry.get("realworld") is tenv.RealWorldEnv
    assert tenv.ACTION_TO_VELOCITY == jenv.ACTION_TO_VELOCITY


def test_realworld_env_without_frames_sends_a_blank_observation():
    env = tenv.RealWorldEnv(tconfigs.EnvCfg(env_type="realworld", env_settings={
        "camera_fn": lambda: (_ for _ in ()).throw(RuntimeError("no frame")),
        "capture_hz": 200}))
    time.sleep(0.02)
    (obs,) = env.get_observation()
    env.close()
    assert obs["rgb"].shape == (224, 224, 3) and obs["finish_action"] and not obs["done"]


def test_agilex_glue_equals_jax(tmp_path, monkeypatch):
    """The recorder writes the same files; the RealSense and ROS classes
    import their hardware modules only when built or started."""
    rs = np.random.RandomState(3)
    obs = {"rgb": rs.randint(0, 255, (6, 5, 3)).astype(np.uint8), "depth": rs.rand(6, 5)}
    out = {}
    for name, mod in (("jax", jagilex), ("port", tagilex)):
        monkeypatch.setattr(mod.time, "time", lambda: 12.5)
        rec = mod.ObsRecorder(str(tmp_path / name))
        rec.save(obs, action=2, pose=np.array([1.0, 2.0]))
        rec.save({"depth": obs["depth"]}, action=np.array([1, 3]))
        rec.close()
        out[name] = {f: (tmp_path / name / f).read_bytes()
                     for f in sorted(os.listdir(tmp_path / name))}
    assert out["port"] == out["jax"] and len(out["port"]) == 4
    for mod in (jagilex, tagilex):
        cam = mod.AlignedRealSense(serial_no="x", warmup_frames=1)
        assert cam.pipeline is None
        cam.stop()  # nothing started
        with pytest.raises(ImportError):
            cam.start()
        with pytest.raises(ImportError):
            mod.RosBaseController()


def test_vlln_dataset_equals_jax(tmp_path):
    """The port's writer and the JAX one write the same episodes; both
    readers yield the same dialog-aware samples, and the combined stream
    interleaves as JAX's does."""
    tpath = tvlln.write_synthetic_vlln_dataset(str(tmp_path / "t.store"), n_episodes=3, T=7)
    jpath = jvlln.write_synthetic_vlln_dataset(str(tmp_path / "j.store"), n_episodes=3, T=7)
    stores = [TrajStore(p, writable=False) for p in (tpath, jpath)]
    assert stores[0].keys() == stores[1].keys() and len(stores[0]) == 3
    for k in stores[0].keys():
        _equal(stores[0].get_tree(k), stores[1].get_tree(k))

    def samples(mod, path):
        return [(s.prompt, s.answer, s.images.tobytes(), s.images.shape)
                for s in mod.VLLNSampleDataset(path, num_history=3)]

    t, j = samples(tvlln, jpath), samples(jvlln, jpath)
    assert t == j and any("The resident replied" in p for p, *_ in t)
    assert any(a == "which room is it in?" for _, a, *_ in t)
    mix_t = [x for x in tvlln.CombinedDataset([range(5), "ab"], [2, 1])]
    mix_j = [x for x in jvlln.CombinedDataset([range(5), "ab"], [2, 1])]
    assert mix_t == mix_j == [0, 1, "a", 2, 3, "b", 4]
