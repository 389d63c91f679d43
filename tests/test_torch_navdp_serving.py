"""Batched serving and the evaluator path of the port's NavDP System-1
(`navdp_async`, `navdp`), mirroring the JAX package's
tests/test_serving_navdp.py, and against the JAX package:

- `BatchedN1Policy` at B = 1 equals the single-stream policy (the same
  generator seed gives the same draws), rows are independent (each row of
  a batch equals its own single-stream run), several cohorts' specs
  grouped by `s1_grouped_dispatch` equal per-cohort dispatch, the sync
  head reads the latents alone, and the batched NavDP System-1 of a padded
  bucket equals the JAX package's with JAX's draws handed in;
- `PipelinedN1Server` with navdp cohorts ((rgb, depth) frames for the
  System-1 phases) equals the cohorts run sequentially, and its stream
  with the shared grouped System-1 equals the one without;
- `VLNPipelinedEvaluator` over FakeEnv driving `BatchedInternVLAN1Agent`
  navdp cohorts equals the JAX evaluator (per-cohort and shared System-1):
  per episode the actions and metrics exactly, trajectories at 1e-4.

Tiny fp32 weights are numpy draws carried across by
`model/weights/from_jax.py`. Port against port with the same shapes is
held bitwise; across batch sizes at 1e-5 (the products' summation order).
"""

import numpy as np
import pytest
import torch

import jax

from internnav_tpu import configs as jconfigs
from internnav_tpu.agent.internvla_n1_agent import BatchedInternVLAN1Agent as JAgent
from internnav_tpu.env import episodes as jepisodes
from internnav_tpu.evaluator import vln_pipelined_evaluator as jpipe
from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import serving as jserving
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.agent.internvla_n1_agent import BatchedInternVLAN1Agent as TAgent
from internnav_tpu_torch.env import episodes as tepisodes
from internnav_tpu_torch.evaluator import vln_pipelined_evaluator as tpipe
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import serving as tserving
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from test_torch_evaluator import assert_runs_equal, episodes, eval_cfg, record_steps
from test_torch_system1 import f32_config, n1_params

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
ROW_TOL = 1e-5
HW = 56
NST = 4
P = 8  # the tiny head's waypoints
STEPS = 20
INSTR = ["walk to the kitchen and stop", "turn left at the sofa then stop"]


def build_navdp_pair(system1="navdp_async"):
    cfg = f32_config(system1)
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, cfg, seed=3)
    tcfg = InternVLAN1Config.tiny(system1, dtype=torch.float32)
    tm = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
    return JPolicy(jm, params, cfg), tpolicy.InternVLAN1Policy(tm)


@pytest.fixture(scope="module")
def pair():
    return build_navdp_pair()


def jax_navdp_noise(key):
    """A port cohort's `noise_fn` drawing what a JAX navdp cohort whose
    `_rng` starts at `key` draws per System-1 call: a split, x_init from
    the new subkey, the step noise from fold_in(subkey, 1)."""
    state = {"rng": key}

    def draw(shape):
        if len(shape) == 3:
            state["rng"], state["sub"] = jax.random.split(state["rng"])
            return torch.from_numpy(np.array(jax.random.normal(state["sub"], shape)))
        return torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(state["sub"], 1), shape)))

    return draw


def rgbd(seed, b, hw=HW):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (b, 2, hw, hw, 3)).astype(np.uint8),
            r.uniform(0.0, 4.0, (b, 2, hw, hw, 1)).astype(np.float32))


def latents(seed, b, cfg):
    return torch.from_numpy(0.1 * np.random.default_rng(seed).standard_normal(
        (b, cfg.n_query, cfg.text.hidden_size)).astype(np.float32))


def test_batched_b1_equals_the_single_stream(pair):
    """B = 1 with the policy's seed draws what the single-stream policy
    draws (x_init, then the step noise) and gives its trajectory bit for
    bit, and its actions."""
    _, tpol = pair
    b1 = tserving.BatchedN1Policy(tpol, 1, seed=tpol.seed)
    lat = latents(0, 1, tpol.cfg)
    rgb, depth = rgbd(7, 1)
    tpol.reset()
    ref = tpol.s1_step_latent(rgb, depth, lat, num_sample_trajs=NST)
    got = b1.s1_step_latent(rgb, lat, num_sample_trajs=NST, depth=depth)[0]
    np.testing.assert_array_equal(got.trajectory, ref.trajectory)
    assert got.idx == ref.idx


def test_batched_rows_are_independent(pair):
    """Two streams with their own noise in one call: each row block equals
    that stream's single-stream run."""
    _, tpol = pair
    lat = latents(1, 2, tpol.cfg)
    rgb, depth = rgbd(8, 2)
    g = torch.Generator().manual_seed(9)
    draws = [(torch.randn(NST, P, 3, generator=g), torch.randn(STEPS, NST, P, 3, generator=g))
             for _ in range(2)]
    refs = [tpol.s1_step_latent(rgb[b:b + 1], depth[b:b + 1], lat[b:b + 1], num_sample_trajs=NST,
                                x_init=x, step_noises=z).trajectory
            for b, (x, z) in enumerate(draws)]
    pol = tserving.BatchedN1Policy(tpol, 2)
    joined = iter([torch.cat([x for x, _ in draws]), torch.cat([z for _, z in draws], dim=1)])
    pol.noise_fn = lambda shape: next(joined)
    outs = pol.s1_step_latent(rgb, lat, num_sample_trajs=NST, depth=depth)
    for b in range(2):
        np.testing.assert_allclose(outs[b].trajectory, refs[b], atol=ROW_TOL, rtol=ROW_TOL)


def test_batched_navdp_matches_jax_in_a_padded_bucket(pair):
    """Five streams take the bucket of 6 (row 0 repeated): the JAX
    package's batched NavDP with its draws handed to the port."""
    jpol, tpol = pair
    jb = jserving.BatchedN1Policy(jpol.model, jpol.params, jpol.cfg, 5, inner=jpol)
    tb = tserving.BatchedN1Policy(tpol, 5)
    tb.noise_fn = jax_navdp_noise(jb._rng)
    lat = latents(2, 5, tpol.cfg)
    rgb, depth = rgbd(10, 5)
    spec = tb.s1_prepare(rgb, lat, NST, depth=depth)
    assert spec["Bp"] == 6 and spec["step_noises"].shape == (STEPS, 6 * NST, P, 3)
    tb._s1_dispatch(spec)
    touts = tb.s1_collect(spec["handle"])
    jouts = jb.s1_step_latent(rgb, jax.numpy.asarray(lat.numpy()), num_sample_trajs=NST,
                              depth=depth)
    assert len(touts) == len(jouts) == 5
    for t, j in zip(touts, jouts):
        assert t.trajectory.shape == (NST, P, 3)
        np.testing.assert_allclose(t.trajectory, np.asarray(j.trajectory), atol=ATOL, rtol=RTOL)
        assert t.idx == j.idx


def _specs(tpol, seeds, lat, rgb, depth):
    pols = [tserving.BatchedN1Policy(tpol, 2, seed=s) for s in seeds]
    return [p.s1_prepare(rgb[2 * i:2 * i + 2], lat[2 * i:2 * i + 2], NST,
                         depth=depth[2 * i:2 * i + 2]) for i, p in enumerate(pols)]


def test_grouped_dispatch_equals_per_cohort(pair):
    """Three cohorts' navdp specs in one grouped denoise (x_init joined
    along the rows, the step noise along axis 1) equal each cohort's own
    dispatch: the same noise blocks, trajectories within ROW_TOL, actions
    equal."""
    _, tpol = pair
    lat = latents(3, 6, tpol.cfg)
    rgb, depth = rgbd(11, 6)
    per = _specs(tpol, (0, 1, 2), lat, rgb, depth)
    for s in per:
        s["policy"]._s1_dispatch(s)
    grouped = _specs(tpol, (0, 1, 2), lat, rgb, depth)
    for a, b in zip(per, grouped):
        torch.testing.assert_close(a["step_noises"], b["step_noises"], atol=0, rtol=0)
    tserving.s1_grouped_dispatch(grouped)
    for a, b in zip(per, grouped):
        ta, tb = (s["policy"].s1_collect(s["handle"]) for s in (a, b))
        for x, y in zip(ta, tb):
            np.testing.assert_allclose(y.trajectory, x.trajectory, atol=ROW_TOL, rtol=ROW_TOL)
            assert x.idx == y.idx


def test_sync_navdp_reads_the_latents_alone():
    """The sync head: no frames, no depth; B = 1 equals the single stream;
    two cohorts grouped equal per-cohort."""
    _, tpol = build_navdp_pair("navdp")
    lat = latents(4, 2, tpol.cfg)
    tpol.reset()
    ref = tpol.s1_step_latent(rgbd(12, 1)[0], None, lat[:1], num_sample_trajs=NST)
    b1 = tserving.BatchedN1Policy(tpol, 1, seed=tpol.seed)
    got = b1.s1_step_latent(None, lat[:1], num_sample_trajs=NST)[0]
    np.testing.assert_array_equal(got.trajectory, ref.trajectory)
    specs = [tserving.BatchedN1Policy(tpol, 1, seed=s).s1_prepare(None, lat[s:s + 1], NST)
             for s in range(2)]
    assert {s["mode"] for s in specs} == {"navdp_noimg"}
    alone = [tserving.BatchedN1Policy(tpol, 1, seed=s).s1_step_latent(None, lat[s:s + 1], NST)[0]
             for s in range(2)]
    tserving.s1_grouped_dispatch(specs)
    for s, a in zip(specs, alone):
        (o,) = s["policy"].s1_collect(s["handle"])
        np.testing.assert_allclose(o.trajectory, a.trajectory, atol=ROW_TOL, rtol=ROW_TOL)


def test_navdp_async_needs_rgbd_pairs(pair):
    _, tpol = pair
    pol = tserving.BatchedN1Policy(tpol, 1)
    rgb, _ = rgbd(13, 1)
    with pytest.raises(ValueError, match="pairs"):
        pol.s1_submit(rgb, latents(5, 1, tpol.cfg), NST)
    with pytest.raises(ValueError, match="pairs"):
        pol.s1_submit(rgb[:, 0], latents(5, 1, tpol.cfg), NST, depth=np.zeros((1, 2, HW, HW, 1)))


def _cohort_frames():
    """Per (cohort, cycle, phase): S2 frames (2, H, W, 3), then (rgb, depth)
    pairs for each System-1 call."""
    fr = {}
    for ci in range(2):
        for t in range(2):
            fr[(ci, t, 0)] = rgbd(20 + 4 * ci + t, 2)[0][:, 1]
            for ph in (1, 2):
                fr[(ci, t, ph)] = rgbd(40 + 8 * ci + 2 * t + ph, 2)
    return fr


def _server(tpol):
    server = tserving.PipelinedN1Server(tpol, 2, cohorts=2)
    for pol in server.cohorts:
        pol.reset(INSTR)
    return server


def _summary(s2, s1):
    return ([o.output_latent is not None for o in s2],
            [[(o.idx, o.trajectory) for o in call] for call in s1])


def _assert_same(a, b, tol=0.0):
    assert a[0] == b[0]
    for ca, cb in zip(a[1], b[1]):
        for (ia, ta), (ib, tb) in zip(ca, cb):
            assert ia == ib
            np.testing.assert_allclose(ta, tb, atol=tol, rtol=tol)


def test_pipelined_navdp_cohorts_equal_sequential_runs(pair):
    """serve_macro_cycle over two navdp cohorts equals each cohort stepped
    alone (S2, then its RGBD System-1 calls); serve_stream over two cycles
    with the shared grouped System-1 equals the stream without it."""
    _, tpol = pair
    fr = _cohort_frames()
    server = _server(tpol)
    got = server.serve_macro_cycle(lambda ci, ph: fr[(ci, 0, ph)], max_new_tokens=4,
                                   num_sample_trajs=NST, s1_calls=2)
    ref = _server(tpol)
    for ci, pol in enumerate(ref.cohorts):
        s2 = pol.s2_step(fr[(ci, 0, 0)], max_new_tokens=4)
        lat = torch.cat([o.output_latent for o in s2])
        s1 = [pol.s1_step_latent(fr[(ci, 0, ph)][0], lat, num_sample_trajs=NST,
                                 depth=fr[(ci, 0, ph)][1]) for ph in (1, 2)]
        assert [s.llm_output for s in pol.slots] == \
            [s.llm_output for s in server.cohorts[ci].slots]
        _assert_same(_summary(*got[ci]), _summary(s2, s1))
    streams = {}
    for shared_s1 in (False, True):
        cycles = streams[shared_s1] = {}
        _server(tpol).serve_stream(
            lambda ci, t, ph: fr[(ci, t, ph)], 2, max_new_tokens=4, num_sample_trajs=NST,
            s1_calls=2, shared_decode=True, shared_s1=shared_s1,
            on_cycle=lambda ci, t, s2, s1, c=cycles: c.setdefault((ci, t), (s2, s1)))
    assert sorted(streams[True]) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for key, (s2, s1) in streams[False].items():
        _assert_same(_summary(*streams[True][key]), _summary(s2, s1), tol=ROW_TOL)


# -------------------------------------------------------------- evaluator
#: (shared_decode, shared_s1, overlap_apply) of the evaluator runs
CASES = {"shared_decode": (True, False, False), "shared_both": (True, True, False)}


def _navdp_cfg(cfgs, out_dir, case):
    cfg = eval_cfg(cfgs, out_dir, *CASES[case])
    cfg.agent.model_settings["system1"] = "navdp_async"
    return cfg


def run_jax(jpol, tmp, case):
    with pytest.MonkeyPatch.context() as mp:
        cfg = _navdp_cfg(jconfigs, tmp / f"jax_{case}", case)
        agent = JAgent(cfg.agent, policy=jserving.BatchedN1Policy(
            jpol.model, jpol.params, jpol.cfg, cfg.agent.model_settings["batch_size"],
            inner=jpol))
        steps = record_steps(mp, jpipe)
        ev = jpipe.VLNPipelinedEvaluator(cfg, episodes=episodes(jepisodes, 7), agent=agent)
        metrics = ev.eval()
    return metrics, {r["key"]: r["info"] for r in ev.store.records()}, steps


class _JaxNoiseEvaluator(tpipe.VLNPipelinedEvaluator):
    """Each cohort's NavDP draws made as a JAX cohort makes them."""

    def _make_cohort_agent(self, idx):
        agent = super()._make_cohort_agent(idx)
        agent.policy.noise_fn = jax_navdp_noise(jax.random.PRNGKey(0))
        return agent


@pytest.fixture(scope="module")
def jax_runs(pair, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_navdp_eval")
    return {case: run_jax(pair[0], tmp, case) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_evaluator_navdp_matches_jax(pair, jax_runs, tmp_path, monkeypatch, case):
    """2 cohorts x 3 streams, max_step 12, FakeEnv's depth: the agents hand
    the policy [memory, current] RGBD pairs (depth x 10 clamped to 5 m)."""
    _, tpol = pair
    cfg = _navdp_cfg(tconfigs, tmp_path / f"port_{case}", case)
    policy = tserving.BatchedN1Policy(tpol, cfg.agent.model_settings["batch_size"])
    policy.noise_fn = jax_navdp_noise(jax.random.PRNGKey(0))
    calls = []
    prepare = tserving.BatchedN1Policy._s1_navdp_prepare

    def recorded(self, rgb, depth, *a, **kw):
        calls.append((np.shape(rgb), np.shape(depth), float(np.max(depth))))
        return prepare(self, rgb, depth, *a, **kw)

    monkeypatch.setattr(tserving.BatchedN1Policy, "_s1_navdp_prepare", recorded)
    agent = TAgent(cfg.agent, policy=policy)
    steps = record_steps(monkeypatch, tpipe)
    ev = _JaxNoiseEvaluator(cfg, episodes=episodes(tepisodes, 7), agent=agent)
    metrics = ev.eval()
    assert calls and all(r[1:] == (2, HW, HW, 3) and d[1:] == (2, HW, HW, 1) and 0 < m <= 5.0
                         for r, d, m in calls)
    assert_runs_equal((metrics, {r["key"]: r["info"] for r in ev.store.records()}, steps),
                      jax_runs[case])
