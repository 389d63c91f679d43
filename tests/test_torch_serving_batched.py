"""Batched multi-episode serving (`serving.BatchedN1Policy`,
`PipelinedN1Server`) of the port, against the JAX package's.

Both sides hold the same tiny fp32 weights (numpy draws carried across by
`model/weights/from_jax.py`, fp32 NextDiT on the JAX side) and get the same
numpy frames. The port's cohorts draw their System-1 noise through
`noise_fn`, which hands them the JAX cohort's draws (the same key chain:
one split per System-1 call). Tolerances: the decoded text (so the greedy
tokens) exactly equal, traj latents and trajectories at atol/rtol 1e-4
(fp32, another summation order); port against port with the same shapes
exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import serving as jserving
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import serving as tserving
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from test_torch_system1 import F32NextDiTConfig, f32_config, n1_params

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
HW = 56
INSTR = ["walk to the kitchen and stop",
         "turn left at the sofa then go forward to the red door and wait",
         "go straight past the table and stop at the plant"]


@pytest.fixture(scope="module", autouse=True)
def fp32_jax_nextdit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        yield


def build_pair(system1="nextdit_async"):
    """(JAX policy, port policy) with the same tiny fp32 weights (the JAX
    NextDiT at fp32 while `fp32_jax_nextdit` is on)."""
    cfg = f32_config(system1)
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, cfg, seed=1)
    tcfg = InternVLAN1Config.tiny(system1, dtype=torch.float32)
    tm = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
    return JPolicy(jm, params, cfg), tpolicy.InternVLAN1Policy(tm)


@pytest.fixture(scope="module")
def pair(fp32_jax_nextdit):
    return build_pair()


def frames(seed, n, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3)).astype(np.uint8)


def jax_noise(key):
    """A port cohort's `noise_fn` drawing what a JAX cohort whose `_rng`
    starts at `key` draws: split, then a normal from the new subkey."""
    state = {"rng": key}

    def draw(shape):
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))

    return draw


def jbatched(jpol, B):
    return jserving.BatchedN1Policy(jpol.model, jpol.params, jpol.cfg, B, inner=jpol)


def assert_s2_equal(touts, jouts, tb, jb, slots):
    for t, j, i in zip(touts, jouts, slots):
        assert tb.slots[i].llm_output == jb.slots[i].llm_output
        assert (t.output_latent is None) == (j.output_latent is None)
        if j.output_latent is not None:
            np.testing.assert_allclose(t.output_latent.numpy(), np.asarray(j.output_latent),
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_array_equal(t.output_pixel, j.output_pixel)


def test_batched_s2_step_matches_jax(pair):
    """Three slots over two steps (the second with a history frame)."""
    jpol, tpol = pair
    jb, tb = jbatched(jpol, 3), tserving.BatchedN1Policy(tpol, 3)
    jb.reset(INSTR)
    tb.reset(INSTR)
    f = frames(1, 6)
    for t in range(2):
        imgs = f[3 * t:3 * t + 3]
        assert_s2_equal(tb.s2_step(imgs, max_new_tokens=6), jb.s2_step(imgs, max_new_tokens=6),
                        tb, jb, range(3))
    assert all(s.episode_idx == 2 for s in tb.slots)


def test_slot_reset_regroups_matches_jax(pair):
    """After one slot is reset its row falls in another history-length
    group; both groups match JAX, and a step of a subset of slots too."""
    jpol, tpol = pair
    jb, tb = jbatched(jpol, 2), tserving.BatchedN1Policy(tpol, 2)
    jb.reset(INSTR[:2])
    tb.reset(INSTR[:2])
    f = frames(2, 5)
    jb.s2_step(f[:2], max_new_tokens=6)
    tb.s2_step(f[:2], max_new_tokens=6)
    jb.reset_slot(1, INSTR[2])
    tb.reset_slot(1, INSTR[2])
    assert_s2_equal(tb.s2_step(f[2:4], max_new_tokens=6), jb.s2_step(f[2:4], max_new_tokens=6),
                    tb, jb, range(2))
    assert [s.episode_idx for s in tb.slots] == [2, 1]
    assert_s2_equal(tb.s2_step(f[4:5], max_new_tokens=6, slot_ids=[1]),
                    jb.s2_step(f[4:5], max_new_tokens=6, slot_ids=[1]), tb, jb, [1])


@pytest.mark.parametrize("slots,bucket", [(11, 12), (24, 24)])
def test_3x2k_bucket_rows_match_single_stream(pair, slots, bucket):
    """{2^k} ∪ {3·2^k} compute buckets: 11 slots pad to 12 rows, 24 take 24;
    each slot's text equals the single-stream policy's."""
    _, tpol = pair
    assert tserving.BatchedN1Policy._pow2_bucket(slots) == bucket
    assert [tserving.BatchedN1Policy._pow2_bucket(n) for n in (3, 5, 7, 13, 48)] == \
        [3, 6, 8, 16, 48]
    tb = tserving.BatchedN1Policy(tpol, slots)
    instr = [INSTR[i % 3] for i in range(slots)]
    tb.reset(instr)
    f = frames(3, slots)
    tb.s2_step(f, max_new_tokens=5)
    for i in range(0, slots, 5):
        tpol.reset()
        tpol.s2_step(f[i], instr[i], max_new_tokens=5)
        assert tb.slots[i].llm_output == tpol.llm_output


def _s1_case(jb, tb, mode, key):
    """Two System-1 calls of one mode on both sides; returns the outputs."""
    r = np.random.default_rng(5)
    latents = (0.1 * r.standard_normal((2, 2, 64))).astype(np.float32)
    mem, cur = frames(21, 2), [frames(22, 2), frames(23, 2)]
    jb._rng = key
    tb.noise_fn = jax_noise(key)
    if mode == "legacy":
        calls = [np.stack([mem, c], axis=1) for c in cur]
    else:
        calls = cur
        for i, (js, ts) in enumerate(zip(jb.slots, tb.slots)):
            js.s1_mem_frame, ts.s1_mem_frame = jnp.asarray(mem[i]), torch.from_numpy(mem[i])
            js.s1_mem_feats = ts.s1_mem_feats = None
    outs = []
    for rgb in calls:
        outs.append((tb.s1_step_latent(rgb, torch.from_numpy(latents), num_sample_trajs=4),
                     jb.s1_step_latent(rgb, jnp.asarray(latents), num_sample_trajs=4)))
        if mode == "cached":
            assert all(s.s1_mem_feats is not None for s in tb.slots)
    return outs


@pytest.mark.parametrize("mode", ["cached", "legacy"])
def test_s1_modes_match_jax(pair, mode):
    """`cached`: the first call encodes the memory frames (mode full) and
    keeps their features, the second reuses them; `legacy`: explicit
    [memory, current] pairs."""
    jpol, tpol = pair
    jb, tb = jbatched(jpol, 2), tserving.BatchedN1Policy(tpol, 2)
    for touts, jouts in _s1_case(jb, tb, mode, jax.random.PRNGKey(7)):
        for t, j in zip(touts, jouts):
            np.testing.assert_allclose(t.trajectory, np.asarray(j.trajectory), atol=ATOL,
                                       rtol=RTOL)
            assert t.idx == j.idx


def test_s1_noimg_matches_jax():
    """A non-async NextDiT reads the latents alone (mode noimg)."""
    jpol, tpol = build_pair("nextdit")
    jb, tb = jbatched(jpol, 2), tserving.BatchedN1Policy(tpol, 2)
    for touts, jouts in _s1_case(jb, tb, "noimg", jax.random.PRNGKey(8)):
        for t, j in zip(touts, jouts):
            np.testing.assert_allclose(t.trajectory, np.asarray(j.trajectory), atol=ATOL,
                                       rtol=RTOL)
    spec = tb.s1_prepare(frames(24, 2), torch.zeros(2, 2, 64), num_sample_trajs=4)
    assert spec["mode"] == "noimg"


def _cohort_frames():
    f = frames(77, 6)
    return {(ci, t, ph): np.stack([f[(2 * t + ci + ph) % 6], f[(2 * t + ci + ph + 1) % 6]])
            for ci in range(2) for t in range(2) for ph in range(3)}


def _server(tpol):
    server = tserving.PipelinedN1Server(tpol, batch_size=2, cohorts=2)
    for ci, pol in enumerate(server.cohorts):
        pol.reset(INSTR[ci:ci + 2])
        pol.noise_fn = jax_noise(jax.random.PRNGKey(500 + ci))
    return server


def _outputs(s2out, s1res):
    return ([o.output_latent for o in s2out], [[o.trajectory for o in call] for call in s1res])


def _assert_same(a, b):
    (lat_a, tr_a), (lat_b, tr_b) = a, b
    for x, y in zip(lat_a, lat_b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    for ca, cb in zip(tr_a, tr_b):
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(x, y)


def test_serve_macro_cycle_and_stream_equal_sequential_cohorts(pair):
    """The interleaved macro-cycle equals each cohort stepped alone and in
    turn (S2, then its System-1 calls); serve_stream over two cycles equals
    two macro-cycles."""
    _, tpol = pair
    fr = _cohort_frames()
    server = _server(tpol)
    got = server.serve_macro_cycle(lambda ci, ph: fr[(ci, 0, ph)], max_new_tokens=5,
                                   num_sample_trajs=2, s1_calls=2)
    ref_server = _server(tpol)
    for ci, pol in enumerate(ref_server.cohorts):
        s2 = pol.s2_step(fr[(ci, 0, 0)], max_new_tokens=5)
        lat = torch.cat([o.output_latent for o in s2])
        s1 = [pol.s1_step_latent(fr[(ci, 0, ph)], lat, num_sample_trajs=2) for ph in (1, 2)]
        assert [s.llm_output for s in pol.slots] == \
            [s.llm_output for s in server.cohorts[ci].slots]
        _assert_same(_outputs(*got[ci]), _outputs(s2, s1))

    stream_server, cycles = _server(tpol), {}
    stream_server.serve_stream(lambda ci, t, ph: fr[(ci, t, ph)], 2, max_new_tokens=5,
                               num_sample_trajs=2, s1_calls=2,
                               on_cycle=lambda ci, t, s2, s1: cycles.setdefault((ci, t), (s2, s1)))
    blocking = _server(tpol)
    for t in range(2):
        res = blocking.serve_macro_cycle(lambda ci, ph: fr[(ci, t, ph)], max_new_tokens=5,
                                         num_sample_trajs=2, s1_calls=2)
        for ci in range(2):
            _assert_same(_outputs(*cycles[(ci, t)]), _outputs(*res[ci]))


def test_pinned_stop_id_decodes_the_full_budget(pair):
    """A stop id that no token can be (-7, as a benchmark pins it to force
    the full decode budget) decodes every row to the budget. The prompt
    keeps its pad id, so each row's text begins with what the default stop
    id gives up to its stop."""
    _, tpol = pair
    f = frames(5, 3)
    eos = tpol.tokenizer.eos_token_id
    texts = {}
    try:
        for stop in (eos, -7):
            tpol.tokenizer.eos_token_id = stop
            tb = tserving.BatchedN1Policy(tpol, 3)
            tb.reset(INSTR)
            tb.s2_step(f, max_new_tokens=8)
            texts[stop] = [s.llm_output.split() for s in tb.slots]
    finally:
        tpol.tokenizer.eos_token_id = eos
    for full, short in zip(texts[-7], texts[eos]):
        assert len(full) == 8 and full[:len(short)] == short
