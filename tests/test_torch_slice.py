"""The whole InternVLA-N1 serving slice, port against the JAX package.

Both policies hold the same tiny fp32 weights (numpy draws, passed to the
port through `model/weights/from_jax.py`) and get the same frames and
instruction. Fused `s2_step`: greedy tokens exactly equal, traj latents at
atol/rtol 1e-4 (fp32, different summation order). `s1_step_latent`: the
port is handed the noise the JAX policy draws from its key, and the
trajectories agree at 1e-4. The `realtime` slice (W8A8 text projections
and an int8 KV cache; the JAX tree quantized by the JAX package's
`quantize_qwen_text_params`) is held to the same tolerances, except
the latents of a step whose int8 codes flip (see its test; F13, settled
in ROADMAP §3 and pinned by `test_realtime_second_step_flip_is_one_tie`).
"""

import dataclasses

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.ops import quant
from test_torch_system1 import F32NextDiTConfig, f32_config, n1_params

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
REALTIME_LATENT_TOL = 2e-2
INSTRUCTION = "walk past the sofa and stop at the kitchen door"


@pytest.fixture(scope="module")
def policies():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        cfg = f32_config()
        jm = jmodel.InternVLAN1Model(cfg)
        params = n1_params(jm, cfg, seed=1)
        tcfg = InternVLAN1Config.tiny("nextdit_async", dtype=torch.float32)
        tm = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
        yield JPolicy(jm, params, cfg), tpolicy.InternVLAN1Policy(tm)


@pytest.fixture(scope="module")
def realtime_policies():
    """Both policies with int8 weights and an int8 KV cache in the text
    model: the fp32 draws, the language model's tree quantized once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        cfg = f32_config()
        params = n1_params(jmodel.InternVLAN1Model(cfg), cfg, seed=1)
        params = {**params, "language_model": jqt.quantize_qwen_text_params(
            jax.tree_util.tree_map(np.asarray, params["language_model"]))}
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, weight_dtype="int8",
                                                                kv_dtype="int8"))
        jm = jmodel.InternVLAN1Model(cfg)
        tcfg = InternVLAN1Config.tiny("nextdit_async", dtype=torch.float32)
        tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, weight_dtype="int8",
                                                                  kv_dtype="int8"))
        tm = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
        yield JPolicy(jm, params, cfg), tpolicy.InternVLAN1Policy(tm)


def _frames(n, hw=56, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3)).astype(np.uint8)


def test_fused_s2_steps_match_jax(policies):
    """Two steps: the second prompt carries a history frame (vision cache)."""
    jpol, tpol = policies
    jpol.reset()
    tpol.reset()
    for frame in _frames(2):
        jout = jpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
        tout = tpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
        np.testing.assert_array_equal(tpol.last_gen_tokens, jpol.last_gen_tokens)
        assert tpol.llm_output == jpol.llm_output
        assert jout.output_latent is not None and tout.output_latent is not None
        np.testing.assert_allclose(tout.output_latent.numpy(), np.asarray(jout.output_latent),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(tout.output_pixel, jout.output_pixel)
    assert len(tpol.input_images) == 2


def test_s1_step_latent_matches_jax_with_injected_noise(policies):
    jpol, tpol = policies
    jpol.reset()
    tpol.reset()
    r = np.random.default_rng(3)
    latent = r.standard_normal((1, 2, 64)).astype(np.float32)
    rgb = _frames(2, seed=4)[None]
    depth = r.uniform(0, 5, (1, 2, 56, 56, 1)).astype(np.float32)
    jout = jpol.s1_step_latent(rgb, depth, jnp.asarray(latent))
    # the JAX policy's first draw: split(PRNGKey(0)) → normal(sub, ...)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    x0 = np.array(jax.random.normal(sub, (32, 8, 3)))
    tout = tpol.s1_step_latent(rgb, depth, torch.from_numpy(latent), x_init=torch.from_numpy(x0))
    np.testing.assert_allclose(tout.trajectory, np.asarray(jout.trajectory), atol=ATOL, rtol=RTOL)
    assert tout.idx == jout.idx


def test_realtime_fused_s2_steps_match_jax(realtime_policies):
    """The realtime slice over two steps: greedy tokens exactly equal, the
    first step's latents at 1e-4. The second step's latents are held at
    REALTIME_LATENT_TOL (they differ by 7.001e-3): the activation
    quantization is a step function, and one int8 code of the second
    step's prefill sits on a rounding tie that the two frameworks' fp32
    last bits put on either side (F13, pinned by
    `test_realtime_second_step_flip_is_one_tie`)."""
    jpol, tpol = realtime_policies
    jpol.reset()
    tpol.reset()
    for step, frame in enumerate(_frames(2)):
        jout = jpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
        tout = tpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
        np.testing.assert_array_equal(tpol.last_gen_tokens, jpol.last_gen_tokens)
        assert tpol.llm_output == jpol.llm_output
        tol = ATOL if step == 0 else REALTIME_LATENT_TOL
        np.testing.assert_allclose(tout.output_latent.numpy(), np.asarray(jout.output_latent),
                                   atol=tol, rtol=tol)
        np.testing.assert_array_equal(tout.output_pixel, jout.output_pixel)


def test_realtime_s1_step_latent_matches_jax(realtime_policies):
    """System-1 on the realtime policies (bf16-format weights there) from the
    same latent and noise: trajectories at 1e-4."""
    jpol, tpol = realtime_policies
    jpol.reset()
    tpol.reset()
    r = np.random.default_rng(5)
    latent = r.standard_normal((1, 2, 64)).astype(np.float32)
    rgb = _frames(2, seed=6)[None]
    jout = jpol.s1_step_latent(rgb, None, jnp.asarray(latent))
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    x0 = np.array(jax.random.normal(sub, (32, 8, 3)))
    tout = tpol.s1_step_latent(rgb, None, torch.from_numpy(latent), x_init=torch.from_numpy(x0))
    np.testing.assert_allclose(tout.trajectory, np.asarray(jout.trajectory), atol=ATOL, rtol=RTOL)
    assert tout.idx == jout.idx


def test_s1_resizes_rgb_and_depth_each_on_its_own_grid(policies):
    """A depth stream at another resolution than rgb is fitted to the S1
    grid on its own (the JAX policy checks the rgb grid only)."""
    _, tpol = policies
    depth = np.ones((1, 2, 90, 90, 1), np.float32)
    assert tpolicy._fit_s1_grid(depth, 56).shape == (1, 2, 56, 56, 1)
    rgb = _frames(2)[None]
    assert tpolicy._fit_s1_grid(rgb, 56) is rgb  # grid matches: untouched
    big = _frames(2, hw=100)[None]
    assert tpolicy._fit_s1_grid(big, 56).shape == (1, 2, 56, 56, 3)
    out = tpol.s1_step_latent(rgb, depth, torch.zeros(1, 2, 64), num_sample_trajs=4)
    assert out.trajectory.shape == (4, 8, 3) and np.isfinite(out.trajectory).all()


def _step2_prefill_inputs(jpol, tpol):
    """Both policies through the realtime slice's two steps; returns the
    port's second-step prefill inputs (embeds, position ids, segment ids)
    and its latent gap to the JAX policy."""
    lm = tpol.model.language_model
    calls = []
    forward = lm.forward
    lm.forward = lambda *a, **k: calls.append((a, k)) or forward(*a, **k)
    try:
        jpol.reset()
        tpol.reset()
        for frame in _frames(2):
            jout = jpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
            tout = tpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
    finally:
        del lm.forward
    a, k = calls[-1]
    gap = np.abs(tout.output_latent.numpy() - np.asarray(jout.output_latent)).max()
    return a[0], a[1], k["segment_ids"], gap


def test_realtime_second_step_flip_is_one_tie(realtime_policies):
    """F13, traced. On the same second-step prefill input, the first op
    whose output differs is layer 0's input RMSNorm (fp32): its variance
    is a sum of 64 squares that XLA on the CPU reduces as two 32-lane
    windows and torch in its own vector order, and its rsqrt is correctly
    rounded in neither framework; the two differ in the last bit. Those
    last bits reach layer 1's normed rows, and exactly one activation
    code flips there: token 19, element 26, where the port's x / a_scale
    is -104.5 exactly (rounded half to even: -104) and XLA's -104.50002
    (-105). The quantizer itself agrees (XLA's quantization of the port's
    rows gives the port's codes), and the vision tokens are not the
    cause: with the JAX tower's tokens the port's latents move not at all.
    The latents' 7.001e-3 is that one flipped code."""
    jpol, tpol = realtime_policies
    embeds, pos, seg, gap = _step2_prefill_inputs(jpol, tpol)
    assert 6e-3 < gap < 8e-3
    lm = tpol.model.language_model
    caps = {}
    hooks = [lm.layers[0].register_forward_hook(lambda m, i, o: caps.__setitem__("x1", o[0]))]
    with torch.no_grad():
        lm(embeds, pos, segment_ids=seg)
    for h in hooks:
        h.remove()

    def jfn(p, e, pos, seg):
        return jpol.text_model.apply({"params": p}, e, pos, segment_ids=seg, return_cache=True,
                                     capture_intermediates=True)

    _, state = jax.jit(jfn)(jpol.params["language_model"], jnp.asarray(embeds.numpy()),
                            jnp.asarray(pos.numpy()), jnp.asarray(seg.numpy()))
    inter = flax.traverse_util.flatten_dict(state["intermediates"], sep="/")
    jnorm = [np.asarray(inter[f"layers_{i}/input_layernorm/__call__"][0]) for i in (0, 1)]

    # layer 0's input RMSNorm on identical inputs: last bits only
    with torch.no_grad():
        tnorm0 = quant.rms_norm(embeds, lm.layers[0].input_layernorm.weight, 1e-6).numpy()
    ulps = np.abs(tnorm0.view(np.int32).astype(np.int64) - jnorm[0].view(np.int32))
    assert 0 < (ulps > 0).sum() and ulps.max() <= 4

    # layer 1's normed rows: the one code on a tie
    with torch.no_grad():
        tnorm1 = quant.rms_norm(caps["x1"], lm.layers[1].input_layernorm.weight, 1e-6)
        tq1, ts1 = quant.quantize_rows(tnorm1)

    def jquant(xf):  # QuantDense's activation quantization (JAX qwen_text.py)
        amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
        a_scale = jnp.maximum(amax, 1e-8) / 127.0
        return jnp.clip(jnp.round(xf / a_scale), -127, 127).astype(jnp.int8)

    jq1 = np.asarray(jax.jit(jquant)(jnorm[1]))
    flips = np.argwhere(jq1 != tq1.numpy())
    assert flips.tolist() == [[0, 19, 26]]
    assert (int(jq1[0, 19, 26]), int(tq1[0, 19, 26])) == (-105, -104)
    assert float(tnorm1[0, 19, 26] / ts1[0, 19, 0]) == -104.5
    np.testing.assert_array_equal(np.asarray(jax.jit(jquant)(tnorm1.numpy())), tq1.numpy())


def test_realtime_gap_does_not_come_from_vision_tokens(realtime_policies):
    """F13's old record blamed the vision tokens' last bits. The port fed
    the JAX tower's tokens for every frame gives the same second-step
    latents, bit for bit, as with its own."""
    jpol, tpol = realtime_policies
    *_, gap_own = _step2_prefill_inputs(jpol, tpol)
    own = tpol.last_gen_tokens
    encode = tpol._encode_images
    tpol._encode_images = lambda images: (torch.from_numpy(np.concatenate(
        [np.asarray(jpol._encode_images(im[None])[0]) for im in np.asarray(images)])),
        encode(images)[1])
    try:
        *_, gap_jax = _step2_prefill_inputs(jpol, tpol)
    finally:
        del tpol._encode_images
    np.testing.assert_array_equal(tpol.last_gen_tokens, own)
    assert gap_jax == gap_own
