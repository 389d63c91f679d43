"""The port's W8A16 / W4A16 decode (`decode_act_dtype="bf16"`), and the
int4 format on the serving paths, against the JAX package.

The fp32 tiny models of tests/test_torch_int4.py (the JAX init's weights,
quantized by the JAX package at 8 or 4 bits) with decode_act_dtype="bf16"
on both configs: the prefill stays W8A8 / W4A8, every cached step (decode
step and latent chunk) takes bf16 activations times the widened codes.
Tolerances: the prefill at 1e-4 (fp32 models, another summation order);
the W8A16 decode's logits, hidden states and latents at W16_TOL = 5e-3:
each W8A16 product casts its fp32 input rows to bf16, and where the two
packages' fp32 rows differ in the last bit (the decode attention and the
SiLU sum and round in other orders) the cast may land one bf16 ulp
(2^-8 relative) apart on an element, which moves every output of that
product by up to |w| |x| 2^-8 (measured: 1.2e-3 on the logits); int8 KV
codes equal, greedy tokens exactly; the grouped decode's
and the batched policy's latents at 2e-2 against JAX (F13, settled:
the two frameworks' fp32 RMSNorms differ in the last bit, which flips an
int8 activation code of the prefill at a rounding tie), tokens exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.model.basemodel.internvla_n1 import serving as jserving
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1 import serving as tserving
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.ops import quant
from test_torch_int4 import WIDTHS, _cfgs, _fp32_params, _hidden
from test_torch_qwen import _assert_int8_caches_equal, _clone_caches, _close, _prompt, _t

torch.set_num_threads(2)
W16_TOL = 5e-3
LATENT_TOL = 2e-2
W16 = dict(kv_dtype="int8", decode_act_dtype="bf16")
_PAIRS = {}


def w16_pair(name, bits):
    """(JAX model, params, port model): fp32 at WIDTHS[name], the weights
    quantized to `bits` by the JAX package, W8A16 / W4A16 decode."""
    key = (name, bits)
    if key not in _PAIRS:
        params = _fp32_params(WIDTHS[name])
        qparams = jqt.quantize_qwen_text_params(params, weight_bits=bits)
        fmt = dict(W16, weight_dtype="int4" if bits == 4 else "int8")
        jcfg, tcfg = _cfgs(WIDTHS[name], **fmt)
        tm = qt.QwenTextModel(tcfg)
        load_from_jax(tm, qparams)
        _PAIRS[key] = (jqt.QwenTextModel(jcfg), qparams, tm)
    return _PAIRS[key]


def _inputs(name, seed=4):
    H = _hidden(name)
    emb, pos, seg, plen, deltas = _prompt(512)
    emb = np.random.default_rng(seed).standard_normal((*seg.shape, H)).astype(np.float32)
    return emb, pos, seg, plen, deltas


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["tiny", "w128"])
def test_w8a16_decode_step_and_chunk_match_jax(name, bits):
    """Prefill (W8A8 / W4A8), one W8A16 decode step with its lm_head, and a
    3-token W8A16 chunk over the padded prompt cache, against JAX's."""
    jm, params, tm = w16_pair(name, bits)
    emb, pos, seg, plen, _ = _inputs(name)
    B, T = seg.shape
    H = emb.shape[-1]
    new = np.random.default_rng(2).standard_normal((B, 3, H)).astype(np.float32)
    npos = (pos.max() + 1 + np.arange(3))[None, None].repeat(3, 0).repeat(B, 1)

    @jax.jit
    def jax_side(p, emb, pos, seg, new, npos, cl):
        logits, _, jc = jm.apply({"params": p}, emb, pos, segment_ids=seg, return_cache=True,
                                 logits_indices=cl - 1)
        jc = jqt.pad_caches(jc, T + 4)
        step = jm.apply({"params": p}, new[:, :1], npos[:, :, :1], jc, cl,
                        method=jm.decode_step)
        chunk, jc2 = jm.apply({"params": p}, new, npos, jc, cl, method=jm.decode_chunk)
        return logits, step, chunk, jc2

    jl, (jlog, jh, jc1), jhc, jc2 = jax_side(
        params, *(jnp.asarray(a) for a in (emb, pos, seg, new, npos, plen)))
    with torch.no_grad():
        tl, _, tc = tm(_t(emb), _t(pos), segment_ids=_t(seg), logits_indices=_t(plen - 1).long())
        tc = qt.pad_caches(tc, T + 4)
        tlog, th, tc1 = tm.decode_step(_t(new[:, :1]), _t(npos[:, :, :1]), _clone_caches(tc),
                                       _t(plen).long())
        thc, tc2 = tm.decode_chunk(_t(new), _t(npos), tc, _t(plen).long())
    _close(tl, jl)
    _close(tlog, jlog, W16_TOL, W16_TOL)
    _close(th, jh, W16_TOL, W16_TOL)
    _close(thc, jhc, W16_TOL, W16_TOL)
    _assert_int8_caches_equal(tc1, jc1)
    _assert_int8_caches_equal(tc2, jc2)


@pytest.mark.parametrize("bits", [8, 4])
def test_w8a16_greedy_generate_matches_jax(bits):
    jm, params, tm = w16_pair("w128", bits)
    emb, pos, seg, plen, deltas = _inputs("w128", seed=5)
    args = dict(max_new_tokens=10, extra_cache_slots=2)

    def run_port(eos):
        return qt.greedy_generate(tm, _t(emb), _t(pos), eos_token_ids=eos,
                                  rope_deltas=_t(deltas), prompt_lengths=_t(plen),
                                  segment_ids=_t(seg), **args)

    eos = (int(run_port((511,))[0][0, 4]),)
    jtok, jlen = jqt.greedy_generate(
        jm, params, jnp.asarray(emb), jnp.asarray(pos), eos_token_ids=eos,
        rope_deltas=jnp.asarray(deltas), prompt_lengths=jnp.asarray(plen),
        segment_ids=jnp.asarray(seg), **args)
    ttok, tlen, _ = run_port(eos)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("bits", [8, 4])
def test_w8a16_layer_runs_bf16_products_and_no_activation_quantization(monkeypatch, bits):
    """The decoding switch (JAX `:413-417`, `:612-616`): the prefill that
    writes the cache runs W8A8 / W4A8 with K6a's fused prologues; a decode
    step runs a layer's 7 W8A16 products in 4 calls (q/k/v and gate/up one
    call each, one K10 launch each on the card) plus the lm_head's, the
    plain RMSNorm and `silu_mul`, and no activation quantization."""
    _, _, tm = w16_pair("w128", bits)
    emb, pos, seg, plen, _ = _inputs("w128")
    B, T = seg.shape
    L = tm.cfg.num_hidden_layers
    calls = {}
    for name in ("w8a16_linear_multi", "rmsnorm_quantize", "swiglu_quantize",
                 "quantize_activations", "w4a8_linear_multi", "w8a8_linear_multi", "silu_mul"):
        _spy(monkeypatch, qt, name, calls)
    with torch.no_grad():
        _, _, tc = tm(_t(emb), _t(pos), segment_ids=_t(seg), logits_indices=_t(plen - 1).long())
        prefill = dict(calls)
        calls.clear()
        tm.decode_step(_t(emb[:, :1]), _t(pos[:, :, :1]), qt.pad_caches(tc, T + 1),
                       _t(plen).long())
    assert prefill.get("w8a16_linear_multi", 0) == 0 and prefill["rmsnorm_quantize"] == 2 * L
    assert prefill["swiglu_quantize"] == L
    assert calls == {"w8a16_linear_multi": 4 * L + 1, "silu_mul": L}


# --------------------------------------------------- grouped, batched
def test_grouped_decode_int4_matches_jax_per_group():
    """The port's grouped decode loop (two cache groups, one loop) on the
    W4A8 model against JAX's `greedy_generate` per group: tokens and
    lengths equal, latents of the grouped chunk within LATENT_TOL."""
    from test_torch_grouped_decode import GROUPS, MAX_NEW, N_Q, _grouped, _latent_pos, _queries

    _, params, _ = w16_pair("tiny", 4)
    jcfg, tcfg = _cfgs({}, weight_dtype="int4", kv_dtype="int8")
    jm, tm = jqt.QwenTextModel(jcfg), load_from_jax(qt.QwenTextModel(tcfg), params)
    groups = []
    for rows, P, seed in GROUPS:
        emb, pos, seg, plen, deltas = _prompt(512, B=rows, P=P, seed=seed)
        groups.append(tuple(torch.from_numpy(np.array(a)) for a in (emb, pos, seg, plen, deltas)))
    tok, ln, lat = _grouped(tm, groups, (511,))
    q = np.asarray(_queries())
    r = GROUPS[0][0]
    for g, t, l, la in zip(groups, (tok[:r], tok[r:]), (ln[:r], ln[r:]), (lat[:r], lat[r:])):
        emb, pos, seg, plen, deltas = (np.asarray(a) for a in g)
        jtok, jlen, jc = jqt.greedy_generate(
            jm, params, jnp.asarray(emb), jnp.asarray(pos), max_new_tokens=MAX_NEW,
            eos_token_ids=(511,), rope_deltas=jnp.asarray(deltas),
            prompt_lengths=jnp.asarray(plen), segment_ids=jnp.asarray(seg), return_caches=True,
            extra_cache_slots=N_Q)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(l.numpy(), np.asarray(jlen))
        B = plen.shape[0]
        jpos = np.asarray(_latent_pos(torch.from_numpy(plen).long(),
                                      torch.from_numpy(deltas).long(), l))
        jlat, _ = jm.apply({"params": params}, jnp.asarray(np.broadcast_to(q, (B, N_Q, 64))),
                           jnp.asarray(jpos), jc, jnp.asarray(plen) + jlen,
                           method=jm.decode_chunk)
        np.testing.assert_allclose(la.numpy(), np.asarray(jlat), atol=LATENT_TOL,
                                   rtol=LATENT_TOL)


@pytest.fixture
def fp32_jax_nextdit():
    from test_torch_system1 import F32NextDiTConfig

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        yield


def test_batched_policy_int4_matches_jax(fp32_jax_nextdit):
    """`BatchedN1Policy` over an int4 inner policy (W4A8, int8 KV): three
    slots over two steps, the texts equal and the latents within
    LATENT_TOL of the JAX batched policy's."""
    from test_torch_serving_batched import INSTR, frames, jbatched
    from test_torch_system1 import f32_config, n1_params

    cfg = f32_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, weight_dtype="int4",
                                                            kv_dtype="int8"))
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, weight_dtype="bf16")), seed=1)
    params = {**params, "language_model": jqt.quantize_qwen_text_params(
        params["language_model"], weight_bits=4)}
    tcfg = InternVLAN1Config.tiny(dtype=torch.float32)
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, weight_dtype="int4",
                                                              kv_dtype="int8"))
    tm = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
    jpol, tpol = JPolicy(jm, params, cfg), tpolicy.InternVLAN1Policy(tm)
    jb, tb = jbatched(jpol, 3), tserving.BatchedN1Policy(tpol, 3)
    jb.reset(INSTR)
    tb.reset(INSTR)
    f = frames(1, 6)
    for t in range(2):
        imgs = f[3 * t:3 * t + 3]
        touts = tb.s2_step(imgs, max_new_tokens=6)
        jouts = jb.s2_step(imgs, max_new_tokens=6)
        for to, jo, i in zip(touts, jouts, range(3)):
            assert tb.slots[i].llm_output == jb.slots[i].llm_output
            assert (to.output_latent is None) == (jo.output_latent is None)
            if jo.output_latent is not None:
                np.testing.assert_allclose(to.output_latent.numpy(),
                                           np.asarray(jo.output_latent), atol=LATENT_TOL,
                                           rtol=LATENT_TOL)
    assert tm.language_model.layers[0].mlp.up_proj.weight_q.dtype == torch.uint8


def test_bench_entry_tiny_int4(capsys):
    """`bench_evaluator.py --tiny --weight-dtype int4 --kv-dtype bf16`: the
    tiny loop runs on an int4 policy and the JSON line names its formats;
    the product went through the W4A8 plain version."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "bench_evaluator", Path(__file__).resolve().parents[1] / "scripts" / "torch" /
        "bench_evaluator.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    calls = {}
    real = quant.w4a8_linear_reference

    def spy(*a, **kw):
        calls["w4a8"] = calls.get("w4a8", 0) + 1
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant, "w4a8_linear_reference", spy)
        assert bench.main(["--tiny", "--weight-dtype", "int4", "--kv-dtype", "bf16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["detail"]["config"]["weight_dtype"] == "int4"
    assert out["detail"]["config"]["kv_dtype"] == "bf16"
    assert out["value"] > 0 and calls["w4a8"] > 0


def test_w8a16_decode_tracks_the_bf16_model():
    """JAX's `test_decode_act_dtype_bf16_tracks_bf16_model` on the port's
    tiny bf16 model (the JAX init's weights, quantized by the JAX
    package): W8A16 decode logits no further from the bf16 model's than
    W8A8's (x 1.05, on the mean) and within 0.15 of them relative to their
    largest entry."""
    params = _fp32_params({}, seed=1)
    B, T = 2, 10
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (B, T)))
    pos = torch.arange(T)[None, None].expand(3, B, T)

    def decode_logits(**fmt):
        cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), **fmt)
        tree = params if cfg.weight_dtype == "bf16" else jqt.quantize_qwen_text_params(params)
        m = load_from_jax(qt.QwenTextModel(cfg), tree)
        with torch.no_grad():
            _, _, caches = m(m.embed(ids), pos)
            lg, _, _ = m.decode_step(m.embed(torch.full((B, 1), 7)), torch.full((3, B, 1), T),
                                     qt.pad_caches(caches, T + 4), torch.full((B,), T))
        return lg.float()

    ref = decode_logits()
    e8 = (decode_logits(weight_dtype="int8") - ref).abs()
    e16 = (decode_logits(weight_dtype="int8", decode_act_dtype="bf16") - ref).abs()
    assert e16.mean() <= e8.mean() * 1.05
    assert e16.max() / (ref.abs().max() + 1e-9) < 0.15


@pytest.mark.parametrize("group", [None, 32])
def test_w8a16_project_fused_plain_path_equals_per_projection(monkeypatch, group):
    """W8A16 over int8 codes: q/k/v and gate/up each one `w8a16_linear_multi`
    call (one K10 launch on the card), on the CPU each segment's plain
    version, bit for bit what each projection gives alone."""
    from test_torch_int4 import _random_quant_layer

    cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), weight_dtype="int8",
                              quant_group_size=group, dtype=torch.float32)
    attn, mlp = _random_quant_layer(cfg, seed=5)
    calls = []
    multi = qt.w8a16_linear_multi
    monkeypatch.setattr(qt, "w8a16_linear_multi",
                        lambda *a, **k: calls.append(len(a[-1])) or multi(*a, **k))
    x = torch.randn((4, cfg.hidden_size), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        for mods in ((attn.q_proj, attn.k_proj, attn.v_proj), (mlp.gate_proj, mlp.up_proj)):
            calls.clear()
            fused = qt.project(x, *mods, bf16_act=True)
            alone = [qt.project(x, m, bf16_act=True)[0] for m in mods]
            assert calls == [len(mods)] + [1] * len(mods)
            for y, z in zip(fused, alone):
                assert torch.equal(y, z)
            want = quant.w8a16_linear_reference(x, mods[0].weight_q, mods[0].scale_q,
                                                mods[0].bias, out_dtype=torch.float32)
            assert torch.equal(fused[0], want)
