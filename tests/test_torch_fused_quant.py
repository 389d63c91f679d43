"""K6a's fused prologues and K7's rotary cache write, held on the CPU.

The int8 decoder quantizes each projection input inside the op that makes
it (`quant.rmsnorm_quantize`, with the residual add before the
post-attention norm; `quant.swiglu_quantize`; `quant.quantize_activations`
for the rows it takes as they are) and rotates q/k, quantizes K/V and
writes the cache in one call (`quant.rope_kv_write`). On the CPU these
dispatchers run their plain versions, which must equal the composition the
decoder ran before the fusion bit for bit (written out below as it was; for
the SwiGLU the JAX package's: XLA's bf16 SiLU times up in fp32, ROADMAP
F14),
and the JAX package's RMSNorm -> QuantDense codes and apply_rotary +
quantize_kv + cache writes: int8 codes, scales, rotated q and caches
bitwise, as in tests/test_torch_quant.py. A spy on the tiny int8 model's
decode step and chunk checks which of them each layer calls, and that it
calls no `RMSNorm`, `apply_rotary` or SwiGLU (`silu_mul`) of its own.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.ops.activations import silu
from internnav_tpu_torch.ops import quant
from internnav_tpu_torch.ops.rope import mrope_cos_sin

torch.set_num_threads(2)
EPS = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


# --------------------------------------- the composition before the fusion
def _rmsnorm_then_quantize(x, weight, eps, residual=None):
    """`QwenDecoderLayer`: x = x + h, then `RMSNorm.forward`, then
    `project`'s `quantize_activations`."""
    if residual is not None:
        x = x + residual
    var = x.float().square().mean(-1, keepdim=True)
    y = (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * weight
    return (*quant.quantize_rows(y.reshape(-1, y.shape[-1]).contiguous()), x)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotary_then_write(q, k, v, cos, sin, k_entry, v_entry, cache_len):
    """`QwenAttention`'s decode branch: `apply_rotary` on (B, H, n, D) views,
    then the int8 write of the rotated k and of v."""
    B, n, D = cos.shape
    KV = k_entry[0].shape[2]
    q = q.reshape(B, n, -1, D).transpose(1, 2)
    k = k.reshape(B, n, KV, D).transpose(1, 2)
    c, s = cos[:, None].to(q.dtype), sin[:, None].to(q.dtype)
    q = q * c + _rotate_half(q) * s
    k = (k * c + _rotate_half(k) * s).to(k.dtype)
    quant.write_kv_cache_reference(k.transpose(1, 2).contiguous(),
                                   v.reshape(B, n, KV, D).contiguous(), k_entry, v_entry,
                                   cache_len)
    return q


def _rows_with_ties(rng, M, K):
    """bf16 activations (M, K) and residuals, scaled per row, with ties: in
    row 0 the residual add lands halfway between two bf16 values (1 +
    2^-8, 3 + 2^-7, and their negatives); in the last row a quantization
    tie (amax 127, so a_scale = 1, and entries at k + 1/2)."""
    x = rng.standard_normal((M, K)) * rng.uniform(0.1, 8.0, (M, 1))
    h = rng.standard_normal((M, K))
    x[0, :4], h[0, :4] = [1.0, -1.0, 3.0, -3.0], [2 ** -8, -2 ** -8, 2 ** -7, -2 ** -7]
    x[-1, :6] = [127.0, 0.5, -0.5, 1.5, -2.5, 126.5]
    return _bf16(x), _bf16(h)


# ------------------------------------------- plain versions == composition
@settings(max_examples=40, deadline=None)
@given(M=st.integers(1, 64), K=st.sampled_from([64, 128, 192, 256, 512]),
       residual=st.booleans(), seed=st.integers(0, 2 ** 32 - 1))
def test_fused_plain_versions_equal_the_composition(M, K, residual, seed):
    """rmsnorm_quantize (N(1, 0.3) fp32 scales, residual on or off),
    swiglu_quantize and quantize_activations on the CPU give the codes,
    scales and x + h of the decoder's former op chain, bit for bit."""
    rng = np.random.default_rng(seed)
    x, h = _rows_with_ties(rng, M, K)
    w = _t(rng.normal(1.0, 0.3, K).astype(np.float32))
    h = h if residual else None
    got, want = quant.rmsnorm_quantize(x, w, EPS, residual=h), _rmsnorm_then_quantize(x, w, EPS, h)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # SwiGLU: gate 16 makes silu(gate) = 16 in bf16, so up = (k + 1/2) / 16
    # places quantization ties in the product
    gate, up = (_bf16(rng.standard_normal((M, K)) * 3.0), _bf16(rng.standard_normal((M, K))))
    gate[-1, :4] = 16.0
    up[-1, :4] = _bf16([127.0 / 16, 0.5 / 16, 2.5 / 16, -3.5 / 16])
    got = quant.swiglu_quantize(gate, up)
    want = quant.quantize_rows(silu(gate).float() * up.float())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(quant.quantize_activations(x),
                                                 quant.quantize_rows(x)))


def test_fused_plain_versions_keep_leading_dims():
    x, h = _rows_with_ties(np.random.default_rng(0), 6, 64)
    x3, h3 = x.view(2, 3, 64), h.view(2, 3, 64)
    q, s, xs = quant.rmsnorm_quantize(x3, torch.ones(64), EPS, residual=h3)
    assert q.shape == (2, 3, 64) and s.shape == (2, 3, 1) and xs.shape == (2, 3, 64)
    q2, s2 = quant.swiglu_quantize(x3, h3)
    assert q2.shape == (2, 3, 64) and s2.shape == (2, 3, 1)
    with pytest.raises(ValueError, match="no path for device"):
        quant.rmsnorm_quantize(x.to("meta"), torch.ones(64), EPS)
    with pytest.raises(ValueError, match="no path for device"):
        quant.swiglu_quantize(x.to("meta"), x.to("meta"))


#: (B, n, cache_len per row, Tmax): a token, the latent chunk, the prompt at
#: 0, a chunk past Tmax (start clamped) and a ragged batch of 3 whose token
#: past Tmax is dropped
WRITES = [(1, 1, (5,), 12), (1, 4, (3,), 12), (2, 8, (0, 0), 8), (1, 4, (10,), 12),
          (2, 4, (11, 2), 12), (3, 1, (2, 12, 15), 12)]


def _kv_inputs(B, n, Tmax, seed, H=4, KV=2, D=16):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((B * n, H * D)) * 2.0)
    k = _bf16(rng.standard_normal((B * n, KV * D)) * 2.0)
    v = _bf16(rng.standard_normal((B * n, KV * D)))
    v[0, :D] = 0.0  # a zero row takes the 1e-8 floor
    pos = _t(rng.integers(0, 300, (3, B, n)))
    cos, sin = mrope_cos_sin(pos, D, (2, 3, 3))

    def entry():
        return (_t(rng.integers(-127, 128, (B, Tmax, KV, D)).astype(np.int8)),
                _t(rng.uniform(1e-3, 0.05, (B, Tmax, KV, 1)).astype(np.float32)))

    return q, k, v, cos, sin, entry(), entry()


@pytest.mark.parametrize("B,n,lengths,Tmax", WRITES)
def test_rope_kv_write_reference_equals_rotary_then_write(B, n, lengths, Tmax):
    q, k, v, cos, sin, ke, ve = _kv_inputs(B, n, Tmax, seed=B * 10 + n)
    ref = [tuple(t.clone() for t in e) for e in (ke, ve)]
    cache_len = torch.tensor(lengths)
    q_rot = quant.rope_kv_write(q, k, v, cos, sin, ke, ve, cache_len)
    want = _rotary_then_write(q, k, v, cos, sin, *ref, cache_len)
    assert q_rot.shape == (B, 4, n, 16) and torch.equal(q_rot, want)
    for got, exp in zip((*ke, *ve), (*ref[0], *ref[1])):
        assert torch.equal(got, exp)
    if B == 3 and n == 1:  # the dropped rows' last slot kept its old codes
        assert torch.equal(ke[0][1:, Tmax - 1], _kv_inputs(B, n, Tmax, seed=31)[5][0][1:, -1])


# ----------------------------------------------------------- against JAX
def _jax_codes_times_scale(y):
    """QuantDense with an identity int8 kernel and unit scales returns
    float(codes) * a_scale of its input rows exactly."""
    K = y.shape[-1]
    jd = jqt.QuantDense(K, use_bias=False, dtype=jnp.float32)
    params = {"kernel_q": jnp.eye(K, dtype=jnp.int8), "scale_q": jnp.ones((K,), jnp.float32)}
    return np.asarray(jd.apply({"params": params}, y))


@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_quantize_matches_jax_rmsnorm_then_quant_dense(residual):
    """JAX: (x + h in bf16) → RMSNorm with an N(1, 0.3) fp32 scale →
    QuantDense; the port: one rmsnorm_quantize. Codes times scales equal
    bit for bit, and x + h too."""
    rng = np.random.default_rng(7 + residual)
    M, K = 9, 64
    x, h = _rows_with_ties(rng, M, K)
    w = rng.normal(1.0, 0.3, K).astype(np.float32)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if residual:
        jx = jx + jnp.asarray(h.float().numpy(), jnp.bfloat16)
    jy = jqt.RMSNorm(eps=EPS).apply({"params": {"scale": jnp.asarray(w)}}, jx)
    want = _jax_codes_times_scale(jy)
    q, s, xs = quant.rmsnorm_quantize(x, _t(w), EPS, residual=h if residual else None)
    np.testing.assert_array_equal((q.float() * s).numpy(), want)
    np.testing.assert_array_equal(xs.float().numpy(), np.asarray(jx, np.float32))


@pytest.mark.parametrize("B,n,lengths,Tmax", WRITES)
def test_rope_kv_write_matches_jax_rotary_quantize_and_cache_writes(B, n, lengths, Tmax):
    """JAX: apply_rotary on (B, H, n, D) bf16, then quantize_kv inside
    _write_cache (one token) or _write_cache_chunk (a chunk) of the rotated
    k and of v; the port: one rope_kv_write. Rotated q, codes and scales
    bitwise."""
    q, k, v, cos, sin, ke, ve = _kv_inputs(B, n, Tmax, seed=B * 10 + n + 1)
    D, KV = 16, 2
    jnp_bf16 = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    jq = jnp_bf16[0].reshape(B, n, -1, D).transpose(0, 2, 1, 3)
    jk = jnp_bf16[1].reshape(B, n, KV, D).transpose(0, 2, 1, 3)
    jq, jk = jqt.apply_rotary(jq, jk, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
    pos = jnp.asarray(np.asarray(lengths, np.int32))
    jentries = []
    for new, (data, scale) in ((jk.transpose(0, 2, 1, 3), ke),
                               (jnp_bf16[2].reshape(B, n, KV, D), ve)):
        cache = (jnp.asarray(data.numpy()), jnp.asarray(scale.numpy()))
        jentries.append(jqt._write_cache(cache, new[:, 0], pos) if n == 1
                        else jqt._write_cache_chunk(cache, new, pos))
    q_rot = quant.rope_kv_write(q, k, v, cos, sin, ke, ve, torch.tensor(lengths))
    np.testing.assert_array_equal(q_rot.float().numpy(), np.asarray(jq, np.float32))
    for (td, ts), (jd, js) in zip((ke, ve), jentries):
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------ the decoder's wiring
def _count(monkeypatch, obj, name, counts, key):
    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        counts[key] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(obj, name, wrapper)


def _spied_decode(monkeypatch, tm):
    """Run one decode step (with its logits) and a 3-token chunk of the tiny
    model over a prefilled cache; returns the calls of each spied name."""
    names = ("rmsnorm_quantize", "swiglu_quantize", "quantize_activations", "rope_kv_write",
             "apply_rotary", "silu_mul", "layer RMSNorm.forward")
    counts = dict.fromkeys(names, 0)
    rng = np.random.default_rng(3)
    B, T, E = 2, 8, tm.cfg.hidden_size
    pos = torch.arange(T).expand(3, B, T)
    with torch.no_grad():
        _, _, caches = tm(_bf16(rng.standard_normal((B, T, E))).to(tm.cfg.dtype), pos)
        caches = qt.pad_caches(caches, T + 6)
        for name in names[:6]:
            _count(monkeypatch, qt, name, counts, name)
        for layer in tm.layers:
            for norm in (layer.input_layernorm, layer.post_attention_layernorm):
                _count(monkeypatch, norm, "forward", counts, "layer RMSNorm.forward")
        new = _bf16(rng.standard_normal((B, 3, E))).to(tm.cfg.dtype)
        cache_len = torch.full((B,), T)
        step = dict(counts)
        tm.decode_step(new[:, :1], pos[:, :, -1:] + 1, caches, cache_len)
        step = {k: counts[k] - step[k] for k in names}
        chunk = dict(counts)
        tm.decode_chunk(new, pos[:, :, -3:] + 2, caches, cache_len + 1)
        chunk = {k: counts[k] - chunk[k] for k in names}
    return step, chunk


def test_int8_decoder_layers_call_the_fused_dispatchers(monkeypatch):
    """Each int8 layer of a decode step and of a chunk: rmsnorm_quantize
    twice, swiglu_quantize, quantize_activations (o_proj) and
    rope_kv_write once each, and no RMSNorm, apply_rotary or silu_mul of its
    own; the step's lm_head adds one quantize_activations."""
    cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), weight_dtype="int8", kv_dtype="int8")
    tm = qt.QwenTextModel(cfg)
    L = cfg.num_hidden_layers
    step, chunk = _spied_decode(monkeypatch, tm)
    want = {"rmsnorm_quantize": 2 * L, "swiglu_quantize": L, "quantize_activations": L,
            "rope_kv_write": L, "apply_rotary": 0, "layer RMSNorm.forward": 0, "silu_mul": 0}
    assert chunk == want
    assert step == {**want, "quantize_activations": L + 1}


def test_bf16_decoder_layers_keep_the_unfused_path(monkeypatch):
    tm = qt.QwenTextModel(qt.QwenTextConfig.tiny())
    L = tm.cfg.num_hidden_layers
    step, chunk = _spied_decode(monkeypatch, tm)
    want = {"rmsnorm_quantize": 0, "swiglu_quantize": 0, "quantize_activations": 0,
            "rope_kv_write": 0, "apply_rotary": L, "layer RMSNorm.forward": 2 * L, "silu_mul": L}
    assert step == want and chunk == want
