"""The port's int8 ops (`ops/quant.py`, the int8 decode attention, the
weight quantizers) held against the JAX package on the CPU.

Inputs are numpy draws from a seed, handed to both sides. Tolerances:
int8 codes and scales bitwise; `QuantLinear` against `QuantDense` at
rtol 1e-5 in fp32 (the same integer product; the grouped sum over groups
in another order); the int8 decode attention at atol/rtol 1e-5 (fp32
softmax and sums, another summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.ops.flash_attention import (
    gqa_chunk_decode_attention as jax_chunk_decode,
    gqa_decode_attention as jax_decode,
)
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.ops import flash_attention as fa
from internnav_tpu_torch.ops import quant

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(seed, M, K):
    """Activations with a zero row, a row of one repeated value and rows at
    bf16-representable values (as the model's bf16 activations are)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32) * r.uniform(0.1, 8.0, (M, 1))
    x = np.asarray(torch.from_numpy(x).bfloat16().float())
    x[0] = 0.0
    x[1] = 0.75
    return x.astype(np.float32)


def test_quantize_rows_codes_equal_quant_dense():
    """QuantDense with an identity int8 kernel and unit scales returns
    float(xq) * a_scale exactly, so its codes are read back from it and
    counted against the port's: none may flip."""
    x = _rows(0, 9, 256)
    jd = jqt.QuantDense(256, use_bias=False, dtype=jnp.float32)
    params = {"kernel_q": jnp.eye(256, dtype=jnp.int8),
              "scale_q": jnp.ones((256,), jnp.float32)}
    y = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    q, a = quant.quantize_rows(_t(x))
    assert q.dtype == torch.int8 and a.dtype == torch.float32 and a.shape == (9, 1)
    codes = np.round(y / a.numpy())
    flipped = int((codes != q.numpy()).sum())
    assert flipped == 0, f"{flipped} int8 codes differ from QuantDense's"
    np.testing.assert_array_equal(y, (q.float() * a).numpy())
    assert int(q[0].abs().max()) == 0 and torch.all(q[1] == 127)


@pytest.mark.parametrize("K,group,bias", [(256, None, True), (256, None, False),
                                          (256, 128, True), (256, 128, False),
                                          (192, 128, True)])
def test_quant_linear_matches_quant_dense(K, group, bias):
    """Per-channel, grouped g=128 and a K that g does not divide (falls back
    to per-channel scales), with and without bias."""
    N, M = 48, 7
    r = np.random.default_rng(K + (group or 0) + bias)
    G = K // group if group and K % group == 0 else None
    params = {"kernel_q": r.integers(-127, 128, (K, N)).astype(np.int8),
              "scale_q": r.uniform(1e-3, 2e-2, (G, N) if G else (N,)).astype(np.float32)}
    if bias:
        params["bias"] = r.standard_normal(N).astype(np.float32)
    x = _rows(1, M, K)
    jd = jqt.QuantDense(N, use_bias=bias, dtype=jnp.float32, group_size=group)
    ref = np.asarray(jd.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                              jnp.asarray(x)))
    lin = qt.QuantLinear(K, N, bias, group, dtype=torch.float32)
    load_from_jax(lin, params)
    assert tuple(lin.scale_q.shape) == ((G, N) if G else (N,))
    with torch.no_grad():
        out = lin(_t(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_quantize_kv_matches_jax_bitwise():
    r = np.random.default_rng(2)
    x = (r.standard_normal((2, 5, 3, 16)) * r.uniform(0.01, 10, (2, 5, 3, 1))).astype(np.float32)
    x[0, 1] = 0.0  # zero rows take the 1e-8 floor
    x[1, 2, 0] = 1e-12
    jq, js = jqt.quantize_kv(jnp.asarray(x))
    tq, ts = quant.quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_write_kv_cache_reference_matches_jax_cache_writes():
    """Quantized writes of 1 and of n tokens at per-row positions equal the
    JAX `_write_cache` / `_write_cache_chunk` on tuple entries."""
    r = np.random.default_rng(3)
    B, T, KV, D = 2, 12, 2, 16
    entry = (np.zeros((B, T, KV, D), np.int8), np.zeros((B, T, KV, 1), np.float32))
    pos = np.array([3, 7])
    for n in (1, 4):
        k = r.standard_normal((B, n, KV, D)).astype(np.float32)
        v = r.standard_normal((B, n, KV, D)).astype(np.float32)
        jent = tuple(map(jnp.asarray, entry))
        if n == 1:
            jk = jqt._write_cache(jent, jnp.asarray(k[:, 0]), jnp.asarray(pos))
            jv = jqt._write_cache(jent, jnp.asarray(v[:, 0]), jnp.asarray(pos))
        else:
            jk = jqt._write_cache_chunk(jent, jnp.asarray(k), jnp.asarray(pos))
            jv = jqt._write_cache_chunk(jent, jnp.asarray(v), jnp.asarray(pos))
        tk, tv = tuple(_t(e) for e in entry), tuple(_t(e) for e in entry)
        quant.write_kv_cache(_t(k), _t(v), tk, tv, _t(pos))
        for got, want in zip((*tk, *tv), (*jk, *jv)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _int8_cache(r, B, KV, Tmax, D):
    data = r.integers(-127, 128, (B, KV, Tmax, D)).astype(np.int8)
    scale = r.uniform(1e-3, 5e-2, (B, KV, Tmax)).astype(np.float32)
    return data, scale


def test_int8_gqa_decode_plain_versions_match_jax():
    """gqa_decode_attention (one token) and gqa_chunk_decode_attention (n
    tokens, stepwise causal) with int8 caches and their scales, cache
    lengths differing per row."""
    r = np.random.default_rng(4)
    B, H, KV, Tmax, D, n = 2, 8, 2, 40, 16, 4
    kd, ks = _int8_cache(r, B, KV, Tmax, D)
    vd, vs = _int8_cache(r, B, KV, Tmax, D)
    lens = np.array([5, 31])
    q1 = r.standard_normal((B, H, D)).astype(np.float32)
    qn = r.standard_normal((B, H, n, D)).astype(np.float32)
    j1 = jax_decode(jnp.asarray(q1), jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(lens),
                    k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    jn = jax_chunk_decode(jnp.asarray(qn), jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(lens),
                          k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t1 = fa.gqa_decode_attention(_t(q1), _t(kd), _t(vd), _t(lens), k_scale=_t(ks),
                                 v_scale=_t(vs))
    tn = fa.gqa_chunk_decode_attention(_t(qn), _t(kd), _t(vd), _t(lens), k_scale=_t(ks),
                                       v_scale=_t(vs))
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=1e-5)


def _tiny_f32_params(seed=0):
    cfg = dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jnp.float32)
    jm = jqt.QwenTextModel(cfg)
    ids = np.zeros((1, 4), np.int32)
    pos = np.zeros((3, 1, 4), np.int32)
    params = jax.jit(lambda i, p: jm.init(jax.random.PRNGKey(seed), i, p, method=jm.init_all))(
        jnp.asarray(ids), jnp.asarray(pos))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("group", [None, 32])
def test_quantize_params_tree_matches_jax(group):
    params = _tiny_f32_params()
    ours = qt.quantize_qwen_text_params(params, group_size=group)
    theirs = jqt.quantize_qwen_text_params(params, group_size=group)
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert len(flat_o) == len(flat_t)
    for path, leaf in flat_o:
        want = np.asarray(flat_t[path])
        assert np.asarray(leaf).dtype == want.dtype, path
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=str(path))
    assert "kernel_q" in ours["lm_head"] and "embedding" in ours["embed_tokens"]


@pytest.mark.parametrize("group", [None, 32])
def test_quantize_model_in_place_matches_tree(group):
    """`quantize_qwen_text_` on a built fp32 model gives the tree
    quantizer's int8 weights and scales bit for bit, and the int8 config."""
    params = _tiny_f32_params(1)
    tree = qt.quantize_qwen_text_params(params, group_size=group)
    tm = qt.QwenTextModel(dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.float32))
    load_from_jax(tm, params)
    qt.quantize_qwen_text_(tm, group_size=group)
    assert tm.cfg.weight_dtype == "int8" and tm.layers[0].self_attn.cfg is tm.cfg
    assert not any(isinstance(m, torch.nn.Linear) for m in tm.modules())
    for name, mod in [("lm_head", tm.lm_head),
                      ("q_proj", tm.layers[1].self_attn.q_proj),
                      ("down_proj", tm.layers[0].mlp.down_proj)]:
        sub = tree["lm_head"] if name == "lm_head" else (
            tree["layers_1"]["self_attn"][name] if name == "q_proj"
            else tree["layers_0"]["mlp"][name])
        np.testing.assert_array_equal(mod.weight_q.numpy(), sub["kernel_q"].T)
        np.testing.assert_array_equal(mod.scale_q.numpy(), sub["scale_q"])
        if "bias" in sub:
            np.testing.assert_array_equal(mod.bias.numpy(), sub["bias"])


def test_dispatchers_send_cpu_tensors_to_the_plain_versions():
    before = (quant.quantize_rows_launches, quant.w8a8_launches, quant.kv_write_launches,
              fa.decode_int8_launches, fa.chunk_decode_int8_launches)
    x = torch.from_numpy(_rows(5, 3, 128))
    xq, a = quant.quantize_activations(x)
    w = torch.randint(-127, 128, (16, 128), dtype=torch.int8)
    s = torch.rand(16) * 1e-2
    y = quant.w8a8_linear(xq, a, w, s, out_dtype=torch.float32)
    torch.testing.assert_close(y, quant.w8a8_linear_reference(xq, a, w, s, None,
                                                              out_dtype=torch.float32),
                               rtol=0, atol=0)
    assert before == (quant.quantize_rows_launches, quant.w8a8_launches,
                      quant.kv_write_launches, fa.decode_int8_launches,
                      fa.chunk_decode_int8_launches)
    with pytest.raises(ValueError, match="no path for device"):
        quant.quantize_activations(x.to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (the dispatchers route
    CPU tensors to the plain versions); they raise before building."""
    x = torch.zeros((2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        quant.quantize_rows_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        quant.w8a8_linear_cuda(x.to(torch.int8), torch.ones(2, 1), torch.zeros((8, 128),
                                                                             dtype=torch.int8),
                               torch.ones(8))
    k = torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16)
    entry = (torch.zeros((1, 4, 2, 128), dtype=torch.int8), torch.zeros((1, 4, 2, 1)))
    with pytest.raises(ValueError, match="on cpu"):
        quant.write_kv_cache_cuda(k, k, entry, entry, torch.zeros(1, dtype=torch.long))
    q = torch.zeros((1, 8, 1, 128), dtype=torch.bfloat16)
    cache = torch.zeros((1, 2, 4, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.gqa_chunk_decode_int8_cuda(q, cache, cache, torch.zeros(1, dtype=torch.long),
                                      torch.ones(1, 2, 4), torch.ones(1, 2, 4))
