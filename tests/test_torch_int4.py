"""The port's W4A8 format (`weight_dtype="int4"`) against the JAX package.

Both packages get the same weights (the JAX init, quantized by the JAX
package's quantizers and carried across by `model/weights/from_jax.py`,
which packs the int4 leaves) and the same numpy inputs. Two widths: the
tiny config (hidden 64, intermediate 128: 128 divides only down_proj's
input, so the other projections fall back to per-channel int4 scales, as
the JAX test's comment says) and W128 (hidden 128, intermediate 256:
grouped-128 scales everywhere, two groups in down_proj). Tolerances:
- quantizers: codes bit for bit, scales exactly equal to the host
  quantizer's and within one fp32 ulp of the device quantizer's (XLA's CPU
  division by qmax may differ in the last bit, as for int8);
- `QuantDense` products in fp32 at atol/rtol 1e-6 (W4A8: exact integer
  sums, the same fp32 epilogue, the sum over groups perhaps in another
  order) and 1e-5 (W8A16 / W4A16: fp32 sums of bf16 products in another
  order);
- the fp32 models at 1e-4 (the int8 models' tolerance,
  tests/test_torch_qwen.py), int8 KV codes equal, greedy tokens exactly;
- decode against a re-prefill of the same tokens at rtol = atol = 2e-2
  (JAX's tests/test_int8_decode.py:248-270).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.ops.rope import rope_cos_sin as jrope_cos_sin
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.weights.from_jax import load_from_jax, state_dict_from_jax
from internnav_tpu_torch.ops import quant
from internnav_tpu_torch.ops.rope import rope_cos_sin
from test_torch_qwen import _assert_int8_caches_equal, _clone_caches, _close, _prompt, _t

torch.set_num_threads(2)
PRODUCT_TOL = 1e-6
W16_PRODUCT_TOL = 1e-5
DECODE_TOL = 2e-2
#: the widths at which grouped-128 scales cover every projection
W128 = dict(hidden_size=128, intermediate_size=256, head_dim=32, mrope_section=(4, 6, 6))
WIDTHS = {"tiny": {}, "w128": W128}
INT4 = dict(weight_dtype="int4", kv_dtype="int8")


def _cfgs(widths, **fmt):
    j = dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jnp.float32, **widths, **fmt)
    t = dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.float32, **widths, **fmt)
    return j, t


def _fp32_params(widths, seed=0):
    jcfg, _ = _cfgs(widths)
    jm = jqt.QwenTextModel(jcfg)
    ids = np.zeros((1, 4), np.int32)
    pos = np.zeros((3, 1, 4), np.int32)
    params = jax.jit(lambda i, p: jm.init(jax.random.PRNGKey(seed), i, p, method=jm.init_all))(
        jnp.asarray(ids), jnp.asarray(pos))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


_PAIRS = {}


def int4_pair(name, **fmt):
    """(JAX model, its int4 params, port model) at WIDTHS[name], fp32, with
    `fmt` on both configs (INT4 by default)."""
    fmt = {**INT4, **fmt}
    key = (name, tuple(sorted(fmt.items())))
    if key not in _PAIRS:
        widths = WIDTHS[name]
        params = _fp32_params(widths)
        qparams = jqt.quantize_qwen_text_params(params, weight_bits=4)
        jcfg, tcfg = _cfgs(widths, **fmt)
        tm = qt.QwenTextModel(tcfg)
        load_from_jax(tm, qparams)
        _PAIRS[key] = (jqt.QwenTextModel(jcfg), qparams, tm)
    return _PAIRS[key]


def _hidden(name):
    return 64 if name == "tiny" else 128


# -------------------------------------------------------------- storage
def test_pack_int4_layout_and_round_trip():
    """Two codes a byte along K, the even k in the low nibble; every code
    of [-7, 7] (and -8) comes back."""
    codes = torch.tensor([[1, -1, 7, -7, 0, -8, 3, 5]], dtype=torch.int8)
    packed = quant.pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (1, 4)
    assert packed[0].tolist() == [0xF1, 0x97, 0x80, 0x53]
    r = torch.from_numpy(np.random.default_rng(0).integers(-7, 8, (33, 256)).astype(np.int8))
    assert torch.equal(quant.unpack_int4(quant.pack_int4(r)), r)
    with pytest.raises(ValueError, match="even width"):
        quant.pack_int4(r[:, :3])


# ------------------------------------------------------------ quantizers
@pytest.mark.parametrize("name", ["tiny", "w128"])
@pytest.mark.parametrize("group", [None, 64])
def test_int4_quantizers_match_jax_host_and_device(name, group):
    """The port's tree quantizer at 4 bits against JAX's host and device
    quantizers: int4 codes bit for bit, scales equal, the lm_head at 8 bits
    with the same groups; the in-place quantizer packs the same codes."""
    params = _fp32_params(WIDTHS[name], seed=1)
    ours = qt.quantize_qwen_text_params(params, group_size=group, weight_bits=4)
    host = jqt.quantize_qwen_text_params(params, weight_bits=4, group_size=group)
    device = jqt.quantize_qwen_text_params_device(params, group_size=group, weight_bits=4)
    assert host["layers_0"]["mlp"]["up_proj"]["kernel_q"].dtype == jnp.int4
    assert host["lm_head"]["kernel_q"].dtype == np.int8
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    for ref in (host, device):
        flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        assert len(flat_o) == len(flat_r)
        for path, leaf in flat_o:
            want = np.asarray(flat_r[path])
            if want.dtype != np.float32:
                want = want.astype(np.int8)
            assert np.asarray(leaf).dtype == want.dtype, path
            if ref is device and want.dtype == np.float32:
                # XLA's CPU division by qmax may differ in the last bit
                np.testing.assert_allclose(np.asarray(leaf), want, rtol=2 ** -23, atol=0,
                                           err_msg=str(path))
            else:
                np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=str(path))
    g = quant.effective_group(group, 4)
    lm = ours["lm_head"]
    assert np.abs(lm["kernel_q"]).max() > 7  # 8-bit codes
    H = _hidden(name)
    assert lm["scale_q"].shape == ((H // g, 512) if H % g == 0 else (512,))
    tcfg = _cfgs(WIDTHS[name])[1]
    tm = qt.QwenTextModel(tcfg)
    load_from_jax(tm, params)
    qt.quantize_qwen_text_(tm, group_size=group, weight_bits=4)
    assert tm.cfg.weight_dtype == "int4" and tm.layers[0].self_attn.cfg is tm.cfg
    for mod, sub in ((tm.lm_head, ours["lm_head"]),
                     (tm.layers[1].self_attn.k_proj, ours["layers_1"]["self_attn"]["k_proj"]),
                     (tm.layers[0].mlp.down_proj, ours["layers_0"]["mlp"]["down_proj"])):
        codes = torch.from_numpy(sub["kernel_q"].T.copy())
        want = codes if mod.weight_bits == 8 else quant.pack_int4(codes)
        assert torch.equal(mod.weight_q, want)
        np.testing.assert_array_equal(mod.scale_q.numpy(), sub["scale_q"])


def test_from_jax_packs_int4_leaves():
    """JAX `jnp.int4` kernels (numpy's ml_dtypes.int4) land packed in the
    port's uint8 weight_q; (G, N) scales keep their layout."""
    _, qparams, tm = int4_pair("w128")
    sd = state_dict_from_jax(qparams, tm)
    leaf = qparams["layers_0"]["mlp"]["down_proj"]
    codes = torch.from_numpy(np.asarray(leaf["kernel_q"]).astype(np.int8).T.copy())
    assert sd["layers.0.mlp.down_proj.weight_q"].dtype == torch.uint8
    assert torch.equal(sd["layers.0.mlp.down_proj.weight_q"], quant.pack_int4(codes))
    assert sd["layers.0.mlp.down_proj.scale_q"].shape == (2, 128)
    assert sd["lm_head.weight_q"].dtype == torch.int8
    bad = jax.tree_util.tree_map(lambda a: a, qparams)
    bad["layers_0"]["mlp"]["down_proj"] = {**leaf, "kernel_q": np.zeros((256, 126), np.int8)}
    with pytest.raises(ValueError, match="shape differs"):
        state_dict_from_jax(bad, tm)


# -------------------------------------------------------------- products
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bf16_act", [False, True], ids=["w_a8", "w_a16"])
@pytest.mark.parametrize("K,group", [(64, None), (128, None), (256, 128), (384, 128)])
def test_quant_dense_products_match_jax(bits, bf16_act, K, group):
    """`QuantDense(weight_bits)` (with `bf16_act`) against the port's
    projection of the same codes: W8A8, W4A8, W8A16, W4A16, per channel and
    grouped (K = 256, 384: two and three groups of 128)."""
    N, M = 96, 5
    r = np.random.default_rng(K + bits)
    x = r.standard_normal((M, K)).astype(np.float32)
    qmax = quant.QMAX[bits]
    codes = r.integers(-qmax, qmax + 1, (K, N)).astype(np.int8)
    scale = (r.random((K // group, N) if group else (N,)) * 1e-2 + 1e-3).astype(np.float32)
    bias = r.standard_normal(N).astype(np.float32)
    dense = jqt.QuantDense(N, dtype=jnp.float32, group_size=group, weight_bits=bits)
    kq = jnp.asarray(codes, jnp.int4 if bits == 4 else jnp.int8)
    want = dense.apply({"params": {"kernel_q": kq, "scale_q": scale, "bias": bias}},
                       jnp.asarray(x), bf16_act=bf16_act)
    lin = qt.QuantLinear(K, N, True, group, torch.float32, weight_bits=bits)
    tcodes = torch.from_numpy(codes.T.copy())
    lin.weight_q = quant.pack_int4(tcodes) if bits == 4 else tcodes
    lin.scale_q, lin.bias = _t(scale), _t(bias)
    got = qt.project(_t(x), lin, bf16_act=bf16_act)[0]
    tol = W16_PRODUCT_TOL if bf16_act else PRODUCT_TOL
    _close(got, want, tol, tol)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("name", ["tiny", "w128"])
def test_int4_prefill_decode_and_chunk_match_jax(name):
    """W4A8 projections + int8 KV: prefill logits, one decode step and a
    3-token chunk over the padded prompt cache; the int8 cache data equal
    and its scales within 1e-4."""
    jm, params, tm = int4_pair(name)
    H = _hidden(name)
    emb, pos, seg, plen, _ = _prompt(512)
    emb = np.random.default_rng(4).standard_normal((*seg.shape, H)).astype(np.float32)
    B, T = seg.shape
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
    _close(tlog, jlog)
    _close(th, jh)
    _close(thc, jhc)
    _assert_int8_caches_equal(tc1, jc1)
    _assert_int8_caches_equal(tc2, jc2)


@pytest.mark.parametrize("name", ["tiny", "w128"])
def test_int4_greedy_generate_matches_jax(name):
    """Greedy tokens and lengths of the W4A8 model exactly equal, with an
    early stop on row 0."""
    jm, params, tm = int4_pair(name)
    H = _hidden(name)
    emb, pos, seg, plen, deltas = _prompt(512)
    emb = np.random.default_rng(5).standard_normal((*seg.shape, H)).astype(np.float32)
    args = dict(max_new_tokens=10, extra_cache_slots=2)

    def run_port(eos):
        return qt.greedy_generate(tm, _t(emb), _t(pos), eos_token_ids=eos,
                                  rope_deltas=_t(deltas), prompt_lengths=_t(plen),
                                  segment_ids=_t(seg), **args)

    eos = (int(run_port((511,))[0][0, 4]),)
    jtok, jlen, jcache = jqt.greedy_generate(
        jm, params, jnp.asarray(emb), jnp.asarray(pos), eos_token_ids=eos,
        rope_deltas=jnp.asarray(deltas), prompt_lengths=jnp.asarray(plen),
        segment_ids=jnp.asarray(seg), return_caches=True, **args)
    ttok, tlen, tcache = run_port(eos)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert int(tlen[0]) <= 4
    _assert_int8_caches_equal(tcache, jcache)


@pytest.mark.parametrize("name", ["tiny", "w128"])
def test_int4_decode_equals_reprefill(name):
    """JAX's W4A8 invariant (tests/test_int8_decode.py:248-270) on the
    port's bf16 model with a bf16 KV cache: the cached decode of token T
    gives the uncached forward's last logits within DECODE_TOL."""
    _, params, _ = int4_pair(name)
    cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), **WIDTHS[name], weight_dtype="int4")
    tm = load_from_jax(qt.QwenTextModel(cfg), params)
    B, T = 2, 12
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (B, T + 1)))
    pos = torch.arange(T + 1)[None, None].expand(3, B, T + 1)
    with torch.no_grad():
        _, _, caches = tm(tm.embed(ids[:, :T]), pos[..., :T])
        caches = qt.pad_caches(caches, T + 2)
        dec, _, _ = tm.decode_step(tm.embed(ids[:, T:]), pos[..., T:], caches,
                                   torch.full((B,), T))
        full, _, _ = tm(tm.embed(ids), pos)
    torch.testing.assert_close(dec.float(), full[:, -1].float(), atol=DECODE_TOL, rtol=DECODE_TOL)


# ------------------------------------------------------------- 1-D rope
def test_1d_rope_path_matches_jax():
    """(B, T) position ids take the 1-D `rope_cos_sin` tables in
    `_cos_sin` (JAX `qwen_text.py:648-653`), equal to JAX's, and the fp32
    prefill and a decode step with 1-D positions match JAX's."""
    params = _fp32_params(W128, seed=2)
    jcfg, tcfg = _cfgs(W128)
    jm, tm = jqt.QwenTextModel(jcfg), load_from_jax(qt.QwenTextModel(tcfg), params)
    B, T = 2, 9
    pos = np.broadcast_to(np.arange(T)[None] + np.array([[0], [3]]), (B, T)).astype(np.int32)
    cos, sin = tm._cos_sin(_t(pos))
    jcos, jsin = jrope_cos_sin(jnp.asarray(pos), 32, tcfg.rope_theta)
    _close(cos, jcos, 1e-6, 1e-6)
    _close(sin, jsin, 1e-6, 1e-6)
    c2, s2 = rope_cos_sin(_t(pos), 32, tcfg.rope_theta)
    assert torch.equal(cos, c2) and torch.equal(sin, s2)
    emb = np.random.default_rng(7).standard_normal((B, T, 128)).astype(np.float32)
    new = np.random.default_rng(8).standard_normal((B, 1, 128)).astype(np.float32)
    npos = (pos[:, -1:] + 1).astype(np.int32)

    @jax.jit
    def jax_side(p, emb, pos, new, npos):
        logits, _, jc = jm.apply({"params": p}, emb, pos, return_cache=True)
        jc = jqt.pad_caches(jc, T + 1)
        step = jm.apply({"params": p}, new, npos, jc, jnp.full((B,), T, jnp.int32),
                        method=jm.decode_step)
        return logits, step[0]

    jl, jstep = jax_side(params, *(jnp.asarray(a) for a in (emb, pos, new, npos)))
    with torch.no_grad():
        tl, _, tc = tm(_t(emb), _t(pos))
        tc = qt.pad_caches(tc, T + 1)
        tstep, _, _ = tm.decode_step(_t(new), _t(npos), tc, torch.full((B,), T))
    _close(tl, jl)
    _close(tstep, jstep)


def _random_quant_layer(cfg, seed):
    """A tiny layer's attention and MLP with random codes, scales and biases."""
    attn, mlp = qt.QwenAttention(cfg), qt.QwenMLP(cfg)
    g = torch.Generator().manual_seed(seed)
    for mod in (attn.q_proj, attn.k_proj, attn.v_proj, attn.o_proj, mlp.gate_proj, mlp.up_proj,
                mlp.down_proj):
        qmax = quant.QMAX[mod.weight_bits]
        codes = torch.randint(-qmax, qmax + 1, (mod.out_features, mod.in_features), generator=g,
                              dtype=torch.int8)
        mod.weight_q = quant.pack_int4(codes) if mod.weight_bits == 4 else codes
        mod.scale_q = torch.rand(mod.scale_q.shape, generator=g) * 1e-2 + 1e-3
        if mod.bias is not None:
            mod.bias = torch.randn(mod.bias.shape, generator=g)
    return attn, mlp


@pytest.mark.parametrize("bf16_act", [False, True], ids=["w4a8", "w4a16"])
@pytest.mark.parametrize("group", [None, 32])
def test_project_fused_plain_path_equals_per_projection(monkeypatch, bf16_act, group):
    """q/k/v and gate/up of a tiny int4 layer each go to one call of the
    4-bit dispatcher (`w4a8_linear_multi`; with bf16_act `w8a16_linear_multi`,
    one K9 or K10 launch on the card), which on the CPU runs each segment's
    plain version: bit for bit what each projection gives alone, and no
    kernel counted."""
    cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), weight_dtype="int4",
                              quant_group_size=group, dtype=torch.float32)
    attn, mlp = _random_quant_layer(cfg, seed=3 + bool(bf16_act))
    name = "w8a16_linear_multi" if bf16_act else "w4a8_linear_multi"
    calls = []
    multi = getattr(qt, name)
    monkeypatch.setattr(qt, name, lambda *a, **k: calls.append(len(a[-1])) or multi(*a, **k))
    x = torch.randn((2, 3, cfg.hidden_size), generator=torch.Generator().manual_seed(4))
    before = [getattr(quant, c) for c in quant.LAUNCH_COUNTERS]
    with torch.no_grad():
        for mods in ((attn.q_proj, attn.k_proj, attn.v_proj), (mlp.gate_proj, mlp.up_proj)):
            calls.clear()
            fused = qt.project(x, *mods, bf16_act=bf16_act)
            alone = [qt.project(x, m, bf16_act=bf16_act)[0] for m in mods]
            assert calls == [len(mods)] + [1] * len(mods)
            for y, z, m in zip(fused, alone, mods):
                assert y.shape == (2, 3, m.out_features) and torch.equal(y, z)
    assert before == [getattr(quant, c) for c in quant.LAUNCH_COUNTERS]
