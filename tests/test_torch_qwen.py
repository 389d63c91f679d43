"""Port Qwen2.5-VL System-2 modules held against the JAX package.

Both packages get the same weights (the JAX init, through
`model/weights/from_jax.py`) and the same numpy inputs. Tolerances: fp32
at atol/rtol 1e-4 (same math, different summation order), greedy tokens
exactly equal, and one bf16 case at atol/rtol 3e-2 (bf16 rounding at
every layer boundary, in a different order on each side).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.model.basemodel.internvla_n1 import qwen_vision as jqv
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_vision as qv
from internnav_tpu_torch.model.weights.from_jax import load_from_jax, state_dict_from_jax
from internnav_tpu_torch.ops.rope import get_rope_index_25

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
BF16_TOL = 3e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------------ text
def _text_pair(jdtype=jnp.float32, tdtype=torch.float32):
    jcfg = dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jdtype)
    jm = jqt.QwenTextModel(jcfg)
    B, T = 2, 16
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, T))
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T))
    params = jax.jit(lambda i, p: jm.init(jax.random.PRNGKey(0), i, p, method=jm.init_all))(
        jnp.asarray(ids), jnp.asarray(pos))["params"]
    tm = qt.QwenTextModel(dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=tdtype))
    load_from_jax(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def text_pair():
    return _text_pair()


def _prompt(cfg_vocab, B=2, P=21, T=32, seed=1):
    """A bucketed prompt: P real tokens right-padded to T, pads in segment 1,
    M-RoPE positions from get_rope_index_25 plus pad positions."""
    r = np.random.default_rng(seed)
    ids = r.integers(3, cfg_vocab - 10, (B, P))
    pos, deltas = get_rope_index_25(ids, None)
    pad_pos = pos.max() + 1 + np.arange(T - P)
    pos = np.concatenate([pos, np.broadcast_to(pad_pos, (3, B, T - P))], axis=2)
    seg = np.zeros((B, T), np.int32)
    seg[:, P:] = 1
    emb = r.standard_normal((B, T, 64)).astype(np.float32)
    return emb, pos, seg, np.full((B,), P, np.int32), deltas[:, 0]


def test_text_prefill_logits_and_caches_match_jax(text_pair):
    jm, params, tm = text_pair
    emb, pos, seg, plen, _ = _prompt(512)
    jl, jh, jc = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:2], segment_ids=a[2], return_cache=True, logits_indices=a[3]))(
        params, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(seg), jnp.asarray(plen - 1))
    with torch.no_grad():
        tl, th, tc = tm(_t(emb), _t(pos), segment_ids=_t(seg),
                        logits_indices=_t(plen - 1).long())
    _close(tl, jl)
    _close(th, jh)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        _close(tk, jk)
        _close(tv, jv)


def test_text_decode_step_and_chunk_match_jax(text_pair):
    jm, params, tm = text_pair
    emb, pos, seg, plen, _ = _prompt(512)
    B, T = seg.shape
    new = np.random.default_rng(2).standard_normal((B, 3, 64)).astype(np.float32)
    npos = (pos.max() + 1 + np.arange(3))[None, None].repeat(3, 0).repeat(B, 1)
    cl = plen.copy()

    @jax.jit
    def jax_side(p, emb, pos, seg, new, npos, cl):
        _, _, jc = jm.apply({"params": p}, emb, pos, segment_ids=seg, return_cache=True)
        jc = jqt.pad_caches(jc, T + 4)
        step = jm.apply({"params": p}, new[:, :1], npos[:, :, :1], jc, cl,
                        method=jm.decode_step)
        chunk, _ = jm.apply({"params": p}, new, npos, jc, cl, method=jm.decode_chunk)
        return step, chunk

    (jlog, jh, jc1), jhc = jax_side(params, *(jnp.asarray(a) for a in (emb, pos, seg, new,
                                                                       npos, cl)))
    with torch.no_grad():
        _, _, tc = tm(_t(emb), _t(pos), segment_ids=_t(seg))
        tc = qt.pad_caches(tc, T + 4)
        tlog, th, tc1 = tm.decode_step(_t(new[:, :1]), _t(npos[:, :, :1]),
                                       [(k.clone(), v.clone()) for k, v in tc], _t(cl).long())
        thc, _ = tm.decode_chunk(_t(new), _t(npos), tc, _t(cl).long())
    _close(tlog, jlog)
    _close(th, jh)
    _close(thc, jhc)
    for (tk, tv), (jk, jv) in zip(tc1, jc1):
        _close(tk, jk)
        _close(tv, jv)


def test_greedy_generate_bucketed_prompt_matches_jax(text_pair):
    """Greedy tokens exactly equal; the stop token is one the port emits at
    step 4 of row 0, so that row stops early while row 1 runs on."""
    jm, params, tm = text_pair
    emb, pos, seg, plen, deltas = _prompt(512)
    args = dict(max_new_tokens=10, extra_cache_slots=2)

    def run_jax(eos):
        return jqt.greedy_generate(jm, params, jnp.asarray(emb), jnp.asarray(pos),
                                   eos_token_ids=eos, rope_deltas=jnp.asarray(deltas),
                                   prompt_lengths=jnp.asarray(plen),
                                   segment_ids=jnp.asarray(seg), return_caches=True, **args)

    def run_port(eos):
        return qt.greedy_generate(tm, _t(emb), _t(pos), eos_token_ids=eos,
                                  rope_deltas=_t(deltas), prompt_lengths=_t(plen),
                                  segment_ids=_t(seg), **args)

    eos = (int(run_port((511,))[0][0, 4]),)
    jtok, jlen, jcache = run_jax(eos)
    ttok, tlen, tcache = run_port(eos)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert int(tlen[0]) <= 4
    for (tk, tv), (jk, jv) in zip(tcache, jcache):  # incl. the decoded tokens' K/V
        _close(tk, jk)
        _close(tv, jv)


def test_text_prefill_bf16_matches_jax():
    """bf16 on both sides (JAX computes with bf16-cast fp32 params, the port
    holds the same values in bf16): hidden states within 3e-2."""
    jm, params, tm = _text_pair(jnp.bfloat16, torch.bfloat16)
    emb, pos, seg, plen, _ = _prompt(512)
    _, jh, _ = jax.jit(lambda p, e, pos, seg: jm.apply({"params": p}, e, pos, segment_ids=seg))(
        params, jnp.asarray(emb, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(seg))
    with torch.no_grad():
        _, th, _ = tm(_t(emb).bfloat16(), _t(pos), segment_ids=_t(seg))
    _close(th.float(), np.asarray(jh, np.float32), BF16_TOL, BF16_TOL)


def _spy(monkeypatch, module, name, calls, key=None):
    """Record each call of module.name (its result, or kwargs[key])."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out if key is None else kwargs[key])
        return out

    monkeypatch.setattr(module, name, wrapper)


def test_text_model_builds_tile_tables_once_for_all_layers(text_pair, monkeypatch):
    """One table build per forward, handed to every layer's attention; the
    output equals the one with no tables handed down."""
    tm = text_pair[2]
    emb, pos, seg, plen, _ = _prompt(512)
    built, seen = [], []
    _spy(monkeypatch, qt, "segment_tile_tables", built)
    _spy(monkeypatch, qt, "flash_attention", seen, key="tile_tables")
    L = tm.cfg.num_hidden_layers
    with torch.no_grad():
        _, with_tables, _ = tm(_t(emb), _t(pos), segment_ids=_t(seg))
        assert len(built) == 1 and len(seen) == L
        assert built[0] is not None and all(t is built[0] for t in seen)
        monkeypatch.setattr(qt, "segment_tile_tables", lambda seg: None)
        _, without, _ = tm(_t(emb), _t(pos), segment_ids=_t(seg))
        assert len(seen) == 2 * L and all(t is None for t in seen[L:])
    assert torch.equal(with_tables, without)


def test_quantized_formats_are_not_silently_bf16():
    """int8 and int4 weights and int8 KV build QuantLinear projections (int4
    layers packed, the lm_head at 8 bits) and tuple caches; W8A16 decode
    builds and runs; unknown formats raise instead of running as something
    else."""
    cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), weight_dtype="int8", kv_dtype="int8")
    tm = qt.QwenTextModel(cfg)
    assert isinstance(tm.lm_head, qt.QuantLinear)
    assert isinstance(tm.layers[0].mlp.down_proj, qt.QuantLinear)
    assert isinstance(tm.embed_tokens, torch.nn.Embedding)
    assert not any(isinstance(m, torch.nn.Linear) for m in tm.modules())
    t4 = qt.QwenTextModel(dataclasses.replace(cfg, weight_dtype="int4"))
    assert not any(isinstance(m, torch.nn.Linear) for m in t4.modules())
    assert t4.layers[0].mlp.down_proj.weight_q.dtype == torch.uint8
    assert t4.lm_head.weight_bits == 8 and t4.lm_head.weight_q.dtype == torch.int8
    for wdt in ("int8", "int4"):
        w16 = dataclasses.replace(cfg, weight_dtype=wdt, decode_act_dtype="bf16")
        assert w16.decode_bf16_act
        m = qt.QwenTextModel(w16)
        B, T = 1, 5
        pos = torch.arange(T)[None, None].expand(3, B, T)
        with torch.no_grad():
            _, _, caches = m(m.embed(torch.ones(B, T, dtype=torch.long)), pos)
            caches = qt.pad_caches(caches, T + 1)
            logits, _, _ = m.decode_step(m.embed(torch.ones(B, 1, dtype=torch.long)),
                                         torch.full((3, B, 1), T), caches,
                                         torch.full((B,), T))
        assert logits.shape == (B, cfg.vocab_size) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="weight_dtype"):
        qt.QwenTextConfig(weight_dtype="int2")
    with pytest.raises(ValueError, match="decode_act_dtype"):
        qt.QwenTextConfig(weight_dtype="int8", decode_act_dtype="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        qt.QwenTextConfig(kv_dtype="fp8")


# ------------------------------------------------------- int8 realtime
INT8 = dict(weight_dtype="int8", kv_dtype="int8")


@pytest.fixture(scope="module")
def int8_text_pair(text_pair):
    """The fp32 tiny weights quantized by the JAX package's
    `quantize_qwen_text_params`, in both int8/int8 models (the port's
    through `from_jax`)."""
    _, params, _ = text_pair
    qparams = jqt.quantize_qwen_text_params(jax.tree_util.tree_map(np.asarray, params))
    jm = jqt.QwenTextModel(dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jnp.float32,
                                               **INT8))
    tm = qt.QwenTextModel(dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.float32,
                                              **INT8))
    load_from_jax(tm, qparams)
    return jm, qparams, tm


def _clone_caches(caches):
    return [tuple(tuple(x.clone() for x in e) for e in layer) for layer in caches]


def _assert_int8_caches_equal(port, ref):
    for tlayer, jlayer in zip(port, ref):
        for (td, ts), (jd, js) in zip(tlayer, jlayer):
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            _close(ts, js)


def test_int8_text_prefill_decode_and_chunk_match_jax(int8_text_pair):
    """W8A8 projections + int8 KV: prefill logits, one decode step and a
    3-token chunk over the padded prompt cache; the int8 cache data equal
    and its scales within 1e-4."""
    jm, params, tm = int8_text_pair
    emb, pos, seg, plen, _ = _prompt(512)
    B, T = seg.shape
    new = np.random.default_rng(2).standard_normal((B, 3, 64)).astype(np.float32)
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
        assert isinstance(tc[0][0], tuple) and tc[0][0][0].dtype == torch.int8
        tlog, th, tc1 = tm.decode_step(_t(new[:, :1]), _t(npos[:, :, :1]), _clone_caches(tc),
                                       _t(plen).long())
        thc, tc2 = tm.decode_chunk(_t(new), _t(npos), tc, _t(plen).long())
    _close(tl, jl)
    _close(tlog, jlog)
    _close(th, jh)
    _close(thc, jhc)
    _assert_int8_caches_equal(tc1, jc1)
    _assert_int8_caches_equal(tc2, jc2)


def test_int8_greedy_generate_matches_jax(int8_text_pair):
    """Greedy tokens of the int8/int8 model exactly equal, with an early
    stop on row 0 as in the bf16 test."""
    jm, params, tm = int8_text_pair
    emb, pos, seg, plen, deltas = _prompt(512)
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


# ---------------------------------------------------------------- vision
def _vision_inputs(cfg, sizes, seed=3):
    """Patches for images of the given sizes (each its own grid)."""
    r = np.random.default_rng(seed)
    patches, grids = [], []
    for hw in sizes:
        img = r.standard_normal((1, hw, hw, 3)).astype(np.float32)
        p, g = qv.preprocess_images(img, cfg)
        pj, gj = jqv.preprocess_images(img, cfg)
        np.testing.assert_array_equal(p, pj)
        np.testing.assert_array_equal(g, gj)
        patches.append(p)
        grids.append(g)
    grid = np.concatenate(grids)
    key = tuple(map(tuple, grid.tolist()))
    idx = qv.vision_indices((cfg.patch_size, cfg.spatial_merge_size, cfg.window_size), key)
    jidx = jqv.vision_indices((cfg.patch_size, cfg.spatial_merge_size, cfg.window_size), key)
    for name in idx:
        np.testing.assert_array_equal(np.asarray(idx[name]), np.asarray(jidx[name]))
    cos, sin = qv.rotary_table(idx["pos_ids"], cfg.hidden_size // cfg.num_heads)
    jcos, jsin = jqv.rotary_table(idx["pos_ids"], cfg.hidden_size // cfg.num_heads)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    arrays = (np.concatenate(patches), cos, sin, idx["window_segments"], idx["full_segments"],
              idx["window_index"], idx["reverse_index"])
    return arrays, idx["window_block"], idx["full_block"]


@pytest.mark.parametrize("sizes,segmented", [((56,), False), ((84, 56), True)])
def test_vision_tower_matches_jax(sizes, segmented):
    """Uniform windows take the block-diagonal path; ragged windows and two
    image sizes take the segmented flash_attention path."""
    jcfg = dataclasses.replace(jqv.QwenVisionConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(qv.QwenVisionConfig.tiny(), dtype=torch.float32)
    arrays, wblk, fblk = _vision_inputs(tcfg, sizes)
    assert (wblk == 0 and fblk == 0) == segmented
    jt = jqv.QwenVisionTower(jcfg)
    jargs = [jnp.asarray(a) for a in arrays]
    params = jax.jit(lambda *a: jt.init(jax.random.PRNGKey(1), *a, window_block=wblk,
                                        full_block=fblk)["params"])(*jargs)
    ref = jax.jit(lambda p, *a: jt.apply({"params": p}, *a, window_block=wblk,
                                         full_block=fblk))(params, *jargs)
    tt = load_from_jax(qv.QwenVisionTower(tcfg), params)
    with torch.no_grad():
        out = tt(*[_t(a) for a in arrays], window_block=wblk, full_block=fblk)
    _close(out, ref)


def test_encode_images_matches_jax():
    """Host normalize + patchify + tower, 84 px frames (ragged windows)."""
    jcfg = dataclasses.replace(jqv.QwenVisionConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(qv.QwenVisionConfig.tiny(), dtype=torch.float32)
    raw = np.random.default_rng(5).integers(0, 256, (2, 84, 84, 3)).astype(np.uint8)
    arrays, wblk, fblk = _vision_inputs(tcfg, (84, 84))
    jt = jqv.QwenVisionTower(jcfg)
    params = jax.jit(lambda *a: jt.init(jax.random.PRNGKey(2), *a, window_block=wblk,
                                        full_block=fblk)["params"])(*map(jnp.asarray, arrays))
    ref, jgrid = jqv.encode_images(jt, params, raw)
    out, grid = qv.encode_images(load_from_jax(qv.QwenVisionTower(tcfg), params), raw)
    np.testing.assert_array_equal(grid, jgrid)
    _close(out, ref)


def test_device_preprocess_matches_host():
    cfg = qv.QwenVisionConfig.tiny()
    raw = np.random.default_rng(4).integers(0, 256, (2, 56, 84, 3)).astype(np.uint8)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    host, _ = qv.preprocess_images((raw / 255.0 - np.asarray(mean)) / np.asarray(std), cfg)
    _close(qv.preprocess_images_device(_t(raw), cfg, mean, std), host)


def test_from_jax_rejects_unconsumed_and_missing_leaves(text_pair):
    jm, params, tm = text_pair
    extra = {**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_jax(extra, tm)
    partial = {k: v for k, v in params.items() if k != "norm"}
    with pytest.raises(KeyError, match="norm.weight"):
        state_dict_from_jax(partial, tm)


def test_vision_tower_builds_one_table_per_segment_set(monkeypatch):
    """Ragged windows (the flash path): one table for the window blocks and
    one for the full-attention blocks per forward, each shared by its
    blocks; the output equals the one with no tables handed down."""
    tcfg = dataclasses.replace(qv.QwenVisionConfig.tiny(), dtype=torch.float32)
    arrays, wblk, fblk = _vision_inputs(tcfg, (84, 56))
    torch.manual_seed(0)
    tower = qv.QwenVisionTower(tcfg)
    args = [_t(a) for a in arrays]
    built, seen = [], []
    with torch.no_grad():
        _spy(monkeypatch, qv, "segment_tile_tables", built)
        _spy(monkeypatch, qv, "flash_attention", seen, key="tile_tables")
        with_tables = tower(*args, window_block=wblk, full_block=fblk)
        assert len(built) == 2 and len(seen) == tcfg.depth
        for i, tabs in enumerate(seen):
            assert tabs is built[1 if i in tcfg.fullatt_block_indexes else 0]
        monkeypatch.setattr(qv, "segment_tile_tables", lambda seg: None)
        without = tower(*args, window_block=wblk, full_block=fblk)
        assert all(t is None for t in seen[tcfg.depth:])
    assert torch.equal(with_tables, without)


def test_from_jax_maps_int8_leaves_strictly(int8_text_pair):
    """`kernel_q` (in, out) lands transposed in `weight_q` (out, in) as
    int8 and `scale_q` as it is; a missing or an extra int8 leaf raises."""
    _, params, tm = int8_text_pair
    sd = state_dict_from_jax(params, tm)
    wq = sd["layers.0.self_attn.q_proj.weight_q"]
    assert wq.dtype == torch.int8
    kernel_q = params["layers_0"]["self_attn"]["q_proj"]["kernel_q"]
    np.testing.assert_array_equal(wq.numpy(), np.asarray(kernel_q).T)
    np.testing.assert_array_equal(sd["lm_head.scale_q"].numpy(), params["lm_head"]["scale_q"])
    missing = {**params, "lm_head": {"kernel_q": params["lm_head"]["kernel_q"]}}
    with pytest.raises(KeyError, match="lm_head.scale_q"):
        state_dict_from_jax(missing, tm)
    extra = {**params, "lm_head": {**params["lm_head"], "kernel": np.zeros((64, 512), np.float32)}}
    with pytest.raises(KeyError, match="lm_head"):
        state_dict_from_jax(extra, tm)
