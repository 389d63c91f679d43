"""Two numerics rules of the port held against the JAX package.

RMSNorm scales: JAX keeps every RMSNorm scale an fp32 parameter and returns
the fp32 product of the bf16-rounded normalised input and that scale; the
W8A8 projections quantize those fp32 rows, a bf16 Dense casts them once.
The tests give both packages N(1, 0.3) scales (the tiny inits have unit
scales, where the rounding of the scale cannot show) and bf16 models:
every layer-0 int8 K/V code equal; in the bf16 format logits and hidden
states within the bf16 tolerance of tests/test_torch_qwen.py (3e-2); in
the int8 format the logits within INT8_LOGIT_TOL; the vision tower within
1e-4 in fp32 and 3e-2 in bf16.

INT8_LOGIT_TOL (0.1, a few bf16 ulps at the tiny model's |logit| ~ 3): the
two packages round a bf16 SwiGLU differently (XLA rounds the sigmoid to
bf16 before the product, torch's SiLU rounds once), and an int8 code flips
wherever its bf16 input moves by one ulp: layer 1's K/V codes differ in
about half the elements with unit scales as with these, so the W8A8
logits carry int8 steps that bf16 logits do not.

Cache writes past Tmax: a chunk, and one token of a one-row batch, start at
min(pos, Tmax - n) (`dynamic_update_slice`); one token of a row of a larger
batch at or past Tmax is dropped (`.at[].set`). The port's plain int8
write and its bf16 write (`cache_write_slots` + `store_cache_rows_`, what
the attention calls) equal JAX's `_write_cache` / `_write_cache_chunk` bit
for bit.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.configs.trainer import ExpCfg as JExpCfg
from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.model.basemodel.internvla_n1 import qwen_vision as jqv
from internnav_tpu.trainer import base as jbase
from internnav_tpu_torch.configs.trainer import ExpCfg
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_vision as qv
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.ops import quant
from internnav_tpu_torch.ops.rope import get_rope_index_25
from internnav_tpu_torch.trainer import base as tbase

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
BF16_TOL = 3e-2
INT8_LOGIT_TOL = 0.1


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _with_norm_scales(params, seed):
    """The tree with every RMSNorm `scale` leaf drawn from N(1, 0.3), fp32."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.normal(1.0, 0.3, np.shape(v)).astype(np.float32) if k == "scale"
                 else np.asarray(v)) for k, v in tree.items()}

    return walk(params)


def _prompt(vocab, B=2, P=21, T=32, seed=1):
    """A bucketed prompt: P real tokens right-padded to T, pads in segment 1."""
    r = np.random.default_rng(seed)
    ids = r.integers(3, vocab - 10, (B, P))
    pos, _ = get_rope_index_25(ids, None)
    pad_pos = pos.max() + 1 + np.arange(T - P)
    pos = np.concatenate([pos, np.broadcast_to(pad_pos, (3, B, T - P))], axis=2)
    seg = np.zeros((B, T), np.int32)
    seg[:, P:] = 1
    emb = r.standard_normal((B, T, 64)).astype(np.float32)
    return emb, pos, seg, np.full((B,), P, np.int32)


@pytest.fixture(scope="module")
def scaled_text_params():
    cfg = qt.QwenTextConfig.tiny()
    jm = jqt.QwenTextModel(jqt.QwenTextConfig.tiny())
    B, T = 2, 16
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T))
    params = jax.jit(lambda i, p: jm.init(jax.random.PRNGKey(0), i, p, method=jm.init_all))(
        jnp.asarray(ids), jnp.asarray(pos))["params"]
    return _with_norm_scales(jax.tree_util.tree_map(np.asarray, params), seed=3)


def _bf16_pair(params, **fmt):
    jm = jqt.QwenTextModel(dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jnp.bfloat16,
                                               **fmt))
    tm = qt.QwenTextModel(dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.bfloat16,
                                              **fmt))
    if fmt.get("weight_dtype") == "int8":
        params = jqt.quantize_qwen_text_params(params)
    load_from_jax(tm, params)
    return jm, params, tm


def _prefill_both(jm, params, tm):
    emb, pos, seg, plen = _prompt(512)
    jl, jh, jc = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:2], segment_ids=a[2], return_cache=True, logits_indices=a[3]))(
        params, jnp.asarray(emb, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(seg),
        jnp.asarray(plen - 1))
    with torch.no_grad():
        tl, th, tc = tm(_t(emb).bfloat16(), _t(pos), segment_ids=_t(seg),
                        logits_indices=_t(plen - 1).long())
    return (tl, th, tc), (jl, jh, jc)


def test_norm_scales_stay_fp32_through_from_jax(scaled_text_params):
    """The text model's norms (every layer's two and the final one) and the
    vision tower's hold fp32 scales in a bf16 model, loaded unrounded."""
    _, params, tm = _bf16_pair(scaled_text_params)
    norms = {n: p for n, p in tm.named_parameters() if "norm" in n}
    assert len(norms) == 2 * tm.cfg.num_hidden_layers + 1
    assert all(p.dtype == torch.float32 for p in norms.values())
    want = np.asarray(params["layers_0"]["input_layernorm"]["scale"])
    np.testing.assert_array_equal(tm.layers[0].input_layernorm.weight.detach().numpy(), want)
    assert tm.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
    tower = qv.QwenVisionTower(qv.QwenVisionConfig.tiny())
    vnorms = [p for n, p in tower.named_parameters() if "norm" in n or "ln_q" in n]
    assert len(vnorms) == 2 * tower.cfg.depth + 1
    assert all(p.dtype == torch.float32 for p in vnorms)


def test_int8_bf16_model_layer0_codes_equal_jax_with_nonunit_scales(scaled_text_params):
    """W8A8 + int8 KV in bf16: the quantized fp32 norm rows give the same
    projections, so all 2,048 layer-0 K and V codes (B=2, T=32, 2 KV heads,
    D=16) equal JAX's (722 K and 668 V codes differ when the port holds
    the scales in bf16), their scales within 1e-4 (as in test_torch_qwen.py), and the
    logits agree within INT8_LOGIT_TOL."""
    jm, params, tm = _bf16_pair(scaled_text_params, weight_dtype="int8", kv_dtype="int8")
    (tl, th, tc), (jl, jh, jc) = _prefill_both(jm, params, tm)
    for (td, ts), (jd, js) in zip(tc[0], jc[0]):
        assert td.numel() == 2048
        assert int((td != _t(np.asarray(jd))).sum()) == 0
        _close(ts, js)  # XLA's CPU division by 127 may differ in the last bit
    assert th.dtype == torch.float32  # the final norm's fp32 product, as in JAX
    _close(tl, np.asarray(jl, np.float32), INT8_LOGIT_TOL, 0)


def test_bf16_model_matches_jax_with_nonunit_scales(scaled_text_params):
    """bf16 weights and cache: logits and hidden within 3e-2 of JAX, and the
    layer-0 K/V within one bf16 rounding."""
    jm, params, tm = _bf16_pair(scaled_text_params)
    (tl, th, tc), (jl, jh, jc) = _prefill_both(jm, params, tm)
    _close(tl, np.asarray(jl, np.float32), BF16_TOL, BF16_TOL)
    _close(th, np.asarray(jh, np.float32), BF16_TOL, BF16_TOL)
    for t, j in zip(tc[0], jc[0]):
        _close(t.float(), np.asarray(j, np.float32), BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", ATOL), ("bfloat16", BF16_TOL)])
def test_vision_tower_matches_jax_with_nonunit_scales(dtype, tol):
    """norm1, norm2 and merger_ln_q at N(1, 0.3) fp32 scales; ragged windows
    (the flash path) on an 84 px frame."""
    jcfg = dataclasses.replace(jqv.QwenVisionConfig.tiny(), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(qv.QwenVisionConfig.tiny(), dtype=getattr(torch, dtype))
    img = np.random.default_rng(3).standard_normal((1, 84, 84, 3)).astype(np.float32)
    patches, grid = qv.preprocess_images(img, tcfg)
    key = tuple(map(tuple, grid.tolist()))
    idx = qv.vision_indices((tcfg.patch_size, tcfg.spatial_merge_size, tcfg.window_size), key)
    cos, sin = qv.rotary_table(idx["pos_ids"], tcfg.hidden_size // tcfg.num_heads)
    arrays = (patches, cos, sin, idx["window_segments"], idx["full_segments"],
              idx["window_index"], idx["reverse_index"])
    kw = dict(window_block=idx["window_block"], full_block=idx["full_block"])
    jt = jqv.QwenVisionTower(jcfg)
    jargs = [jnp.asarray(a) for a in arrays]
    params = jax.jit(lambda *a: jt.init(jax.random.PRNGKey(1), *a, **kw)["params"])(*jargs)
    params = _with_norm_scales(jax.tree_util.tree_map(np.asarray, params), seed=4)
    ref = jax.jit(lambda p, *a: jt.apply({"params": p}, *a, **kw))(params, *jargs)
    tt = load_from_jax(qv.QwenVisionTower(tcfg), params)
    with torch.no_grad():
        out = tt(*[_t(a) for a in arrays], **kw)
    _close(out.float(), np.asarray(ref, np.float32), tol, tol)


class _MixedTree(torch.nn.Module):
    """bf16 kernels and embedding beside an fp32 RMSNorm scale, as in the
    bf16 model."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(6, 5, dtype=torch.bfloat16)
        self.norm = qt.RMSNorm(5)
        self.embed = torch.nn.Embedding(7, 5, dtype=torch.bfloat16)


def _mixed_trees(seed):
    r = np.random.default_rng(seed)
    return {"proj": {"kernel": jnp.asarray(r.standard_normal((6, 5)), jnp.bfloat16),
                     "bias": jnp.asarray(r.standard_normal(5), jnp.bfloat16)},
            "norm": {"scale": jnp.asarray(r.normal(1.0, 0.3, 5), jnp.float32)},
            "embed": {"embedding": jnp.asarray(r.standard_normal((7, 5)), jnp.bfloat16)}}


@pytest.mark.parametrize("state_dtype", [None, "bf16"])
def test_optimizer_trains_fp32_norm_scales_beside_bf16_leaves(state_dtype):
    """Three steps of the JAX chain and the port's on a mixed tree: the norm
    scale stays fp32 and within 1e-6 of JAX's (2e-5 with bf16 moments: the
    clip factor over bf16 gradients differs in its last bits, and a moment
    stored in bf16 can round one ulp apart, lr x 2^-9), the bf16 leaves
    within one bf16 rounding (3e-2 relative)."""
    exp = JExpCfg()
    exp.il.weight_decay, exp.il.lr, exp.il.warmup_ratio = 0.1, 1e-2, 0.25
    exp.il.opt_state_dtype = state_dtype
    tx = jbase.make_optimizer(exp, 4)
    jparams = _mixed_trees(0)
    jstate = tx.init(jparams)
    tm = load_from_jax(_MixedTree(), jax.tree_util.tree_map(np.asarray, jparams))
    opt = tbase.make_optimizer(ExpCfg.model_validate(exp.model_dump()), 4, tm)
    for step in range(3):
        grads = _mixed_trees(10 + step)
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        gsd = load_from_jax(_MixedTree(), jax.tree_util.tree_map(np.asarray, grads)).state_dict()
        for n, p in tm.named_parameters():
            p.grad = gsd[n].clone()
        opt.step()
    want = load_from_jax(_MixedTree(), jax.tree_util.tree_map(np.asarray, jparams)).state_dict()
    assert tm.norm.weight.dtype == torch.float32 and jparams["norm"]["scale"].dtype == jnp.float32
    tol = 2e-5 if state_dtype == "bf16" else 1e-6
    _close(tm.norm.weight.detach(), want["norm.weight"], atol=tol, rtol=tol)
    for n in ("proj.weight", "proj.bias", "embed.weight"):
        assert dict(tm.named_parameters())[n].dtype == torch.bfloat16
        _close(dict(tm.named_parameters())[n].detach().float(), want[n].float(),
               BF16_TOL, BF16_TOL)


# ----------------------------------------------------- cache writes past Tmax
TMAX, KV, D = 12, 2, 16
WRITES = [  # (B, n, positions)
    (1, 1, (TMAX - 1,)), (1, 1, (TMAX,)), (1, 1, (TMAX + 5,)),
    (3, 1, (2, TMAX, TMAX + 3)), (2, 1, (TMAX - 1, TMAX)),
    (1, 4, (TMAX - 2,)), (1, 4, (TMAX + 7,)), (2, 4, (TMAX - 1, 3)), (3, 4, (TMAX, 0, 9)),
]


def _jax_write(cache, new, pos):
    """JAX's write of new (B, n, KV, D) at pos: `_write_cache` for one
    token, `_write_cache_chunk` for a chunk (as QwenAttention calls them)."""
    if new.shape[1] == 1:
        return jqt._write_cache(cache, new[:, 0], pos)
    return jqt._write_cache_chunk(cache, new, pos)


@pytest.mark.parametrize("B,n,positions", WRITES)
def test_int8_cache_write_past_tmax_matches_jax(B, n, positions):
    rng = np.random.default_rng(B * 10 + n)
    new = rng.standard_normal((B, n, KV, D)).astype(np.float32) * 2
    data = rng.integers(-127, 128, (B, TMAX, KV, D)).astype(np.int8)
    scale = rng.uniform(1e-3, 0.05, (B, TMAX, KV, 1)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    jd, js = _jax_write((jnp.asarray(data), jnp.asarray(scale)), jnp.asarray(new),
                        jnp.asarray(pos))
    k_entry = (_t(data), _t(scale))
    v_entry = (_t(data).clone(), _t(scale).clone())
    quant.write_kv_cache_reference(_t(new), _t(new), k_entry, v_entry, _t(pos).long())
    for d_, s_ in (k_entry, v_entry):
        np.testing.assert_array_equal(d_.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(s_.numpy(), np.asarray(js))


@pytest.mark.parametrize("B,n,positions", WRITES)
def test_bf16_cache_write_past_tmax_matches_jax(B, n, positions):
    rng = np.random.default_rng(B * 10 + n + 1)
    new = _t(rng.standard_normal((B, n, KV, D)).astype(np.float32)).bfloat16()
    cache = _t(rng.standard_normal((B, TMAX, KV, D)).astype(np.float32)).bfloat16()
    pos = np.asarray(positions, np.int32)
    want = _jax_write(jnp.asarray(cache.float().numpy(), jnp.bfloat16),
                      jnp.asarray(new.float().numpy(), jnp.bfloat16), jnp.asarray(pos))
    quant.store_cache_rows_(cache, new, *quant.cache_write_slots(_t(pos), n, TMAX))
    np.testing.assert_array_equal(cache.float().numpy(), np.asarray(want, np.float32))


def test_cache_write_rule():
    """The slots themselves: clamped starts, dropped rows."""
    cols, keep = quant.cache_write_slots(torch.tensor([TMAX + 3]), 4, TMAX)
    assert cols.tolist() == [[TMAX - 4, TMAX - 3, TMAX - 2, TMAX - 1]] and keep.all()
    cols, keep = quant.cache_write_slots(torch.tensor([1, TMAX, TMAX + 9]), 1, TMAX)
    assert cols.tolist() == [[1], [TMAX - 1], [TMAX - 1]]
    assert keep[:, 0].tolist() == [True, False, False]
    with pytest.raises(ValueError, match="does not fit"):
        quant.cache_write_slots(torch.tensor([0]), TMAX + 1, TMAX)
