"""K6b's decode plan and the W8A8 products of several projections of one
input, checked on the CPU (the kernel runs only on the card, where
`test_torch_kernels_cuda.py` checks its results).

- `gemm_decode_plan` (hypothesis): the blocks cover every (column, 64-wide
  k-chunk) of every projection exactly once, split K only at whole scale
  groups, and give no SM more than one tile's bytes above the mean; the
  draws are derandomized, so every run checks the same plans, with F16's
  three ragged-width inputs among them.
- `w8a8_linear_reference` equals JAX's `QuantDense` at odd N (F15),
  per-channel and grouped g=128, at rtol 1e-5 in fp32 (the same integer
  product; the grouped sum over groups in another order).
- `project()` hands all its `QuantLinear`s one call, which on the CPU
  equals the per-module products bit for bit and launches nothing.
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.ops import quant


def _covers_once(plan, widths, K) -> bool:
    """The blocks' (columns, k) rectangles tile every projection's (N, K)
    exactly: per segment, the column tiles run 0..N edge to edge and each
    tile's k slices run 0..K edge to edge, in 64-wide chunks."""
    slices = {}
    for _, seg, c0, c1, k0, k1 in plan.units():
        if k0 % 64 or (k1 % 64 and k1 != K):
            return False
        slices.setdefault(seg, {}).setdefault((c0, c1), []).append((k0, k1))
    if sorted(slices) != list(range(len(widths))):
        return False
    for seg, tiles in slices.items():
        edges = sorted(tiles)
        if [c0 for c0, _ in edges] != [0] + [c1 for _, c1 in edges[:-1]] \
                or edges[-1][1] != widths[seg]:
            return False
        for ks in tiles.values():
            ks = sorted(k for k in ks if k[0] < k[1])
            if [k0 for k0, _ in ks] != [0] + [k1 for _, k1 in ks[:-1]] or ks[-1][1] != K:
                return False
    return True


@settings(max_examples=150, deadline=None, derandomize=True)
@example(widths=[7950, 17026, 330], K=512, group=64, rows=5)
@example(widths=[524, 16613, 16647], K=12288, group=256, rows=6)
@example(widths=[15169, 7917, 2252], K=16576, group=0, rows=5)
@given(widths=st.lists(st.integers(1, 20000), min_size=1, max_size=3),
       K=st.integers(1, 300).map(lambda k: 64 * k),
       group=st.sampled_from([0, 64, 128, 192, 256]),
       rows=st.integers(1, quant.GEMM_DECODE_MAX_M))
def test_decode_plan_covers_every_chunk_once_and_balances_the_sms(widths, K, group, rows):
    if group and K % group:
        group = 0
    plan = quant.gemm_decode_plan(tuple(widths), K, group, rows)
    assert 1 <= plan.split <= quant.GEMM_DECODE_MAX_SPLIT
    assert 1 <= plan.stages <= quant.GEMM_DECODE_MAX_STAGES
    assert plan.block_n == quant.GEMM_DECODE_BLOCK_N
    assert plan.grid == (plan.tiles * plan.split if plan.split > 1
                         else min(plan.tiles, plan.resident_blocks(rows)))
    assert _covers_once(plan, widths, K)
    for _, _, _, _, k0, k1 in plan.units():  # slices end at whole scale groups
        assert k0 % (group or 64) == 0 and (k1 == K or k1 % (group or 64) == 0)
    biggest = max((c1 - c0) * (k1 - k0) for _, _, c0, c1, k0, k1 in plan.units())
    load = plan.sm_bytes()
    assert max(load) - sum(load) / len(load) <= biggest
    assert sum(load) == sum(widths) * K


def test_decode_plans_at_the_7b_shapes():
    """One token: q/k/v and o split K 7 ways (one cluster of 7 a 64-column
    tile), down 4 ways; gate/up and the lm_head stream whole K through
    persistent blocks that fill the card."""
    plans = {name: quant.gemm_decode_plan(widths, K, 0, 1) for name, widths, K in (
        ("qkv", (3584, 512, 512), 3584), ("o", (3584,), 3584),
        ("gate_up", (18944, 18944), 3584), ("down", (3584,), 18944),
        ("lm_head", (152064,), 3584))}
    assert {k: (p.split, p.grid) for k, p in plans.items()} == {
        "qkv": (7, 504), "o": (7, 392), "gate_up": (1, 396), "down": (4, 224),
        "lm_head": (1, 396)}


def test_decode_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="1 to 3 projections"):
        quant.gemm_decode_plan((64,) * 4, 128)
    with pytest.raises(ValueError, match="multiples of 64"):
        quant.gemm_decode_plan((64,), 96)


@pytest.mark.parametrize("N", [63, 65])
@pytest.mark.parametrize("group", [None, 128])
def test_w8a8_reference_matches_quant_dense_at_odd_n(N, group):
    K, M = 256, 5
    r = np.random.default_rng(N + (group or 0))
    G = K // group if group else None
    params = {"kernel_q": r.integers(-127, 128, (K, N)).astype(np.int8),
              "scale_q": r.uniform(1e-3, 2e-2, (G, N) if G else (N,)).astype(np.float32),
              "bias": r.standard_normal(N).astype(np.float32)}
    x = (r.standard_normal((M, K)) * r.uniform(0.1, 8.0, (M, 1))).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).bfloat16().float())
    jd = jqt.QuantDense(N, use_bias=True, dtype=jnp.float32, group_size=group)
    want = np.asarray(jd.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                               jnp.asarray(x)))
    xq, a = quant.quantize_rows(torch.from_numpy(x))
    w = torch.from_numpy(params["kernel_q"].T.copy())
    got = quant.w8a8_linear_reference(xq, a, w, torch.from_numpy(params["scale_q"]),
                                      torch.from_numpy(params["bias"]), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("x_kind", ["rows", "quantized"])
def test_project_sends_every_projection_in_one_call(monkeypatch, group, x_kind):
    """q/k/v of the tiny int8 model's first layer: one `w8a8_linear_multi`
    call with three segments, equal bit for bit to each module alone, and
    no kernel launch on the CPU."""
    cfg = qt.QwenTextConfig.tiny()
    attn = qt.QwenAttention(qt.dataclasses.replace(cfg, weight_dtype="int8",
                                                   quant_group_size=group,
                                                   dtype=torch.float32))
    g = torch.Generator().manual_seed(0)
    for mod in (attn.q_proj, attn.k_proj, attn.v_proj):
        mod.weight_q = torch.randint(-127, 128, mod.weight_q.shape, generator=g,
                                     dtype=torch.int8)
        mod.scale_q = torch.rand(mod.scale_q.shape, generator=g) * 1e-2
        mod.bias = torch.randn(mod.bias.shape, generator=g)
    x = torch.randn((2, 3, cfg.hidden_size), generator=g)
    if x_kind == "quantized":
        x = qt.QuantizedRows(*quant.quantize_activations(x))
    calls = []
    multi = quant.w8a8_linear_multi
    monkeypatch.setattr(qt, "w8a8_linear_multi",
                        lambda *a, **k: calls.append(len(a[2])) or multi(*a, **k))
    before = (quant.w8a8_launches, quant.w8a8_fused_launches, quant.quantize_rows_launches)
    with torch.no_grad():
        q, k, v = qt.project(x, attn.q_proj, attn.k_proj, attn.v_proj)
        alone = [qt.project(x, m)[0] for m in (attn.q_proj, attn.k_proj, attn.v_proj)]
    assert calls == [3, 1, 1, 1]
    assert before == (quant.w8a8_launches, quant.w8a8_fused_launches,
                      quant.quantize_rows_launches)
    for y, z, m in zip((q, k, v), alone, (attn.q_proj, attn.k_proj, attn.v_proj)):
        assert y.shape == (2, 3, m.out_features) and y.dtype == torch.float32
        assert torch.equal(y, z)
    xq = x if x_kind == "quantized" else qt.QuantizedRows(*quant.quantize_rows(x))
    want = quant.w8a8_linear_reference(xq.q.reshape(-1, cfg.hidden_size),
                                       xq.scale.reshape(-1, 1), attn.k_proj.weight_q,
                                       attn.k_proj.scale_q, attn.k_proj.bias,
                                       out_dtype=torch.float32)
    assert torch.equal(k.reshape(-1, k.shape[-1]), want)


def test_from_jax_loads_quant_linear_unchanged():
    """The fused call needs no new weight layout: `QuantLinear` keeps its
    (N, K) `weight_q`, `scale_q` and `bias`, loaded from `QuantDense`'s
    params as before."""
    r = np.random.default_rng(7)
    params = {"kernel_q": r.integers(-127, 128, (128, 65)).astype(np.int8),
              "scale_q": r.uniform(1e-3, 2e-2, (65,)).astype(np.float32),
              "bias": r.standard_normal(65).astype(np.float32)}
    lin = qt.QuantLinear(128, 65, True, None, dtype=torch.float32)
    load_from_jax(lin, params)
    np.testing.assert_array_equal(lin.weight_q.numpy(), params["kernel_q"].T)
    assert lin.weight_q.is_contiguous() and tuple(lin.scale_q.shape) == (65,)


GEOMETRIES = {"K9": quant.K9_GEOMETRY, "K10_int8": quant.K10_GEOMETRY[8],
              "K10_int4": quant.K10_GEOMETRY[4]}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@settings(max_examples=100, deadline=None, derandomize=True)
@example(widths=[7950, 17026, 330], K=512, group=64, rows=5)
@example(widths=[524, 16613, 16647], K=12288, group=256, rows=6)
@example(widths=[15169, 7917, 2252], K=16576, group=0, rows=5)
@example(widths=[3584, 512, 512], K=3584, group=128, rows=1)
@example(widths=[18944, 18944], K=3584, group=128, rows=48)
@example(widths=[3584], K=18944, group=128, rows=192)
@given(widths=st.lists(st.integers(1, 20000), min_size=1, max_size=3),
       K=st.integers(1, 300).map(lambda k: 64 * k),
       group=st.sampled_from([0, 64, 128, 192, 256]),
       rows=st.integers(1, quant.W8A16_MAX_M))
def test_k9_k10_decode_plans_cover_every_line_once_and_balance_the_sms(geometry, widths, K,
                                                                       group, rows):
    """K9's and K10's ring geometry (256 k a line for int4 codes, bf16 rows
    for K10, up to 192 rows): every (column, k) once, K slices at whole
    lines and whole scale groups, no SM more than one block's weight bytes
    above the mean, a block's shared memory within the card's, rings no
    deeper and blocks an SM no more than the geometry gives those rows, and
    only whole-K plans above GEMM_SPLIT_MAX_M rows."""
    geo = GEOMETRIES[geometry]
    rows = min(rows, geo.max_rows)
    if group and K % group:
        group = 0
    plan = quant.gemm_decode_plan(tuple(widths), K, group, rows, geo)
    assert plan.geometry == geo and plan.block_n == quant.GEMM_DECODE_BLOCK_N
    assert 1 <= plan.split <= (quant.GEMM_DECODE_MAX_SPLIT if rows <= quant.GEMM_SPLIT_MAX_M
                               else 1)
    assert 1 <= plan.stages <= geo.deepest_ring(rows) <= geo.max_stages
    assert plan.smem_bytes(rows) <= quant.GEMM_BLOCK_SMEM
    if geo.register_blocks(rows):  # the launch bounds' blocks an SM, at most
        assert plan.resident_blocks(rows) <= geo.register_blocks(rows) * quant.GEMM_SMS
    assert plan.grid == (plan.tiles * plan.split if plan.split > 1
                         else min(plan.tiles, plan.resident_blocks(rows)))
    assert _covers_once(plan, widths, K)
    for _, _, _, _, k0, k1 in plan.units():  # whole lines, whole scale groups
        assert k0 % geo.line_k == 0 and (k1 == K or k1 % geo.line_k == 0)
        assert k0 % (group or 64) == 0 and (k1 == K or k1 % (group or 64) == 0)
    biggest = max(plan.unit_bytes(c0, c1, k0, k1) for _, _, c0, c1, k0, k1 in plan.units())
    load = plan.sm_bytes()
    assert max(load) - sum(load) / len(load) <= biggest
    assert sum(load) == sum(widths) * K * geo.wbits // 8


def test_k9_k10_plans_at_the_7b_shapes():
    """One token: K9 (grouped-128 int4, 256 k a line) and K10 split q/k/v 5
    ways, o 7 ways and down 8 ways over clusters, and stream gate/up's 592
    column tiles whole-K, each ring at most 3 stages deep. The shared
    decode's 48 rows split q/k/v, o and down 2 ways (rank 0 holds 2 x 48 x
    64 partials) and stream gate/up over 264 persistent blocks, two an SM
    (the registers of the 17-64 row layout), every ring 2 stages deep."""
    layer = (("qkv", (3584, 512, 512), 3584), ("o", (3584,), 3584),
             ("gate_up", (18944, 18944), 3584), ("down", (3584,), 18944))

    def plans(geo, rows, group):
        return {name: (p.split, p.grid) for name, widths, K in layer
                for p in [quant.gemm_decode_plan(widths, K, group, rows, geo)]}

    one = {"qkv": (5, 360), "o": (7, 392), "gate_up": (1, 592), "down": (8, 448)}
    assert plans(quant.K9_GEOMETRY, 1, 128) == one
    assert plans(quant.K10_GEOMETRY[4], 1, 128) == one
    assert plans(quant.K10_GEOMETRY[8], 48, 0) == {"qkv": (2, 144), "o": (2, 112),
                                                   "gate_up": (1, 264), "down": (2, 112)}
    assert all(quant.gemm_decode_plan(w, K, 0, 48, quant.K10_GEOMETRY[8]).stages == 2
               for _, w, K in layer)
    assert all(quant.gemm_decode_plan(w, K, 128, 1, quant.K9_GEOMETRY).stages <= 3
               for _, w, K in layer)
    with pytest.raises(ValueError, match="1 to 64 rows"):
        quant.gemm_decode_plan((64,), 128, 0, 65, quant.K9_GEOMETRY)
