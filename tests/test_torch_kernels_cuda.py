"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: each test skips without a CUDA device. On a machine with one
(no jax needed there):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances: o within atol/rtol 2e-2 (bf16 output, P rounded to bf16 for
the P.V product); lse within 1e-3 (fp32 statistics from the same bf16
inputs), -inf on exactly the rows the plain version marks fully masked;
dq/dk/dv (K2, K3) within atol 1% of the plain backward's largest entry
(at least 1e-2: a one-token row's exact gradient is 0, the kernel's a
rounding residue) plus rtol 2% (bf16 outputs, P and dS rounded to bf16 as
tensor-core operands and summed over up to T terms).
"""

import pytest
import torch

from internnav_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
O_TOL = 2e-2
LSE_TOL = 1e-3
BWD_ATOL_FRAC = 1e-2
BWD_RTOL = 2e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(device, *shape, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)


def _walked_tiles(q, k, seg, kv_seg, causal):
    """Key tiles K1 must walk, summed over its blocks: the CPU count of live
    (128-query block, 64-key tile) pairs times the heads."""
    B, H, Tq = q.shape[:3]
    pairs = fa.live_tile_pairs(Tq, k.shape[2], causal=causal,
                               segment_ids=None if seg is None else seg.cpu(),
                               kv_segment_ids=None if kv_seg is None else kv_seg.cpu(),
                               query_block=fa.FWD_QUERY_BLOCK)
    return pairs * H * (B if seg is None else 1)


def _check(q, k, v, seg=None, kv_seg=None, causal=False, tile_tables=None):
    """K1 against the plain version; the kernel walks exactly the live key
    tiles the CPU rule counts."""
    before = fa.kernel_launches
    walked = torch.zeros(1, dtype=torch.int32, device=q.device)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg,
                                     kv_segment_ids=kv_seg, tile_tables=tile_tables,
                                     tile_counter=walked)
    assert fa.kernel_launches == before + 1
    assert int(walked) == _walked_tiles(q, k, seg, kv_seg, causal)
    ref_o, ref_lse = fa.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                                      segment_ids=seg, kv_segment_ids=kv_seg, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ref_o, atol=O_TOL, rtol=O_TOL)
    finite = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=LSE_TOL, rtol=0)
    return o, lse


@pytest.mark.parametrize("T", [2112, 329, 64, 1])
def test_text_prefill_gqa_causal_with_pad_segment(device, T):
    seg = torch.zeros((1, T), dtype=torch.int32, device=device)
    seg[:, max(T - 23, 0):] = 1
    _check(_rand(device, 1, 28, T, 128), _rand(device, 1, 4, T, 128, seed=1),
           _rand(device, 1, 4, T, 128, seed=2), seg, causal=True)


@pytest.mark.parametrize("H", [4, 3])
@pytest.mark.parametrize("T", [1088, 329])
def test_text_prefill_on_a_tp8_ranks_local_heads(device, H, T):
    """Serving at tp = 8 on the 7B decoder: a rank holds one KV head and 4
    (even ranks) or 3 (odd ranks) of its query heads."""
    seg = torch.zeros((1, T), dtype=torch.int32, device=device)
    seg[:, T - 23:] = 1
    _check(_rand(device, 1, H, T, 128), _rand(device, 1, 1, T, 128, seed=1),
           _rand(device, 1, 1, T, 128, seed=2), seg, causal=True)


@pytest.mark.parametrize("S", [900, 257])
def test_vision_head_dim_80_windows(device, S):
    seg = (torch.arange(S, device=device) // 64).to(torch.int32)[None]
    _check(_rand(device, 1, 16, S, 80), _rand(device, 1, 16, S, 80, seed=1),
           _rand(device, 1, 16, S, 80, seed=2), seg)


def test_batched_cross_lengths_and_fully_masked_rows(device):
    B, H, Tq, Tk = 2, 4, 100, 150
    qseg = torch.zeros((B, Tq), dtype=torch.int32, device=device)
    qseg[:, 90:] = 7  # no key has segment 7: o = 0, lse = -inf
    kseg = torch.zeros((B, Tk), dtype=torch.int32, device=device)
    kseg[1, 120:] = 3
    o, lse = _check(_rand(device, B, H, Tq, 128), _rand(device, B, 2, Tk, 128, seed=1),
                    _rand(device, B, 2, Tk, 128, seed=2), qseg, kseg)
    assert torch.all(o[:, :, 90:] == 0) and torch.all(torch.isneginf(lse[:, :, 90:]))


def _seg(device, rows):
    return torch.as_tensor(rows, dtype=torch.int32, device=device)


def _check_gqa(device, seg, kv_seg=None, causal=True, H=8, KV=2, D=128, Tk=None):
    B, T = seg.shape
    Tk = Tk or T
    return _check(_rand(device, B, H, T, D), _rand(device, B, KV, Tk, D, seed=1),
                  _rand(device, B, KV, Tk, D, seed=2), seg, kv_seg, causal=causal)


def test_forward_tile_mixing_a_sample_with_pads(device):
    """One tile holds the end of the last sample and the -1 pads after it."""
    T = 640
    row = [t // 150 for t in range(T)]
    row[T - 30:] = [-1] * 30
    _check_gqa(device, _seg(device, [row]))


def test_forward_interleaved_segments(device):
    """Ids (t // 7) % 3: every tile holds all three segments, none is skipped."""
    T = 700
    _check_gqa(device, _seg(device, [[(t // 7) % 3 for t in range(T)]]))


def test_forward_several_negative_ids(device):
    T = 500
    row = [(t // 40) % 4 - 2 for t in range(T)]  # ids -2, -1, 0, 1 in runs of 40
    row[100:130] = [-5] * 30
    _check_gqa(device, _seg(device, [row]), causal=False)
    _check_gqa(device, _seg(device, [row]), causal=True)


def test_forward_batch_rows_with_different_layouts(device):
    T = 333
    rows = [[t // 100 for t in range(T)], [(t // 7) % 3 for t in range(T)]]
    rows[0][T - 20:] = [-1] * 20
    _check_gqa(device, _seg(device, rows))


def test_forward_query_block_without_live_key_tile(device):
    """Queries 128-255 (the second 128-row block) carry a segment no key
    has: that block walks no tile, its o is exactly 0 and its lse -inf;
    the tables passed in give the same output as those computed inside."""
    T = 320
    qseg = _seg(device, [[0] * 128 + [5] * 128 + [2] * 64])
    kseg = _seg(device, [[0] * 128 + [1] * 128 + [2] * 64])
    assert not fa.live_tile_mask(T, T, causal=False, segment_ids=qseg.cpu(),
                                 kv_segment_ids=kseg.cpu(), query_block=128)[0, 1].any()
    q, k, v = (_rand(device, 1, h, T, 128, seed=s) for s, h in ((0, 4), (1, 2), (2, 2)))
    o, lse = _check(q, k, v, qseg, kseg)
    assert torch.all(o[:, :, 128:256] == 0) and torch.all(torch.isneginf(lse[:, :, 128:256]))
    tabs = (fa.tile_segment_ranges(qseg), fa.tile_segment_ranges(kseg))
    o2, lse2 = _check(q, k, v, qseg, kseg, tile_tables=tabs)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_forward_explicit_tables_equal_computed_ones(device):
    T = 1000
    seg = _seg(device, [[t // 230 for t in range(T - 40)] + [-1] * 40])
    q, k, v = (_rand(device, 1, h, T, 128, seed=s) for s, h in ((0, 28), (1, 4), (2, 4)))
    want = _check(q, k, v, seg, causal=True)
    got = _check(q, k, v, seg, causal=True, tile_tables=fa.segment_tile_tables(seg))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_forward_dense_causal_ragged(device):
    """No segment ids: only the causal rule skips, T ragged."""
    T = 1000
    _check(_rand(device, 1, 28, T, 128), _rand(device, 1, 4, T, 128, seed=1),
           _rand(device, 1, 4, T, 128, seed=2), causal=True)


@pytest.mark.parametrize("segmented", [False, True])
def test_forward_non_causal_cross_lengths(device, segmented):
    Tq, Tk = 200, 333
    q, k, v = _rand(device, 2, 8, Tq, 128), _rand(device, 2, 2, Tk, 128, seed=1), \
        _rand(device, 2, 2, Tk, 128, seed=2)
    if not segmented:
        _check(q, k, v)
        return
    qseg = _seg(device, [[t // 70 for t in range(Tq)], [t % 2 for t in range(Tq)]])
    kseg = _seg(device, [[t // 120 for t in range(Tk)], [(t // 64) % 2 for t in range(Tk)]])
    _check(q, k, v, qseg, kseg)


@pytest.mark.parametrize("S", [900, 257])
def test_vision_head_dim_80_real_windows(device, S):
    """The tower's own window segments (30 x 30 grid at S=900, ragged
    windows of 37 tokens at S=257), 16 heads of D=80, non-causal."""
    if S == 900:
        from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_vision import vision_indices

        win = vision_indices((14, 2, 112), ((1, 30, 30),))["window_segments"]
        seg = torch.as_tensor(win, dtype=torch.int32, device=device)[None]
    else:
        seg = (torch.arange(S, device=device) // 37).to(torch.int32)[None]
    _check(_rand(device, 1, 16, S, 80), _rand(device, 1, 16, S, 80, seed=1),
           _rand(device, 1, 16, S, 80, seed=2), seg)


def test_dispatcher_launches_the_kernel_on_cuda(device):
    q = _rand(device, 1, 2, 64, 80)
    before = fa.kernel_launches
    out = fa.flash_attention(q, q, q, causal=True)
    assert fa.kernel_launches == before + 1 and out.dtype == torch.bfloat16


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    q = _rand(device, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, q, q)
    q = _rand(device, 1, 2, 64, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_cuda(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(2, 3), q, q)
    seg = torch.zeros((1, 64), dtype=torch.int32, device=device)
    tabs = fa.segment_tile_tables(seg)
    for bad in ((tabs[0].long(), tabs[1]), (tabs[0].cpu(), tabs[1]),
                (torch.zeros((1, 2, 4), dtype=torch.int32, device=device), tabs[1])):
        with pytest.raises(ValueError, match="tile tables"):
            fa.flash_attention_cuda(q, q, q, segment_ids=seg, tile_tables=bad)


def _check_bwd(q, k, v, seg=None, kv_seg=None, causal=False, seed=3):
    o, lse = _check(q, k, v, seg, kv_seg, causal)
    do = _rand(q.device, *q.shape, seed=seed)
    di = (o.float() * do.float()).sum(-1)
    before = (fa.bwd_dkv_launches, fa.bwd_dq_launches)
    kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, di, **kw)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, di, **kw)
    assert (fa.bwd_dkv_launches, fa.bwd_dq_launches) == (before[0] + 1, before[1] + 1)
    assert dk.shape == k.shape and dv.shape == v.shape and dq.shape == q.shape
    want = fa.flash_backward_reference(q, k, v, seg, kv_seg, o, lse, do, causal)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        ref = ref.float()
        torch.testing.assert_close(got.float(), ref, rtol=BWD_RTOL,
                                   atol=BWD_ATOL_FRAC * max(ref.abs().max().item(), 1.0))
    return dq, dk, dv


@pytest.mark.parametrize("T", [2048, 1000, 64, 1])
def test_backward_packed_causal_gqa(device, T):
    """The training head shape: 28 heads over 4 KV heads, packed segments
    with a pad segment -1 at the end; 1000 and 1 are ragged."""
    seg = torch.zeros((1, T), dtype=torch.int32, device=device)
    seg[:, T // 3:] = 1
    seg[:, T // 2:] = 2
    seg[:, max(T - 37, 0):] = -1
    _check_bwd(_rand(device, 1, 28, T, 128), _rand(device, 1, 4, T, 128, seed=1),
               _rand(device, 1, 4, T, 128, seed=2), seg, seg, causal=True)


def test_backward_head_dim_80_windows(device):
    S = 900
    seg = (torch.arange(S, device=device) // 64).to(torch.int32)[None]
    _check_bwd(_rand(device, 1, 16, S, 80), _rand(device, 1, 16, S, 80, seed=1),
               _rand(device, 1, 16, S, 80, seed=2), seg, seg)


def test_backward_cross_lengths_and_fully_masked_rows(device):
    B, H, Tq, Tk = 2, 4, 100, 150
    qseg = torch.zeros((B, Tq), dtype=torch.int32, device=device)
    qseg[:, 90:] = 7  # no key has segment 7: their dq is 0
    kseg = torch.zeros((B, Tk), dtype=torch.int32, device=device)
    kseg[1, 120:] = 3  # keys no query sees: their dk, dv are 0
    dq, dk, dv = _check_bwd(_rand(device, B, H, Tq, 128), _rand(device, B, 2, Tk, 128, seed=1),
                            _rand(device, B, 2, Tk, 128, seed=2), qseg, kseg)
    assert torch.all(dq[:, :, 90:] == 0)
    assert torch.all(dk[1, :, 120:] == 0) and torch.all(dv[1, :, 120:] == 0)


def _check_bwd_gqa(device, seg, causal=True, H=8, KV=2, D=128):
    B, T = seg.shape
    return _check_bwd(_rand(device, B, H, T, D), _rand(device, B, KV, T, D, seed=1),
                      _rand(device, B, KV, T, D, seed=2), seg, seg, causal=causal)


def test_backward_interleaved_segments(device):
    """Ids (t // 7) % 3: every tile holds all three segments, none is skipped."""
    T = 700
    _check_bwd_gqa(device, _seg(device, [[(t // 7) % 3 for t in range(T)]]))


def test_backward_tile_mixing_a_sample_with_pads(device):
    """One tile holds the end of the last sample and the -1 pads after it."""
    T = 640
    row = [t // 150 for t in range(T)]
    row[T - 30:] = [-1] * 30
    _check_bwd_gqa(device, _seg(device, [row]))


def test_backward_several_negative_ids(device):
    T = 500
    row = [(t // 40) % 4 - 2 for t in range(T)]  # ids -2, -1, 0, 1 in runs of 40
    row[100:130] = [-5] * 30
    _check_bwd_gqa(device, _seg(device, [row]), causal=False)


def test_backward_batch_rows_with_different_layouts(device):
    T = 333
    rows = [[t // 100 for t in range(T)], [(t // 7) % 3 for t in range(T)]]
    rows[0][T - 20:] = [-1] * 20
    _check_bwd_gqa(device, _seg(device, rows))


def test_backward_dense_causal(device):
    """No segment ids: only the causal rule skips, T ragged."""
    T = 1000
    _check_bwd(_rand(device, 1, 28, T, 128), _rand(device, 1, 4, T, 128, seed=1),
               _rand(device, 1, 4, T, 128, seed=2), causal=True)


def test_backward_key_tile_without_live_query_tile(device):
    """Keys 128-191 form a segment no query carries: their KV tile has no
    live query tile, K2 walks nothing for it and its dK, dV are exactly 0;
    the tile tables passed in give the same gradients as computed inside."""
    T = 320
    qseg = _seg(device, [[0] * 128 + [1] * 64 + [2] * 128])
    kseg = _seg(device, [[0] * 128 + [5] * 64 + [2] * 128])
    tabs = (fa.tile_segment_ranges(qseg), fa.tile_segment_ranges(kseg))
    assert not fa.live_tile_mask(T, T, causal=False, segment_ids=qseg,
                                 kv_segment_ids=kseg)[0, :, 2].any()
    q, k, v = (_rand(device, 1, h, T, 128, seed=s) for s, h in ((0, 4), (1, 2), (2, 2)))
    dq, dk, dv = _check_bwd(q, k, v, qseg, kseg)
    assert torch.all(dk[:, :, 128:192] == 0) and torch.all(dv[:, :, 128:192] == 0)
    o, lse = fa.flash_attention_cuda(q, k, v, segment_ids=qseg, kv_segment_ids=kseg)
    do = _rand(device, *q.shape, seed=3)
    di = (o.float() * do.float()).sum(-1)
    kw = dict(segment_ids=qseg, kv_segment_ids=kseg, tile_tables=tabs)
    assert torch.equal(fa.flash_bwd_dq_cuda(q, k, v, do, lse, di, **kw), dq)
    assert all(torch.equal(a, b) for a, b in zip(fa.flash_bwd_dkv_cuda(q, k, v, do, lse, di, **kw),
                                                 (dk, dv)))


def test_autograd_function_runs_the_three_kernels(device):
    """flash_attention on CUDA tensors: forward K1, backward K2 + K3, with
    the gradients of the plain version's autograd."""
    T = 200
    seg = torch.zeros((1, T), dtype=torch.int32, device=device)
    seg[:, 120:] = 1
    q, k, v = (_rand(device, 1, h, T, 128, seed=s).requires_grad_()
               for s, h in ((0, 8), (1, 2), (2, 2)))
    do = _rand(device, 1, 8, T, 128, seed=3)
    before = (fa.kernel_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
    o = fa.flash_attention(q, k, v, causal=True, segment_ids=seg)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert (fa.kernel_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches) == tuple(
        b + 1 for b in before)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref = fa.mha_reference(qf, kf, vf, causal=True, segment_ids=seg)
    want = torch.autograd.grad(ref, (qf, kf, vf), do.float())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=BWD_RTOL,
                                   atol=BWD_ATOL_FRAC * max(w.abs().max().item(), 1.0))


def test_backward_wrappers_reject_what_the_kernels_do_not_take(device):
    q = _rand(device, 1, 2, 64, 128)
    o, lse = fa.flash_attention_cuda(q, q, q)
    di = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_bwd_dkv_cuda(q, q, q, q.float(), lse, di)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_bwd_dq_cuda(q, q, q, q, lse[:, :, :10].contiguous(), di)


# ---------------------------------------------------------- int8 kernels
# K6a's PLAIN and SWIGLU prologues and K7 bitwise (same IEEE divisions,
# expf/rsqrtf and round-half-even as the plain versions); K6a's RMSNORM
# prologue with codes within +-1 and scales within 2^-7 (its sum of squares
# runs in another order than ATen's mean); K6b per-channel within one bf16
# ulp (exact int32 sums and the same fp32 epilogue order), grouped at atol =
# rtol = 1e-2 (the sum over groups in another order); K4/K5 at atol = rtol
# = 2e-2, as K1.
W8A8_7B = [(3584, 3584, True), (512, 3584, True), (18944, 3584, False), (3584, 18944, False)]


def _int8_weight(device, N, K, seed, group=None):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(-127, 128, (N, K), generator=g, device=device, dtype=torch.int8)
    shape = (K // group, N) if group else (N,)
    s = torch.rand(shape, generator=g, device=device) * 1e-3 + 1e-4
    return w, s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", [(1, 64), (3, 200), (1, 3584), (4, 3584), (1, 18944),
                                 (329, 3584), (1100, 18944)])
def test_quantize_rows_kernel_is_bitwise(device, M, K, dtype):
    """bf16 rows (attention output, SwiGLU product) and fp32 rows (the
    RMSNorm products)."""
    from internnav_tpu_torch.ops import quant

    x = (_rand(device, M, K, seed=M).float() * 3.0
         + torch.randn((M, K), device=device) * 1e-3).to(dtype)
    x[0, : K // 2] = 0.0
    before = quant.quantize_rows_launches
    q, s = quant.quantize_activations(x)
    assert quant.quantize_rows_launches == before + 1
    rq, rs = quant.quantize_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(s, rs) and torch.equal(q, rq)


K6A_ROWS = [1, 4, 16, 17, 1088]


def _norm_scale(device, K, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(K, generator=g, device=device) * 0.3 + 1.0  # N(1, 0.3), fp32


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("K", [64, 3584])
@pytest.mark.parametrize("M", K6A_ROWS)
def test_rmsnorm_quantize_kernel_matches_plain(device, M, K, residual):
    """K6a's RMSNORM prologue at the tiny and 7B hidden widths: x + residual
    bitwise; codes within +-1 and scales within 2^-7 of the plain version
    (the kernel adds the squares in another order than ATen's mean, which
    can move the norm's last bit). The count of differing codes is printed
    and held under 1 in 1,000."""
    from internnav_tpu_torch.ops import quant

    x = _rand(device, M, K, seed=M + K) * 2.0
    h = _rand(device, M, K, seed=M + K + 1) if residual else None
    w = _norm_scale(device, K, seed=K)
    before = (quant.quantize_rows_launches, quant.rmsnorm_quantize_launches)
    q, s, xs = quant.rmsnorm_quantize(x, w, 1e-6, residual=h)
    assert (quant.quantize_rows_launches, quant.rmsnorm_quantize_launches) == \
        (before[0] + 1, before[1] + 1)
    rq, rs, rxs = quant.rmsnorm_quantize_reference(x, w, 1e-6, residual=h)
    torch.cuda.synchronize()
    assert q.shape == (M, K) and s.shape == (M, 1) and torch.equal(xs, rxs)
    differing = int((q != rq).sum())
    print(f"RMSNORM M={M} K={K} residual={residual}: {differing} of {M * K} codes differ")
    assert int((q.int() - rq.int()).abs().max()) <= 1
    assert differing * 1000 <= M * K
    torch.testing.assert_close(s, rs, atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("K", [128, 12000, 18944, 40960])
@pytest.mark.parametrize("M", K6A_ROWS)
def test_swiglu_quantize_kernel_is_bitwise(device, M, K):
    """K6a's SWIGLU prologue at the tiny and 7B intermediate widths and at
    2 and 5 vectors a thread (the widest row it takes): the
    same expf, IEEE division, bf16 roundings and subnormal flushes as the
    plain version (XLA's SiLU on bf16, times up in fp32), also at inputs
    whose SiLU flushes to zero (subnormal and tiny gates, gates at or
    below -87.5)."""
    from internnav_tpu_torch.ops import quant

    gate = _rand(device, M, K, seed=M + 2 * K) * 3.0
    up = _rand(device, M, K, seed=M + 2 * K + 1)
    gate[0, :8] = torch.tensor([0.0, -0.0, 88.0, -88.0, 100.0, -100.0, 1e-3, -1e-3])
    gate[0, 8:14] = torch.tensor([1e-39, -1e-39, 1.5e-38, -1.5e-38, -87.0, -87.5])
    before = (quant.quantize_rows_launches, quant.swiglu_quantize_launches)
    q, s = quant.swiglu_quantize(gate, up)
    assert (quant.quantize_rows_launches, quant.swiglu_quantize_launches) == \
        (before[0] + 1, before[1] + 1)
    rq, rs = quant.swiglu_quantize_reference(gate, up)
    torch.cuda.synchronize()
    assert torch.equal(s, rs) and torch.equal(q, rq)


@pytest.mark.parametrize("n", [65280, 8 * 18944, 3420 * 3 + 5])
@pytest.mark.parametrize("with_up", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_silu_kernel_is_bitwise(device, n, with_up, offset):
    """K8: every finite bf16 bit pattern (n = 65280), a 7B SwiGLU row block
    and a length off the 8-element vectors, from 16-byte aligned storage
    (vector path) and one element past it (element path), silu alone and
    times up, bitwise against the plain version."""
    from internnav_tpu_torch.ops import activations as act

    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32, device=device).to(torch.int16)
    finite = bits.view(torch.bfloat16)
    finite = finite[torch.isfinite(finite)]
    if n == finite.numel():
        gate = torch.cat([finite[:offset], finite])[offset:]
    else:
        gate = _rand(device, n + offset, seed=n) * 3.0
        gate[offset:offset + 8] = torch.tensor([1e-39, -1e-39, 1.5e-38, -1.5e-38, -87.0, -87.5,
                                                88.0, -100.0])
        gate = gate[offset:]
    up = _rand(device, gate.numel() + offset, seed=n + 1)[offset:] if with_up else None
    before = act.silu_launches
    out = act.silu_cuda(gate, up)
    assert act.silu_launches == before + 1
    ref = act.silu_mul_reference(gate, up) if with_up else act.silu_reference(gate)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


def test_silu_dispatch_launches_the_kernel_on_cuda(device):
    """silu / silu_mul of bf16 CUDA tensors run K8 (one launch each, the
    autograd path too); fp32 tensors go to F.silu; the wrapper refuses
    what the kernel does not take."""
    import torch.nn.functional as F

    from internnav_tpu_torch.ops import activations as act

    g, u = _rand(device, 4, 96, seed=1), _rand(device, 4, 96, seed=2)
    before = act.silu_launches
    act.silu(g)
    act.silu_mul(g, u)
    gr = g.clone().requires_grad_(True)
    act.silu_mul(gr, u).sum().backward()  # forward, and silu(gate) in the backward
    assert act.silu_launches == before + 4
    assert torch.equal(act.silu(g.float()), F.silu(g.float()))
    for bad in (g.float(), g.t(), g.cpu()):
        with pytest.raises(ValueError):
            act.silu_cuda(bad)
    with pytest.raises(ValueError):
        act.silu_cuda(g, u[:2])


def test_silu_gradient_on_cuda_is_the_plain_one(device):
    """A bf16 `silu` that needs a gradient launches K8 inside `_SiluBf16`
    and returns a tracked tensor (ROADMAP F29); its gradient is torch's
    autograd of F.silu in bf16 on the same tensors, bitwise, and its
    output K8's."""
    import torch.nn.functional as F

    from internnav_tpu_torch.ops import activations as act

    x, g = _rand(device, 64, 384, seed=5) * 3.0, _rand(device, 64, 384, seed=6)
    xa = x.clone().requires_grad_(True)
    before = act.silu_launches
    y = act.silu(xa)
    assert act.silu_launches == before + 1 and y.grad_fn is not None
    y.backward(g)
    xb = x.clone().requires_grad_(True)
    F.silu(xb).backward(g)
    torch.cuda.synchronize()
    assert torch.equal(y.detach().view(torch.int16), act.silu_reference(x).view(torch.int16))
    assert torch.equal(xa.grad.view(torch.int16), xb.grad.view(torch.int16))


#: K8f against its plain version: fp32 sums in another order than
#: cuBLAS's can round a gate or up value to the neighbouring bf16 value
K8F_RTOL, K8F_ATOL = 2.0 ** -6, 1e-3


@pytest.mark.parametrize("M,N,K", [(1024, 1024, 384), (1000, 1024, 384), (1, 1024, 384),
                                   (130, 100, 72), (257, 63, 8), (64, 1024, 448),
                                   (256, 128, 1000)])
def test_swiglu_gemm_kernel_matches_plain(device, M, N, K):
    """K8f at NextDiT's feed-forward (M = 1,024 and a ragged 1,000 and 1),
    columns past a 64-column tile and an odd N (element stores), K off the
    64-wide stages (zero fill), and K past the 6-stage ring (its stages
    reused): within K8F_RTOL / K8F_ATOL of `swiglu_gemm_reference`."""
    from internnav_tpu_torch.ops import activations as act

    x = _rand(device, M, K, seed=M)
    w1, w3 = _rand(device, N, K, seed=N) * 0.02, _rand(device, N, K, seed=N + 1) * 0.02
    before = act.swiglu_gemm_launches
    out = act.swiglu_gemm_cuda(x, w1, w3)
    assert act.swiglu_gemm_launches == before + 1
    ref = act.swiglu_gemm_reference(x, w1, w3)
    torch.cuda.synchronize()
    assert out.shape == (M, N) and torch.isfinite(out).all()
    assert ((out.float() - ref.float()).abs() <= K8F_ATOL + K8F_RTOL * ref.float().abs()).all()


def test_swiglu_gemm_dispatch_and_refusals(device):
    """NextDiT's feed-forward launches K8f once with no gradient recorded
    and keeps its two products and K8 under grad; the wrapper refuses
    what the kernel does not take, and a call that would need a backward."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.nextdit import LuminaFeedForward
    from internnav_tpu_torch.ops import activations as act

    torch.manual_seed(0)
    ffn = LuminaFeedForward(384, 256, torch.bfloat16).to(device)
    x = torch.randn(2, 512, 384, device=device)
    k8f, k8 = act.swiglu_gemm_launches, act.silu_launches
    with torch.no_grad():
        y = ffn(x)
    assert (act.swiglu_gemm_launches, act.silu_launches) == (k8f + 1, k8)
    ffn(x).float().sum().backward()
    assert act.swiglu_gemm_launches == k8f + 1 and act.silu_launches > k8
    assert ffn.linear_1.weight.grad is not None and y.shape == (2, 512, 384)
    w = ffn.linear_1.weight.detach()
    xs = x.reshape(-1, 384).bfloat16()
    for bad in ((xs.float(), w, w), (xs.t(), w, w), (xs[:, :380].contiguous(), w[:, :380], w),
                (xs[:, :12].contiguous(), w[:, :12].contiguous(), w[:, :12].contiguous()),
                (xs.cpu(), w.cpu(), w.cpu())):
        with pytest.raises(ValueError):
            act.swiglu_gemm_cuda(*bad)
    with pytest.raises(RuntimeError):
        act.swiglu_gemm_cuda(xs, ffn.linear_1.weight, ffn.linear_3.weight)


def test_k6a_wrappers_reject_what_they_do_not_take(device):
    from internnav_tpu_torch.ops import quant

    x = torch.zeros((4, 256), dtype=torch.bfloat16, device=device)
    w = torch.ones(256, device=device)
    with pytest.raises(ValueError, match="bfloat16"):  # RMSNORM takes bf16 rows only
        quant.rmsnorm_quantize_cuda(x.float(), w, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):  # a strided view
        quant.rmsnorm_quantize_cuda(x[:, ::2], w[::2], 1e-6)
    with pytest.raises(ValueError, match="norm scale"):
        quant.rmsnorm_quantize_cuda(x, w.bfloat16(), 1e-6)
    with pytest.raises(ValueError, match="second input"):
        quant.swiglu_quantize_cuda(x, x[:2])
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        quant.quantize_rows_cuda(torch.zeros((2, 12), dtype=torch.bfloat16, device=device))
    with pytest.raises(ValueError, match="at most"):
        quant.quantize_rows_cuda(torch.zeros((1, 32772), device=device))


@pytest.mark.parametrize("M", [1, 4, 5, 329])
@pytest.mark.parametrize("N,K,bias", [(64, 128, True), *W8A8_7B])
def test_w8a8_gemm_per_channel_within_one_ulp(device, M, N, K, bias):
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=7))
    w, s = _int8_weight(device, N, K, seed=N + K)
    b = torch.randn(N, device=device) if bias else None
    before = quant.w8a8_launches
    y = quant.w8a8_linear(xq, a, w, s, b)
    assert quant.w8a8_launches == before + 1 and y.dtype == torch.bfloat16
    want = quant.w8a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("M", [1, 4, 1100])
@pytest.mark.parametrize("N,K,bias", [(64, 256, True), *W8A8_7B])
def test_w8a8_gemm_grouped(device, M, N, K, bias):
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=8))
    w, s = _int8_weight(device, N, K, seed=N - K, group=128)
    b = torch.randn(N, device=device) if bias else None
    y = quant.w8a8_linear(xq, a, w, s, b)
    want = quant.w8a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("M", [17, 129, 1088, 1100])
@pytest.mark.parametrize("N,K,bias", [(64, 128, True), (1024, 256, False), (1088, 256, True),
                                      *W8A8_7B])
def test_w8a8_gemm_prefill_tiles_are_bitwise(device, M, N, K, bias):
    """The wgmma prefill tiles (M > 16) at both tile widths, which the
    kernel picks from N (128 up to N = 1024, 256 above): exact int32 sums
    and the plain version's epilogue, so equal bit for bit, also where M is
    not a multiple of the 128-row tile or N of its width. The output starts
    uninitialised, so a tile the grid missed would show."""
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=11))
    w, s = _int8_weight(device, N, K, seed=N + K + 1)
    b = torch.randn(N, device=device) if bias else None
    y = quant.w8a8_linear_cuda(xq, a, w, s, b)
    want = quant.w8a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_w8a8_gemm_lm_head_at_decode(device):
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, 1, 3584, seed=9))
    w, s = _int8_weight(device, 152064, 3584, seed=10)
    y = quant.w8a8_linear(xq, a, w, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), quant.w8a8_linear_reference(xq, a, w, s).float(),
                               atol=0, rtol=2 ** -7)


GEMM_DECODE_ROWS = [1, 4, 12, 16]
ODD_N = [63, 65, 4097]


def _w8a8_segments(device, widths, K, bias, seed, group=None):
    segs = []
    for i, N in enumerate(widths):
        w, s = _int8_weight(device, N, K, seed=seed + i, group=group)
        segs.append((w, s, torch.randn(N, device=device) if bias else None))
    return segs


@pytest.mark.parametrize("M", GEMM_DECODE_ROWS)
@pytest.mark.parametrize("N,K,bias", [*W8A8_7B, *((n, 3584, True) for n in ODD_N)])
def test_w8a8_decode_tiles_are_bitwise(device, M, N, K, bias):
    """The decode tiles (TMA ring, K split over a cluster where the plan
    asks) at the 7B shapes and at odd N: exact int32 sums in any split and
    the plain version's epilogue, so equal bit for bit. The output starts
    uninitialised, so a tile or a K slice the grid missed would show."""
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=13 + M))
    (w, s, b), = _w8a8_segments(device, (N,), K, bias, seed=N + K + M)
    before = quant.w8a8_launches
    y = quant.w8a8_linear_cuda(xq, a, w, s, b)
    assert quant.w8a8_launches == before + 1
    want = quant.w8a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_w8a8_decode_tiles_walk_edge_tiles_last(device):
    """F16: a whole-K plan over ragged widths walks every segment's full
    tiles, then the three narrow edge tiles (`DecodePlan.tile_order`, the
    kernel's `dc_segment`), so the SMs that take an extra tile take the
    narrow ones. Each projection equals the plain version bit for bit."""
    from internnav_tpu_torch.ops import quant

    widths, K, M = (15169, 7917, 2252), 16576, 5
    plan = quant.gemm_decode_plan(widths, K, 0, M)
    assert plan.split == 1 and plan.tile_order()[-3:] == [(0, 15168), (1, 7872), (2, 2240)]
    xq, a = quant.quantize_rows(_rand(device, M, K, seed=29))
    segs = _w8a8_segments(device, widths, K, True, seed=31)
    ys = quant.w8a8_linear_multi(xq, a, segs)
    torch.cuda.synchronize()
    for y, sg in zip(ys, segs):
        assert torch.equal(y, quant.w8a8_linear_reference(xq, a, *sg))


@pytest.mark.parametrize("M", GEMM_DECODE_ROWS)
@pytest.mark.parametrize("widths,bias", [((3584, 512, 512), True), ((18944, 18944), False),
                                         ((63, 4097, 65), True)])
def test_w8a8_multi_is_one_launch_equal_to_separate_calls(device, M, widths, bias):
    """q/k/v and gate/up of one input in one decode launch, counted once
    (and once as fused), bitwise equal to the projections' separate
    launches and to the plain version."""
    from internnav_tpu_torch.ops import quant

    K = 3584
    xq, a = quant.quantize_rows(_rand(device, M, K, seed=17 + M))
    segs = _w8a8_segments(device, widths, K, bias, seed=len(widths) + M)
    before = (quant.w8a8_launches, quant.w8a8_fused_launches)
    ys = quant.w8a8_linear_multi(xq, a, segs)
    assert (quant.w8a8_launches, quant.w8a8_fused_launches) == (before[0] + 1, before[1] + 1)
    alone = [quant.w8a8_linear_cuda(xq, a, *sg) for sg in segs]
    assert quant.w8a8_fused_launches == before[1] + 1
    torch.cuda.synchronize()
    for y, z, sg in zip(ys, alone, segs):
        assert y.shape == (M, sg[0].shape[0])
        assert torch.equal(y, z) and torch.equal(y, quant.w8a8_linear_reference(xq, a, *sg))


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("widths,K", [((3584, 512, 512), 3584), ((18944,), 3584),
                                      ((3584,), 18944), ((65,), 256)])
def test_w8a8_decode_tiles_grouped(device, M, widths, K):
    """Grouped g=128 scales at decode rows, fused and alone: each group
    folded in fp32 (K split only at whole groups), within GROUPED_TOL."""
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=19 + M))
    segs = _w8a8_segments(device, widths, K, True, seed=K + M, group=128)
    ys = quant.w8a8_linear_multi(xq, a, segs)
    torch.cuda.synchronize()
    for y, sg in zip(ys, segs):
        want = quant.w8a8_linear_reference(xq, a, *sg)
        torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("M", [17, 129])
@pytest.mark.parametrize("N", ODD_N)
def test_w8a8_prefill_tiles_at_odd_n_are_bitwise(device, M, N):
    """F15: at odd N a bf16 pair is stored only where its address is 4-byte
    aligned ((m N + n) even), else one value at a time."""
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, 3584, seed=23 + M))
    (w, s, b), = _w8a8_segments(device, (N,), 3584, True, seed=N + M)
    y = quant.w8a8_linear_cuda(xq, a, w, s, b)
    want = quant.w8a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_w8a8_multi_rejects_what_it_does_not_take(device):
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, 2, 256, seed=29))
    segs = _w8a8_segments(device, (64, 64, 64, 64), 256, False, seed=29)
    with pytest.raises(ValueError, match="1 to 3 projections"):
        quant.w8a8_decode_cuda(xq, a, segs)
    grouped = _w8a8_segments(device, (64,), 256, False, seed=30, group=128)
    with pytest.raises(ValueError, match="scale groups differ"):
        quant.w8a8_decode_cuda(xq, a, [segs[0], grouped[0]])
    with pytest.raises(ValueError, match="M <= 16"):
        quant.w8a8_decode_cuda(*quant.quantize_rows(_rand(device, 17, 256, seed=31)), segs[:1])


def test_w8a8_gemm_rejects_what_it_does_not_take(device):
    from internnav_tpu_torch.ops import quant

    xq = torch.zeros((2, 96), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="multiple of 64"):
        quant.w8a8_linear_cuda(xq, torch.ones((2, 1), device=device),
                               torch.zeros((8, 96), dtype=torch.int8, device=device),
                               torch.ones(8, device=device))
    xq = torch.zeros((2, 128), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="whole"):
        quant.w8a8_linear_cuda(xq, torch.ones((2, 1), device=device),
                               torch.zeros((8, 128), dtype=torch.int8, device=device),
                               torch.ones((4, 8), device=device))


def _int8_kv_cache(device, B, Tmax, KV, D, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    data = torch.randint(-127, 128, (B, Tmax, KV, D), generator=g, device=device,
                         dtype=torch.int8)
    scale = torch.rand((B, Tmax, KV, 1), generator=g, device=device) * 0.05 + 1e-3
    return data, scale


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("B,H,KV,Tmax,lens", [(1, 28, 4, 1260, (1100,)),
                                              (2, 28, 4, 460, (5, 329)),
                                              (2, 8, 2, 100, (31, 64)),
                                              (1, 28, 4, 33, (0,)),
                                              # 16 blocks a head over 16 / 17 live
                                              # keys (n = 1): one key a block or two
                                              (2, 28, 4, 1220, (15, 16)),
                                              (1, 28, 4, 4893, (4761,)),
                                              (1, 28, 4, 8192, (8000,)),
                                              (3, 28, 4, 1220, (1088, 17, 700))])
def test_int8_decode_kernel_matches_plain(device, n, B, H, KV, Tmax, lens):
    """K4 (n = 1) and K5 (n = 4, and n = 8: 56 query rows a KV head, two
    row tiles) on strided views of (B, Tmax, KV, D) caches, cache lengths
    differing per row, past 4,096 keys (one cluster of 16 blocks a head),
    and live ranges shorter than the cluster or just longer (blocks with no
    key, or one): a key missed or walked twice by the cluster's split moves
    the short rows' outputs past the tolerance."""
    D = 128
    kd, ks = _int8_kv_cache(device, B, Tmax, KV, D, seed=1)
    vd, vs = _int8_kv_cache(device, B, Tmax, KV, D, seed=2)
    views = (kd.transpose(1, 2), vd.transpose(1, 2))
    scales = dict(k_scale=ks[..., 0].transpose(1, 2), v_scale=vs[..., 0].transpose(1, 2))
    cache_len = torch.tensor(lens, device=device)
    if n == 1:
        q = _rand(device, B, H, D, seed=3)
        before = fa.decode_int8_launches
        out = fa.gqa_decode_attention(q, *views, cache_len + 1, **scales)
        assert fa.decode_int8_launches == before + 1
        want = fa.gqa_decode_attention(q.cpu(), *(t.cpu() for t in views), (cache_len + 1).cpu(),
                                       **{k: t.cpu() for k, t in scales.items()})
    else:
        q = _rand(device, B, H, n, D, seed=3)
        before = fa.chunk_decode_int8_launches
        out = fa.gqa_chunk_decode_attention(q, *views, cache_len, **scales)
        assert fa.chunk_decode_int8_launches == before + 1
        want = fa.gqa_chunk_decode_attention(q.cpu(), *(t.cpu() for t in views),
                                             cache_len.cpu(),
                                             **{k: t.cpu() for k, t in scales.items()})
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float().cpu(), want.float(), atol=O_TOL, rtol=O_TOL)
    # twice in a row: the same bits (no state is left between launches)
    again = (fa.gqa_decode_attention(q, *views, cache_len + 1, **scales) if n == 1 else
             fa.gqa_chunk_decode_attention(q, *views, cache_len, **scales))
    assert torch.equal(again, out)


@pytest.mark.parametrize("n,pos", [(1, (0,)), (1, (17, 450)), (4, (3, 100)), (329, (0, 0)),
                                   # past Tmax = 460: a one-row token and a chunk clamp
                                   # their start, a token of a batch of rows is dropped
                                   (1, (470,)), (1, (455, 460, 471)), (4, (458, 3)),
                                   (4, (900,))])
def test_kv_write_kernel_is_bitwise(device, n, pos):
    from internnav_tpu_torch.ops import quant

    B, KV, D, Tmax = len(pos), 4, 128, 460
    k = _rand(device, B, n, KV, D, seed=4) * 2.0
    v = _rand(device, B, n, KV, D, seed=5)
    k[0, 0, 0] = 0.0  # a zero row takes the 1e-8 floor
    cache_len = torch.tensor(pos, device=device)
    ke, ve = _int8_kv_cache(device, B, Tmax, KV, D, 6), _int8_kv_cache(device, B, Tmax, KV, D, 7)
    ref = [tuple(t.clone() for t in e) for e in (ke, ve)]
    before = quant.kv_write_launches
    quant.write_kv_cache(k, v, ke, ve, cache_len)
    assert quant.kv_write_launches == before + 1
    quant.write_kv_cache_reference(k, v, ref[0], ref[1], cache_len)
    torch.cuda.synchronize()
    for got, want in zip((*ke, *ve), (*ref[0], *ref[1])):
        assert torch.equal(got, want)


def _rotary_tables(device, B, n, D, seed):
    """cos/sin (B, n, D) fp32 of random positions, as `mrope_cos_sin` makes
    them (the frequencies duplicated over the two halves)."""
    from internnav_tpu_torch.ops.rope import mrope_cos_sin

    g = torch.Generator(device=device).manual_seed(seed)
    pos = torch.randint(0, 5000, (3, B, n), generator=g, device=device)
    return mrope_cos_sin(pos, D, (16, 24, 24) if D == 128 else (D // 8, D // 8, D // 4))


@pytest.mark.parametrize("n,pos", [(1, (17,)), (1, (455, 460, 471)), (4, (3, 100)),
                                   (4, (458,)), (4, (900, 0, 5)), (1088, (0,))])
@pytest.mark.parametrize("D", [64, 128])
def test_rope_kv_write_kernel_is_bitwise(device, n, pos, D):
    """K7 with rotary: one token, a ragged batch of 3 whose row past Tmax =
    460 is dropped (and whose slot keeps its old codes), chunks clamped at
    the cache's end, and a 1,088-token write at 0 (Tmax 1220 then): the
    rotated q, the codes and the scales equal `rope_kv_write_reference`."""
    from internnav_tpu_torch.ops import quant

    B, H, KV = len(pos), 28, 4
    Tmax = 460 if n < 1088 else 1220
    q = _rand(device, B * n, H * D, seed=11) * 2.0
    k = _rand(device, B * n, KV * D, seed=12) * 2.0
    v = _rand(device, B * n, KV * D, seed=13)
    v[0, :D] = 0.0  # a zero row takes the 1e-8 floor
    cos, sin = _rotary_tables(device, B, n, D, seed=14)
    cache_len = torch.tensor(pos, device=device, dtype=torch.int32 if B == 3 else torch.int64)
    ke, ve = (_int8_kv_cache(device, B, Tmax, KV, D, 15), _int8_kv_cache(device, B, Tmax, KV,
                                                                          D, 16))
    ref = [tuple(t.clone() for t in e) for e in (ke, ve)]
    before = quant.kv_write_launches
    q_rot = quant.rope_kv_write(q, k, v, cos, sin, ke, ve, cache_len)
    assert quant.kv_write_launches == before + 1
    want = quant.rope_kv_write_reference(q, k, v, cos, sin, ref[0], ref[1], cache_len)
    torch.cuda.synchronize()
    assert q_rot.shape == (B, H, n, D) and q_rot.is_contiguous() and torch.equal(q_rot, want)
    for got, exp in zip((*ke, *ve), (*ref[0], *ref[1])):
        assert torch.equal(got, exp)


def test_k7_wrappers_reject_what_they_do_not_take(device):
    from internnav_tpu_torch.ops import quant

    B, n, H, KV, D, Tmax = 1, 2, 8, 2, 128, 16
    q = torch.zeros((B * n, H * D), dtype=torch.bfloat16, device=device)
    k = torch.zeros((B * n, KV * D), dtype=torch.bfloat16, device=device)
    cos = torch.zeros((B, n, D), device=device)
    entry = (torch.zeros((B, Tmax, KV, D), dtype=torch.int8, device=device),
             torch.zeros((B, Tmax, KV, 1), device=device))
    cache_len = torch.zeros(B, dtype=torch.long, device=device)
    with pytest.raises(ValueError, match="q must be"):
        quant.rope_kv_write_cuda(q.float(), k, k, cos, cos, entry, entry, cache_len)
    with pytest.raises(ValueError, match="cos must be"):
        quant.rope_kv_write_cuda(q, k, k, cos.bfloat16(), cos, entry, entry, cache_len)
    with pytest.raises(ValueError, match="k must be"):  # a strided view
        quant.rope_kv_write_cuda(q, k.t().contiguous().t(), k, cos, cos, entry, entry,
                                 cache_len)
    with pytest.raises(ValueError, match="head dim"):
        quant.rope_kv_write_cuda(q, k, k, cos, cos, tuple(t[..., :96] for t in entry[:1])
                                 + entry[1:], entry, cache_len)
    with pytest.raises(ValueError, match="cache_len"):
        quant.rope_kv_write_cuda(q, k, k, cos, cos, entry, entry, cache_len.float())


# ------------------------------------------------------ decode loop graphs
def _decode_model(device, fmt, seed=0):
    """A small text model whose shapes the int8 kernels take (head dim 128,
    K multiples of 64): bf16, or W8A8 projections with an int8 KV cache."""
    import dataclasses

    from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt

    cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), hidden_size=256, intermediate_size=512,
                              num_attention_heads=2, num_key_value_heads=1, head_dim=128,
                              mrope_section=(16, 24, 24), dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(seed)
    with torch.device(device):
        model = qt.QwenTextModel(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" not in name:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    if fmt == "int8":
        qt.quantize_qwen_text_(model)
        model.cfg = dataclasses.replace(model.cfg, kv_dtype="int8")
        for mod in model.modules():
            if isinstance(getattr(mod, "cfg", None), qt.QwenTextConfig):
                mod.cfg = model.cfg
    return model.eval()


def _decode_prompts(device, groups, T=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    out = []
    for rows, P in groups:
        emb = (0.5 * torch.randn((rows, T, 256), generator=g)).to(device, torch.bfloat16)
        pos = torch.arange(T, device=device)[None, None].expand(3, rows, T).contiguous()
        seg = torch.zeros((rows, T), dtype=torch.int32, device=device)
        seg[:, P:] = 1
        plen = torch.full((rows,), P, dtype=torch.long, device=device)
        out.append((emb, pos, seg, plen, torch.zeros(rows, dtype=torch.long, device=device)))
    return out


def _decode(model, prompts, eager, buffers=None, max_new=12, n_q=2):
    """Each group prefilled into a cache set of the pool, then one (grouped)
    decode loop, the sets released: tokens, lengths and every group's
    caches but their last slot, copied. (The warm-up step before a capture
    writes that slot, which a request writes before it reads it.)"""
    from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
    from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import DecodeBuffers

    buffers = buffers or DecodeBuffers()
    statics, firsts = [], []
    with torch.inference_mode():
        for emb, pos, seg, plen, _ in prompts:
            caches = buffers.acquire(model.cfg, emb.shape[0], emb.shape[1] + max_new + n_q,
                                     emb.device)
            logits, _, _ = model(emb, pos, segment_ids=seg, logits_indices=plen - 1,
                                 caches_out=caches.entries)
            statics.append(caches)
            firsts.append(logits[:, 0].argmax(-1))
        tok, ln = qt.greedy_decode_grouped(
            model, torch.cat(firsts), statics, prompt_lengths=torch.cat([p[3] for p in prompts]),
            rope_deltas=torch.cat([p[4] for p in prompts]), max_new_tokens=max_new,
            eos_token_ids=(7,), buffers=buffers, eager=eager)
        torch.cuda.synchronize()
        flat = [t[:, :-1].clone() for c in statics for layer in c.entries for e in layer
                for t in (e if isinstance(e, tuple) else (e,))]
    for c in statics:
        buffers.release(c)
    return tok, ln, flat


@pytest.mark.parametrize("groups", [((1, 21),), ((2, 21), (3, 17))])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_decode_graph_replay_is_bitwise_eager(device, fmt, groups):
    """The captured step replayed equals the same step run eagerly, bit for
    bit (the same kernels in the same order), single and grouped."""
    model = _decode_model(device, fmt)
    prompts = _decode_prompts(device, groups)
    ref = _decode(model, prompts, eager=True)
    got = _decode(model, prompts, eager=False)
    for a, b in zip(got[:2] + tuple(got[2]), ref[:2] + tuple(ref[2])):
        assert torch.equal(a, b)


def test_decode_graph_replays_count_their_launches(device):
    """Each replay adds its graph's captured launches to the wrappers'
    counters: a replayed decode counts what the same decode counts eagerly."""
    from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph
    from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import DecodeBuffers

    model = _decode_model(device, "int8")
    prompts = _decode_prompts(device, ((2, 21), (3, 17)))
    counts = {}
    for eager in (True, False):
        buffers = DecodeBuffers()
        _decode(model, prompts, eager, buffers)  # the capture (and its warm-up) first
        before = decode_graph.launch_counters()
        _decode(model, prompts, eager, buffers)
        after = decode_graph.launch_counters()
        counts[eager] = {k: after[k] - before[k] for k in after}
    assert counts[False] == counts[True]
    assert counts[False][("internnav_tpu_torch.ops.flash_attention", "decode_int8_launches")] \
        == 2 * 2 * 12  # 2 layers x 2 groups x 12 steps


def test_decode_graph_capture_after_cache_rebuild(device, monkeypatch):
    """When a group's caches are made anew (a pool of one set: another
    shape drops it, then the first shape comes again), the new capture
    gives the same tokens."""
    from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph
    from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import DecodeBuffers

    monkeypatch.setattr(decode_graph, "MAX_CACHES", 1)
    model = _decode_model(device, "int8")
    prompts = _decode_prompts(device, ((2, 21),))
    buffers = DecodeBuffers()
    first = _decode(model, prompts, False, buffers)
    decode_graph.reset_stats()
    _decode(model, _decode_prompts(device, ((2, 40),), T=64), False, buffers)
    again = _decode(model, prompts, False, buffers)
    assert decode_graph.stats["captures"] == 4  # both shapes captured anew
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_decode_graph_one_token_budget(device):
    """A one-token budget captures only the step without the lm_head (the
    tokens buffer has no column for a next token), and its replay equals
    the eager step."""
    from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph

    model = _decode_model(device, "int8")
    prompts = _decode_prompts(device, ((2, 21), (1, 17)))
    ref = _decode(model, prompts, eager=True, max_new=1)
    decode_graph.reset_stats()
    got = _decode(model, prompts, eager=False, max_new=1)
    assert decode_graph.stats["captures"] == 1 and decode_graph.stats["logits_steps"] == 0
    assert got[0].shape == (3, 1)
    for a, b in zip(got[:2] + tuple(got[2]), ref[:2] + tuple(ref[2])):
        assert torch.equal(a, b)


def test_decode_graph_reused_across_owners_of_one_layout(device):
    """Two rounds of a two-group decode whose sets are acquired in the same
    order by different callers replay the first round's graphs: one
    capture in all."""
    from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph
    from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import DecodeBuffers

    model = _decode_model(device, "int8")
    buffers = DecodeBuffers()
    decode_graph.reset_stats()
    prompts = _decode_prompts(device, ((2, 21), (2, 17)))
    first = _decode(model, prompts, False, buffers)
    second = _decode(model, prompts[::-1], False, buffers)
    assert decode_graph.stats["warmup_steps"] == 1 and decode_graph.stats["captures"] == 2
    assert torch.equal(first[0][:2], second[0][2:]) and torch.equal(first[0][2:], second[0][:2])


# ------------------------------------------------------------- graft entry
#: `graft_entry.entry()` on the card against the same forward on the host
#: (the same seed-0 weights, drawn on the host): bf16 activations through
#: 4 layers, K1 against the plain attention and the card's GEMMs against
#: the host's round in other places, so each output is held within 3% of
#: its largest entry
ENTRY_TOL_FRAC = 3e-2


def test_graft_entry_on_the_card_matches_the_host(device):
    from internnav_tpu_torch import graft_entry

    before = fa.kernel_launches
    fn, args = graft_entry.entry()
    logits, traj = fn(*args)
    torch.cuda.synchronize()
    assert fa.kernel_launches > before  # the prefill went through K1
    ref_logits, ref_traj = (lambda f, a: f(*a))(*graft_entry.entry(device="cpu"))
    for got, want in ((logits, ref_logits), (traj, ref_traj)):
        got, want = got.float().cpu(), want.float()
        assert got.shape == want.shape and torch.isfinite(got).all()
        atol = ENTRY_TOL_FRAC * want.abs().max().item()
        assert torch.allclose(got, want, atol=atol, rtol=0), (got - want).abs().max().item()


# ------------------------------------------------------------- checkpoints
def test_checkpoint_round_trips_decode_the_same_tokens(device, tmp_path):
    """The small policy written as an HF-layout sharded checkpoint and
    loaded on the card, bf16 and quantized on load to int8, then the int8
    policy saved natively and loaded again: every tensor equals the random
    build of its format, and each System-2 step decodes the same tokens
    and latents as the original on the same frame."""
    import dataclasses

    import numpy as np

    from internnav_tpu_torch.graft_entry import small_n1_config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.model.weights.convert import hf_state_dict
    from internnav_tpu_torch.model.weights.safetensors_io import save_sharded

    cfg = small_n1_config()
    int8 = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, weight_dtype="int8",
                                                             kv_dtype="int8"))
    frame = np.random.default_rng(0).integers(0, 256, (56, 56, 3)).astype(np.uint8)

    def step(policy):
        policy.reset()
        out = policy.s2_step(frame, "go to the door", max_new_tokens=8)
        torch.cuda.synchronize()
        return policy.last_gen_tokens, out.output_latent

    def same(a, b):
        sa, sb = a.model.state_dict(), b.model.state_dict()
        assert sa.keys() == sb.keys()
        assert all(sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)
        (ta, la), (tb, lb) = step(a), step(b)
        assert np.array_equal(ta, tb)
        assert (la is None) == (lb is None) and (la is None or torch.equal(la, lb))

    original = InternVLAN1Policy.build(cfg, device=device)
    hf = tmp_path / "hf"
    save_sharded(hf_state_dict(original.model), str(hf), max_shard_bytes=2**23)
    same(original, InternVLAN1Policy.from_pretrained_torch(str(hf), cfg, device=device))
    loaded = InternVLAN1Policy.from_pretrained_torch(str(hf), int8, device=device)
    same(InternVLAN1Policy.build(int8, device=device), loaded)
    loaded.save_pretrained(str(tmp_path / "native"))
    same(loaded, InternVLAN1Policy.from_pretrained(str(tmp_path / "native"), int8, device=device))


# ------------------------------------------------------------- K9, K10
# K9 per channel: the integer sums are exact and the epilogue K6b's, so
# bitwise. Grouped (K9 and K10): atol = rtol = 1e-2, the sum over groups in
# another order. K10 per channel: the same tolerance, its fp32 sums run in
# the tensor cores' order.
W4_ROWS = [1, 4, 12, 16, 17, 48, 192, 1088]
W16_ROWS = [1, 4, 12, 16, 48, 192]


def _int4_weight(device, N, K, seed, group=None):
    from internnav_tpu_torch.ops import quant

    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(-7, 8, (N, K), generator=g, device=device, dtype=torch.int8)
    shape = (K // group, N) if group else (N,)
    s = torch.rand(shape, generator=g, device=device) * 1e-2 + 1e-3
    return quant.pack_int4(w), s


@pytest.mark.parametrize("M", W4_ROWS)
@pytest.mark.parametrize("N,K,bias", [(64, 128, True), *W8A8_7B, *((n, 3584, True) for n in ODD_N)])
def test_w4a8_gemm_per_channel_is_bitwise(device, M, N, K, bias):
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=11))
    w, s = _int4_weight(device, N, K, seed=N + K)
    b = torch.randn(N, device=device) if bias else None
    before = quant.w4a8_launches
    y = quant.w4a8_linear(xq, a, w, s, b)
    assert quant.w4a8_launches == before + 1 and y.dtype == torch.bfloat16
    want = quant.w4a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


@pytest.mark.parametrize("M", [1, 4, 12, 48, 1088])
@pytest.mark.parametrize("N,K,bias", [(64, 256, True), *W8A8_7B, (65, 3584, True)])
def test_w4a8_gemm_grouped(device, M, N, K, bias):
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=12))
    w, s = _int4_weight(device, N, K, seed=N - K, group=128)
    b = torch.randn(N, device=device) if bias else None
    y = quant.w4a8_linear(xq, a, w, s, b)
    want = quant.w4a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("M", W16_ROWS)
@pytest.mark.parametrize("N,K,bias", [(64, 128, True), *W8A8_7B, (4097, 3584, True)])
def test_w8a16_gemm_matches_plain(device, M, N, K, bias, group, bits):
    from internnav_tpu_torch.ops import quant

    x = _rand(device, M, K, seed=13)
    w, s = (_int4_weight if bits == 4 else _int8_weight)(device, N, K, seed=N * 3 + K,
                                                         group=group)
    b = torch.randn(N, device=device) if bias else None
    before = quant.w8a16_launches
    y = quant.w8a16_linear(x, w, s, b)
    assert quant.w8a16_launches == before + 1 and y.dtype == torch.bfloat16
    want = quant.w8a16_linear_reference(x, w, s, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_w8a16_gemm_lm_head_at_decode(device):
    from internnav_tpu_torch.ops import quant

    x = _rand(device, 12, 3584, seed=14)
    w, s = _int8_weight(device, 152064, 3584, seed=5, group=128)
    y = quant.w8a16_linear_cuda(x, w, s)
    want = quant.w8a16_linear_reference(x, w, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_w4a8_and_w8a16_replay_in_a_graph_bitwise(device):
    """Both wrappers are capture-safe: a captured launch replays the eager
    call's bits (no atomics, a fixed order of every sum)."""
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, 4, 3584, seed=15))
    x = _rand(device, 4, 3584, seed=16)
    w4, s4 = _int4_weight(device, 3584, 3584, seed=1, group=128)
    w8, s8 = _int8_weight(device, 512, 3584, seed=2)
    eager = (quant.w4a8_linear_cuda(xq, a, w4, s4), quant.w8a16_linear_cuda(x, w4, s4),
             quant.w8a16_linear_cuda(x, w8, s8))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant.w4a8_linear_cuda(xq, a, w4, s4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (quant.w4a8_linear_cuda(xq, a, w4, s4), quant.w8a16_linear_cuda(x, w4, s4),
                quant.w8a16_linear_cuda(x, w8, s8))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


def test_w4a8_and_w8a16_wrappers_reject_what_they_do_not_take(device):
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, 2, 128))
    w4, s4 = _int4_weight(device, 64, 128, seed=0)
    w8, s8 = _int8_weight(device, 64, 128, seed=0)
    x = _rand(device, 2, 128)
    with pytest.raises(ValueError, match="weight_q"):
        quant.w4a8_linear_cuda(xq, a, w8, s8)  # int8 codes are K6b's
    with pytest.raises(ValueError, match="multiple of 64"):
        quant.w4a8_linear_cuda(xq[:, :96].contiguous(), a, w4[:, :48].contiguous(), s4)
    with pytest.raises(ValueError, match="scale groups"):
        quant.w4a8_linear_cuda(xq, a, w4, torch.ones((4, 64), device=device))
    with pytest.raises(ValueError, match="x must be"):
        quant.w8a16_linear_cuda(x.float(), w8, s8)
    with pytest.raises(ValueError, match="bias"):
        quant.w8a16_linear_cuda(x, w8, s8, torch.ones(63, device=device))
    with pytest.raises(TypeError, match="bfloat16"):
        quant.w8a16_linear(x, w8, s8, out_dtype=torch.float32)


def test_int4_and_w8a16_text_model_on_card_matches_cpu(device, monkeypatch):
    """A 2-layer text model at 7B's widths on the card, held to the JAX
    package's invariants (tests/test_int8_decode.py): W4A8 (K9, the 8-bit
    grouped lm_head on K6b) decode_step logits equal a re-prefill of the
    same tokens within rtol = atol = 2e-2 (bf16 KV cache, as there; both
    prefills attend through the plain version, as the decode's bf16-cache
    attention does, since K1 rounds P to bf16 for its P V product); W8A16
    and W4A16 decode (K10, no K6a) within 0.15 and 0.5 of the bf16 model's
    decode logits relative to their largest entry (the int8 and int4
    bounds there), and on the mean no further than W8A8 / W4A8 decode (x
    1.05, `test_decode_act_dtype_bf16_tracks_bf16_model`); and the W4A8
    prefill's logits
    within 5e-2 of the same model's plain versions on the CPU relative to
    their largest entry (K6a's RMSNorm codes may differ by one, K1 and the
    plain attention sum in other orders)."""
    import copy
    import dataclasses

    from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
    from internnav_tpu_torch.ops import quant

    cfg = dataclasses.replace(qt.QwenTextConfig(), num_hidden_layers=2, vocab_size=4096)
    torch.manual_seed(0)
    bf16 = qt.QwenTextModel(cfg)
    with torch.no_grad():
        for p in bf16.parameters():
            if p.dim() > 1:
                p.normal_(0, 0.02)
    bf16 = bf16.to(device)
    B, T = 2, 40
    ids = torch.randint(0, 4096, (B, T + 1), generator=torch.Generator().manual_seed(1))
    ids = ids.to(device)
    pos = torch.arange(T + 1, device=device)[None, None].expand(3, B, T + 1)

    def decode_logits(m):
        with torch.no_grad():
            _, _, caches = m(m.embed(ids[:, :T]), pos[..., :T].contiguous())
            caches = qt.pad_caches(caches, T + 1)
            k6a = quant.quantize_rows_launches
            lg, _, _ = m.decode_step(m.embed(ids[:, T:]), pos[..., T:].contiguous(), caches,
                                     torch.full((B,), T, device=device))
            if m.cfg.decode_bf16_act:
                assert quant.quantize_rows_launches == k6a
        return lg.float()

    ref = decode_logits(bf16)
    err = {}
    for wdt, act in (("int8", "int8"), ("int8", "bf16"), ("int4", "int8"), ("int4", "bf16")):
        m = qt.quantize_qwen_text_(copy.deepcopy(bf16), None, 4 if wdt == "int4" else 8)
        m.cfg = dataclasses.replace(m.cfg, decode_act_dtype=act)
        for mod in m.modules():
            if isinstance(getattr(mod, "cfg", None), qt.QwenTextConfig):
                mod.cfg = m.cfg
        lg = decode_logits(m)
        err[wdt, act] = (lg - ref).abs()
        if wdt == "int4" and act == "int8":
            # both prefills attend through the plain version, the bf16-cache
            # decode attention's arithmetic (K1 rounds P to bf16 for P V)
            with monkeypatch.context() as mp, torch.no_grad():
                mp.setattr(qt, "flash_attention", lambda q, k, v, causal=False,
                           segment_ids=None, tile_tables=None: fa.mha_reference(
                               q, k, v, causal=causal, segment_ids=segment_ids))
                lg = decode_logits(m)
                full, _, _ = m(m.embed(ids), pos)
            torch.testing.assert_close(lg, full[:, -1].float(), atol=2e-2, rtol=2e-2)
            with torch.no_grad():
                cpu = copy.deepcopy(m).cpu()
                want, _, _ = cpu(cpu.embed(ids.cpu()), pos.cpu())
            gap = (full.float().cpu() - want.float()).abs().max() / want.float().abs().max()
            assert gap < 5e-2, gap
    # the JAX bounds: W8A16 within 0.15 and no worse than W8A8 (x 1.05, on
    # the mean); int4 within 0.5 (test_int4_model_forward_and_generate)
    top = ref.abs().max()
    for wdt, bound in (("int8", 0.15), ("int4", 0.5)):
        assert err[wdt, "bf16"].max() / top < bound
        assert err[wdt, "bf16"].mean() <= err[wdt, "int8"].mean() * 1.05


# -------------------------------------------- K9, K10 on the decode ring
# The formats of the ring: (kernel, code bits). K9 takes int8 rows, K10
# bf16 rows; above 16 rows both run rows of warps on the ring (K9 to 64
# rows, then its wgmma prefill tiles; K10 to 192). A row's bits must not
# depend on M, the plan, the tile or the launch's other projections
# (csrc/quant_gemm.cuh).
RING_FORMATS = [("K9", 4), ("K10", 8), ("K10", 4)]
RING_ROWS = [1, 12, 16, 17, 48, 64, 65, 192]


def _ring_segments(device, kernel, bits, widths, K, group, seed):
    make = _int4_weight if bits == 4 else _int8_weight
    segs = []
    for i, N in enumerate(widths):
        w, s = make(device, N, K, seed=seed + i, group=group)
        segs.append((w, s, torch.randn(N, device=device)))
    return segs


def _ring_inputs(device, kernel, M, K, seed):
    from internnav_tpu_torch.ops import quant

    x = _rand(device, M, K, seed=seed)
    return quant.quantize_rows(x) if kernel == "K9" else (x, None)


def _ring_multi(kernel, x, a, segs):
    from internnav_tpu_torch.ops import quant

    if kernel == "K9":
        return quant.w4a8_linear_multi(x, a, segs)
    return quant.w8a16_linear_multi(x, segs)


def _ring_reference(kernel, x, a, seg):
    from internnav_tpu_torch.ops import quant

    if kernel == "K9":
        return quant.w4a8_linear_reference(x, a, *seg)
    return quant.w8a16_linear_reference(x, *seg)


def _with_split(plan, split, rows):
    """`plan` with its K cut into `split` slices (1: whole-K persistent
    blocks) at `rows` rows: as deep a ring as fits, and the grid the
    planner would give that split; `plan` itself where the split's
    partials do not fit a block's shared memory."""
    import dataclasses

    from internnav_tpu_torch.ops import quant

    forced = dataclasses.replace(plan, split=split)
    most = max(l1 - l0 for l0, l1 in map(forced.slice_lines, range(split)))
    forced = dataclasses.replace(forced, stages=min(plan.geometry.max_stages, most))
    while forced.stages > 1 and forced.smem_bytes(rows) > quant.GEMM_BLOCK_SMEM:
        forced = dataclasses.replace(forced, stages=forced.stages - 1)
    if forced.smem_bytes(rows) > quant.GEMM_BLOCK_SMEM:
        return plan
    return dataclasses.replace(forced, grid=forced.tiles * split if split > 1 else
                               min(forced.tiles, forced.resident_blocks(rows)))


@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("kernel,bits", RING_FORMATS)
def test_ring_row_bits_do_not_depend_on_m_plan_or_fusion(device, monkeypatch, kernel, bits,
                                                         group):
    """q/k/v of a 7B layer: row r of every M in RING_ROWS equals row r of
    the 192-row launch bit for bit; on the ring the fused launch (one
    launch, counted once as fused) equals each projection alone, and up
    to 64 rows the whole-K plan equals splits of 2 and 7."""
    from internnav_tpu_torch.ops import quant

    K, widths = 3584, (3584, 512, 512)
    segs = _ring_segments(device, kernel, bits, widths, K, group, seed=40 + bits)
    x, a = _ring_inputs(device, kernel, max(RING_ROWS), K, seed=41)
    ref = _ring_multi(kernel, x, a, segs)
    counters = ("w4a8_launches", "w4a8_fused_launches") if kernel == "K9" else \
        ("w8a16_launches", "w8a16_fused_launches")
    for M in RING_ROWS[:-1]:
        xs, as_ = x[:M], None if a is None else a[:M]
        before = [getattr(quant, c) for c in counters]
        ys = _ring_multi(kernel, xs, as_, segs)
        ring = M <= (quant.W4A8_MAX_M if kernel == "K9" else quant.W8A16_MAX_M)
        if ring:
            assert [getattr(quant, c) for c in counters] == [before[0] + 1, before[1] + 1]
        for y, r in zip(ys, ref):
            assert torch.equal(y, r[:M]), (M, (y.float() - r[:M].float()).abs().max())
        if not ring:
            continue
        for seg, r in zip(segs, ref):
            assert torch.equal(_ring_multi(kernel, xs, as_, [seg])[0], r[:M])
        if M > quant.GEMM_SPLIT_MAX_M:  # whole-K plans only above 64 rows
            continue
        planner = quant.gemm_decode_plan
        for split in (1, 2, 7):
            monkeypatch.setattr(quant, "gemm_decode_plan", lambda *args, split=split:
                                _with_split(planner(*args), split, args[3]))
            for y, r in zip(_ring_multi(kernel, xs, as_, segs), ref):
                assert torch.equal(y, r[:M]), (M, split)
            monkeypatch.setattr(quant, "gemm_decode_plan", planner)
    torch.cuda.synchronize()
    for r, seg in zip(ref, segs):
        want = _ring_reference(kernel, x, a, seg)
        if kernel == "K9" and not group:
            assert torch.equal(r, want)
        else:
            torch.testing.assert_close(r.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("M", [1, 4, 17, 48])
@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("kernel,bits", RING_FORMATS)
def test_ring_at_odd_n_and_a_partial_line(device, kernel, bits, group, M):
    """Odd N (63, 65, 4097) in one launch and K = 320, which ends inside a
    128-k int8 line and a 256-k int4 line: K9 per channel bitwise, the rest
    within GROUPED_TOL of the plain versions."""
    K = 320
    segs = _ring_segments(device, kernel, bits, (63, 65, 4097), K, group, seed=50 + M)
    x, a = _ring_inputs(device, kernel, M, K, seed=51 + M)
    ys = _ring_multi(kernel, x, a, segs)
    torch.cuda.synchronize()
    for y, seg in zip(ys, segs):
        want = _ring_reference(kernel, x, a, seg)
        if kernel == "K9" and not group:
            assert torch.equal(y, want)
        else:
            torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("M", [4, 48])
@pytest.mark.parametrize("kernel,bits", RING_FORMATS)
def test_ring_fused_launches_replay_in_a_graph_bitwise(device, kernel, bits, M):
    """gate/up in one launch on the ring, captured and replayed: the eager
    call's bits."""
    K = 3584
    segs = _ring_segments(device, kernel, bits, (18944, 18944), K, 128, seed=60)
    x, a = _ring_inputs(device, kernel, M, K, seed=61)
    eager = _ring_multi(kernel, x, a, segs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _ring_multi(kernel, x, a, segs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _ring_multi(kernel, x, a, segs)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


@pytest.mark.parametrize("bits,group", [(8, None), (4, 128)])
@pytest.mark.parametrize("M", [193, 256])
def test_w8a16_above_one_launch_of_rows(device, M, bits, group):
    """Above W8A16_MAX_M rows K10 launches once per 192 rows, each launch
    counted (fused ones too): the q/k/v of a 7B layer within GROUPED_TOL
    of the plain version, and the rows past 192 bitwise equal to the same
    rows launched alone."""
    from internnav_tpu_torch.ops import quant

    K = 3584
    segs = _ring_segments(device, "K10", bits, (3584, 512, 512), K, group, seed=70 + bits)
    x, _ = _ring_inputs(device, "K10", M, K, seed=71)
    before = (quant.w8a16_launches, quant.w8a16_fused_launches)
    ys = quant.w8a16_linear_multi(x, segs)
    assert (quant.w8a16_launches - before[0], quant.w8a16_fused_launches - before[1]) == (2, 2)
    tail = quant.w8a16_linear_multi(x[quant.W8A16_MAX_M:].contiguous(), segs)
    torch.cuda.synchronize()
    for y, t, seg in zip(ys, tail, segs):
        assert torch.equal(y[quant.W8A16_MAX_M:], t)
        want = _ring_reference("K10", x, None, seg)
        torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("N,K", [(65, 768), (3584, 1536)])
@pytest.mark.parametrize("group", [64, 192, 256])
@pytest.mark.parametrize("M", [65, 129, 1088])
def test_w4a8_prefill_tiles_at_other_groups(device, M, group, N, K):
    """K9's prompt tiles with scale groups other than 128 (their fold as
    each group ends, not pipelined): within GROUPED_TOL of the plain
    version."""
    from internnav_tpu_torch.ops import quant

    xq, a = quant.quantize_rows(_rand(device, M, K, seed=80 + M))
    w, s = _int4_weight(device, N, K, seed=N + group, group=group)
    b = torch.randn(N, device=device)
    before = quant.w4a8_launches
    y = quant.w4a8_linear(xq, a, w, s, b)
    assert quant.w4a8_launches == before + 1
    want = quant.w4a8_linear_reference(xq, a, w, s, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("group", [64, 256])
def test_w4a8_ring_and_prefill_rows_agree_at_other_groups(device, group):
    """A row's bits are the same from K9's decode ring (up to 64 rows) and
    its prompt tiles (129 rows) at groups other than 128."""
    from internnav_tpu_torch.ops import quant

    K, N = 1536, 3584
    xq, a = quant.quantize_rows(_rand(device, 129, K, seed=90))
    w, s = _int4_weight(device, N, K, seed=91, group=group)
    b = torch.randn(N, device=device)
    full = quant.w4a8_linear(xq, a, w, s, b)
    for M in (1, 17, 64):
        assert torch.equal(quant.w4a8_linear(xq[:M], a[:M], w, s, b), full[:M]), M


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("widths,K", [((3584, 512, 512), 3584), ((3584,), 18944),
                                      ((65,), 512)])
def test_w8a8_decode_grouped_fold_keeps_k6b_bits(device, M, widths, K):
    """K6b's grouped decode keeps its own arithmetic under the shared ring
    (quant_gemm.cuh): in each K slice of its plan, the groups' terms
    folded in order into an fp32 sum with one rounding a group (an FMA of
    float(acc_g) and the scale), the slices' partials added in fp32 in rank
    order, times the activation scale, + bias, to bf16. Emulated here in
    float64 (each step exact there but for the one fp32 rounding)."""
    import numpy as np

    from internnav_tpu_torch.ops import quant

    group = 128
    xq, a = quant.quantize_rows(_rand(device, M, K, seed=70 + M))
    segs = _w8a8_segments(device, widths, K, True, seed=K + M, group=group)
    ys = quant.w8a8_linear_multi(xq, a, segs)
    plan = quant.gemm_decode_plan(widths, K, group, M)
    torch.cuda.synchronize()
    xd = xq.cpu().double().numpy().reshape(M, K // group, group)
    av = a.cpu().numpy()[:, 0]
    for y, (w, s, b) in zip(ys, segs):
        N = w.shape[0]
        wd = w.cpu().double().numpy().reshape(N, K // group, group)
        acc = np.einsum("mgk,ngk->gmn", xd, wd)  # exact integer sums a group
        sv = s.cpu().numpy().astype(np.float64)
        total = np.zeros((M, N), np.float32)
        for rank in range(plan.split):
            l0, l1 = plan.slice_lines(rank)
            part = np.zeros((M, N), np.float32)
            for gi in range(l0 * quant.GEMM_LINE // group, min(K, l1 * quant.GEMM_LINE) // group):
                part = (part.astype(np.float64) + acc[gi] * sv[gi][None]).astype(np.float32)
            total = (total.astype(np.float64) + part).astype(np.float32)
        want = (total.astype(np.float64) * av[:, None]).astype(np.float32)
        want = (want.astype(np.float64) + b.cpu().numpy()[None]).astype(np.float32)
        want = torch.from_numpy(want).to(torch.bfloat16)
        assert torch.equal(y.cpu(), want)


# ----------------------------------------------------------------- NavDP
#: the fp32 NavDP head on the card against the same module on the host:
#: 20 DDPM steps of a 16-layer fp32 decoder and two ViT-S towers, cuBLAS
#: and the CPU summing each product in another order (TF32 products off
#: and cuDNN's TF32 at PyTorch's default, which the head's own guard
#: turns off while the towers run)
NAVDP_TOL = 1e-4


def _navdp_draws(rows, P, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, P, 3, generator=g), torch.randn(20, rows, P, 3, generator=g)


def test_navdp_head_on_the_card_matches_the_host(device):
    """The 7B NavDP head (384 wide, 16 layers, 224 x 224 RGBD pairs), one
    stream of 32 samples with injected noise, on the card and on the host."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.navdp_head import NavDPHead
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import init_random_

    head = init_random_(NavDPHead(vlm_token_dim=3584), torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(1, 4, 3584, generator=g).to(torch.bfloat16)
    im = torch.rand(1, 2, 224, 224, 3, generator=g)
    de = 5.0 * torch.rand(1, 2, 224, 224, 1, generator=g)
    x0, zs = _navdp_draws(32, 32, 2)
    with torch.no_grad():
        ref = head.predict_pointgoal_action_async(lat, im, de, x_init=x0, step_noises=zs)
        head.to(device)
        got = head.predict_pointgoal_action_async(
            *(t.to(device) for t in (lat, im, de)), x_init=x0.to(device),
            step_noises=zs.to(device)).cpu()
    assert got.shape == (32, 32, 3) and torch.isfinite(got).all()
    assert torch.allclose(got, ref, atol=NAVDP_TOL, rtol=0), (got - ref).abs().max().item()


def test_navdp_grouped_equals_per_cohort_on_the_card(device):
    """Four cohorts of 3 streams (the bucket of 3) at 224 x 224: one grouped
    denoise against each cohort's own, the same draws; trajectories within
    NAVDP_TOL, actions equal."""
    import dataclasses

    import numpy as np

    from internnav_tpu_torch.model.basemodel.internvla_n1 import serving
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    cfg = dataclasses.replace(InternVLAN1Config.tiny("navdp_async"), s1_image_hw=224)
    inner = InternVLAN1Policy.build(cfg, device=device)
    r = np.random.default_rng(3)
    rgb = r.integers(0, 256, (12, 2, 224, 224, 3)).astype(np.uint8)
    depth = r.uniform(0, 5, (12, 2, 224, 224, 1)).astype(np.float32)
    lat = torch.randn(12, cfg.n_query, cfg.text.hidden_size, device=device,
                      generator=torch.Generator(device=device).manual_seed(4))

    def specs():
        return [serving.BatchedN1Policy(inner, 3, seed=c).s1_prepare(
            rgb[3 * c:3 * c + 3], lat[3 * c:3 * c + 3], 32, depth=depth[3 * c:3 * c + 3])
            for c in range(4)]

    per, grouped = specs(), specs()
    for s in per:
        s["policy"]._s1_dispatch(s)
    serving.s1_grouped_dispatch(grouped)
    for a, b in zip(per, grouped):
        outs = [s["policy"].s1_collect(s["handle"]) for s in (a, b)]
        for x, y in zip(*outs):
            assert np.isfinite(x.trajectory).all()
            np.testing.assert_allclose(y.trajectory, x.trajectory, atol=NAVDP_TOL, rtol=0)
            assert x.idx == y.idx


def test_fsdp_single_rank_step_equals_the_unsharded_step(device, tmp_path):
    """One N1 step of the small policy (graft_entry's: 4 text layers at
    128-wide heads, bf16) under a one-rank NCCL process group with
    param_sharding="fsdp", against the same step unsharded: FSDP over one
    rank gathers and reduces nothing, so losses and grad_norm agree (bf16
    tolerance), and so do the updates: Adam's first step moves each
    element by about lr, and the two updates of an element agree within
    0.02·lr plus one bf16 spacing of the updated parameter (its rounding),
    except where the gradient is below its own noise (under 4 times the
    two gradients' difference, at most 1% of the reached elements). A step
    that skipped the update, or updated a stale shard, moves elements by
    lr where the other did not. Both run remat, so K1-K3 run inside
    non-reentrant checkpoints of FSDP-wrapped decoder layers: K1 twice a
    layer, K2 and K3 once."""
    import socket

    import torch.distributed as dist

    from internnav_tpu_torch.configs.trainer import ExpCfg, MeshCfg
    from internnav_tpu_torch.dataset.internvla_n1_dataset import (
        N1SampleDataset,
        n1_packed_collate_fn,
        tokenize_sample,
        write_synthetic_n1_dataset,
    )
    from internnav_tpu_torch.graft_entry import small_n1_config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.trainer.base import B1
    from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer

    cfg = small_n1_config()
    lr = 1e-3
    store = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=2, T=6, hw=56)

    def run(mesh):
        policy = InternVLAN1Policy.build(cfg, device=device, seed=0)
        tpi = policy._tokens_per_image((56, 56))
        rows = [tokenize_sample(s, policy.tokenizer, tokens_per_image=tpi, n_query=cfg.n_query)
                for s, _ in zip(N1SampleDataset(store, predict_step_nums=cfg.predict_step_nums,
                                                num_history=2), range(3))]
        batch = n1_packed_collate_fn(rows, max_len=512, predict_step_nums=cfg.predict_step_nums)
        exp = ExpCfg(name="fsdp1", model_name="internvla_n1", output_dir=str(tmp_path / "o"),
                     mesh=mesh)
        exp.il.lr, exp.il.lr_schedule, exp.il.remat = lr, "constant", True
        start = {n: p.detach().float().cpu() for n, p in policy.model.named_parameters()}
        trainer = InternVLAN1Trainer(exp, policy, total_steps=1)
        if mesh.param_sharding == "fsdp":  # the layers are FSDP groups of their own
            assert hasattr(trainer.model.language_model.layers[0], "reshard")
        before = (fa.kernel_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
        metrics = trainer.train_on_batches([batch])
        launches = (fa.kernel_launches - before[0], fa.bwd_dkv_launches - before[1],
                    fa.bwd_dq_launches - before[2])
        return metrics, trainer.full_state(), launches, start

    plain, plain_state, _, start = run(MeshCfg())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        sharded, state, launches, _ = run(MeshCfg(axes={"dp": 1}, param_sharding="fsdp"))
    finally:
        dist.destroy_process_group()
    layers = cfg.text.num_hidden_layers
    assert launches[0] >= 2 * layers and launches[1] == launches[2] == layers, launches
    for k in ("lm_loss", "s1_loss", "loss", "grad_norm"):
        assert abs(sharded[k] - plain[k]) <= 1e-3 * abs(plain[k]), (k, sharded[k], plain[k])
    mu_p, mu_s = plain_state["opt_state"]["mu"], state["opt_state"]["mu"]
    assert set(mu_p) == set(mu_s) and len(mu_p) > 20
    moved = 0
    for name in mu_p:
        g_p, g_s = mu_p[name].float() / (1 - B1), mu_s[name].float() / (1 - B1)
        new_p = plain_state["params"][name].float()
        new_s = state["params"][name].float()
        reached = (g_p != 0) | (g_s != 0)
        noisy = reached & (g_p.abs() < 4 * (g_p - g_s).abs())
        assert noisy.sum() <= 0.01 * reached.sum(), (name, int(noisy.sum()), int(reached.sum()))
        # one bf16 spacing at the larger updated magnitude: 2^(e - 8), x = m·2^e, m in [0.5, 1)
        _, e = torch.frexp(torch.maximum(new_p.abs(), new_s.abs()))
        tol = 0.02 * lr + torch.exp2(e.float() - 8)
        err = ((new_s - start[name]) - (new_p - start[name])).abs()
        bad = (err > tol) & ~noisy
        assert not bad.any(), (name, int(bad.sum()), float(err[bad].max()))
        moved += int(((new_p - start[name]).abs() >= 0.5 * lr)[reached].sum())
    assert moved > 0.5 * sum(int(((m != 0)).sum()) for m in mu_p.values()), moved


#: card against host for the recurrent policies: fp32 with TF32 off
#: (cuDNN convolutions and LSTMs, cuBLAS GEMMs) through two ResNets and
#: three recurrences
RECURRENT_TOL = 1e-4


@pytest.mark.parametrize("name", ["cma", "seq2seq"])
def test_recurrent_policy_on_the_card_matches_the_host(device, name):
    """CMA and Seq2Seq at small widths (ResNet-18 RGB, the fixed ResNet-50
    depth tower at 256 x 256, hidden 32), the same weights and inputs on the
    card and on the host: logits, states and progress; the per-token text
    padding stays exact zeros on the card (cuDNN's LSTM past each row's
    length is discarded)."""
    from internnav_tpu_torch import model as zoo

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = zoo.get_config(name)
        cfg.text_encoder.rnn_hidden_size, cfg.state_encoder.hidden_size = 8, 32
        cfg.image_encoder.rgb.model_name = "resnet18"
        host = zoo.get_policy(name).build(cfg, device="cpu", seed=0)
        card = zoo.get_policy(name).build(cfg, device=device, seed=0)
        g = torch.Generator().manual_seed(1)
        n, layers = 4, host.num_recurrent_layers()
        tokens = torch.zeros(n, 200, dtype=torch.int32)
        for i, k in enumerate((0, 1, 17, 200)):
            tokens[i, :k] = torch.randint(1, 2504, (k,), generator=g)
        batch = {"observations": {"instruction": tokens,
                                  "rgb": 255 * torch.rand(n, 224, 224, 3, generator=g),
                                  "depth": torch.rand(n, 256, 256, 1, generator=g)},
                 "rnn_states": torch.randn(n, layers, 32, generator=g),
                 "prev_actions": torch.tensor([0, 1, 2, 3]),
                 "masks": torch.tensor([0.0, 1.0, 1.0, 1.0])}
        on_card = {k: ({f: t.to(device) for f, t in v.items()} if isinstance(v, dict)
                       else v.to(device)) for k, v in batch.items()}
        want = host.forward(batch)
        got = card.forward(on_card)
        for w, c in zip(want, got):
            assert torch.isfinite(c).all()
            assert torch.allclose(c.cpu(), w, atol=RECURRENT_TOL, rtol=0), \
                (c.cpu() - w).abs().max().item()
        if name == "cma":
            emb = card.net.instruction_encoder(on_card["observations"]["instruction"]).cpu()
            assert (emb[0] == 0).all() and (emb[2, 17:] == 0).all() and (emb[3] != 0).any()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


#: standalone NavDP and the DPT head, fp32 with TF32 off on both sides: the
#: same math summed in another order by cuBLAS / cuDNN and by the CPU
STANDALONE_NAVDP_TOL = 1e-4
DPT_TOL = 1e-4


def test_standalone_navdp_replan_on_the_card_matches_the_host(device):
    """navdp_cfg at the reference's width (224 x 224 RGB-D, memory 8,
    predict 24, an 8-layer decoder, four ViT-S towers), one pointgoal replan
    of 16 samples with fixed draws, on the card and on the host: the best
    and worst trajectories."""
    from internnav_tpu_torch import model as zoo

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = zoo.get_config("navdp")
        host = zoo.get_policy("navdp").build(cfg, device="cpu", seed=0)
        card = zoo.get_policy("navdp").build(cfg, device=device, seed=0)
        g = torch.Generator().manual_seed(1)
        obs = {"input_images": torch.rand(1, 8, 224, 224, 3, generator=g),
               "input_depths": 5.0 * torch.rand(1, 8, 224, 224, 1, generator=g),
               "goal_point": torch.tensor([[2.0, 0.5, 0.0]])}
        draws = host.net.infer_draws(16, g, "cpu")
        batch = {"mode": "pointgoal", "observations": obs, "sample_num": 16, "draws": draws}
        want = host.forward(batch)
        got = card.forward(dict(batch, draws={k: v.to(device) for k, v in draws.items()}))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for w, c in zip(want, got):
        assert c.shape == (1, 8, 24, 3) and torch.isfinite(c).all()
        err = (c.cpu() - w).abs().max().item()
        assert err <= STANDALONE_NAVDP_TOL, err


def test_dpt_forward_on_the_card_matches_the_host(device):
    """DepthAnythingV2 (ViT-S trunk, the DPT head) at the reference's 518 x
    518 input, seed-0 weights, on the card and on the host."""
    from internnav_tpu_torch.model.encoder.dpt import DepthAnythingV2

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        host = DepthAnythingV2().eval()
        card = DepthAnythingV2().eval()
        card.load_state_dict(host.state_dict())
        card.to(device)
        x = torch.randn(1, 518, 518, 3, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            want, got = host(x), card(x.to(device)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.shape == (1, 518, 518) and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= DPT_TOL * host.max_depth, err
