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
