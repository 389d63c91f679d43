"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: each test skips without a CUDA device. On a machine with one
(no jax needed there):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances: o within atol/rtol 2e-2 (bf16 output, P rounded to bf16 for
the P.V product); lse within 1e-3 (fp32 statistics from the same bf16
inputs), -inf on exactly the rows the plain version marks fully masked.
"""

import pytest
import torch

from internnav_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
O_TOL = 2e-2
LSE_TOL = 1e-3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(device, *shape, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)


def _check(q, k, v, seg=None, kv_seg=None, causal=False):
    before = fa.kernel_launches
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg,
                                     kv_segment_ids=kv_seg)
    assert fa.kernel_launches == before + 1
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
