"""Port ops (internnav_tpu_torch.ops) held against the JAX package's ops.

Inputs are drawn with numpy from a seed and fed to both packages. The JAX
flash kernel runs in Pallas interpret mode on the CPU, as
tests/test_ops_attention.py runs it. Tolerances: fp32 at atol/rtol 1e-4
(same math, different summation order); integer index tables exactly.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from internnav_tpu.ops.schedulers import FlowMatchEulerScheduler as JFlowMatch
from internnav_tpu_torch.ops import flash_attention as fa
from internnav_tpu_torch.ops import rope
from internnav_tpu_torch.ops.schedulers import FlowMatchEulerScheduler

torch.set_num_threads(2)
# the JAX ops package re-exports functions under the module names
jfa = importlib.import_module("internnav_tpu.ops.flash_attention")
jrope = importlib.import_module("internnav_tpu.ops.rope")
ATOL = RTOL = 1e-4  # fp32 on both sides; only the summation order differs


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def _qkv(seed, B, H, T, D, KV=None, Tk=None):
    r = np.random.default_rng(seed)
    KV = KV or H
    Tk = Tk or T
    return (r.standard_normal((B, H, T, D)).astype(np.float32),
            r.standard_normal((B, KV, Tk, D)).astype(np.float32),
            r.standard_normal((B, KV, Tk, D)).astype(np.float32))


def _segments(B, T):
    seg = np.zeros((B, T), np.int32)
    seg[0, T // 3:] = 1
    seg[0, T - 17:] = 2
    if B > 1:
        seg[1, T // 2:] = 5
    return seg


@pytest.mark.parametrize("causal,segmented", [(True, False), (False, True), (True, True)])
def test_flash_attention_cpu_path_matches_pallas_kernel(causal, segmented):
    """Port flash_attention on CPU tensors (the plain version) against the
    Pallas kernel in interpret mode: o and the per-row logsumexp."""
    B, H, T, D = 2, 2, 128, 32
    q, k, v = _qkv(0, B, H, T, D)
    seg = _segments(B, T) if segmented else None
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if seg is None else jnp.asarray(seg), None if seg is None else jnp.asarray(seg),
            causal=causal, sm_scale=D ** -0.5, block_q=64, block_k=64)
    tseg = None if seg is None else _t(seg)
    o = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, segment_ids=tseg)
    _close(o, jo)
    _, lse = fa.mha_reference(_t(q), _t(k), _t(v), causal=causal, segment_ids=tseg,
                              return_lse=True)
    _close(lse, np.asarray(jlse)[..., 0])


def test_flash_attention_ragged_length_matches_reference():
    """T with no power-of-two divisor: the JAX wrapper drops to its XLA
    reference there; the port (and its kernel) masks the ragged tail."""
    B, H, T, D = 1, 3, 77, 16
    q, k, v = _qkv(1, B, H, T, D)
    seg = np.zeros((B, T), np.int32)
    seg[:, 70:] = 1
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                            segment_ids=jnp.asarray(seg))
    _close(fa.flash_attention(_t(q), _t(k), _t(v), causal=True, segment_ids=_t(seg)), ref)


def test_flash_attention_gqa_unrepeated_matches_repeated():
    """KV heads read in place (h // G) equal the JAX jnp.repeat form."""
    B, H, KV, T, D = 1, 6, 2, 64, 16
    q, k, v = _qkv(2, B, H, T, D, KV=KV)
    seg = _segments(B, T)
    rep = lambda a: jnp.repeat(jnp.asarray(a), H // KV, axis=1)  # noqa: E731
    ref = jfa.mha_reference(jnp.asarray(q), rep(k), rep(v), causal=True,
                            segment_ids=jnp.asarray(seg))
    _close(fa.flash_attention(_t(q), _t(k), _t(v), causal=True, segment_ids=_t(seg)), ref)


def test_causal_conventions_agree_only_when_square():
    """The plain version is bottom-right causal (as the JAX reference), the
    kernel top-left; flash_attention refuses causal with Tq != Tk."""
    q, k, v = _qkv(3, 1, 2, 32, 16)
    top_left = fa.mha_reference(_t(q), _t(k), _t(v), causal=True)
    _close(fa.flash_attention(_t(q), _t(k), _t(v), causal=True), top_left)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention(_t(q[:, :, :16]), _t(k), _t(v), causal=True)
    ref = jfa.mha_reference(jnp.asarray(q[:, :, :16]), jnp.asarray(k), jnp.asarray(v),
                            causal=True)
    _close(fa.mha_reference(_t(q[:, :, :16]), _t(k), _t(v), causal=True), ref)


def test_fully_masked_rows_give_zero_and_minus_inf_lse():
    B, H, T, D = 1, 2, 8, 16
    q, k, v = _qkv(4, B, H, T, D)
    qseg = np.zeros((B, T), np.int32)
    qseg[:, 5:] = 9  # no key carries segment 9
    kseg = np.zeros((B, T), np.int32)
    o, lse = fa.mha_reference(_t(q), _t(k), _t(v), segment_ids=_t(qseg),
                              kv_segment_ids=_t(kseg), return_lse=True)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg))
    _close(o, ref)
    assert torch.all(o[:, :, 5:] == 0) and torch.all(torch.isneginf(lse[:, :, 5:]))
    assert torch.all(torch.isfinite(lse[:, :, :5]))


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (_t(a) for a in _qkv(5, 1, 2, 16, 80))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16())
    before = fa.kernel_launches
    fa.flash_attention(q, k, v)
    assert fa.kernel_launches == before  # the plain version launches nothing


def _bad_tables(kind, good):
    q_tab, kv_tab = good
    return {"shape": (q_tab[:, :2].contiguous(), kv_tab),
            "dtype": (q_tab, kv_tab.long()),
            "device": (q_tab.to("meta"), kv_tab)}[kind]


@pytest.mark.parametrize("kind", ["shape", "dtype", "device"])
def test_wrappers_reject_tile_tables_the_kernels_do_not_take(kind):
    """K1's wrapper, the dispatcher and the backward wrappers refuse tables
    of another shape, dtype or device before anything else; right tables
    pass that check (the CPU tensors then fail the kernel's device check)."""
    q, k, v = (_t(a).bfloat16() for a in _qkv(6, 1, 2, 130, 128))
    seg = torch.zeros((1, 130), dtype=torch.int32)
    seg[:, 100:] = 1
    good = fa.segment_tile_tables(seg)
    bad = _bad_tables(kind, good)
    lse = torch.zeros((1, 2, 130))
    with pytest.raises(ValueError, match="tile tables"):
        fa.flash_attention_cuda(q, k, v, segment_ids=seg, tile_tables=bad)
    with pytest.raises(ValueError, match="tile tables"):
        fa.flash_attention(q.float(), k.float(), v.float(), segment_ids=seg, tile_tables=bad)
    with pytest.raises(ValueError, match="tile tables"):
        fa.flash_bwd_dkv_cuda(q, k, v, q, lse, lse, segment_ids=seg, tile_tables=bad)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v, segment_ids=seg, tile_tables=good)


def test_tile_tables_leave_the_cpu_path_unchanged():
    q, k, v = (_t(a) for a in _qkv(7, 1, 2, 130, 16))
    seg = torch.as_tensor(_segments(1, 130))
    tabs = fa.segment_tile_tables(seg)
    assert torch.equal(fa.flash_attention(q, k, v, causal=True, segment_ids=seg, tile_tables=tabs),
                       fa.flash_attention(q, k, v, causal=True, segment_ids=seg))
    with pytest.raises(ValueError, match="without segment ids"):
        fa.flash_attention(q, k, v, tile_tables=tabs)


def test_kernel_build_asks_for_nvcc_only_when_building(monkeypatch, tmp_path):
    """The ops import without a CUDA compiler; a build request without one
    raises, and the library name follows the source and flags."""
    from internnav_tpu_torch.ops import _build

    path = _build.library_path("flash_fwd.cu")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("flash_fwd_")
    assert path == _build.library_path("flash_fwd.cu")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("flash_fwd.cu")


def test_kernel_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """Editing a shared header `csrc/*.cuh` renames (so rebuilds) every
    library; editing one source renames only its own."""
    from internnav_tpu_torch.ops import _build

    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build.library_path(s) for s in ("flash_fwd.cu", "flash_bwd.cu")}
    assert before["flash_bwd.cu"] == _build.library_path("flash_bwd.cu")
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build.library_path(s) for s in before}
    assert all(after[s] != before[s] for s in before)
    (tmp_path / "flash_fwd.cu").write_text((tmp_path / "flash_fwd.cu").read_text() + "\n")
    assert _build.library_path("flash_fwd.cu") != after["flash_fwd.cu"]
    assert _build.library_path("flash_bwd.cu") == after["flash_bwd.cu"]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("scaled", [False, True])
def test_gqa_decode_attention_matches_jax(n, scaled):
    """With scaled=True the caches carry per-token dequant scales (the int8
    KV interface; here on float data)."""
    B, H, KV, Tmax, D = 2, 6, 2, 24, 16
    r = np.random.default_rng(6)
    q = r.standard_normal((B, H, n, D)).astype(np.float32)
    kc = r.standard_normal((B, KV, Tmax, D)).astype(np.float32)
    vc = r.standard_normal((B, KV, Tmax, D)).astype(np.float32)
    cl = np.array([5, 17], np.int32)
    scales = {}
    if scaled:
        scales = {name: r.uniform(0.01, 0.05, (B, KV, Tmax)).astype(np.float32)
                  for name in ("k_scale", "v_scale")}
    jscales = {k: jnp.asarray(v) for k, v in scales.items()}
    tscales = {k: _t(v) for k, v in scales.items()}
    if n == 1:
        ref = jfa.gqa_decode_attention(jnp.asarray(q[:, :, 0]), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(cl), **jscales)
        out = fa.gqa_decode_attention(_t(q[:, :, 0]), _t(kc), _t(vc), _t(cl), **tscales)
    else:
        ref = jfa.gqa_chunk_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                             jnp.asarray(vc), jnp.asarray(cl), **jscales)
        out = fa.gqa_chunk_decode_attention(_t(q), _t(kc), _t(vc), _t(cl), **tscales)
    _close(out, ref)


def test_decode_attention_and_cu_seqlens_match_jax():
    B, H, Tmax, D = 2, 3, 20, 8
    r = np.random.default_rng(7)
    q = r.standard_normal((B, H, D)).astype(np.float32)
    kc = r.standard_normal((B, H, Tmax, D)).astype(np.float32)
    vc = r.standard_normal((B, H, Tmax, D)).astype(np.float32)
    cl = np.array([3, 20], np.int32)
    _close(fa.decode_attention(_t(q), _t(kc), _t(vc), _t(cl)),
           jfa.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(cl)))
    cu = np.array([0, 5, 11, 16])
    np.testing.assert_array_equal(fa.segment_ids_from_cu_seqlens(_t(cu), 16).numpy(),
                                  np.asarray(jfa.segment_ids_from_cu_seqlens(jnp.asarray(cu), 16)))


def test_rope_and_mrope_match_jax():
    pos = np.random.default_rng(8).integers(0, 900, (3, 2, 11))
    for ours, ref in zip(rope.mrope_cos_sin(_t(pos), 16, (2, 3, 3)),
                         jrope.mrope_cos_sin(jnp.asarray(pos), 16, (2, 3, 3))):
        _close(ours, ref)
    for ours, ref in zip(rope.rope_cos_sin(_t(pos[0]), 32, 1e6),
                         jrope.rope_cos_sin(jnp.asarray(pos[0]), 32, 1e6)):
        _close(ours, ref)
    x = np.random.default_rng(9).standard_normal((2, 3, 5, 8)).astype(np.float32)
    _close(rope.rotate_half(_t(x)), jrope.rotate_half(jnp.asarray(x)))


def test_get_rope_index_25_equals_jax():
    img = 151655
    ids = np.array([[1, 2, 151652] + [img] * 16 + [151653, 7, 8, 151652] + [img] * 4
                    + [151653, 9]])
    grid = np.array([[1, 8, 8], [1, 4, 4]])
    ours = rope.get_rope_index_25(ids, grid)
    ref = jrope.get_rope_index_25(ids, grid)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_flow_match_euler_with_injected_noise():
    """Same x_init and velocity function → same Euler trajectory."""
    x0 = np.random.default_rng(10).standard_normal((4, 8, 3)).astype(np.float32)
    w = np.random.default_rng(11).standard_normal((3, 3)).astype(np.float32) * 0.1
    ref = JFlowMatch().denoise_scan(lambda x, t: x @ jnp.asarray(w) + t / 1000.0,
                                    jnp.asarray(x0), 10)
    ours = FlowMatchEulerScheduler().denoise(lambda x, t: x @ _t(w) + t / 1000.0, _t(x0), 10)
    _close(ours, ref)


# ----------------------------------------------------------------- backward
BWD_CASES = {  # name: (H, KV, causal, q segments, kv segments)
    "causal": (2, 2, True, None, None),
    "full": (2, 2, False, None, None),
    "packed_causal": (2, 2, True, "packed", "packed"),
    "gqa_packed_causal": (4, 2, True, "packed", "packed"),
    "fully_masked_rows": (2, 2, False, "masked", "packed"),
}


def _bwd_segments(kind, T):
    if kind is None:
        return None
    seg = np.zeros((1, T), np.int32)
    seg[:, T // 3:] = 1
    seg[:, T - 40:] = 2
    if kind == "masked":
        seg[:, T - 16:] = 9  # no key carries segment 9: o = 0, lse = -inf
    return seg


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_backward_matches_pallas_backward(case):
    """The port's plain backward (`flash_backward_reference`, from the
    forward's o and lse) and the autograd of its CPU `flash_attention`,
    against the JAX `_flash_attention` gradient with the Pallas dK/dV and
    dQ kernels in interpret mode. The JAX side takes K/V repeated per query
    head (as its prefill does); its dK/dV are summed over each group here.
    fp32 on both sides: atol/rtol 1e-4."""
    H, KV, causal, qkind, kkind = BWD_CASES[case]
    B, T, D = 1, 128, 32
    q, k, v = _qkv(20, B, H, T, D, KV=KV)
    do = np.random.default_rng(21).standard_normal((B, H, T, D)).astype(np.float32)
    qseg, kseg = _bwd_segments(qkind, T), _bwd_segments(kkind, T)
    G = H // KV
    sm = D ** -0.5
    jseg = None if qseg is None else jnp.asarray(qseg)
    jkseg = None if kseg is None else jnp.asarray(kseg)

    def f(q_, k_, v_):
        return jfa._flash_attention(q_, k_, v_, jseg, jkseg, causal, sm, 64, 64)

    rep = lambda a: jnp.repeat(jnp.asarray(a), G, axis=1)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(q), rep(k), rep(v))
        jdq, jdk, jdv = vjp(jnp.asarray(do))
    sum_groups = lambda g: np.asarray(g).reshape(B, KV, G, T, D).sum(2)  # noqa: E731
    want = (np.asarray(jdq), sum_groups(jdk), sum_groups(jdv))

    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tseg = None if qseg is None else _t(qseg)
    tkseg = None if kseg is None else _t(kseg)
    o = fa.flash_attention(tq, tk, tv, causal=causal, segment_ids=tseg, kv_segment_ids=tkseg)
    autograd = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    o, lse = fa.mha_reference(_t(q), _t(k), _t(v), causal=causal, segment_ids=tseg,
                              kv_segment_ids=tkseg, return_lse=True)
    plain = fa.flash_backward_reference(_t(q), _t(k), _t(v), tseg, tkseg, o, lse, _t(do), causal)
    for name, a, p, w in zip(("dq", "dk", "dv"), autograd, plain, want):
        _close(p, w)
        _close(a, w)
    if case == "fully_masked_rows":
        assert torch.all(plain[0][:, :, T - 16:] == 0) and torch.all(torch.isneginf(lse[:, :, T - 16:]))


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = (_t(a).bfloat16() for a in _qkv(22, 1, 2, 16, 128))
    lse = torch.zeros((1, 2, 16))
    for fn in (fa.flash_bwd_dkv_cuda, fa.flash_bwd_dq_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, q, lse, lse)
    before = (fa.bwd_dkv_launches, fa.bwd_dq_launches)
    tq = _t(_qkv(22, 1, 2, 16, 128)[0]).requires_grad_()
    fa.flash_attention(tq, tq, tq, causal=True).sum().backward()
    assert (fa.bwd_dkv_launches, fa.bwd_dq_launches) == before  # autograd of the plain version


def test_flow_match_training_noise_matches_jax():
    r = np.random.default_rng(12)
    x0 = r.standard_normal((3, 8, 3)).astype(np.float32)
    noise = r.standard_normal((3, 8, 3)).astype(np.float32)
    t = np.array([0, 417, 999], np.int32)
    ours, ref = FlowMatchEulerScheduler(), JFlowMatch()
    _close(ours.add_noise(_t(x0), _t(noise), _t(t)),
           ref.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    _close(ours.velocity_target(_t(x0), _t(noise)),
           ref.velocity_target(jnp.asarray(x0), jnp.asarray(noise)))
