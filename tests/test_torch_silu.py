"""The port's SiLU against the JAX package's on bf16 (ROADMAP F14).

XLA computes `jax.nn.silu` of a bf16 input as x * (1 / (1 + exp(-x))),
each op rounded to bf16, and flushes subnormals to zero; torch's F.silu
rounds once. `ops/activations.silu` takes XLA's steps and equals
jax.nn.silu on every finite bf16 bit pattern; `silu_mul` equals
`jax.nn.silu(g) * u` (the product rounded to bf16, as a bf16 Dense then
reads it). Before a quantization XLA fuses the product into the fp32
convert, so the int8 SwiGLU input is silu(g) times u in fp32: the plain
SWIGLU quantizer (`quant.swiglu_quantize`) gives JAX's codes exactly. On
fp32 inputs both helpers are F.silu.

The layer-1 K/V codes of the tiny bf16 W8A8 model are counted against
JAX's and the count pinned: F14's repair moved it from 1117 K and 1087 V
codes (of 2048 each) to 1082 and 1077. The rest come from the prefill
attention (ROADMAP F17): XLA reads the rotated q/k at fp32 there (it
drops the bf16 rounding between the rotary and the attention's fp32
convert), the port at bf16, so layer 0's attention output differs by one
bf16 ulp in about a quarter of its elements, and an int8 code flips at a
one-ulp change of its input about half the time.
"""

import numpy as np
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from internnav_tpu_torch.ops import quant
from internnav_tpu_torch.ops.activations import silu, silu_mul
from test_torch_norm_scales_and_cache_writes import (  # noqa: F401 (a fixture)
    _bf16_pair,
    _prefill_both,
    scaled_text_params,
)

torch.set_num_threads(2)


def _all_finite_bf16() -> torch.Tensor:
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    return x[torch.isfinite(x)]


def _jax_bits(fn, *xs: torch.Tensor) -> np.ndarray:
    args = [jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16) for x in xs]
    return np.asarray(jax.jit(fn)(*args).view(jnp.int16))


def _gate_up(seed=0, shape=(64, 4096)):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal(shape) * 3.0).bfloat16(),
            torch.from_numpy(r.standard_normal(shape)).bfloat16())


def test_silu_equals_jax_on_every_finite_bf16_bit_pattern():
    x = _all_finite_bf16()
    assert x.numel() == 65280
    want = _jax_bits(jax.nn.silu, x)
    got = silu(x).view(torch.int16).numpy()
    assert int((got != want).sum()) == 0
    # torch's single rounding differs from XLA's steps (and keeps subnormals)
    assert int((F.silu(x).view(torch.int16).numpy() != want).sum()) > 1000


def test_silu_is_f_silu_on_fp32():
    x = torch.cat([_all_finite_bf16().float(),
                   torch.from_numpy(np.random.default_rng(1).standard_normal(4096) * 5).float()])
    assert torch.equal(silu(x).view(torch.int32), F.silu(x).view(torch.int32))
    g, u = torch.randn(8, 64), torch.randn(8, 64)
    assert torch.equal(silu_mul(g, u), F.silu(g) * u)


def test_silu_mul_equals_jax_swiglu():
    g, u = _gate_up()
    want = _jax_bits(lambda a, b: jax.nn.silu(a) * b, g, u)
    assert int((silu_mul(g, u).view(torch.int16).numpy() != want).sum()) == 0
    assert int(((F.silu(g) * u).view(torch.int16).numpy() != want).sum()) > 10000


def _jax_swiglu_codes(g, u):
    """QuantDense's activation quantization of silu(g) * u, as the down
    projection's input in the JAX package (one jitted function: XLA fuses
    the product into the fp32 convert)."""
    def fn(a, b):
        xf = (jax.nn.silu(a) * b).astype(jnp.float32)
        amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
        scale = jnp.maximum(amax, 1e-8) / 127.0
        return jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8), scale

    args = [jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16) for x in (g, u)]
    q, s = jax.jit(fn)(*args)
    return np.asarray(q), np.asarray(s)


def test_swiglu_quantize_codes_equal_jax():
    g, u = _gate_up(seed=2)
    jq, js = _jax_swiglu_codes(g, u)
    q, s = quant.swiglu_quantize(g, u)
    assert int((q.numpy() != jq).sum()) == 0
    # XLA divides by 127 through a multiply by its reciprocal
    np.testing.assert_allclose(s.numpy(), js, rtol=2**-23, atol=0)
    old, _ = quant.quantize_rows(F.silu(g) * u)  # the quantizer before the repair
    assert int((old.numpy() != jq).sum()) > 1000


def test_silu_mul_keeps_only_its_inputs_for_backward():
    """The bf16 SwiGLU saves gate and up; gate's gradient is the one torch's
    autograd gives F.silu(gate) * up in bf16, up's the incoming gradient
    times silu(gate) as the forward rounded it."""
    g, u = _gate_up(seed=3, shape=(16, 256))
    g.requires_grad_(True)
    u.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = silu_mul(g, u)
    assert len(saved) == 2
    grad = torch.from_numpy(np.random.default_rng(4).standard_normal(y.shape)).bfloat16()
    y.backward(grad)
    g2, u2 = g.detach().clone().requires_grad_(True), u.detach().clone().requires_grad_(True)
    (F.silu(g2) * u2).backward(grad)
    assert g.grad.dtype == torch.bfloat16 and u.grad.dtype == torch.bfloat16
    assert torch.equal(g.grad, g2.grad)
    assert torch.equal(u.grad, grad * silu(g.detach()))


def test_tiny_int8_model_kv_codes_against_jax(scaled_text_params):
    """The tiny bf16 W8A8 + int8-KV model's prefill (the norm-scale test's
    model and prompt): layer 0's K/V codes equal JAX's; layer 1's differ in
    the pinned counts, with F14 repaired and F17 standing (docstring)."""
    jm, params, tm = _bf16_pair(scaled_text_params, weight_dtype="int8", kv_dtype="int8")
    (_, _, tc), (_, _, jc) = _prefill_both(jm, params, tm)
    counts = [[int((td != torch.from_numpy(np.array(jd))).sum())
               for (td, _), (jd, _) in zip(tc[layer], jc[layer])] for layer in (0, 1)]
    assert all(td.numel() == 2048 for td, _ in tc[1])
    assert counts == [[0, 0], [1082, 1077]]


def test_batched_stream_silu_calls_follow_chip_smoke_count(monkeypatch):
    """chip_smoke.py holds serve batched's K8 and K8f launches to
    `expected_batched_launches`: each cohort and cycle, one SiLU a ViT block
    (one vision call), and for each of the System-1 denoises 2 SiLUs a
    velocity (the time embedding's, and the one every NextDiT block's
    AdaLN and the output norm share) and one fused SwiGLU GEMM a NextDiT
    layer and velocity. The same counts of `silu` / `silu_mul` and of
    `swiglu_gemm` calls in a tiny 2 x 2 shared-decode stream on the CPU
    (on the card each call is one K8 or one K8f launch)."""
    import chip_smoke
    from internnav_tpu_torch.model.basemodel.internvla_n1 import nextdit, qwen_vision, serving
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    calls = {"K8": [], "K8f": []}
    for mod, name, key in ((nextdit, "silu", "K8"), (qwen_vision, "silu_mul", "K8"),
                           (nextdit, "swiglu_gemm", "K8f")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _c=calls[key], **k:
                            _c.append(1) or _fn(*a, **k))
    cfg = InternVLAN1Config.tiny("nextdit_async", dtype=torch.float32)
    policy = InternVLAN1Policy.build(cfg, device="cpu")
    server = serving.PipelinedN1Server(policy, 2, cohorts=2)
    frames = np.random.default_rng(0).integers(0, 256, (6, 56, 56, 3)).astype(np.uint8)
    for pol in server.cohorts:
        pol.reset(["go to the door", "stop at the sofa"])
    cycles = 3
    server.serve_stream(lambda ci, t, ph: frames[[(ci + t + ph) % 6, (ci + t + ph + 1) % 6]],
                        cycles, max_new_tokens=5, num_sample_trajs=2,
                        s1_calls=chip_smoke.BATCH_S1_CALLS, shared_decode=True)
    want = chip_smoke.expected_batched_launches(policy, cycles, 2, 2)
    L = len(policy.model.traj_dit.layers)
    denoises = cycles * 2 * chip_smoke.BATCH_S1_CALLS
    assert want["K8f"] == denoises * chip_smoke.S1_STEPS * L
    assert {k: len(c) for k, c in calls.items()} == {k: want[k] for k in calls}
