"""System-1's SiLU gradients (ROADMAP F29), the shared AdaLN SiLU and the
K8f dispatch of NextDiT's feed-forward, on the CPU.

- F29: K8 returns a tensor with no autograd history, so a bf16 `silu`
  that needs a gradient goes through `_SiluBf16`, whose backward is the
  one torch's autograd gives `F.silu` in bf16 (bitwise here); jax.grad of
  jax.nn.silu rounds each step of its backward to bf16 (the sigmoid, 1 -
  s, the products, the sum), where torch rounds once: the two differ by
  at most 2^-5 of the incoming gradient (measured 0.023; silu' lies in
  [-0.1, 1.1], and its sum s + x s (1 - s) cancels near x = -1.28, so a
  relative bound would not hold there).
- A tiny bf16 NextDiT whose SiLU kernel entry is replaced by a detached
  stand-in (what the CUDA kernel returns) still gives every parameter a
  gradient, equal bitwise to the unreplaced run's.
- NextDiT takes one SiLU of its conditioning per forward (K8 2 launches a
  velocity on the card, with the time embedding's) and runs its
  feed-forward through `swiglu_gemm` (K8f on the card) where no gradient
  is recorded; on the CPU that dispatch is the plain version, bitwise
  `silu_mul_reference(F.linear(x, W1), F.linear(x, W3))`. The bf16 NextDiT
  stays within bf16 tolerances of the JAX package's (its fp32 parity is
  tests/test_torch_system1.py's, at 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import nextdit as jnd
from internnav_tpu_torch.model.basemodel.internvla_n1 import nextdit as tnd
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.ops import activations as act

torch.set_num_threads(2)
GRAD_TOL = 2.0 ** -5  # of |incoming gradient|: XLA's bf16 steps in the backward
# bf16 NextDiT against JAX's: the same bf16 roundings of every Dense and
# SiLU, fp32 sums in another order (a bf16 ulp here and there, carried
# through 2 blocks)
BF16_ATOL = BF16_RTOL = 5e-2


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jax_bf16(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def test_silu_bf16_is_tracked_and_its_gradient_is_torchs():
    r = np.random.default_rng(0)
    x = _bf16(r.standard_normal(4096) * 4.0)
    x[:6] = torch.tensor([0.0, -0.0, 1e-39, -87.5, 90.0, -100.0])
    g = _bf16(r.standard_normal(4096))
    xa = x.clone().requires_grad_(True)
    y = act.silu(xa)
    assert y.grad_fn is not None and y.dtype == torch.bfloat16
    assert torch.equal(y.detach(), act.silu_reference(x))
    y.backward(g)
    xb = x.clone().requires_grad_(True)
    F.silu(xb).backward(g)
    assert xa.grad.dtype == torch.bfloat16
    assert torch.equal(xa.grad.view(torch.int16), xb.grad.view(torch.int16))
    _, vjp = jax.vjp(jax.nn.silu, _jax_bf16(x))
    (want,) = vjp(_jax_bf16(g))
    gap = np.abs(xa.grad.float().numpy() - np.asarray(want, np.float32))
    assert (gap <= GRAD_TOL * np.abs(g.float().numpy())).all()
    # outside grad the call stays the plain one, with no history
    with torch.no_grad():
        assert act.silu(xa).grad_fn is None


def _tiny_bf16_nextdit(seed=0):
    torch.manual_seed(seed)
    cfg = tnd.NextDiTConfig.tiny()
    assert cfg.dtype == torch.bfloat16
    model = tnd.NextDiT(cfg)
    with torch.no_grad():  # nonzero cross-attention gates, so that branch trains too
        for layer in model.layers:
            layer.gate.fill_(0.3)
    r = np.random.default_rng(seed + 1)
    x = torch.from_numpy(r.standard_normal((4, 8, cfg.dim)).astype(np.float32))
    t = torch.tensor([900.0, 100.0])
    z = torch.from_numpy(r.standard_normal((2, 5, cfg.latent_embedding_size)).astype(np.float32))
    proj = torch.from_numpy(r.standard_normal((4, 8, cfg.dim)).astype(np.float32))
    return model, (x, t, z), proj


def _grads(model, inputs, proj):
    model.zero_grad(set_to_none=True)
    out = model(*inputs, num_samples=2)
    (out.float() * proj).sum().backward()
    return {n: None if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}


def test_nextdit_trains_every_parameter_through_a_detached_silu_kernel(monkeypatch):
    """The card's SiLU kernel returns a tensor without history: with its
    entry replaced by such a stand-in, the backward still reaches every
    parameter (the time embedding's too) with the plain path's gradients."""
    model, inputs, proj = _tiny_bf16_nextdit()
    plain = _grads(model, inputs, proj)
    assert all(g is not None for g in plain.values())
    entry = act._silu_mul_bf16

    def detached(gate, up=None):
        return entry(gate.detach(), None if up is None else up.detach())

    monkeypatch.setattr(act, "_silu_mul_bf16", detached)
    got = _grads(model, inputs, proj)
    missing = sorted(n for n, g in got.items() if g is None)
    assert not missing, f"no gradient for {missing}"
    for n, g in got.items():
        assert torch.equal(g, plain[n]), n
    assert all(bool(plain[n].abs().max() > 0) for n in plain if "time_caption_embed" in n)


def _count(monkeypatch, names, module=tnd):
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def spy(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, n, spy)
    return calls


def test_nextdit_shares_one_silu_and_runs_its_feed_forward_as_one_call(monkeypatch):
    """A velocity with no gradient recorded: 2 SiLUs (the time embedding's
    and the conditioning's, shared by every block and the output norm) and
    one `swiglu_gemm` a layer, which calls no `silu_mul`; with a gradient
    `swiglu_gemm` keeps the two products and `silu_mul`. Both give the same
    output, bitwise, as a per-block SiLU would."""
    model, (x, t, z), _ = _tiny_bf16_nextdit()
    calls = _count(monkeypatch, ("silu", "swiglu_gemm"))
    inner = _count(monkeypatch, ("silu_mul",), module=act)
    with torch.no_grad():
        out = model(x, t, z, num_samples=2)
    L = len(model.layers)
    assert calls == {"silu": 2, "swiglu_gemm": L} and inner == {"silu_mul": 0}
    for c in (calls, inner):
        for n in c:
            c[n] = 0
    trained = model(x, t, z, num_samples=2)
    assert calls == {"silu": 2, "swiglu_gemm": L} and inner == {"silu_mul": L}
    assert torch.equal(trained.detach(), out)

    # the JAX package's structure: a SiLU in every block and for the output norm
    dt = model.cfg.dtype
    with torch.no_grad():
        cond = model.caption_fc2(F.gelu(model.caption_fc1(z.to(dt)), approximate="tanh"))
        temb = model.time_caption_embed(t, cond).to(dt)
        h = x.to(dt)
        for layer in model.layers:
            h = layer(h, cond, act.silu(temb), 2)
        scale = model.norm_out_linear(act.silu(temb)).repeat_interleave(2, dim=0)
        ref = model.norm_out_linear2((model.norm_out_ln(h) * (1 + scale[:, None])).to(dt))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_feed_forward_dispatch_is_plain_on_the_cpu(monkeypatch, dtype):
    """LuminaFeedForward calls `swiglu_gemm`; on the CPU its bf16 dispatch
    is `swiglu_gemm_reference`, bitwise silu_mul_reference(F.linear(x, W1),
    F.linear(x, W3)); on fp32 it is F.silu of the first product times the
    second. Under grad it is differentiable and gives the same numbers."""
    torch.manual_seed(4)
    ffn = tnd.LuminaFeedForward(32, 16, dtype)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 7, 32)).astype(np.float32))
    calls = _count(monkeypatch, ("swiglu_gemm",))
    xd = x.to(dtype)
    w1, w3 = ffn.linear_1.weight.detach(), ffn.linear_3.weight.detach()
    if dtype == torch.bfloat16:
        inner = act.silu_mul_reference(F.linear(xd, w1), F.linear(xd, w3))
        assert torch.equal(act.swiglu_gemm(xd, w1, w3), inner)
        assert torch.equal(act.swiglu_gemm_reference(xd, w1, w3), inner)
    else:
        inner = F.silu(F.linear(xd, w1)) * F.linear(xd, w3)
    with torch.no_grad():
        got = ffn(x)
        want = ffn.linear_2(inner)
    assert calls == {"swiglu_gemm": 1}
    assert got.shape == (3, 7, 32) and torch.equal(got, want)
    trained = ffn(x)  # the training path: silu_mul of the two products
    assert trained.grad_fn is not None and torch.equal(trained.detach(), want)
    assert calls == {"swiglu_gemm": 2}


def test_swiglu_gemm_cuda_refuses_cpu_tensors():
    x, w = torch.zeros(4, 16, dtype=torch.bfloat16), torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        act.swiglu_gemm_cuda(x, w, w)


def test_bf16_nextdit_stays_near_jax():
    """The tiny bf16 NextDiT (the JAX package's own default dtype) against
    JAX's on the same weights and inputs, with the SiLU shared across the
    blocks on the port's side."""
    r = np.random.default_rng(7)
    B, ns, T = 2, 2, 8
    jcfg, tcfg = jnd.NextDiTConfig.tiny(), tnd.NextDiTConfig.tiny()
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    x = r.standard_normal((B * ns, T, jcfg.dim)).astype(np.float32)
    t = np.array([900.0, 100.0], np.float32)
    z = r.standard_normal((B, 5, jcfg.latent_embedding_size)).astype(np.float32)
    jm = jnd.NextDiT(jcfg)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    params = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, num_samples=ns))(
        *args)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 if path[-1].key == "gate" else a, params)
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, num_samples=ns))(params, *args)
    tm = load_from_jax(tnd.NextDiT(dataclasses.replace(tcfg)), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(z), num_samples=ns)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.parametrize("kernel_like", [False, True], ids=["plain", "detached_silu"])
def test_train_step_gradients_pass_chip_smokes_check(tmp_path, monkeypatch, kernel_like):
    """chip_smoke's train phase reads the first step's gradients before the
    update (`gradient_report`) and holds them to `check_train_gradients`:
    every trainable parameter but System-1's memory path's holds a finite
    gradient, the time embedding's nonzero. A tiny bf16 `nextdit_async`
    trainer passes it, also with the SiLU kernel entry replaced by a
    detached stand-in, as the card's kernel returns."""
    import chip_smoke
    from internnav_tpu_torch.configs.trainer import ExpCfg
    from internnav_tpu_torch.dataset.internvla_n1_dataset import write_synthetic_n1_dataset
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.trainer import train_n1
    from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer

    if kernel_like:
        entry = act._silu_mul_bf16
        monkeypatch.setattr(act, "_silu_mul_bf16", lambda g, up=None: entry(
            g.detach(), None if up is None else up.detach()))
    store = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=2, T=6, hw=28)
    cfg = dataclasses.replace(InternVLAN1Config.tiny("nextdit_async", dtype=torch.bfloat16),
                              s1_image_hw=28)
    policy = InternVLAN1Policy.build(cfg, device="cpu")
    assert policy.model.traj_dit.cfg.dtype == torch.bfloat16
    trainer = InternVLAN1Trainer(ExpCfg(name="grads", output_dir=str(tmp_path / "out")), policy,
                                 total_steps=1, tune_llm=True, tune_mm_vision=False)
    batch = trainer.prepare_batch(next(train_n1.make_batch_iter(store, policy, cfg, 2, 256, 2,
                                                                28)))
    grads, step = {}, trainer.optimizer.step

    def step_reading_grads():
        grads.update(chip_smoke.gradient_report(trainer.optimizer.params))
        return step()

    trainer.optimizer.step = step_reading_grads
    trainer.train_step(batch)
    counts = chip_smoke.check_train_gradients(grads)
    assert counts["with_grad"] > 0 and counts["s1_memory_without"] > 0
    # without the repair the time embedding's gradients are gone, and the check fails
    grads.update({n: None for n in grads if "time_caption_embed" in n})
    with pytest.raises(AssertionError):
        chip_smoke.check_train_gradients(grads)
