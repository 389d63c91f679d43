"""The modules of the port's NavDP System-1 (`navdp_async`, `navdp`) held
against the JAX package: `DDPMScheduler`, `SinusoidalPosEmb`,
`causal_mask`, `TransformerDecoderLayer`, the pre- and post-norm
`FormerDecoder` with masks, `TokenCompressor`, `RGBDBackbone` and
`NavDPHead` (async and sync batched, at the tiny config and at the 7B
head's widths with 2 decoder layers). The model, the slice and the
refusals are in tests/test_torch_navdp_slice.py.

Weights are numpy draws in the shape of each JAX param tree, carried to
the port by `model/weights/from_jax.py`; inputs are numpy draws from a
seed; the noise (the starting noise and the per-step ancestral noise) is
JAX's draw, injected into the port. Tolerance: fp32 at atol/rtol 1e-4
(the same math in another summation order); actions exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1.navdp_head import NavDPHead as JNavDPHead
from internnav_tpu.model.encoder import navdp_backbone as jbb
from internnav_tpu.model.encoder import transformer as jtr
from internnav_tpu.ops import schedulers as jsched
from internnav_tpu_torch.model.basemodel.internvla_n1.navdp_head import NavDPHead
from internnav_tpu_torch.model.encoder import navdp_backbone as tbb
from internnav_tpu_torch.model.encoder import transformer as ttr
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.ops import schedulers as tsched
from test_torch_system1 import random_jax_params

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
HW = 56
STEPS = 20  # the head's DDPM steps


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _pair(jmod, tmod, args, seed=0, method=None, **kw):
    """Random numpy params in the shape of jmod's tree (from `method`, the
    flax init's entry), loaded into tmod; returns (params, tmod)."""
    init = (lambda k, *a: jmod.init(k, *a, method=method, **kw)) if method else \
        (lambda k, *a: jmod.init(k, *a, **kw))
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args])
    params = random_jax_params(shapes["params"], seed)
    return params, load_from_jax(tmod, params)


def _run_pair(jmod, tmod, *args, **kw):
    params, tmod = _pair(jmod, tmod, args, **kw)
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kw))(
        params, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        return tmod(*[_t(a) for a in args], **kw), ref


def jax_noise_pair(key, rows, P=8):
    """What JAX's NavDP draws from `key`: the starting noise normal(key)
    and the step noise normal(fold_in(key, 1)) of (STEPS, rows, P, 3)."""
    x0 = jax.random.normal(key, (rows, P, 3))
    zs = jax.random.normal(jax.random.fold_in(key, 1), (STEPS, rows, P, 3))
    return np.array(x0), np.array(zs)


def rgbd(seed, b, hw=HW):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (b, 2, hw, hw, 3)).astype(np.uint8),
            r.uniform(0.0, 5.0, (b, 2, hw, hw, 1)).astype(np.float32))


# --------------------------------------------------------------- modules
@pytest.mark.parametrize("schedule,T", [("squaredcos_cap_v2", 20), ("squaredcos_cap_v2", 10),
                                        ("linear", 20)])
def test_ddpm_scheduler_matches_jax(schedule, T):
    """Betas and alphas_cumprod bit for bit (the same numpy), the
    timesteps, one step at every t, and the whole loop with injected step
    noises."""
    js = jsched.DDPMScheduler(num_train_timesteps=T, beta_schedule=schedule)
    ts = tsched.DDPMScheduler(num_train_timesteps=T, beta_schedule=schedule)
    np.testing.assert_array_equal(ts.betas, np.asarray(js.betas))
    np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
    np.testing.assert_array_equal(ts.timesteps(), np.asarray(js.timesteps()))
    assert ts.timesteps().tolist() == list(range(T - 1, -1, -1))
    r = np.random.default_rng(T)
    x, eps, z = (2.0 * r.standard_normal((3, 5, 3)).astype(np.float32) for _ in range(3))
    for t in range(T):
        ref = js.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), noise=jnp.asarray(z))
        _close(ts.step(_t(eps), t, _t(x), noise=_t(z)), ref)
    x0 = _t(np.abs(eps))
    np.testing.assert_allclose(ts.add_noise(x0, _t(z), torch.tensor([0, T - 1, T // 2])),
                               js.add_noise(jnp.asarray(np.abs(eps)), jnp.asarray(z),
                                            jnp.asarray([0, T - 1, T // 2])), atol=1e-6)
    w = r.standard_normal((3, 3)).astype(np.float32)
    noises = r.standard_normal((T, 3, 5, 3)).astype(np.float32)

    def jeps(x, t):
        return jnp.tanh(x @ w) * (1.0 + t / T)

    ref = jax.jit(lambda x, n: js.denoise_scan(jeps, x, noises=n))(jnp.asarray(x),
                                                                 jnp.asarray(noises))
    out = ts.denoise(lambda x, t: torch.tanh(x @ _t(w)) * (1.0 + t / T), _t(x), _t(noises))
    _close(out, ref)
    with pytest.raises(ValueError, match="noises"):
        ts.denoise(lambda x, t: x, _t(x), _t(noises[:-1]))


def test_sinusoidal_pos_emb_and_causal_mask_match_jax():
    t = np.array([0.0, 3.0, 19.0], np.float32)
    _close(ttr.SinusoidalPosEmb(32)(_t(t)), jtr.SinusoidalPosEmb(32)(jnp.asarray(t)))
    np.testing.assert_array_equal(ttr.causal_mask(6).numpy(), np.asarray(jtr.causal_mask(6)))


def test_transformer_decoder_layer_with_masks_matches_jax():
    """Pre-norm, a causal tgt_mask and a memory key padding mask (one row
    with its last keys masked out)."""
    r = np.random.default_rng(1)
    tgt = r.standard_normal((2, 6, 32)).astype(np.float32)
    mem = r.standard_normal((2, 9, 32)).astype(np.float32)
    kpm = np.zeros((2, 9), bool)
    kpm[1, 6:] = True
    causal = np.tril(np.ones((6, 6), bool))
    out, ref = _run_pair(jtr.TransformerDecoderLayer(32, 4), ttr.TransformerDecoderLayer(32, 4),
                         tgt, mem, causal, kpm)
    _close(out, ref)


@pytest.mark.parametrize("norm_first", [True, False])
def test_former_decoder_with_masks_matches_jax(norm_first):
    """The pre-norm stack NavDP's decoder is (layer_{i}), and the post-norm
    one with the same tgt and memory masks (a memory mask row that sees no
    key gives 0, as torch SDPA does)."""
    r = np.random.default_rng(2)
    tgt = r.standard_normal((2, 5, 32)).astype(np.float32)
    mem = r.standard_normal((2, 7, 32)).astype(np.float32)
    causal = np.tril(np.ones((5, 5), bool))
    mmask = np.ones((5, 7), bool)
    mmask[0] = False
    mmask[3, 4:] = False
    out, ref = _run_pair(jbb.FormerDecoder(32, 4, 2, norm_first=norm_first),
                         tbb.FormerDecoder(32, 4, 2, norm_first=norm_first),
                         tgt, mem, causal, mmask)
    _close(out, ref)


@pytest.mark.parametrize("padded", [False, True])
def test_token_compressor_matches_jax(padded):
    r = np.random.default_rng(3)
    x = r.standard_normal((3, 6, 32)).astype(np.float32)
    args = (x,)
    if padded:
        pad = np.zeros((3, 6), bool)
        pad[1, 4:] = True
        pad[2, 1:] = True
        args = (x, pad)
    out, ref = _run_pair(jbb.TokenCompressor(32, 8, 1), tbb.TokenCompressor(32, 8, 1), *args)
    assert out.shape == (3, 1, 32)
    _close(out, ref)


def test_rgbd_backbone_matches_jax():
    """Two DINOv2 ViT-S towers at 56 x 56 (rgb normalized, depth repeated to
    3 channels un-normalized), the former PE and queries, the post-norm
    former and the projection."""
    rgb, depth = rgbd(4, 2)
    im = rgb.astype(np.float32) / 255.0
    out, ref = _run_pair(jbb.RGBDBackbone(embed_size=32, memory_size=2),
                         tbb.RGBDBackbone(embed_size=32, memory_size=2, image_hw=HW), im, depth)
    assert out.shape == (2, 32, 32)
    _close(out, ref)


# ------------------------------------------------------------------ head
HEADS = {"tiny": dict(memory_size=2, predict_size=8, temporal_depth=2, token_dim=32, heads=4,
                      vlm_token_dim=64),
         "7b_widths_2_layers": dict(memory_size=2, temporal_depth=2, vlm_token_dim=3584)}


@pytest.fixture(scope="module", params=list(HEADS))
def head_pair(request):
    """A NavDP head on both sides, the same weights (from the JAX init's
    `forward_vlm_traj` tree, as the policy's init makes it)."""
    kw = HEADS[request.param]
    jh = JNavDPHead(**kw)
    B, L, P = 2, 3, jh.predict_size
    args = (np.zeros((B, L, kw["vlm_token_dim"]), np.float32),
            np.zeros((B, 2, HW, HW, 3), np.float32), np.zeros((B, 2, HW, HW, 1), np.float32),
            np.zeros((B, P, 3), np.float32))
    shapes = jax.eval_shape(lambda k, *a: jh.init(k, *a, k, method=jh.forward_vlm_traj),
                            jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args])
    params = random_jax_params(shapes["params"], seed=5)
    assert "point_encoder" not in params and "critic_head" not in params
    th = load_from_jax(NavDPHead(image_hw=HW, **kw), params)
    return request.param, jh, params, th


@pytest.mark.parametrize("variant", ["async", "sync"])
def test_navdp_head_batched_matches_jax(head_pair, variant):
    """Two streams x 3 samples through the batched denoise with JAX's draws:
    async over RGBD pairs with a latent mask, sync on the mean-pooled
    latents."""
    name, jh, params, th = head_pair
    D = HEADS[name]["vlm_token_dim"]
    r = np.random.default_rng(6)
    B, ns, P = 2, 3, jh.predict_size
    lat = r.standard_normal((B, 4, D)).astype(np.float32)
    mask = np.ones((B, 4), bool)
    mask[1, 3:] = False
    rgb, depth = rgbd(7, B)
    im = rgb.astype(np.float32) / 255.0
    x0, zs = jax_noise_pair(jax.random.PRNGKey(8), B * ns, P)
    if variant == "async":
        ref = jax.jit(lambda p, *a: jh.apply(
            {"params": p}, *a, jax.random.PRNGKey(0), vlm_mask=jnp.asarray(mask), sample_num=ns,
            x_init=jnp.asarray(x0), step_noises=jnp.asarray(zs),
            method=jh.predict_pointgoal_action_async_batched))(
            params, jnp.asarray(lat), jnp.asarray(im), jnp.asarray(depth))
        with torch.no_grad():
            out = th.predict_pointgoal_action_async_batched(
                _t(lat), _t(im), _t(depth), vlm_mask=_t(mask), sample_num=ns, x_init=_t(x0),
                step_noises=_t(zs))
    else:
        ref = jax.jit(lambda p, a: jh.apply(
            {"params": p}, a, jax.random.PRNGKey(0), sample_num=ns, x_init=jnp.asarray(x0),
            step_noises=jnp.asarray(zs), method=jh.predict_pointgoal_action_batched))(
            params, jnp.asarray(lat))
        with torch.no_grad():
            out = th.predict_pointgoal_action_batched(_t(lat), sample_num=ns, x_init=_t(x0),
                                                      step_noises=_t(zs))
    assert out.shape == (B * ns, P, 3) and out.dtype == torch.float32
    _close(out, ref)


def test_navdp_head_is_fp32_on_bf16_latents(head_pair):
    """bf16 latents go through the fp32 head (flax promotes them at the
    first Dense): the same result as their fp32 values."""
    name, _, _, th = head_pair
    D = HEADS[name]["vlm_token_dim"]
    lat = torch.randn(1, 2, D, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    x0 = torch.randn(2, th.predict_size, 3, generator=torch.Generator().manual_seed(1))
    zs = torch.randn(STEPS, 2, th.predict_size, 3, generator=torch.Generator().manual_seed(2))
    assert {p.dtype for p in th.parameters()} == {torch.float32}
    with torch.no_grad():
        a = th.predict_pointgoal_action_batched(lat, x_init=x0, step_noises=zs, sample_num=2)
        b = th.predict_pointgoal_action_batched(lat.float(), x_init=x0, step_noises=zs,
                                                sample_num=2)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
