"""Port System-1 (`nextdit_async`) modules held against the JAX package:
DinoViT, MemoryEncoder, QFormer, NextDiT and the whole
`generate_traj_nextdit` denoise with the same injected noise.

Weights pass from the JAX init through `model/weights/from_jax.py`; inputs
are numpy draws from a seed. Tolerance: fp32 at atol/rtol 1e-4 (same math,
different summation order). The JAX tiny model hard-codes a bf16 NextDiT;
the tests swap in an fp32 NextDiT config so that both sides run fp32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import nextdit as jnd
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu.model.encoder.navdp_backbone import FormerDecoder as JFormerDecoder
from internnav_tpu.model.encoder.transformer import TransformerEncoderLayer as JEncoderLayer
from internnav_tpu.model.encoder.vit import DinoViT as JDinoViT
from internnav_tpu_torch.model.basemodel.internvla_n1 import model as tmodel
from internnav_tpu_torch.model.basemodel.internvla_n1 import nextdit as tnd
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import build_model
from internnav_tpu_torch.model.encoder.navdp_backbone import FormerDecoder
from internnav_tpu_torch.model.encoder.transformer import TransformerEncoderLayer
from internnav_tpu_torch.model.encoder.vit import DinoViT
from internnav_tpu_torch.model.weights.from_jax import load_from_jax

torch.set_num_threads(2)
ATOL = RTOL = 1e-4


class F32NextDiTConfig(jnd.NextDiTConfig):
    """The JAX tiny NextDiT at fp32 (its own default is bf16)."""

    @classmethod
    def tiny(cls):
        return dataclasses.replace(jnd.NextDiTConfig.tiny(), dtype=jnp.float32)


def f32_config(system1="nextdit_async"):
    cfg = jmodel.InternVLAN1Config.tiny(system1)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, dtype=jnp.float32),
                               vision=dataclasses.replace(cfg.vision, dtype=jnp.float32))


@pytest.fixture(scope="module", autouse=True)
def fp32_jax_nextdit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        yield


def random_jax_params(shapes, seed=0):
    """numpy draws in the structure of a JAX param tree (`jax.eval_shape`
    of its init): quicker than compiling the flax init, and with non-zero
    biases, gates and layer scales and non-unit norm scales, so that every
    parameter's mapping shows in the outputs."""
    r = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "kernel":
            a = r.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * r.standard_normal(shape)
        elif name in ("bias", "ls1", "ls2", "gate"):
            a = 0.3 * r.standard_normal(shape)
        else:  # embeddings, learned queries, position tables
            a = r.standard_normal(shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def n1_params(jm, cfg, seed=0):
    shapes = jax.eval_shape(lambda k: JPolicy._init_params(jm, cfg, k, 56), jax.random.PRNGKey(0))
    return random_jax_params(shapes, seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _run_pair(jmod, tmod, *args, **kw):
    """Init the flax module on args, load its params into the torch module,
    run both; returns (torch out, jax out)."""
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kw))(*jargs)["params"]
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kw))(params, *jargs)
    load_from_jax(tmod, params)
    with torch.no_grad():
        return tmod(*[_t(a) for a in args], **kw), ref


def test_dino_vit_same_padding_matches_jax():
    """50 px is not a multiple of 14: flax pads SAME, and so must the port."""
    pix = np.random.default_rng(0).standard_normal((2, 50, 50, 3)).astype(np.float32)
    out, ref = _run_pair(JDinoViT(dim=32, depth=2, heads=4), DinoViT(32, 2, 4, image_hw=50), pix)
    assert out.shape == (2, 16, 32)
    _close(out, ref)


@pytest.mark.parametrize("norm_first,activation", [(True, "gelu"), (False, "relu"),
                                                    (True, "mish")])
def test_transformer_encoder_layer_with_masks_matches_jax(norm_first, activation):
    """Pre/post-norm, each activation (gelu is the exact erf form), with a
    key padding mask and a boolean attention mask holding a fully masked row."""
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    kpm = np.zeros((2, 7), bool)
    kpm[1, 5:] = True
    attn = np.tril(np.ones((7, 7), bool), -1)  # row 0 sees no key
    jl = JEncoderLayer(32, 4, dim_feedforward=48, norm_first=norm_first, activation=activation)
    tl = TransformerEncoderLayer(32, 4, dim_feedforward=48, norm_first=norm_first,
                                 activation=activation)
    _close(*_run_pair(jl, tl, x, kpm, attn))


def test_former_decoder_layernorm_eps_matches_flax():
    """Inputs at 1e-3 scale put the LayerNorm variance near its eps: torch's
    default 1e-5 would differ from flax's 1e-6 here."""
    r = np.random.default_rng(7)
    tgt = 1e-3 * r.standard_normal((2, 4, 32)).astype(np.float32)
    mem = 1e-3 * r.standard_normal((2, 9, 32)).astype(np.float32)
    _close(*_run_pair(JFormerDecoder(32, 4, 2), FormerDecoder(32, 4, 2), tgt, mem))


def test_memory_encoder_matches_jax():
    feats = np.random.default_rng(1).standard_normal((2, 24, 32)).astype(np.float32)
    _close(*_run_pair(jmodel.MemoryEncoder(hidden_size=32, num_heads=4),
                      tmodel.MemoryEncoder(hidden_size=32, num_heads=4), feats))


def test_qformer_matches_jax():
    """Post-norm FormerDecoder with flax's LayerNorm eps 1e-6."""
    feats = np.random.default_rng(2).standard_normal((2, 20, 48)).astype(np.float32)
    _close(*_run_pair(jmodel.QFormer(hidden_size=48, num_heads=4),
                      tmodel.QFormer(hidden_size=48, num_heads=4), feats))


@pytest.mark.parametrize("num_samples", [1, 3])
def test_nextdit_matches_jax(num_samples):
    r = np.random.default_rng(3)
    B, T = 2, 8
    x = r.standard_normal((B * num_samples, T, 32)).astype(np.float32)
    t = np.array([900.0, 100.0], np.float32)
    z = r.standard_normal((B, 5, 48)).astype(np.float32)
    jcfg = F32NextDiTConfig.tiny()
    tcfg = dataclasses.replace(tnd.NextDiTConfig.tiny(), dtype=torch.float32)
    jm = jnd.NextDiT(jcfg)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    params = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                        num_samples=num_samples))(*args)["params"]
    # the zero-initialized cross-attention gates would hide that branch
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 if path[-1].key == "gate" else a, params)
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, num_samples=num_samples))(
        params, *args)
    tm = load_from_jax(tnd.NextDiT(tcfg), params)
    with torch.no_grad():
        out = tm(_t(x), _t(t), _t(z), num_samples=num_samples)
    _close(out, ref)


@pytest.fixture(scope="module", params=["nextdit_async", "nextdit"])
def n1_pair(request):
    """The tiny dual-system model on both sides, same weights; System-1
    with (async) and without the DINOv2 memory tokens."""
    cfg = f32_config(request.param)
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, cfg)
    tcfg = tmodel.InternVLAN1Config.tiny(request.param, dtype=torch.float32)
    return jm, params, load_from_jax(build_model(tcfg, device="cpu"), params)


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_generate_traj_nextdit_matches_jax(n1_pair, guidance):
    """The whole System-1: latent projection, DINOv2 memory tokens, QFormer,
    10 Euler steps of NextDiT from the same x_init."""
    jm, params, tm = n1_pair
    r = np.random.default_rng(4)
    B, ns = 1, 4
    lat = r.standard_normal((B, 2, 64)).astype(np.float32)
    imgs = r.standard_normal((B, 2, 56, 56, 3)).astype(np.float32)
    x0 = r.standard_normal((B * ns, 8, 3)).astype(np.float32)
    ref = jax.jit(lambda p, lat, im, x: jm.apply(
        {"params": p}, method=lambda m: m.generate_traj_nextdit(
            lat, im, guidance_scale=guidance, num_sample_trajs=ns, x_init=x)))(
        params, jnp.asarray(lat), jnp.asarray(imgs), jnp.asarray(x0))
    with torch.no_grad():
        out = tm.generate_traj_nextdit(_t(lat), _t(imgs), x_init=_t(x0),
                                       guidance_scale=guidance, num_sample_trajs=ns)
    _close(out, ref)


def test_embed_multimodal_matches_jax(n1_pair):
    jm, params, tm = n1_pair
    cfg = jm.cfg
    ids = np.array([[1, cfg.image_token_index, cfg.image_token_index, 7,
                     cfg.traj_token_index, cfg.traj_token_index, 600]])
    img = np.random.default_rng(5).standard_normal((2, 64)).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(img),
                   method=jm.embed_multimodal)
    with torch.no_grad():
        out = tm.embed_multimodal(_t(ids), _t(img))
    _close(out, ref)


def test_unknown_system1_still_raises():
    """An unknown System-1 head is refused (the NavDP heads are ported:
    tests/test_torch_navdp*.py)."""
    with pytest.raises(ValueError, match="unknown system1"):
        tmodel.InternVLAN1Model(tmodel.InternVLAN1Config.tiny("diffusion_policy"))
