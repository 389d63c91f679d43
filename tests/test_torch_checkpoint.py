"""Checkpoint loading of the port against the JAX package and HF transformers.

Tiny models built in the test, no download:
- the converter on a tiny HF Qwen2.5-VL state dict (both key layouts, tied
  and untied) equals the JAX package's `convert_*` mapped by `from_jax`,
  tensor for tensor, and so does the whole tiny InternVLA-N1 written through
  the inverse map and read back by JAX's `convert_internvla_n1`; the map is
  strict (a missing, unknown or misshapen key raises, the skip list passes);
- the loaded policy's text logits, vision tokens and greedy generation
  equal HF transformers' (the tolerances of tests/test_weight_conversion.py;
  tokens exactly, as tests/test_hf_generate_parity.py);
- `from_pretrained_torch` in int8 is bitwise JAX's `from_pretrained_torch`
  mapped by `from_jax`; the native round trip is bitwise in bf16 and int8
  and a dtype mismatch raises JAX's message;
- F4 (`realworld.serve.build_policy`): a bf16 native directory under the
  realtime profile serves bf16 weights with an int8 KV cache, an HF
  directory is quantized on load; the agents' `_build_n1_policy` over
  native, HF and no checkpoint; `train_n1 --ckpt` takes 2 steps; the
  converter CLI;
- `safetensors_io` against the `safetensors` package (files, shards and
  the index, the lookup order of a directory, .bin and .pth);
- the new modules import and load a checkpoint with jax, internnav_tpu,
  transformers and safetensors blocked.
"""

import dataclasses
import json
import os
import re
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu.model.weights import convert as jconvert
from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_vision as qv
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
    NATIVE_WEIGHTS,
    InternVLAN1Policy,
    build_model,
)
from internnav_tpu_torch.model.weights import convert
from internnav_tpu_torch.model.weights import safetensors_io as sio
from internnav_tpu_torch.model.weights.from_jax import state_dict_from_jax
from internnav_tpu_torch.ops.rope import get_rope_index_25

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
VOCAB = 512
VS, VE, IMG_TOK, TRAJ_TOK = 506, 507, 508, 509
EOS, PAD = 510, 511
HW = 56  # grid (1, 4, 4): 4 merged tokens an image
MAX_NEW = 24
OLD_LAYOUT = (("model.language_model.", "model."), ("model.visual.", "visual."))


# ------------------------------------------------------------------ fixtures
def _hf_model(tied: bool, seed: int = 0):
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import (
        Qwen2_5_VLConfig,
        Qwen2_5_VLTextConfig,
        Qwen2_5_VLVisionConfig,
    )
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VLForConditionalGeneration,
    )

    text = Qwen2_5_VLTextConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
        rope_theta=1000000.0, rms_norm_eps=1e-6,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}, tie_word_embeddings=tied)
    vision = Qwen2_5_VLVisionConfig(
        depth=2, hidden_size=32, intermediate_size=64, num_heads=4, patch_size=14,
        spatial_merge_size=2, temporal_patch_size=2, window_size=56, fullatt_block_indexes=[1],
        out_hidden_size=64, hidden_act="silu")
    cfg = Qwen2_5_VLConfig(text_config=text.to_dict(), vision_config=vision.to_dict(),
                           image_token_id=IMG_TOK, video_token_id=TRAJ_TOK,
                           vision_start_token_id=VS, vision_end_token_id=VE,
                           tie_word_embeddings=tied)
    torch.manual_seed(seed)
    return Qwen2_5_VLForConditionalGeneration(cfg).eval()


@pytest.fixture(scope="module")
def hf_models():
    return {tied: _hf_model(tied) for tied in (False, True)}


def _hf_sd(hf, *, tied: bool, old_layout: bool):
    """The HF model's state dict as a checkpoint holds it: the tied
    lm_head left out (as save_pretrained does), keys in the old layout on
    request."""
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    if tied:
        del sd["lm_head.weight"]
    if old_layout:
        for new, old in OLD_LAYOUT:
            sd = {(old + k[len(new):] if k.startswith(new) else k): v for k, v in sd.items()}
    return sd


def _np(sd):
    return {k: v.float().numpy() for k, v in sd.items()}


def _text_cfg(dtype=torch.float32, **kw):
    return dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=dtype, **kw)


def n1_config(system1="nextdit_async", dtype=torch.float32, **text):
    """The tiny N1 at the HF fixture's dims and special ids."""
    cfg = InternVLAN1Config.tiny(system1, dtype=dtype)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, **text),
                               image_token_index=IMG_TOK, traj_token_index=TRAJ_TOK)


def _assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _jax_tree_with_memory_proj(jtree, sd):
    """JAX's converter leaves out `memory_proj`, a layer only the tiny
    configs have (2 x the DINOv2 width != the QFormer's); splice it in."""
    w, b = sd["model.memory_proj.weight"], sd["model.memory_proj.bias"]
    return {**jtree, "memory_proj": {"kernel": np.asarray(w, np.float32).T,
                                     "bias": np.asarray(b, np.float32)}}


# ---------------------------------------------------------------- converter
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("old_layout", [False, True], ids=["layout_4_52", "layout_4_51"])
def test_qwen25vl_converters_equal_jax(hf_models, tied, old_layout):
    sd = _hf_sd(hf_models[tied], tied=tied, old_layout=old_layout)
    text = qt.QwenTextModel(_text_cfg(tie_word_embeddings=tied))
    got = convert.convert_qwen25vl_text(sd, text)
    want = state_dict_from_jax(jconvert.convert_qwen25vl_text(_np(sd)), text)
    _assert_state_equal(got, want)
    assert ("lm_head.weight" in got) != tied
    tower = qv.QwenVisionTower(dataclasses.replace(qv.QwenVisionConfig.tiny(),
                                                   dtype=torch.float32))
    _assert_state_equal(convert.convert_qwen25vl_vision(sd, tower),
                        state_dict_from_jax(jconvert.convert_qwen25vl_vision(_np(sd)), tower))


def _random_n1(cfg, seed=0):
    return InternVLAN1Policy.build(cfg, device="cpu", seed=seed).model


@pytest.mark.parametrize("old_layout", [False, True], ids=["layout_4_52", "layout_4_51"])
def test_full_n1_converter_equals_jax(old_layout):
    """A whole tiny N1 written through the inverse map: the port's
    converter gives the model's state back, and equals JAX's
    convert_internvla_n1 mapped by from_jax."""
    model = _random_n1(n1_config())
    prefixes = dict(text_prefix="model.", vision_prefix="visual.") if old_layout else {}
    sd = convert.hf_state_dict(model, **prefixes)
    assert "model.rgb_model.blocks.0.attn.qkv.weight" in sd
    assert "model.rgb_resampler.decoder.layers.0.multihead_attn.in_proj_weight" in sd
    assert sd["visual.patch_embed.proj.weight" if old_layout else
              "model.visual.patch_embed.proj.weight"].shape == (32, 3, 2, 14, 14)
    got = convert.convert_internvla_n1(sd, model)
    _assert_state_equal(got, model.state_dict())
    jtree = _jax_tree_with_memory_proj(jconvert.convert_internvla_n1(_np(sd)), sd)
    _assert_state_equal(got, state_dict_from_jax(jtree, model))


@pytest.mark.parametrize("module", ["rgb_model", "traj_dit", "memory_encoder", "rgb_resampler"])
def test_system1_converters_equal_jax(module):
    """convert_dinov2_vits (qkv split), convert_nextdit, convert_memory_encoder
    and convert_qformer (torch MultiheadAttention's packed in_proj) on the
    tiny N1's checkpoint, against the JAX package's and the module's own
    state."""
    model = _random_n1(n1_config())
    sd = convert.hf_state_dict(model)
    port, jax_convert = {
        "rgb_model": (convert.convert_dinov2_vits,
                      lambda d: jconvert.convert_dinov2_vits(d, prefix="model.rgb_model.")),
        "traj_dit": (convert.convert_nextdit, jconvert.convert_nextdit),
        "memory_encoder": (convert.convert_memory_encoder, jconvert.convert_memory_encoder),
        "rgb_resampler": (convert.convert_qformer, jconvert.convert_qformer),
    }[module]
    sub = getattr(model, module)
    got = port(sd, sub)
    _assert_state_equal(got, sub.state_dict())
    _assert_state_equal(got, state_dict_from_jax(jax_convert(_np(sd)), sub))


def test_converter_is_strict():
    model = _random_n1(n1_config())
    sd = convert.hf_state_dict(model)
    skipped = {"model.rgb_resampler.visual_proj.weight": torch.zeros(48, 48),
               "model.rgb_resampler.visual_proj.bias": torch.zeros(48),
               "model.rgb_model.mask_token": torch.zeros(1, 32),
               "model.traj_dit.model.pad_token": torch.zeros(32),
               "model.traj_dit.model.patch_embedder.proj.weight": torch.zeros(32, 12)}
    convert.convert_internvla_n1({**sd, **skipped}, model)
    with pytest.raises(KeyError, match="not taken by any port parameter"):
        convert.convert_internvla_n1({**sd, "model.extra.weight": torch.zeros(2)}, model)
    missing = dict(sd)
    del missing["model.traj_dit.model.layers.0.gate"]
    with pytest.raises(KeyError, match="lacks the sources"):
        convert.convert_internvla_n1(missing, model)
    bad = {**sd, "model.latent_queries": torch.zeros(1, 3, 64)}
    with pytest.raises(ValueError, match="shape differs"):
        convert.convert_internvla_n1(bad, model)
    tied = dict(sd)
    del tied["lm_head.weight"]  # an untied model needs its lm_head
    with pytest.raises(KeyError, match="lacks the sources"):
        convert.convert_internvla_n1(tied, model)


# ----------------------------------------------------------- HF parity
@pytest.fixture(scope="module")
def hf_policy(hf_models, tmp_path_factory):
    """The untied HF model plus a random System-1 (nextdit) as an HF-layout
    safetensors checkpoint, loaded by from_pretrained_torch (fp32)."""
    hf = hf_models[False]
    cfg = n1_config("nextdit")
    sd = {**convert.hf_state_dict(_random_n1(cfg, seed=5)), **_hf_sd(hf, tied=False,
                                                                     old_layout=False)}
    d = tmp_path_factory.mktemp("hf_n1")
    sio.write_safetensors(str(d / "model.safetensors"), sd)
    policy = InternVLAN1Policy.from_pretrained_torch(str(d), cfg, device="cpu")
    policy.tokenizer.eos_token_id = EOS
    return hf, policy


def _pixels(rs, n):
    imgs = rs.randint(0, 255, (n, HW, HW, 3)).astype(np.uint8)
    mean = np.asarray(InternVLAN1Policy.CLIP_MEAN)
    std = np.asarray(InternVLAN1Policy.CLIP_STD)
    norm = ((imgs.astype(np.float32) / 255.0) - mean) / std
    patches, grid = qv.preprocess_images(norm.astype(np.float32), qv.QwenVisionConfig.tiny())
    return imgs, torch.tensor(np.asarray(patches), dtype=torch.float32), torch.tensor(grid)


def test_text_logits_and_vision_tokens_match_hf(hf_policy):
    hf, policy = hf_policy
    B, T = 2, 12
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, VOCAB, (B, T)))
    pos = torch.arange(T)[None, None].expand(3, B, T)
    with torch.no_grad():
        want = hf.lm_head(hf.model.language_model(input_ids=ids, position_ids=pos)
                          .last_hidden_state)
        lm = policy.model.language_model
        got, _, _ = lm(lm.embed(ids), pos)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-3)
    imgs, patches, grid = _pixels(np.random.RandomState(1), 1)
    with torch.no_grad():
        want = hf.model.visual(patches, grid_thw=grid)
    got, _ = policy._encode_images(imgs)
    torch.testing.assert_close(got, want, atol=3e-4, rtol=3e-3)


@pytest.mark.parametrize("n_images", [1, 4])
def test_greedy_generate_matches_hf(hf_policy, n_images):
    """Token for token against HF generate(do_sample=False) through the
    policy's fused System-2 path (vision, embed scatter, prefill, graph-loop
    decode), two prompts a batch."""
    hf, policy = hf_policy
    rs = np.random.RandomState(100 + n_images)

    def prompt():
        ids = list(rs.randint(3, 490, size=3))
        for _ in range(n_images):
            ids += [VS] + [IMG_TOK] * 4 + [VE]
        return ids + list(rs.randint(3, 490, size=7))

    ids = np.asarray([prompt(), prompt()], np.int64)
    imgs, patches, grid = _pixels(rs, 2 * n_images)
    with torch.no_grad():
        hf_out = hf.generate(input_ids=torch.from_numpy(ids), attention_mask=torch.ones_like(
            torch.from_numpy(ids)), pixel_values=patches, image_grid_thw=grid,
            do_sample=False, max_new_tokens=MAX_NEW, eos_token_id=EOS, pad_token_id=PAD,
            use_cache=True)[:, ids.shape[1]:].numpy()
    img_tokens, grid_ours = policy._encode_images(imgs)
    pos, deltas = get_rope_index_25(ids, grid_ours, spatial_merge_size=2, image_token_id=IMG_TOK)
    B, T = ids.shape
    tokens, lengths, _ = policy.fused_s2(
        img_tokens, torch.from_numpy(ids), torch.from_numpy(np.asarray(pos)),
        torch.from_numpy(np.asarray(deltas)[:, 0]), torch.full((B,), T),
        torch.zeros((B, T), dtype=torch.int32), MAX_NEW)
    for r in range(B):
        stop = np.where(hf_out[r] == EOS)[0]
        n = int(stop[0]) + 1 if stop.size else MAX_NEW
        assert n == min(int(lengths[r]) + 1, MAX_NEW)
        np.testing.assert_array_equal(tokens[r, :n].numpy(), hf_out[r, :n])


# ------------------------------------------------- int8 load, native format
def _bf16_exact_checkpoint(tmp_path, cfg):
    """A tiny N1 HF-layout checkpoint in fp32 whose values are bf16 numbers,
    so the JAX package's cast to bf16 and the port's to each parameter's
    dtype lose nothing (the JAX reader takes numpy arrays: no bf16)."""
    sd = {k: v.bfloat16().float() for k, v in convert.hf_state_dict(_random_n1(cfg, 7)).items()}
    sio.write_safetensors(str(tmp_path / "model.safetensors"), sd)
    return sd


def test_from_pretrained_torch_int8_equals_jax(tmp_path):
    cfg = n1_config(dtype=torch.bfloat16, weight_dtype="int8", kv_dtype="int8")
    sd = _bf16_exact_checkpoint(tmp_path, n1_config())
    policy = InternVLAN1Policy.from_pretrained_torch(str(tmp_path), cfg, device="cpu")
    jcfg = jmodel.InternVLAN1Config.tiny()
    jcfg = dataclasses.replace(
        jcfg, text=dataclasses.replace(jcfg.text, dtype=jnp.bfloat16, weight_dtype="int8",
                                       kv_dtype="int8"),
        image_token_index=IMG_TOK, traj_token_index=TRAJ_TOK)
    jpol = JPolicy.from_pretrained_torch(str(tmp_path), jcfg)
    jtree = _jax_tree_with_memory_proj(jax.tree_util.tree_map(np.asarray, jpol.params), sd)
    target = build_model(cfg, device="cpu")
    _assert_state_equal(policy.model.state_dict(), state_dict_from_jax(jtree, target))
    assert isinstance(policy.model.language_model.lm_head, qt.QuantLinear)


def test_from_pretrained_torch_int4_equals_jax(tmp_path):
    """int4 quantized on load (JAX `policy.py:315-320`): the packed codes,
    grouped-128 scales where 128 divides the input (down_proj, K=128) and
    per channel elsewhere (K=64), and the lm_head at 8 bits, bitwise JAX's
    `from_pretrained_torch` mapped by `from_jax` (which packs its jnp.int4
    leaves)."""
    cfg = n1_config(dtype=torch.bfloat16, weight_dtype="int4", kv_dtype="int8")
    sd = _bf16_exact_checkpoint(tmp_path, n1_config())
    policy = InternVLAN1Policy.from_pretrained_torch(str(tmp_path), cfg, device="cpu")
    jcfg = jmodel.InternVLAN1Config.tiny()
    jcfg = dataclasses.replace(
        jcfg, text=dataclasses.replace(jcfg.text, dtype=jnp.bfloat16, weight_dtype="int4",
                                       kv_dtype="int8"),
        image_token_index=IMG_TOK, traj_token_index=TRAJ_TOK)
    jpol = JPolicy.from_pretrained_torch(str(tmp_path), jcfg)
    assert jpol.params["language_model"]["layers_0"]["mlp"]["down_proj"]["kernel_q"].dtype \
        == jnp.int4
    jtree = _jax_tree_with_memory_proj(jax.tree_util.tree_map(np.asarray, jpol.params), sd)
    target = build_model(cfg, device="cpu")
    _assert_state_equal(policy.model.state_dict(), state_dict_from_jax(jtree, target))
    lm = policy.model.language_model
    assert lm.layers[0].mlp.down_proj.scale_q.shape == (1, 64)  # one group of 128
    assert lm.layers[0].mlp.up_proj.scale_q.shape == (128,)  # K=64: per channel
    assert lm.lm_head.weight_bits == 8 and lm.lm_head.weight_q.dtype == torch.int8


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8", "int4"])
def test_native_round_trip_is_bitwise(tmp_path, weight_dtype):
    cfg = n1_config(dtype=torch.bfloat16, weight_dtype=weight_dtype)
    policy = InternVLAN1Policy.build(cfg, device="cpu", seed=3)
    policy.save_pretrained(str(tmp_path))
    info = json.loads((tmp_path / "config.json").read_text())
    assert set(info) == {"policy", "system1", "weight_dtype", "text", "note"}
    assert info["weight_dtype"] == weight_dtype
    assert sorted(os.listdir(tmp_path)) == ["config.json", NATIVE_WEIGHTS]
    loaded = InternVLAN1Policy.from_pretrained(str(tmp_path), cfg, device="cpu")
    _assert_state_equal(loaded.model.state_dict(), policy.model.state_dict())
    other = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, weight_dtype="int8" if weight_dtype == "bf16" else "bf16"))
    with pytest.raises(ValueError, match=f"saved with weight_dtype='{weight_dtype}'"):
        InternVLAN1Policy.from_pretrained(str(tmp_path), other, device="cpu")


def test_tied_checkpoint_serves_tied_logits(tmp_path):
    """No lm_head.weight: the model ties its embeddings, in bf16 and int8
    (the embedding is never quantized), and the native round trip keeps it."""
    sd = convert.hf_state_dict(_random_n1(n1_config("nextdit")))
    del sd["lm_head.weight"]
    sio.write_safetensors(str(tmp_path / "model.safetensors"), sd)
    for wdt in ("bf16", "int8"):
        cfg = n1_config("nextdit", weight_dtype=wdt)
        pol = InternVLAN1Policy.from_pretrained_torch(str(tmp_path), cfg, device="cpu")
        lm = pol.model.language_model
        assert lm.cfg.tie_word_embeddings and lm.lm_head is None
        h = torch.randn(3, 64)
        torch.testing.assert_close(lm._logits(h), h @ lm.embed_tokens.weight.float().T,
                                   atol=0, rtol=0)
        pol.save_pretrained(str(tmp_path / wdt))
        again = InternVLAN1Policy.from_pretrained(str(tmp_path / wdt), cfg, device="cpu")
        assert again.model.language_model.lm_head is None


def test_jax_native_directory_is_refused(tmp_path):
    (tmp_path / "params.msgpack").write_bytes(b"\x80")
    (tmp_path / "config.json").write_text('{"weight_dtype": "int8"}')
    from internnav_tpu_torch.realworld.serve import build_policy

    for load in (InternVLAN1Policy.from_pretrained, InternVLAN1Policy.from_pretrained_torch,
                 lambda path, cfg, device: build_policy("realtime", device=device, ckpt=path,
                                                        config=cfg)):
        with pytest.raises(ValueError, match="params.msgpack.*convert_checkpoint.py"):
            load(str(tmp_path), n1_config(), device="cpu")
    # the int4 format builds; its JAX native directory is refused all the same
    with pytest.raises(ValueError, match="params.msgpack.*convert_checkpoint.py"):
        InternVLAN1Policy.from_pretrained(str(tmp_path), n1_config(weight_dtype="int4"),
                                          device="cpu")


# ---------------------------------------------------------- F4, agents
def test_f4_native_bf16_under_realtime_serves_bf16_weights_with_int8_cache(tmp_path, capsys):
    from internnav_tpu_torch.realworld.serve import build_policy

    cfg = n1_config(dtype=torch.bfloat16)
    InternVLAN1Policy.build(cfg, device="cpu").save_pretrained(str(tmp_path / "native"))
    pol = build_policy("realtime", device="cpu", ckpt=str(tmp_path / "native"), config=cfg)
    assert "recorded by the native checkpoint" in capsys.readouterr().out
    text = pol.cfg.text
    assert (text.weight_dtype, text.kv_dtype) == ("bf16", "int8")
    assert not any(isinstance(m, qt.QuantLinear) for m in pol.model.modules())
    frame = np.random.default_rng(0).integers(0, 256, (HW, HW, 3)).astype(np.uint8)
    pol.s2_step(frame, "go to the door", max_new_tokens=3)
    caches = pol.decode_buffers._sets  # the int8 KV cache the request wrote
    entry = next(iter(next(iter(caches.values())))).entries[0][0]
    assert isinstance(entry, tuple) and entry[0].dtype == torch.int8
    sio.write_safetensors(str(tmp_path / "hf.safetensors"),
                          convert.hf_state_dict(InternVLAN1Policy.build(cfg, device="cpu").model))
    pol = build_policy("realtime", device="cpu", ckpt=str(tmp_path / "hf.safetensors"),
                       config=cfg)
    assert "quantized on load" in capsys.readouterr().out
    assert pol.cfg.text.weight_dtype == "int8"
    assert isinstance(pol.model.language_model.layers[0].mlp.down_proj, qt.QuantLinear)


def test_agents_build_their_policy_from_native_hf_or_none(tmp_path):
    from internnav_tpu_torch.agent.internvla_n1_agent import (
        BatchedInternVLAN1Agent,
        _build_n1_policy,
    )

    cfg = n1_config()
    random = InternVLAN1Policy.build(
        n1_config(weight_dtype="int8", kv_dtype="int8"), device="cpu")
    sio.write_safetensors(str(tmp_path / "model.safetensors"),
                          convert.hf_state_dict(InternVLAN1Policy.build(cfg, device="cpu").model))
    random.save_pretrained(str(tmp_path / "native"))
    settings = {"device": "cpu", "config": cfg, "profile": "realtime"}
    for ckpt in (str(tmp_path), str(tmp_path / "native"), ""):
        pol = _build_n1_policy(AgentCfg(ckpt_path=ckpt), settings)
        _assert_state_equal(pol.model.state_dict(), random.model.state_dict())
    with pytest.raises(FileNotFoundError):
        _build_n1_policy(AgentCfg(ckpt_path=str(tmp_path / "absent")), settings)
    agent = BatchedInternVLAN1Agent(AgentCfg(
        model_name="internvla_n1_batched", ckpt_path=str(tmp_path / "native"),
        model_settings={**settings, "batch_size": 2}))
    _assert_state_equal(agent.policy.inner.model.state_dict(), random.model.state_dict())


# ---------------------------------------------------------- train, CLI
def test_train_n1_takes_two_steps_from_a_checkpoint(tmp_path):
    from internnav_tpu_torch.dataset.internvla_n1_dataset import write_synthetic_n1_dataset
    from internnav_tpu_torch.trainer import train_n1

    store = str(tmp_path / "store.bin")
    write_synthetic_n1_dataset(store, n_episodes=2, T=6, hw=28)
    cfg = dataclasses.replace(InternVLAN1Config.tiny("nextdit"), s1_image_hw=28)
    source = InternVLAN1Policy.build(cfg, device="cpu", seed=9)
    sio.save_sharded(convert.hf_state_dict(source.model), str(tmp_path / "hf"),
                     max_shard_bytes=2**18)
    pol = train_n1.build_policy(cfg, torch.device("cpu"), str(tmp_path / "hf"))
    _assert_state_equal(pol.model.state_dict(), source.model.state_dict())
    metrics = train_n1.main(["--tiny", "--device", "cpu", "--store", store, "--steps", "2",
                             "--batch-size", "2", "--max-len", "256", "--ckpt",
                             str(tmp_path / "hf"), "--output-dir", str(tmp_path / "out"),
                             "--no-resume"])
    assert np.isfinite(metrics["loss"])
    source8 = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, weight_dtype="int8"))
    InternVLAN1Policy.build(source8, device="cpu").save_pretrained(str(tmp_path / "int8"))
    with pytest.raises(ValueError, match="training needs bf16 weights"):
        train_n1.build_policy(cfg, torch.device("cpu"), str(tmp_path / "int8"))


def _convert_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", REPO / "scripts" / "torch" / "convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convert_checkpoint_cli(tmp_path):
    cli = _convert_cli()
    src = tmp_path / "src"
    src.mkdir()
    cfg = n1_config()
    sio.write_safetensors(str(src / "model.safetensors"),
                          convert.hf_state_dict(InternVLAN1Policy.build(cfg, device="cpu").model))
    (src / "generation_config.json").write_text("{}")
    cli.convert_n1(str(src), str(tmp_path / "dst"), int8=True, device="cpu", cfg=cfg)
    assert (tmp_path / "dst" / "generation_config.json").exists()
    cfg8 = n1_config(weight_dtype="int8")
    loaded = InternVLAN1Policy.from_pretrained(str(tmp_path / "dst"), cfg8, device="cpu")
    want = InternVLAN1Policy.from_pretrained_torch(str(src), cfg8, device="cpu")
    _assert_state_equal(loaded.model.state_dict(), want.model.state_dict())
    cli.convert_n1(str(src), str(tmp_path / "dst4"), int4=True, device="cpu", cfg=cfg)
    cfg4 = n1_config(weight_dtype="int4")
    loaded = InternVLAN1Policy.from_pretrained(str(tmp_path / "dst4"), cfg4, device="cpu")
    want = InternVLAN1Policy.from_pretrained_torch(str(src), cfg4, device="cpu")
    _assert_state_equal(loaded.model.state_dict(), want.model.state_dict())
    assert loaded.model.language_model.layers[0].mlp.up_proj.weight_q.dtype == torch.uint8
    base = ["--src", str(src), "--dst", str(tmp_path / "x"), "--device", "cpu"]
    seen = {}
    real = cli.convert_n1
    cli.convert_n1 = lambda *a, **kw: seen.update(kw)  # the 7B conversion is the card's
    try:
        assert cli.main(["--model", "internvla_n1", "--int4", *base]) == 0
    finally:
        cli.convert_n1 = real
    assert seen["int4"] and not seen["int8"]
    real = cli.convert_recurrent
    cli.convert_recurrent = lambda *a, **kw: seen.update(model=a[0])
    try:
        for model in ("seq2seq", "rdp", "navdp"):
            assert cli.main(["--model", model, *base]) == 0
            assert seen["model"] == model
    finally:
        cli.convert_recurrent = real
    with pytest.raises(SystemExit):
        cli.main(["--model", "internvla_n1", "--int8", "--int4", *base])


def test_convert_checkpoint_cli_recurrent(tmp_path):
    """`--model cma`: a reference-layout CMA checkpoint (small widths, the
    keys JAX's convert_cma_policy reads) becomes a native directory that
    loads back to the same weights, its config.json the one it was
    converted at."""
    from internnav_tpu_torch import model as zoo
    from internnav_tpu_torch.model.weights.convert import recurrent_reference_state_dict

    cli = _convert_cli()
    cfg = zoo.get_config("cma")
    cfg.text_encoder.rnn_hidden_size, cfg.state_encoder.hidden_size = 8, 32
    cfg.image_encoder.rgb.model_name = "resnet18"
    src = zoo.get_policy("cma").build(cfg, device="cpu", seed=4)
    (tmp_path / "ref").mkdir()
    torch.save(recurrent_reference_state_dict(src.net), tmp_path / "ref" / "model.pth")
    cli.convert_recurrent("cma", str(tmp_path / "ref"), str(tmp_path / "dst"), device="cpu",
                          cfg=cfg)
    back = zoo.get_policy("cma").from_pretrained(str(tmp_path / "dst"), device="cpu")
    assert back.cfg.model_dump() == cfg.model_dump()
    _assert_state_equal(back.net.state_dict(), src.net.state_dict())


# ------------------------------------------------------------ safetensors
def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"a.bf16": torch.randn(3, 5, generator=g).bfloat16(),
            "b.f16": torch.randn(7, generator=g).half(),
            "c.f32": torch.randn(2, 3, 4, generator=g),
            "d.i8": torch.randint(-128, 127, (5,), dtype=torch.int8, generator=g),
            "e.i32": torch.randint(-2**31, 2**31 - 1, (3,), dtype=torch.int32, generator=g),
            "f.i64": torch.randint(-2**40, 2**40, (2, 2), dtype=torch.int64, generator=g),
            "g.bool": torch.rand(9, generator=g) > 0.5,
            "h.scalar": torch.tensor(3.5),
            "i.empty": torch.zeros(0, 4)}


def test_safetensors_io_equals_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    tensors = _tensors()
    ours = str(tmp_path / "ours.safetensors")
    sio.write_safetensors(ours, tensors, {"format": "pt"})
    theirs = load_file(ours)
    _assert_state_equal(theirs, tensors)
    save_file(tensors, str(tmp_path / "theirs.safetensors"))
    _assert_state_equal(sio.read_safetensors(str(tmp_path / "theirs.safetensors")), tensors)
    # a tensor that starts off its element size's alignment is copied out
    raw = json.dumps({"x": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
                      "y": {"dtype": "F32", "shape": [2], "data_offsets": [3, 11]}}).encode()
    with open(tmp_path / "odd.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + bytes([1, 2, 255])
                + struct.pack("<2f", 1.5, -2.0))
    odd = sio.read_safetensors(str(tmp_path / "odd.safetensors"))
    assert odd["x"].tolist() == [1, 2, -1] and odd["y"].tolist() == [1.5, -2.0]
    with pytest.raises(ValueError, match="not one of"):
        bad = raw.replace(b'"F32"', b'"F64"')
        (tmp_path / "bad.safetensors").write_bytes(struct.pack("<Q", len(bad)) + bad + bytes(11))
        sio.read_safetensors(str(tmp_path / "bad.safetensors"))


def test_shards_and_index_as_hf_writes_them(tmp_path):
    from safetensors.torch import load_file

    tensors = {f"layer.{i}.w": torch.full((64, 64), float(i)) for i in range(5)}
    files = sio.save_sharded(tensors, str(tmp_path), max_shard_bytes=40000)
    assert files[-1] == sio.INDEX_FILE and len(files) == 4
    index = json.loads((tmp_path / sio.INDEX_FILE).read_text())
    assert index["metadata"]["total_size"] == 5 * 64 * 64 * 4
    assert sorted(index["weight_map"]) == sorted(tensors)
    for name, file in index["weight_map"].items():
        assert torch.equal(load_file(str(tmp_path / file))[name], tensors[name])
    _assert_state_equal(convert.load_torch_state_dict(str(tmp_path)), tensors)
    single = tmp_path / "single"
    assert sio.save_sharded(tensors, str(single)) == ["model.safetensors"]


def test_checkpoint_directory_lookup_order(tmp_path):
    """model.safetensors, pytorch_model.bin, model.pth, then shards (the
    JAX package's order); .bin / .pth through torch.load, a "state_dict"
    entry unwrapped; the port's native file is never taken for a shard."""
    a, b, c = ({"w": torch.full((2,), float(i))} for i in range(3))
    torch.save({"state_dict": c}, tmp_path / "model.pth")
    _assert_state_equal(convert.load_torch_state_dict(str(tmp_path)), c)
    torch.save(b, tmp_path / "pytorch_model.bin")
    _assert_state_equal(convert.load_torch_state_dict(str(tmp_path)), b)
    sio.write_safetensors(str(tmp_path / "model.safetensors"), a)
    _assert_state_equal(convert.load_torch_state_dict(str(tmp_path)), a)
    shards = tmp_path / "shards"
    shards.mkdir()
    sio.write_safetensors(str(shards / "part-1.safetensors"), {"x": torch.ones(1)})
    sio.write_safetensors(str(shards / "part-2.safetensors"), {"y": torch.zeros(1)})
    sio.write_safetensors(str(shards / NATIVE_WEIGHTS), {"z": torch.zeros(1)})
    assert set(convert.load_torch_state_dict(str(shards))) == {"x", "y"}
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no reference-format weights"):
        convert.load_torch_state_dict(str(tmp_path / "empty"))


# ------------------------------------------------------------------ guard
def test_only_the_tokenizer_loader_imports_transformers():
    """transformers is imported in `load_hf_tokenizer` alone, safetensors
    nowhere in the port, its scripts or chip_smoke.py."""
    pattern = re.compile(r"^\s*(import|from)\s+(transformers|safetensors)(\.|\s|$)", re.M)
    hits = {}
    for path in [*(REPO / "internnav_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
                 *(REPO / "scripts" / "torch").glob("*.py")]:
        for m in pattern.finditer(path.read_text()):
            hits.setdefault(path.relative_to(REPO).as_posix(), []).append(m.group(2))
    assert hits == {"internnav_tpu_torch/model/utils/tokenization.py": ["transformers"]}


def test_new_modules_run_without_jax_transformers_or_safetensors(tmp_path):
    """In a fresh interpreter with jax, internnav_tpu, transformers and
    safetensors unimportable: the checkpoint modules, the launchers and the
    converter CLI import, and a tiny HF-layout checkpoint written by the
    port loads (quantized on load) and saves natively."""
    code = f"""
import sys
for m in ("jax", "internnav_tpu", "transformers", "safetensors"):
    sys.modules[m] = None
import dataclasses, importlib.util, torch
import internnav_tpu_torch.model.weights.convert as convert
import internnav_tpu_torch.model.weights.safetensors_io as sio
import internnav_tpu_torch.model.utils.tokenization
import internnav_tpu_torch.realworld.serve, internnav_tpu_torch.trainer.train_n1
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
spec = importlib.util.spec_from_file_location(
    "cli", {str(REPO / 'scripts/torch/convert_checkpoint.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
cfg = InternVLAN1Config.tiny()
sio.save_sharded(convert.hf_state_dict(InternVLAN1Policy.build(cfg, device="cpu").model),
                 {str(tmp_path / 'hf')!r}, max_shard_bytes=2**20)
cfg8 = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, weight_dtype="int8"))
pol = InternVLAN1Policy.from_pretrained_torch({str(tmp_path / 'hf')!r}, cfg8, device="cpu")
pol.save_pretrained({str(tmp_path / 'native')!r})
InternVLAN1Policy.from_pretrained({str(tmp_path / 'native')!r}, cfg8, device="cpu")
assert not any(m.split('.')[0] in ('jax', 'flax', 'internnav_tpu', 'transformers', 'safetensors')
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
