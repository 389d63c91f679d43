"""F17 and F13 measured with XLA's excess precision off (ROADMAP §3).

On the CPU, XLA may keep a bf16 intermediate at fp32 inside a fusion
(`--xla_allow_excess_precision`, on by default): the rotary's output
before the attention's fp32 convert (F17), or a bf16 product before a bf16
dot. The port rounds every bf16 op, as a Pallas call's bf16 operands are
rounded on the TPU (`internnav_tpu/ops/flash_attention.py:498`,
`:511-517`). Here the JAX side runs twice on the same numpy inputs: in this
process (the default flags), and in a subprocess started with
JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_allow_excess_precision=false (a flag
is read once, when the backend starts), whose outputs come back as .npz.
Against the port, four measurements:

- F17's standalone case: rotary + prefill attention of the same bf16 q, k
  and v (2 x 4 heads x 32 tokens x 16), elements of the bf16 output that
  differ;
- layer 1's K and V codes of the tiny bf16 W8A8 + int8-KV model
  (`test_torch_silu.py`'s case), codes that differ of 2,048 each;
- F13: the realtime slice's second-step traj latents (fp32), their
  largest difference;
- this slice's W8A16 decode (the tiny bf16 int8 model with
  decode_act_dtype="bf16"): logits that differ of 1,024, and the largest
  difference.

With the flag, and the port's SwiGLU product rounded to bf16 as XLA then
rounds it, all of F17's counts and the W8A16 logits are equal: F17 is an
artefact of CPU XLA's fusion (settled in ROADMAP §3). F13 runs in fp32,
where the flag changes nothing; it stays open.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.ops.flash_attention import flash_attention
from internnav_tpu_torch.ops.rope import apply_rotary, mrope_cos_sin
from test_torch_norm_scales_and_cache_writes import (  # noqa: F401 (a fixture)
    _bf16_pair,
    _prompt,
    scaled_text_params,
)

torch.set_num_threads(2)
TESTS = Path(__file__).resolve().parent
NO_EXCESS = "--xla_allow_excess_precision=false"
SUBPROCESS_TIMEOUT_S = 900


# ------------------------------------------------------------- the cases
def _attention_inputs():
    r = np.random.default_rng(17)
    B, H, KV, T, D = 2, 4, 2, 32, 16
    q, k, v = (r.standard_normal(s).astype(np.float32) for s in
               ((B, H, T, D), (B, KV, T, D), (B, KV, T, D)))
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    seg[1, 27:] = 1
    return q, k, v, pos, seg


def _jax_attention():
    """F17's standalone case on the JAX side: the prefill's rotary and
    attention (`QwenAttention`'s steps) on bf16 q, k, v."""
    from internnav_tpu.ops.flash_attention import flash_attention as jflash
    from internnav_tpu.ops.rope import mrope_cos_sin as jmrope

    q, k, v, pos, seg = _attention_inputs()
    H, KV = q.shape[1], k.shape[1]

    @jax.jit
    def run(q, k, v, pos, seg):
        cos, sin = jmrope(pos, q.shape[-1], (2, 3, 3), 1e6, dtype=jnp.float32)
        q, k = jqt.apply_rotary(q, k, cos, sin)
        k, v = jnp.repeat(k, H // KV, axis=1), jnp.repeat(v, H // KV, axis=1)
        return jflash(q, k, v, causal=True, segment_ids=seg)

    bf = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    return np.asarray(run(*bf, jnp.asarray(pos), jnp.asarray(seg)).astype(jnp.float32))


def _port_attention():
    q, k, v, pos, seg = (torch.from_numpy(np.array(a)) for a in _attention_inputs())
    cos, sin = mrope_cos_sin(pos, q.shape[-1], (2, 3, 3), 1e6)
    q, k = apply_rotary(q.bfloat16(), k.bfloat16(), cos, sin)
    return flash_attention(q, k, v.bfloat16(), causal=True, segment_ids=seg).float().numpy()


def _decode_inputs(B, H):
    r = np.random.default_rng(18)
    return r.standard_normal((B, 1, H)).astype(np.float32)


def _jax_text(params):
    """The tiny bf16 W8A8 model's prefill (layer 1's K/V codes) and its
    W8A16 decode step's logits, on the JAX side."""
    jm, qparams, _ = _bf16_pair(params, weight_dtype="int8", kv_dtype="int8")
    emb, pos, seg, plen = _prompt(512)
    B, T = seg.shape
    w16 = jqt.QwenTextModel(dataclasses.replace(jm.cfg, decode_act_dtype="bf16"))
    new = _decode_inputs(B, 64)
    npos = np.broadcast_to(pos.max() + 1, (3, B, 1)).astype(np.int32)

    @jax.jit
    def run(p, emb, pos, seg, plen, new, npos):
        _, _, jc = w16.apply({"params": p}, emb, pos, segment_ids=seg, return_cache=True,
                             logits_indices=plen - 1)
        logits, _, _ = w16.apply({"params": p}, new, npos, jqt.pad_caches(jc, T + 1), plen,
                                 method=w16.decode_step)
        return jc[1], logits

    (k1, v1), logits = run(qparams, jnp.asarray(emb, jnp.bfloat16), jnp.asarray(pos),
                           jnp.asarray(seg), jnp.asarray(plen), jnp.asarray(new, jnp.bfloat16),
                           jnp.asarray(npos))
    return np.asarray(k1[0]), np.asarray(v1[0]), np.asarray(logits, np.float32)


def _port_text(params):
    _, _, tm = _bf16_pair(params, weight_dtype="int8", kv_dtype="int8")
    tm8 = qt.QwenTextModel(dataclasses.replace(tm.cfg, decode_act_dtype="bf16"))
    tm8.load_state_dict(tm.state_dict())
    emb, pos, seg, plen = _prompt(512)
    B, T = seg.shape
    with torch.no_grad():
        _, _, tc = tm8(torch.from_numpy(emb).bfloat16(), torch.from_numpy(np.array(pos)),
                       segment_ids=torch.from_numpy(seg),
                       logits_indices=torch.from_numpy(plen - 1).long())
        codes = (tc[1][0][0].numpy(), tc[1][1][0].numpy())
        logits, _, _ = tm8.decode_step(
            torch.from_numpy(_decode_inputs(B, 64)).bfloat16(),
            torch.from_numpy(np.broadcast_to(pos.max() + 1, (3, B, 1)).copy()),
            qt.pad_caches(tc, T + 1), torch.from_numpy(plen).long())
    return (*codes, logits.float().numpy())


def _jax_f13_latents():
    """F13's realtime slice on the JAX side: the second step's latents."""
    from test_torch_slice import INSTRUCTION, _frames
    from test_torch_system1 import F32NextDiTConfig, f32_config, n1_params

    from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
    from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        cfg = f32_config()
        params = n1_params(jmodel.InternVLAN1Model(cfg), cfg, seed=1)
        params = {**params, "language_model": jqt.quantize_qwen_text_params(
            jax.tree_util.tree_map(np.asarray, params["language_model"]))}
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, weight_dtype="int8",
                                                                kv_dtype="int8"))
        pol = JPolicy(jmodel.InternVLAN1Model(cfg), params, cfg)
        pol.reset()
        for frame in _frames(2):
            out = pol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
    return np.asarray(out.output_latent)


def _port_f13_latents():
    from test_torch_slice import INSTRUCTION, _frames
    from test_torch_system1 import F32NextDiTConfig, f32_config, n1_params

    from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
    from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.weights.from_jax import load_from_jax

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        cfg = f32_config()
        params = n1_params(jmodel.InternVLAN1Model(cfg), cfg, seed=1)
    params = {**params, "language_model": jqt.quantize_qwen_text_params(
        jax.tree_util.tree_map(np.asarray, params["language_model"]))}
    tcfg = InternVLAN1Config.tiny("nextdit_async", dtype=torch.float32)
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, weight_dtype="int8",
                                                              kv_dtype="int8"))
    pol = tpolicy.InternVLAN1Policy(load_from_jax(tpolicy.build_model(tcfg, device="cpu"),
                                                  params))
    pol.reset()
    for frame in _frames(2):
        out = pol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
    return out.output_latent.numpy()


def jax_side(params_path: str, out_path: str) -> None:
    """Every JAX measurement of this file, written to out_path (.npz):
    run in the subprocess with the flag, and in the test's own process."""
    flat = dict(np.load(params_path))
    params = {}
    for key, value in flat.items():
        node = params
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    k1, v1, logits = _jax_text(params)
    np.savez(out_path, attention=_jax_attention(), k1=k1, v1=v1, logits=logits,
             latents=_jax_f13_latents(), excess=np.asarray(
                 NO_EXCESS not in os.environ.get("XLA_FLAGS", "")))


# ------------------------------------------------------------------ test
def _counts(got, port: dict) -> dict:
    return {
        "attention": int((got["attention"] != port["attention"]).sum()),
        "k1_codes": int((got["k1"] != port["k1"]).sum()),
        "v1_codes": int((got["v1"] != port["v1"]).sum()),
        "w8a16_logits": int((got["logits"] != port["logits"]).sum()),
        "f13_latent_max_diff": float(np.abs(got["latents"] - port["latents"]).max()),
    }


def _rounded_swiglu_quantize(gate, up):
    """The SwiGLU quantization with the product rounded to bf16 first:
    what XLA computes once excess precision is off."""
    from internnav_tpu_torch.ops import quant

    return quant.quantize_rows(quant.silu_reference(gate) * up)


@pytest.fixture(scope="module")
def measured(scaled_text_params, tmp_path_factory):
    """The counts of `_counts` for each pair: JAX with excess precision off
    (subprocess) or on (default), against the port as it is (its SwiGLU
    quantizer takes the fp32 product, F14) or with the product rounded to
    bf16 (`_rounded_swiglu_quantize`)."""
    from internnav_tpu_torch.ops import quant

    tmp = tmp_path_factory.mktemp("xla_precision")
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(scaled_text_params)[0]}
    np.savez(tmp / "params.npz", **flat)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": NO_EXCESS,
           "PYTHONPATH": os.pathsep.join([str(TESTS), str(TESTS.parent),
                                          os.environ.get("PYTHONPATH", "")])}
    code = (f"import test_torch_xla_precision as m; "
            f"m.jax_side({str(tmp / 'params.npz')!r}, {str(tmp / 'flag.npz')!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(TESTS),
                          capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jax_side(str(tmp / "params.npz"), str(tmp / "default.npz"))
    flag, default = np.load(tmp / "flag.npz"), np.load(tmp / "default.npz")
    assert not bool(flag["excess"]) and bool(default["excess"])
    attention, latents = _port_attention(), _port_f13_latents()
    ports = {}
    for swiglu in ("fp32", "bf16"):
        with pytest.MonkeyPatch.context() as mp:
            if swiglu == "bf16":
                mp.setattr(quant, "swiglu_quantize_reference", _rounded_swiglu_quantize)
            k1, v1, logits = _port_text(scaled_text_params)
        ports[swiglu] = {"attention": attention, "k1": k1, "v1": v1, "logits": logits,
                         "latents": latents}
    return {(jax_run, swiglu): _counts(got, ports[swiglu])
            for jax_run, got in (("no_excess", flag), ("default", default))
            for swiglu in ports}


def test_f17_is_xla_excess_precision(measured):
    """F17 settled: with excess precision off in XLA and the SwiGLU product
    rounded to bf16 on both sides, F17's attention case, layer 1's K/V
    codes and the W8A16 decode logits are all equal. The flag alone zeroes
    the attention case; the codes left (718 K, 752 V) come from the SwiGLU
    product, which the flag rounds to bf16 in JAX while the port keeps it
    in fp32 as XLA's default fusion does (F14). With the default flags the
    counts stand where test_torch_silu.py pins them."""
    zero = {"attention": 0, "k1_codes": 0, "v1_codes": 0, "w8a16_logits": 0}
    got = measured["no_excess", "bf16"]
    assert {k: got[k] for k in zero} == zero
    counts = {key: (m["attention"], m["k1_codes"], m["v1_codes"], m["w8a16_logits"])
              for key, m in measured.items()}
    assert counts[("no_excess", "fp32")] == (0, 718, 752, 787)
    assert counts[("default", "fp32")] == (1146, 1082, 1077, 815)


def test_f13_is_unchanged_without_xla_excess_precision(measured):
    """F13's realtime slice runs in fp32, where the flag changes nothing:
    its second-step latents differ from JAX's by the same amount either
    way (7.0e-3, within test_torch_slice.py's 2e-2), so F13 stays open."""
    diffs = {m["f13_latent_max_diff"] for m in measured.values()}
    assert len(diffs) == 1 and 0 < diffs.pop() < 2e-2
