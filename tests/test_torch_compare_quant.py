"""scripts/torch/compare_quant.py against bench.py's quality comparison.

The JAX side runs as tests/test_bench_smoke.py patches bench.py: the tiny
nextdit_async config (bf16, 2 decoder layers), 56-pixel frames, 4 decode
tokens, 4 System-1 samples, 2 prompts; the quantized side W8A8 with the
int8 KV cache (`quantize_qwen_text_params_device`). The port gets JAX's
bf16 weights (`model/weights/from_jax`), quantizes its own copy of the
decoder (`quantize_qwen_text_`), and is handed the System-1 noise JAX
draws from PRNGKey(1000 + i). Tolerances: greedy tokens exactly equal on
both sides; traj latents within LATENT_ATOL, 4 bf16 ulps at their largest
magnitude (2-4): the same bf16 decoder summed in another order (the CPU
XLA keeps a bf16 intermediate at fp32 inside a fusion, F17);
trajectories within TRAJ_ATOL.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import bench as jbench
from internnav_tpu.model.basemodel.internvla_n1.model import InternVLAN1Config as JConfig
from internnav_tpu.model.basemodel.internvla_n1.model import InternVLAN1Model as JModel
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu.model.basemodel.internvla_n1.qwen_text import (
    quantize_qwen_text_params_device,
)
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.weights.from_jax import load_from_jax

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
N_PROMPTS = 2
LATENT_ATOL = 4 * 2.0 ** -6
TRAJ_ATOL = 1e-3
#: bench.py's statistics (`_quality_compare`)
STATS = ("token_agreement", "mean_first_divergence_tok", "traj_latent_rel_l2",
         "waypoint_mean_l2_m", "waypoint_rel_l2")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"port_{name}", REPO / "scripts" / "torch" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cq = _load("compare_quant")


def _jax_cfg(weight_dtype="bf16", kv_dtype="bf16"):
    cfg = JConfig.tiny("nextdit_async")
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, weight_dtype=weight_dtype,
                                                             kv_dtype=kv_dtype))


def _jax_draws(i: int) -> torch.Tensor:
    """The starting noise JAX's `_quality_prompts` draws for prompt i."""
    _, sub = jax.random.split(jax.random.PRNGKey(1000 + i))
    shape = (cq.TINY["num_sample_trajs"], 8, 3)
    return torch.from_numpy(np.array(jax.random.normal(sub, shape)))


@pytest.fixture(scope="module")
def jax_quality():
    """bench.py's per-prompt outputs on the tiny patched config: bf16, and
    W8A8 + int8 KV on the same weights; and those bf16 weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbench, "IMAGE_HW", cq.TINY["image_hw"])
        mp.setattr(jbench, "DECODE_TOKENS", cq.TINY["decode_tokens"])
        mp.setattr(jbench, "NUM_SAMPLE_TRAJS", cq.TINY["num_sample_trajs"])
        cfg = _jax_cfg()
        model = JModel(cfg)
        params = jbench._random_bf16_params(model, cfg, cq.TINY["image_hw"])
        bf16 = jbench._quality_prompts(JPolicy(model, params, cfg), cfg, N_PROMPTS)
        qcfg = _jax_cfg("int8", "int8")
        qparams = {**params, "language_model": quantize_qwen_text_params_device(
            params["language_model"])}
        quant = jbench._quality_prompts(JPolicy(JModel(qcfg), qparams, qcfg), qcfg, N_PROMPTS)
    return params, bf16, quant


def test_quality_compare_equals_bench_on_seeded_outputs():
    """The host-only copy against bench._quality_compare: tokens that agree,
    diverge at once and at the end, lengths that differ, a zero latent."""
    r = np.random.default_rng(0)
    outs = []
    for n in (20, 20, 17, 20):
        outs.append([{"tokens": r.integers(0, 5, n), "latent": r.standard_normal((1, 4, 8)),
                      "traj": r.standard_normal((32, 8, 3)).astype(np.float32)}
                     for _ in range(2)])
    a, b = [o[0] for o in outs], [o[1] for o in outs]
    b[0]["tokens"] = a[0]["tokens"].copy()
    a[3]["latent"] = np.zeros_like(a[3]["latent"])
    for x, y in ((a, b), (b, a), (a, a)):
        assert cq.quality_compare(x, y) == jbench._quality_compare(x, y)


def test_quality_against_jax_bf16_and_int8_kv8(jax_quality):
    """The port's bf16 and W8A8 + int8-KV passes on JAX's weights: tokens
    equal JAX's for each prompt, latents within LATENT_ATOL, trajectories
    within TRAJ_ATOL with JAX's draws; the statistics under bench's keys,
    the token statistics equal."""
    params, jbf, jq = jax_quality
    tcfg = cq.full_n1_config(2, tiny=True)
    policy = tpolicy.InternVLAN1Policy(load_from_jax(tpolicy.build_model(tcfg, device="cpu"),
                                                     params))
    line, tbf, tq = cq.compare_quant(policy, n_prompts=N_PROMPTS, x_init=_jax_draws, **cq.TINY)
    for ours, ref in ((tbf, jbf), (tq, jq)):
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o["tokens"], r["tokens"])
            np.testing.assert_allclose(o["latent"], r["latent"], atol=LATENT_ATOL, rtol=0)
            np.testing.assert_allclose(o["traj"], r["traj"], atol=TRAJ_ATOL, rtol=0)
    want = jbench._quality_compare(jbf, jq)
    got = {k: line["detail"][k] for k in want}
    assert tuple(want) == STATS and tuple(cq.quality_compare(tbf, tq)) == STATS
    for k in ("token_agreement", "mean_first_divergence_tok"):
        assert got[k] == want[k]
    assert line["value"] == want["token_agreement"]
    assert line["metric"] == "int8_vs_bf16_serving_quality_7b_width"
    assert line["detail"]["kv_dtype"] == "int8" and line["detail"]["num_layers"] == 2


def test_cli_sequential_gives_the_co_resident_statistics(capsys):
    """Both modes of the command line on the host at tiny size: bench.py's
    schema, and the sequential mode (free, regenerate from the seed,
    quantize in place) the co-resident statistics exactly."""
    import json

    argv = ["--device", "cpu", "--tiny", "--quant-layers", "2"]
    co = cq.main(argv)
    seq = cq.main(argv + ["--sequential"])
    printed = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert printed == [co, seq]
    keys = {"metric", "value", "unit", "vs_baseline", "detail"}
    assert set(co) == set(seq) == keys
    assert {k: co["detail"][k] for k in STATS} == {k: seq["detail"][k] for k in STATS}
    assert set(co["detail"]) == set(seq["detail"]) and {"scheme", "caveat"} <= set(co["detail"])
    assert co["unit"] == seq["unit"] == "greedy_token_agreement"
    assert seq["metric"] == "int8_kv8_vs_bf16_serving_quality_7b_width_sequential"
    assert "sequential" in seq["detail"]["scheme"] and cq.CAVEAT in seq["detail"]["caveat"]


def test_quantized_copy_leaves_the_bf16_policy_whole():
    """The co-resident copy shares the bf16 tensors and quantizes its own
    decoder: the source's projections stay bf16 Linears, the embedding,
    vision tower and System-1 are the same tensors."""
    policy = tpolicy.InternVLAN1Policy.build(cq.full_n1_config(2, tiny=True), device="cpu")
    before = {k: v.clone() for k, v in policy.model.state_dict().items()}
    quant = cq.quantized_copy(policy, 4, None, "int8")
    after = policy.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    src, lm = policy.model.language_model, quant.model.language_model
    assert isinstance(src.layers[0].mlp.gate_proj, torch.nn.Linear)
    assert lm.layers[0].mlp.gate_proj.weight_q.dtype == torch.uint8  # packed int4
    assert lm.lm_head.weight_q.dtype == torch.int8  # the lm_head stays at 8 bits
    assert lm.embed_tokens.weight.data_ptr() == src.embed_tokens.weight.data_ptr()
    assert quant.model.visual is policy.model.visual
    assert quant.cfg.text.kv_dtype == lm.cfg.kv_dtype == "int8"
    assert policy.cfg.text.weight_dtype == "bf16" and quant.cfg.text.weight_dtype == "int4"
