"""Tensor-parallel serving where the ranks share the KV heads (tp = 8 at
7B: 28 query heads over 4 KV heads), held against the JAX package on the
CPU.

JAX splits q_proj into 3.5 heads a device at tp = 8 and k / v into
halves, and GSPMD partitions the rest; the port gives each pair of ranks
one KV head whole and splits its 7 query heads 4 + 3
(`parallel/tp.shared_kv_spans`). The two compute the same function, so
the tokens are held exactly and the logits within LOGIT_TOL.

- The layout without processes: the spans at (H, KV, tp) = (28, 4, 8) and
  (14, 2, 4) on the 7B widths, the layouts at tp <= 4 as the TP rules
  give them, the refusals (tp = 16 at 7B; tp = 8 on the tiny config, four
  ranks a KV head), and training's `apply_tp` refusing tp = 8.
- One spawn of 8 gloo processes (`torch_gloo_workers.serve_tp8_worker`):
  `graft_entry`'s serving phase at dp=1 x tp=8 on a text model of 28 / 4
  heads of 16 (mrope (2, 3, 3), 2 layers, fp32) and at dp=2 x tp=4 on one
  of 14 / 2; tokens and lengths equal to JAX's `greedy_generate` under
  `qwen_tp_sharding` on its 8 CPU devices and to the port's unsharded
  decode, the teacher-forced logits within LOGIT_TOL of both packages'
  unsharded prefill; then a tiny N1 policy with the 28 / 4 text model,
  written as an HF-layout checkpoint and loaded rank by rank at tp = 8:
  `fused_s2`'s tokens equal to the unsharded policy's and its traj
  latents within LOGIT_TOL, and the same blocks loaded from its native
  directory.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.parallel.tp import qwen_tp_sharding as j_tp_sharding
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
    InternVLAN1Policy,
    build_model,
)
from internnav_tpu_torch.model.weights.convert import hf_state_dict
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.model.weights.safetensors_io import save_sharded
from internnav_tpu_torch.parallel.mesh import Blocks, block_of
from internnav_tpu_torch.parallel.tp import (
    apply_tp,
    qwen_tp_sharding,
    serve_tp_layout,
)
# fp32_jax_nextdit: autouse, the JAX tiny NextDiT in fp32 for every test here
from test_torch_system1 import (  # noqa: F401
    f32_config,
    fp32_jax_nextdit,
    n1_params,
    random_jax_params,
)
from torch_gloo_workers import join_ranks, start_ranks

torch.set_num_threads(2)
EOS = (3,)
#: `graft_entry._dryrun_serve`'s decode: B = 2·dp rows of T ids, NEW tokens
T, NEW = 24, 4
#: fp32 logits and latents of the laid-out model against the unsharded one:
#: the same sums over 2 layers in another order (o_proj's and down_proj's
#: 8 partial sums, the embedding's), each term O(1), so a few fp32 ulps of
#: the largest partial; 1e-4 leaves two orders of magnitude above that and
#: lies far below the O(1) errors a misplaced head or block gives
LOGIT_TOL = 1e-4
#: the 7B attention's heads (query, KV) and the layouts held at tp = 8 and 4
SHARED = ((28, 4, 8), (14, 2, 4))


def _text(jcfg=None, **heads):
    base = jqt.QwenTextConfig.tiny() if jcfg is None else jcfg
    j = dataclasses.replace(base, dtype=jnp.float32, **heads)
    t = dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.float32, **heads)
    return j, t


def _meta_7b(**heads):
    with torch.device("meta"):
        return qt.QwenTextModel(dataclasses.replace(qt.QwenTextConfig(), num_hidden_layers=2,
                                                    **heads))


# --------------------------------------------------------------- the layout
@pytest.mark.parametrize("H,KV,tp", SHARED)
def test_shared_kv_layout_gives_whole_heads(H, KV, tp):
    """Each pair of ranks holds one KV head whole (k / v rows and biases
    replicated over the pair) and splits its H / KV query heads ceil +
    floor; q's rows and o_proj's input columns follow the rank's heads, so
    o_proj's blocks are uneven; the MLP and the vocab split evenly."""
    lm = _meta_7b(num_attention_heads=H, num_key_value_heads=KV)
    D, G = lm.cfg.head_dim, H // KV
    layout = serve_tp_layout(lm, tp)
    pre = "language_model.layers.1."
    q = layout[pre + "self_attn.q_proj.weight"]["tp"]
    assert isinstance(q, Blocks) and q.dim == 0
    heads = [size // D for _, size in q.spans]
    assert heads == [-(-G // 2), G // 2] * KV  # 4 + 3 at 7B
    assert [start for start, _ in q.spans] == [sum(heads[:r]) * D for r in range(tp)]
    assert layout[pre + "self_attn.q_proj.bias"]["tp"] == q
    assert layout[pre + "self_attn.o_proj.weight"]["tp"] == Blocks(1, q.spans)
    kv = Blocks(0, tuple((r // 2 * D, D) for r in range(tp)))
    for leaf in ("k_proj.weight", "k_proj.bias", "v_proj.weight", "v_proj.bias"):
        assert layout[pre + "self_attn." + leaf]["tp"] == kv
    for leaf, dim in (("mlp.gate_proj.weight", 0), ("mlp.up_proj.weight", 0),
                      ("mlp.down_proj.weight", 1)):
        assert layout[pre + leaf] == {"tp": dim}
    assert layout["language_model.embed_tokens.weight"] == {"tp": 0}
    assert layout["language_model.lm_head.weight"] == {"tp": 0}
    o = lm.layers[1].self_attn.o_proj.weight
    widths = [block_of(Blocks(1, q.spans), o.shape, tp, r)[2] for r in range(tp)]
    assert widths == [h * D for h in heads] and sum(widths) == H * D
    if (H, KV, tp) == (28, 4, 8):
        assert widths == [512, 384] * 4
        down = lm.layers[1].mlp.down_proj.weight
        assert block_of(1, down.shape, tp, 7) == (1, 7 * 2368, 2368)
        assert block_of(0, lm.lm_head.weight.shape, tp, 7) == (0, 7 * 19008, 19008)


@pytest.mark.parametrize("model,tp", [("7b", 1), ("7b", 2), ("7b", 4), ("tiny", 1),
                                      ("tiny", 2)])
def test_layouts_without_shared_kv_heads_are_the_tp_rules(model, tp):
    """Where tp divides the KV heads the serving layout is the TP rules'
    even blocks, as before the shared-KV layout: no `Blocks`."""
    if model == "7b":
        lm = _meta_7b()
    else:
        lm = qt.QwenTextModel(_text()[1])
    holder = torch.nn.ModuleDict({"language_model": lm})
    layout = serve_tp_layout(lm, tp)
    assert layout == qwen_tp_sharding(holder, {"tp": tp})
    assert not any(isinstance(v, Blocks) for spec in layout.values() for v in spec.values())


@pytest.mark.parametrize("model,tp", [("7b", 16), ("7b", 3), ("tiny", 8)])
def test_layouts_without_whole_heads_are_refused(model, tp):
    """tp = 16 at 7B would put four ranks on a KV head (1.75 query heads a
    rank); tp = 3 divides no head count; tp = 8 on the tiny config (4 / 2
    heads) would put four on one: each refused, naming q_proj."""
    lm = _meta_7b() if model == "7b" else qt.QwenTextModel(_text()[1])
    with pytest.raises(NotImplementedError,
                       match=rf"tp={tp}: language_model\.layers\.0\.self_attn\.q_proj\.weight"):
        serve_tp_layout(lm, tp)


def test_training_still_refuses_tp8_and_names_the_serving_layout():
    """`apply_tp` (training's DTensor plan) at tp = 8 on the 7B widths: the
    KV heads would have to be replicated over pairs of ranks with their
    gradients summed over each pair, which `Shard(0)` cannot express."""

    class Mesh8:
        def size(self):
            return 8

    lm = _meta_7b()
    model = torch.nn.ModuleDict({"language_model": lm})
    layout = qwen_tp_sharding(model, {"tp": 8})
    with pytest.raises(NotImplementedError,
                       match=r"tp=8: language_model\.layers\.0\.self_attn\.q_proj\.weight.*"
                             r"serve_tp_layout.*ROADMAP"):
        apply_tp(model, layout, Mesh8())


# ------------------------------------------------------------ gloo parity
def _jax_text_params(jcfg, seed):
    jm = jqt.QwenTextModel(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    pos = jnp.zeros((3, 1, 4), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ids, pos,
                                            method=jm.init_all))["params"]
    return jax.tree_util.tree_map(np.asarray, random_jax_params(shapes, seed))


def _jax_decode(jcfg, params, ids, mesh=None):
    """JAX's greedy decode of embed(ids) (replicated, or under
    `qwen_tp_sharding` on `mesh` with the rows over its dp axis where it
    has one) and its teacher-forced logits at the generated positions."""
    jm = jqt.QwenTextModel(jcfg)
    B = ids.shape[0]
    pos = jnp.broadcast_to(jnp.arange(T + NEW)[None, None], (3, B, T + NEW)).astype(jnp.int32)
    embeds = jm.apply({"params": params}, jnp.asarray(ids), method=jm.embed)

    def gen(p, e, po):
        return jqt.greedy_generate(jm, p, e, po, max_new_tokens=NEW, eos_token_ids=EOS)[:2]

    if mesh is None:
        tok, ln = jax.jit(gen)(params, embeds, pos[..., :T])
    else:
        rows = "dp" if "dp" in mesh.axis_names else None
        shardings = j_tp_sharding(mesh, params)
        e_sh, p_sh = NamedSharding(mesh, P(rows)), NamedSharding(mesh, P(None, rows))
        tok, ln = jax.jit(gen, in_shardings=(shardings, e_sh, p_sh))(
            jax.device_put(params, shardings), jax.device_put(embeds, e_sh),
            jax.device_put(pos[..., :T], p_sh))
    full = jnp.concatenate([jnp.asarray(ids), tok], axis=1)
    logits, _, _ = jax.jit(lambda p, i, po: jm.apply({"params": p}, jm.apply(
        {"params": p}, i, method=jm.embed), po))(params, full, pos)
    return np.asarray(tok), np.asarray(ln), np.asarray(logits[:, T - 1:T - 1 + NEW])


def _port_decode(lm, ids):
    """The port's unsharded decode of ids and its teacher-forced logits."""
    B = ids.shape[0]
    pos = torch.arange(T + NEW)[None, None].expand(3, B, T + NEW)
    prompt = torch.as_tensor(ids)
    with torch.inference_mode():
        tok, ln, _ = qt.greedy_generate(lm, lm.embed(prompt), pos[..., :T], max_new_tokens=NEW,
                                        eos_token_ids=EOS)
        logits, _, _ = lm(lm.embed(torch.cat([prompt, tok], 1)), pos)
    return tok.numpy(), ln.numpy(), logits[:, T - 1:T - 1 + NEW].numpy()


@pytest.fixture(scope="module")
def tp8(tmp_path_factory):
    """The 8 ranks' results (one spawn) beside JAX's and the port's
    unsharded decodes, which run while the ranks do."""
    from torch_gloo_workers import serve_tp8_worker

    tmp = tmp_path_factory.mktemp("serve_tp8")
    # the N1 policy with 28 / 4 text heads; its text model is case "tp8"'s
    jcfg = f32_config("nextdit")
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(
        jcfg.text, num_attention_heads=28, num_key_value_heads=4))
    params = jax.tree_util.tree_map(np.array, n1_params(jmodel.InternVLAN1Model(jcfg), jcfg,
                                                        seed=5))
    tcfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(
        tcfg.text, num_attention_heads=28, num_key_value_heads=4))
    policy = InternVLAN1Policy(load_from_jax(build_model(tcfg, device="cpu"), params))
    save_sharded(hf_state_dict(policy.model), str(tmp / "hf"))
    policy.save_pretrained(str(tmp / "native"))
    recorded = []
    fused_s2 = policy.fused_s2

    def record(*args):
        recorded.append(args)
        out = fused_s2(*args)
        recorded.append(out)
        return out

    policy.fused_s2 = record
    frame = np.random.default_rng(0).integers(0, 256, (56, 56, 3), dtype=np.uint8)
    policy.s2_step(frame, "go past the table and stop at the door", max_new_tokens=6)
    (*prompt, new), whole = recorded
    # the text models: 28 / 4 heads (the policy's) and 14 / 2 heads
    cases = {"tp8": (jcfg.text, tcfg.text, params["language_model"], {"dp": 1, "tp": 8})}
    j14, t14 = _text(jcfg.text, num_attention_heads=14, num_key_value_heads=2)
    cases["dp2_tp4"] = (j14, t14, _jax_text_params(j14, 6), {"dp": 2, "tp": 4})
    spec = {"decode": {}, "ckpt": str(tmp / "hf"), "native": str(tmp / "native"), "cfg": tcfg,
            "prompt": prompt, "new": new}
    lms = {}
    for name, (jc, tc, p, axes) in cases.items():
        lms[name] = load_from_jax(qt.QwenTextModel(tc), p)
        torch.save(lms[name].state_dict(), tmp / f"{name}.pt")
        spec["decode"][name] = {"mesh": axes, "text": tc, "state": str(tmp / f"{name}.pt")}
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    procs = start_ranks(serve_tp8_worker, 8, str(tmp / "store"), str(tmp / "spec.pkl"),
                        str(tmp))
    try:
        ref = {}
        devices = np.asarray(jax.devices()[:8])
        for name, (jc, _, p, axes) in cases.items():
            ids = np.random.RandomState(0).randint(0, jc.vocab_size, (2 * axes["dp"], T))
            mesh = Mesh(devices.reshape(axes["dp"], axes["tp"]), ("dp", "tp"))
            ref[name] = {"jax_sharded": _jax_decode(jc, p, ids, mesh),
                         "port": _port_decode(lms[name], ids)}
        ref["tp8"]["jax"] = _jax_decode(cases["tp8"][0], cases["tp8"][2],
                                        np.random.RandomState(0).randint(
                                            0, jcfg.text.vocab_size, (2, T)))
    finally:
        codes = join_ranks(procs, 150)
    assert codes == [0] * 8, codes
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(8)]
    return ref, ranks, whole


@pytest.mark.parametrize("case", ["tp8", "dp2_tp4"])
def test_shared_kv_decode_matches_jax_and_unsharded(tp8, case):
    """Tokens and lengths of the laid-out decode equal JAX's decode under
    its tp sharding and the port's unsharded decode (and, at tp = 8, JAX's
    replicated one)."""
    ref, ranks, _ = tp8
    jtok, jlen, _ = ref[case]["jax_sharded"]
    ptok, plen, _ = ref[case]["port"]
    np.testing.assert_array_equal(ptok, jtok)
    np.testing.assert_array_equal(plen, jlen)
    if case == "tp8":
        np.testing.assert_array_equal(ref[case]["jax"][0], jtok)
    for res in ranks:
        np.testing.assert_array_equal(res[case]["tokens"].numpy(), jtok)
        np.testing.assert_array_equal(res[case]["lengths"].numpy(), jlen)


@pytest.mark.parametrize("case", ["tp8", "dp2_tp4"])
def test_shared_kv_teacher_forced_logits_within_tolerance(tp8, case):
    """The prompt and its tokens re-prefilled through the laid-out model:
    the logits at the generated positions, gathered over the vocab split,
    within LOGIT_TOL of the unsharded prefill's in both packages."""
    ref, ranks, _ = tp8
    got = ranks[0][case]["logits"].numpy()
    for want in (ref[case]["port"][2], ref[case]["jax_sharded"][2]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def test_policy_fused_s2_at_tp8_from_rank_slices(tp8):
    """The tiny N1 policy loaded at tp = 8 from its HF-layout checkpoint,
    each rank reading its own blocks: (4, 1) local heads on even ranks,
    (3, 1) on odd ones, o_proj's uneven input blocks; `fused_s2`'s tokens
    and lengths equal the unsharded policy's, its traj latents within
    LOGIT_TOL; no collective staged through the host (CPU tensors); the
    native directory's blocks equal the HF checkpoint's."""
    _, ranks, (tokens, lengths, latents) = tp8
    D = 16
    for r, res in enumerate(ranks):
        pol = res["policy"]
        assert pol["heads"] == ((4, 1) if r % 2 == 0 else (3, 1))
        assert pol["blocks"]["layers.0.self_attn.o_proj.weight"] == (
            1, 7 * D * (r // 2) + (0 if r % 2 == 0 else 4 * D), pol["heads"][0] * D)
        assert pol["blocks"]["layers.0.self_attn.k_proj.weight"] == (0, r // 2 * D, D)
        assert pol["staged"] == {} and pol["native_equal"]
        np.testing.assert_array_equal(pol["tokens"].numpy(), tokens.numpy())
        np.testing.assert_array_equal(pol["lengths"].numpy(), lengths.numpy())
        np.testing.assert_allclose(pol["latents"].numpy(), latents.numpy(), atol=LOGIT_TOL,
                                   rtol=0)
