"""Multi-GPU greedy decode of the port at dp x tp (`parallel/tp.apply_serve_tp`,
the serving layout) held against the JAX package on the CPU.

The same weights go to both packages (the JAX init or JAX-layout trees,
through `model/weights/from_jax.py`); the port runs in gloo processes, JAX
on its 8-device virtual CPU mesh. Tokens and lengths are ints and are held
exactly. The text models are fp32 on both sides (the JAX test
`tests/test_serving_tp.py` runs bf16 within JAX alone; across the packages
fp32 keeps a near-tie in the logits from deciding a token).

- tp=2 in 2 processes: JAX's `test_tp_sharded_greedy_decode_matches_replicated`
  (B=2, T=10, 6 new tokens, EOS (3,)) against the port's single-device
  decode and JAX's replicated and tp-sharded decodes; a tie across vocab
  shards (the lm_head's rows equal in both halves of the vocab) broken to
  the lowest id as `jnp.argmax` does; a tiny `realtime` (W8A8, int8 KV)
  model, whose quantized projections stay whole and which decodes as
  unsharded; `vocab_argmax` on logits with ties inside and across shards.
- dp=4 x tp=2 in 8 processes: `graft_entry.dryrun_multichip(8)`'s serving
  phase against the single-device decode and JAX's phase 2
  (`__graft_entry__.py`), on the same weights.
- tp=3 on the tiny config: refused by `check_whole_heads`, naming the
  parameter.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.parallel.tp import qwen_tp_sharding as j_tp_sharding
from internnav_tpu_torch.graft_entry import dryrun_multichip
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.parallel.tp import serve_tp_layout
# fp32_jax_nextdit: autouse, the JAX tiny NextDiT in fp32 for every test here
from test_torch_system1 import f32_config, fp32_jax_nextdit, n1_params  # noqa: F401
from torch_gloo_workers import child_deadline, run_ranks

torch.set_num_threads(2)
EOS = (3,)
#: the tie case's lm_head: ids 100 (shard 0) and 300 (shard 1) share the
#: largest logit when the first hidden unit is positive; when it is not,
#: every other id ties at 0, in both shards
TIE = (100, 300)


def _cfgs(**fmt):
    j = dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jnp.float32, **fmt)
    t = dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.float32, **fmt)
    return j, t


def _jax_params(seed=0):
    jcfg, _ = _cfgs()
    jm = jqt.QwenTextModel(jcfg)
    ids = np.zeros((1, 4), np.int32)
    pos = np.zeros((3, 1, 4), np.int32)
    params = jax.jit(lambda i, p: jm.init(jax.random.PRNGKey(seed), i, p, method=jm.init_all))(
        jnp.asarray(ids), jnp.asarray(pos))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _tie_params(params):
    """The final norm passes the first hidden unit alone; the lm_head maps
    it to +100 at TIE's ids and to 0 elsewhere, so every logit is one
    exact product and the maximum is a tie across the two vocab shards."""
    p = jax.tree_util.tree_map(np.array, params)
    scale = np.zeros_like(p["norm"]["scale"])
    scale[0] = 1.0
    p["norm"]["scale"] = scale
    head = np.zeros_like(p["lm_head"]["kernel"])
    head[0, list(TIE)] = 100.0
    p["lm_head"]["kernel"] = head
    return p


def _jax_greedy(jcfg, params, ids, new, mesh=None):
    """JAX's greedy decode of embed(ids), replicated or (mesh) under
    `qwen_tp_sharding`, as tests/test_serving_tp.py runs it."""
    jm = jqt.QwenTextModel(jcfg)
    B, T = ids.shape
    pos = jnp.broadcast_to(jnp.arange(T)[None, None], (3, B, T))
    embeds = jm.apply({"params": params}, jnp.asarray(ids), method=jm.embed)

    def gen(p, e, po):
        return jqt.greedy_generate(jm, p, e, po, max_new_tokens=new, eos_token_ids=EOS)

    if mesh is None:
        out = jax.jit(gen)(params, embeds, pos)
    else:
        shardings = j_tp_sharding(mesh, params)
        repl = NamedSharding(mesh, P())
        out = jax.jit(gen, in_shardings=(shardings, repl, repl))(
            jax.device_put(params, shardings), jax.device_put(embeds, repl),
            jax.device_put(pos, repl))
    return tuple(np.asarray(a) for a in out)


def _port_greedy(tm, ids, new):
    B, T = ids.shape
    pos = torch.arange(T)[None, None].expand(3, B, T)
    with torch.inference_mode():
        tok, ln, _ = qt.greedy_generate(tm, tm.embed(torch.as_tensor(ids)), pos,
                                        max_new_tokens=new, eos_token_ids=EOS)
    return tok.numpy(), ln.numpy()


def _spawn(target, world, tmp, *args):
    run_ranks(target, world, str(tmp / "store"), *args, deadline_s=120)


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """The tp=2 cases, decoded in one 2-process run: per case the port's
    models (whole), JAX's params and config, and every rank's results."""
    from torch_gloo_workers import serve_tp_worker

    tmp = tmp_path_factory.mktemp("serve_tp")
    params = _jax_params()
    jcfg, tcfg = _cfgs()
    qcfg_j, qcfg_t = _cfgs(weight_dtype="int8", kv_dtype="int8")
    ids = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 10))
    cases = {
        "jax_test": (jcfg, tcfg, params, ids, 6),
        "tie": (jcfg, tcfg, _tie_params(params), ids, 6),
        "realtime": (qcfg_j, qcfg_t, jqt.quantize_qwen_text_params(params), ids, 6),
    }
    spec = {"cases": {}}
    models = {}
    for name, (jc, tc, p, case_ids, new) in cases.items():
        tm = load_from_jax(qt.QwenTextModel(tc), p)
        models[name] = tm
        torch.save(tm.state_dict(), tmp / f"{name}.pt")
        spec["cases"][name] = {"cfg": tc, "state": str(tmp / f"{name}.pt"), "ids": case_ids,
                               "new": new, "eos": EOS}
    # logits (2 rows, 8 ids) split 4 | 4: row 0's maximum 5 at ids 1, 2
    # (shard 0) and 4, 6 (shard 1); row 1's at 5 and 7 (shard 1 alone)
    logits = np.array([[1, 5, 5, 2, 5, 0, 5, 1], [4, 0, 4, 3, 0, 5, 1, 5]], np.float32)
    spec["argmax_logits"] = [logits[:, :4], logits[:, 4:]]
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    _spawn(serve_tp_worker, 2, tmp, str(tmp / "spec.pkl"), str(tmp))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return cases, models, ranks, logits


def _check_ranks(ranks, name, want_tok, want_len):
    for res in ranks:
        np.testing.assert_array_equal(res[name]["tokens"].numpy(), want_tok)
        np.testing.assert_array_equal(res[name]["lengths"].numpy(), want_len)


def test_tp2_greedy_decode_matches_single_device_and_jax(tp2):
    """JAX's test_tp_sharded_greedy_decode_matches_replicated at tp=2: the
    port's tp=2 decode equals its single-device decode and JAX's, which
    equals JAX's own tp-sharded decode."""
    cases, models, ranks, _ = tp2
    jcfg, _, params, ids, new = cases["jax_test"]
    jtok, jlen = _jax_greedy(jcfg, params, ids, new)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
    stok, slen = _jax_greedy(jcfg, params, ids, new, mesh)
    np.testing.assert_array_equal(stok, jtok)
    np.testing.assert_array_equal(slen, jlen)
    ttok, tlen = _port_greedy(models["jax_test"], ids, new)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tlen, jlen)
    _check_ranks(ranks, "jax_test", jtok, jlen)
    res = ranks[1]["jax_test"]
    # every projection, the embedding and the lm_head split; whole local heads
    assert res["reduce"] == (True, True) and res["starts"] == (256, 256)
    assert res["heads"] == (2, 1)
    assert "language_model.layers.1.self_attn.o_proj.weight" in res["split"]


def test_tie_across_vocab_shards_goes_to_the_lowest_id(tp2):
    cases, models, ranks, _ = tp2
    jcfg, _, params, ids, new = cases["tie"]
    jtok, jlen = _jax_greedy(jcfg, params, ids, new)
    assert set(np.unique(jtok)) <= {TIE[0], 0}  # the lowest id of the tie, in shard 0
    ttok, tlen = _port_greedy(models["tie"], ids, new)
    np.testing.assert_array_equal(ttok, jtok)
    _check_ranks(ranks, "tie", jtok, jlen)


def test_vocab_argmax_breaks_ties_as_jnp_argmax(tp2):
    *_, ranks, logits = tp2
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    assert want.tolist() == [1, 5]
    for res in ranks:
        np.testing.assert_array_equal(res["argmax"].numpy(), want)


def test_realtime_keeps_quantized_projections_whole(tp2):
    """A tiny W8A8 / int8-KV model at tp=2: the quantized projections and
    the int8 lm_head stay whole on both ranks (no all-reduce in the
    layers), the bf16 embedding splits its vocab, and the tokens equal the
    unsharded decode's and JAX's."""
    cases, models, ranks, _ = tp2
    jcfg, _, params, ids, new = cases["realtime"]
    jtok, jlen = _jax_greedy(jcfg, params, ids, new)
    ttok, tlen = _port_greedy(models["realtime"], ids, new)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tlen, jlen)
    _check_ranks(ranks, "realtime", jtok, jlen)
    whole = {n: tuple(b.shape) for n, b in models["realtime"].layers[0].named_buffers()}
    got = [r["realtime"] for r in ranks]
    for res in got:
        assert res["split"] == ["language_model.embed_tokens.weight"]
        assert res["reduce"] == (False, False) and res["heads"] == (4, 2)
        assert res["starts"][1] is None and res["buffers"] == whole
    assert [res["starts"][0] for res in got] == [0, 256]


def test_dryrun_multichip_serving_matches_single_device_and_jax(tmp_path):
    """`dryrun_multichip(8)`'s serving phase at dp=4 x tp=2 (B = 8 rows of
    T = 24, 4 new tokens, EOS (3,)) from the same tiny N1 weights as JAX's
    phase 2, which runs here on JAX's 8-device dp x tp mesh."""
    cfg = f32_config("nextdit")
    from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel

    jm = jmodel.InternVLAN1Model(cfg)
    params = jax.tree_util.tree_map(np.array, n1_params(jm, cfg, seed=4))
    tcfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
    model = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
    torch.save(model.state_dict(), tmp_path / "state.pt")
    # the serving phase alone: the training step is test_torch_parallel.py's
    with child_deadline(120):
        res = dryrun_multichip(8, spec={"state": str(tmp_path / "state.pt"), "train": False})

    # JAX's phase 2 on the same language model
    tparams = params["language_model"]
    tmodel = jqt.QwenTextModel(cfg.text)
    dp, tp = 4, 2
    B, T = 2 * dp, 24
    ids = np.random.RandomState(0).randint(0, cfg.text.vocab_size, (B, T))
    pos = jnp.broadcast_to(jnp.arange(T)[None, None], (3, B, T)).astype(jnp.int32)
    embeds = tmodel.apply({"params": tparams}, jnp.asarray(ids), method=tmodel.embed)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(dp, tp), ("dp", "tp"))
    shardings = j_tp_sharding(mesh, tparams)

    def serve(p, e, po):
        return jqt.greedy_generate(tmodel, p, e, po, max_new_tokens=4, eos_token_ids=EOS)

    jtok, jlen = jax.jit(serve, in_shardings=(shardings, NamedSharding(mesh, P("dp")),
                                              NamedSharding(mesh, P(None, "dp"))))(
        jax.device_put(tparams, shardings), jax.device_put(embeds, NamedSharding(mesh, P("dp"))),
        jax.device_put(pos, NamedSharding(mesh, P(None, "dp"))))
    ttok, tlen = _port_greedy(model.language_model, ids, 4)
    np.testing.assert_array_equal(ttok, np.asarray(jtok))
    np.testing.assert_array_equal(tlen, np.asarray(jlen))
    np.testing.assert_array_equal(res["serve"]["tokens"].numpy(), ttok)
    np.testing.assert_array_equal(res["serve"]["lengths"].numpy(), tlen)


def test_tp3_is_refused_naming_the_parameter():
    """tp=3 on the tiny config: 4 query heads of 16 do not split into whole
    heads a rank, so the layout falls through to replicated and
    `check_whole_heads` refuses it."""
    tm = qt.QwenTextModel(_cfgs()[1])
    with pytest.raises(NotImplementedError,
                       match=r"tp=3: language_model\.layers\.0\.self_attn\.q_proj\.weight"):
        serve_tp_layout(tm, 3)
    assert serve_tp_layout(tm, 2)["language_model.layers.0.mlp.down_proj.weight"] == {"tp": 1}
