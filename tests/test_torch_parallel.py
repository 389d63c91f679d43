"""The port's sharded N1 training (`parallel/`, the trainer's layouts) held
against the JAX package on the CPU.

- Layout rules: `fsdp_param_sharding` and `qwen_tp_sharding` give, leaf by
  leaf, the JAX `PartitionSpec`s of the tiny N1 policy at dp=4 and at
  dp=4 x tp=2, in the port's torch dims; `mesh_sizes` resolves -1 and
  refuses a mesh that does not fill the ranks; the collectives are the
  identity without a process group, and in 4 gloo processes on a 2 x 2
  mesh reduce over the mesh dimension they name.
- Sharded steps: `graft_entry.dryrun_multichip` trains one step in gloo
  CPU processes (8 at dp=4 x tp=2 with fsdp_rest; 4 at dp=4 FSDP on 4 rows
  of unequal valid-token counts), held against JAX's step on its 8-device
  virtual mesh in the same layout: losses and grad_norm at 1e-4, the
  updated parameters gathered on rank 0 within 2% of the learning rate
  (test_torch_train.py's tolerance: Adam moves each element by about lr,
  so float noise in a gradient near zero can move it by a fraction of
  lr), the frozen vision tower bitwise. The dp x tp run starts from a
  single-device checkpoint and writes one that a single-device trainer
  restores bitwise.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from internnav_tpu.configs.trainer import ExpCfg as JExpCfg
from internnav_tpu.configs.trainer import MeshCfg as JMeshCfg
from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu.model.basemodel.internvla_n1.policy import SimpleTokenizer as JTokenizer
from internnav_tpu.parallel.mesh import fsdp_param_sharding as j_fsdp_sharding
from internnav_tpu.parallel.tp import qwen_tp_sharding as j_tp_sharding
from internnav_tpu.trainer.internvla_n1_trainer import InternVLAN1Trainer as JTrainer
from internnav_tpu_torch import parallel
from internnav_tpu_torch.configs.trainer import ExpCfg
from internnav_tpu_torch.dataset.internvla_n1_dataset import (
    N1SampleDataset,
    n1_packed_collate_fn,
    stack_packed_rows,
    tokenize_sample,
    write_synthetic_n1_dataset,
)
from internnav_tpu_torch.graft_entry import dryrun_multichip
from torch_gloo_workers import child_deadline
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import _resolve, load_from_jax
from internnav_tpu_torch.parallel.mesh import mesh_sizes, row_bounds
from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer
# fp32_jax_nextdit: autouse, the JAX tiny NextDiT in fp32 for every test here
from test_torch_system1 import f32_config, fp32_jax_nextdit, n1_params  # noqa: F401

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
LR = 1e-3
#: parameters whose update is compared (one of each trainable group)
UPDATED = ("language_model.layers.0.self_attn.q_proj.weight",
           "language_model.layers.1.mlp.down_proj.weight", "language_model.embed_tokens.weight",
           "language_model.lm_head.weight", "latent_queries", "cond_projector.0.weight",
           "action_decoder.weight", "traj_dit.layers.0.attn1.to_q.weight")


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------ layout rules
def _jax_layout(shardings, model):
    """A JAX NamedSharding tree as the port's layout: port name → {axis:
    torch dim} (a Dense kernel (in, out) is the torch (out, in) weight, a
    conv kernel HWIO is OIHW; `model/weights/from_jax.py`'s naming)."""
    shapes = model.state_dict()
    specs = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if hasattr(v, "spec"):
                specs[prefix + (str(k),)] = v.spec
            else:
                walk(v, prefix + (str(k),))

    walk(shardings)
    out = {}
    for path, spec in specs.items():
        leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(path[-1],
                                                                                 path[-1])
        key = _resolve(path[:-1] + (leaf,), set(shapes))
        to_torch = ({2: {0: 1, 1: 0}, 4: {0: 2, 1: 3, 2: 1, 3: 0}}[shapes[key].dim()]
                    if path[-1] == "kernel" else {})
        out[key] = {axis: to_torch.get(j, j) for j, axis in enumerate(spec) if axis is not None}
    return out


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = f32_config("nextdit")
    jm = jmodel.InternVLAN1Model(cfg)
    params = jax.tree_util.tree_map(np.array, n1_params(jm, cfg, seed=4))
    tcfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
    model = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
    return cfg, jm, params, model


@pytest.mark.parametrize("rule", ["fsdp", "tp", "tp_fsdp_rest"])
def test_layout_rules_match_jax_partition_specs(tiny_pair, rule):
    """Every leaf of the tiny N1 tree: FSDP at dp=4, and the Megatron TP
    rules at dp=4 x tp=2 without and with fsdp_rest."""
    _, _, params, model = tiny_pair
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    sizes = {"dp": 4, "tp": 2}
    if rule == "fsdp":
        want = _jax_layout(j_fsdp_sharding(mesh, params, axis="dp"), model)
        got = parallel.fsdp_param_sharding(model, sizes, "dp")
    else:
        rest = rule == "tp_fsdp_rest"
        want = _jax_layout(j_tp_sharding(mesh, params, fsdp_rest=rest), model)
        got = parallel.qwen_tp_sharding(model, sizes, fsdp_rest=rest)
    assert set(got) == set(want) == {n for n, _ in model.named_parameters()}
    assert {n: d for n, d in got.items() if d != want[n]} == {}
    # the rule splits something on every axis it names
    split = {axis for d in got.values() for axis in d}
    assert split == ({"dp"} if rule == "fsdp" else {"tp", "dp"} if rest else {"tp"})


def test_mesh_sizes_and_identity_collectives():
    assert mesh_sizes({"dp": -1, "tp": 2}, 8) == {"dp": 4, "tp": 2}
    assert mesh_sizes(None, 4) == {"dp": 4}
    for axes, world in (({"dp": 3}, 8), ({"dp": -1, "tp": 3}, 8), ({"dp": -1, "tp": -1}, 4)):
        with pytest.raises(ValueError):
            mesh_sizes(axes, world)
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh({"dp": 1})
    assert parallel.get_rank() == 0 and parallel.get_world_size() == 1
    assert parallel.is_main_process()
    assert parallel.all_reduce_mean(2.5) == 2.5 and parallel.host_broadcast("cfg") == "cfg"
    x = torch.ones(3)
    assert parallel.psum_mean(x, None, "dp") is x
    parallel.grad_allreduce([x], None, "dp")
    assert torch.equal(x, torch.ones(3))
    seen = []
    parallel.save_on_master(seen.append, 1)
    assert seen == [1]
    rows = {"a": torch.arange(8).reshape(4, 2), "b": torch.zeros(3)}
    assert parallel.shard_batch(rows, {"dp": 2})["a"].shape == (2, 2)
    assert parallel.shard_batch(rows, None)["a"] is rows["a"]
    assert [row_bounds(8, 4, i) for i in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert row_bounds(6, 4, 3) == (0, 6)


def test_collectives_over_a_gloo_mesh(tmp_path):
    """Each collective's multi-rank branch in 4 gloo processes on a
    dp x tp = 2 x 2 mesh (rank = 2·dp + tp): means, sums and maxima over
    one mesh dimension, rank 0's value broadcast, rank 0 alone saving, and
    each dp rank's block of rows."""
    from torch_gloo_workers import collectives_worker, run_ranks

    run_ranks(collectives_worker, 4, str(tmp_path / "store"), str(tmp_path), deadline_s=90)
    for r in range(4):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        dp, tp = divmod(r, 2)
        assert res["coords"] == (dp, tp)
        assert (res["rank"], res["world"], res["main"], res["saved"]) == (r, 4, r == 0,
                                                                          [0] if r == 0 else [])
        assert res["device"] == "cpu"
        assert res["mean_scalar"] == 1.5
        assert res["mean_array"].dtype == np.float32
        np.testing.assert_array_equal(res["mean_array"], [1.5, 3.0])
        assert res["broadcast"] == {"from": 0}
        dp_peers = torch.tensor([[q, 10.0 * q] for q in (tp, 2 + tp)])
        tp_peers = torch.tensor([[q, 10.0 * q] for q in (2 * dp, 2 * dp + 1)])
        assert torch.equal(res["psum_mean_dp"], dp_peers.mean(0))
        assert torch.equal(res["psum_mean_tp"], tp_peers.mean(0))
        assert torch.equal(res["grad_allreduce_tp"], tp_peers.mean(0))
        assert torch.equal(res["psum_forward_tp"], tp_peers.sum(0))
        assert torch.equal(res["psum_forward_grad"], torch.tensor([1.0, 2.0]))  # unchanged
        assert torch.equal(res["pmax_dp"], dp_peers.amax(0))
        shard = res["shard_dp"]
        assert torch.equal(shard["a"], torch.arange(8).reshape(4, 2)[2 * dp:2 * dp + 2])
        assert torch.equal(shard["odd"], torch.arange(3)) and shard["n"] == 5


# ------------------------------------------------------------ sharded steps
def _samples(tmp_path, tok, tpi, cfg, n):
    path = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=3, T=8, hw=28)
    ds = N1SampleDataset(path, predict_step_nums=cfg.predict_step_nums, num_history=2)
    out = []
    for s in ds:
        out.append(tokenize_sample(s, tok, tokens_per_image=tpi, n_query=cfg.n_query))
        if len(out) == n:
            return out
    raise AssertionError("store too small")


def _jax_step(params, cfg, batch, mesh, tmp, accum=1):
    """JAX's one train_on_batches step: (metrics, updated params, Adam's
    first moments (1 - b1) x the clipped gradient, the step's System-1
    draws: one (t, noise) pair, or at accum > 1 a list of each
    micro-batch's, from fold_in(key, i))."""
    jm = jmodel.InternVLAN1Model(cfg)
    jpol = JPolicy(jm, jax.tree_util.tree_map(jnp.array, params), cfg,
                   tokenizer=JTokenizer(cfg.text.vocab_size))
    jexp = JExpCfg(name="jsharded", model_name="internvla_n1", output_dir=str(tmp),
                   mesh=JMeshCfg(**mesh))
    jexp.il.lr, jexp.il.lr_schedule = LR, "constant"
    jexp.il.grad_accum_steps = accum
    jt = JTrainer(jexp, jpol, total_steps=1)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    if accum == 1:
        metrics = jt.train_on_batches([batch])
    else:  # its train() path: train_on_batches skips the micro-batch stacking
        prepared = jt.shard_batch(jt.prepare_batch(batch))
        jt.params, jt.opt_state, metrics = jt.build_train_step()(jt.params, jt.opt_state,
                                                                prepared, sub)
        metrics = {k: float(v) for k, v in metrics.items()}
    mu = jt.opt_state.inner_states["train"].inner_state[1][0].mu
    N = batch["traj_poses"].shape[0]

    def draws(key):
        r_t, r_n = jax.random.split(key)
        t = np.array((jax.random.uniform(r_t, (N,)) * 1000).astype(jnp.int32))
        noise = np.array(jax.random.normal(r_n, (N, cfg.predict_step_nums, 3)))
        return torch.from_numpy(t), torch.from_numpy(noise)

    drawn = draws(sub) if accum == 1 else [draws(jax.random.fold_in(sub, i))
                                           for i in range(accum)]
    return metrics, jax.device_get(jt.params), jax.device_get(mu), drawn


def _port_tensors(tree, model):
    """The array leaves of a JAX tree under the port's names and layouts
    (`from_jax` naming); masked leaves (frozen parameters) skipped."""
    names = set(model.state_dict())
    out = {}

    def walk(node, prefix=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (str(k),))
            elif hasattr(v, "shape"):
                leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(k, k)
                a = np.asarray(v)
                if k == "kernel":
                    a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
                out[_resolve(prefix + (leaf,), names)] = torch.from_numpy(np.array(a))

    walk(tree)
    return out


#: Adam's first update is lr·g/(|g| + 1e-8) of the clipped gradient g, so
#: a gradient error δ moves it by lr·1e-8·δ/(|g| + 1e-8)². With the
#: gradients held within δ <= 1e-6 + 1e-4·|g|, that bound is under 2% of lr
#: only for |g| >= 1e-6: below it the update is not determined by the
#: checked gradient (summation order decides it), and only the gradient
#: is compared
NOISE_GRAD = 1e-6


def _check_step(got_metrics, got_state, jax_out, start, tcfg):
    """Losses and grad_norm; every trainable gradient (Adam's first moment
    over 1 - b1); the updates of UPDATED, except the elements whose
    gradient is float noise, not 0 and under NOISE_GRAD (at most 1% of a
    parameter); the frozen vision tower unchanged."""
    jm_out, jparams, jmu, _ = jax_out
    for k in ("lm_loss", "s1_loss", "loss", "grad_norm"):
        _close(got_metrics[k], jm_out[k])
    model = tpolicy.build_model(tcfg, device="cpu")
    want = load_from_jax(model, jparams).state_dict()
    want_g = {n: m / 0.1 for n, m in _port_tensors(jmu, model).items()}
    got_g = {n: m / 0.1 for n, m in got_state["opt_state"]["mu"].items()}
    assert set(got_g) == set(want_g) and len(got_g) > 20
    for name, g in want_g.items():
        _close(got_g[name], g, atol=1e-6, rtol=1e-4)
    got = got_state["params"]
    for name in UPDATED:
        assert not torch.equal(got[name], start[name]), name
        g = want_g[name].abs()
        live = (g >= NOISE_GRAD) | (g == 0)  # an unreached element stays put on both sides
        assert live.float().mean() > 0.9, name  # few elements' gradients are that small
        _close((got[name] - start[name])[live], (want[name] - start[name])[live],
               atol=0.02 * LR, rtol=0)
    for name, value in start.items():
        if name.startswith("visual."):
            assert torch.equal(got[name], value), name


def _exp(tmp, **mesh):
    from internnav_tpu_torch.configs.trainer import MeshCfg

    exp = ExpCfg(name="tsharded", model_name="internvla_n1", output_dir=str(tmp),
                 mesh=MeshCfg(**mesh))
    exp.il.lr, exp.il.lr_schedule = LR, "constant"
    return exp


def test_dp4_tp2_step_matches_jax_and_checkpoints_cross_layouts(tiny_pair, tmp_path):
    """One step at dp=4 x tp=2 (param_sharding tp, fsdp_rest) in 8 gloo
    processes from a single-device checkpoint, against JAX's step on its
    dp=4 x tp=2 mesh; the step's checkpoint restores single-device."""
    cfg, _, params, model = tiny_pair
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)

    def policy():
        return tpolicy.InternVLAN1Policy(
            load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params))

    pol = policy()
    rows = _samples(tmp_path, pol.tokenizer, pol._tokens_per_image((28, 28)), cfg, 2)
    batch = n1_packed_collate_fn(rows, max_len=256, predict_step_nums=cfg.predict_step_nums)
    mesh = {"axes": {"dp": 4, "tp": 2}, "param_sharding": "tp", "fsdp_rest": True}
    jax_out = _jax_step(params, cfg, batch, mesh, tmp_path / "j")

    out = tmp_path / "ckpt"
    InternVLAN1Trainer(_exp(out), pol, total_steps=1).save_checkpoint()  # step 0, one device
    with open(tmp_path / "batch.pkl", "wb") as f:
        pickle.dump(batch, f)
    with child_deadline(120):
        res = dryrun_multichip(8, spec={"mesh": mesh, "il": {"lr": LR, "lr_schedule": "constant"},
                                        "batch": str(tmp_path / "batch.pkl"),
                                        "draws": jax_out[3], "output_dir": str(out),
                                        "resume": True, "save": True, "gather": True})
    assert res["step"] == 1
    _check_step(res["metrics"], res["state"], jax_out, start, tcfg)
    got = res["state"]["params"]

    # the dp x tp checkpoint in a single-device trainer
    single = InternVLAN1Trainer(_exp(out), policy(), total_steps=2)
    assert single.maybe_restore() and single.step == 1 and single.optimizer.count == 1
    for name, p in single.model.named_parameters():
        assert torch.equal(p.detach(), got[name]), name
    for name, m in single.optimizer.mu.items():
        assert torch.equal(m, res["state"]["opt_state"]["mu"][name]), name


def test_dp4_fsdp_step_over_unequal_rows_matches_jax(tiny_pair, tmp_path):
    """One step at dp=4 FSDP in 4 gloo processes over 4 packed rows whose
    valid-label counts differ: each rank's token mean would differ; the
    global mean over the step's tokens equals JAX's on the whole batch."""
    cfg, _, params, model = tiny_pair
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
    pol = tpolicy.InternVLAN1Policy(load_from_jax(tpolicy.build_model(tcfg, device="cpu"),
                                                  params))
    rows = _samples(tmp_path, pol.tokenizer, pol._tokens_per_image((28, 28)), cfg, 7)
    groups = (rows[0:1], rows[1:3], rows[3:4], rows[4:7])
    batch = stack_packed_rows([n1_packed_collate_fn(g, max_len=192,
                                                    predict_step_nums=cfg.predict_step_nums)
                               for g in groups])
    valid = (batch["labels"][:, 1:] != -100).sum(1)
    assert len(set(valid.tolist())) == 4, valid
    mesh = {"axes": {"dp": 4, "tp": 2}, "param_sharding": "fsdp"}
    jax_out = _jax_step(params, cfg, batch, mesh, tmp_path / "j")
    with open(tmp_path / "batch.pkl", "wb") as f:
        pickle.dump(batch, f)
    torch.save(start, tmp_path / "state.pt")
    with child_deadline(120):
        res = dryrun_multichip(4, spec={"mesh": {"axes": {"dp": 4}, "param_sharding": "fsdp"},
                                        "il": {"lr": LR, "lr_schedule": "constant"},
                                        "state": str(tmp_path / "state.pt"),
                                        "batch": str(tmp_path / "batch.pkl"),
                                        "draws": jax_out[3], "gather": True})
    _check_step(res["metrics"], res["state"], jax_out, start, tcfg)
