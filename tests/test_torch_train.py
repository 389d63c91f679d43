"""The port's training path held against the JAX package on the CPU.

Tiny configs, fp32 weights (numpy draws through `model/weights/from_jax.py`)
and the same inputs on both sides. Tolerances:
- losses, gradients and optimizer updates of fp32 math at atol/rtol 1e-4
  or tighter: the same arithmetic in a different summation order;
- bf16-stored Adam moments at the same tolerance: both sides update in
  fp32 and round the stored moments with round-to-nearest-even;
- the trainer's updated parameters to 2% of one step's learning rate
  (Adam normalizes each update to about lr, so float noise in a gradient
  near zero can move it by a fraction of lr);
- the frozen vision tower bitwise.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.configs.trainer import ExpCfg as JExpCfg
from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu.model.basemodel.internvla_n1.policy import SimpleTokenizer as JTokenizer
from internnav_tpu.trainer import base as jbase
from internnav_tpu.trainer.internvla_n1_trainer import InternVLAN1Trainer as JTrainer
from internnav_tpu_torch.configs.trainer import ExpCfg
from internnav_tpu_torch.dataset.internvla_n1_dataset import (
    N1SampleDataset,
    n1_packed_collate_fn,
    tokenize_sample,
    write_synthetic_n1_dataset,
)
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.trainer import base as tbase
from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer
# fp32_jax_nextdit: autouse, the JAX tiny NextDiT in fp32 for every test here
from test_torch_system1 import f32_config, fp32_jax_nextdit, n1_params  # noqa: F401

torch.set_num_threads(2)
ATOL = RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------------ losses
@pytest.fixture(scope="module")
def text_pair():
    jcfg = dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jnp.float32)
    jm = jqt.QwenTextModel(jcfg)
    B, T = 2, 40
    r = np.random.default_rng(0)
    ids = r.integers(0, jcfg.vocab_size, (B, T))
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T))
    params = jax.jit(lambda i, p: jm.init(jax.random.PRNGKey(0), i, p, method=jm.init_all))(
        jnp.asarray(ids), jnp.asarray(pos))["params"]
    tm = load_from_jax(qt.QwenTextModel(dataclasses.replace(qt.QwenTextConfig.tiny(),
                                                            dtype=torch.float32)), params)
    labels = np.where(r.random((B, T)) < 0.3, -100, r.integers(0, jcfg.vocab_size, (B, T)))
    hidden = r.standard_normal((B, T, jcfg.hidden_size)).astype(np.float32)
    return jm, params, tm, hidden, labels, pos


def test_chunked_ce_equals_full_logits_and_jax(text_pair):
    """chunk=16 does not divide T - 1 = 39: the last chunk is short."""
    jm, params, tm, hidden, labels, _ = text_pair
    ref = jax.jit(lambda p, h, lab: jm.apply({"params": p}, h, lab, ignore_index=-100, chunk=16,
                                              method=jm.chunked_ce))(
        params, jnp.asarray(hidden), jnp.asarray(labels))
    h = _t(hidden).requires_grad_()
    loss = tm.chunked_ce(h, _t(labels), ignore_index=-100, chunk=16)
    (grad,) = torch.autograd.grad(loss, h)
    _close(loss.detach(), ref)
    h2 = _t(hidden).requires_grad_()
    logits = tm._logits(h2)[:, :-1]
    lab = _t(labels)[:, 1:]
    valid = lab != -100
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                           torch.where(valid, lab, 0).reshape(-1),
                                           reduction="none").reshape(valid.shape)
    full = (ce * valid).sum() / valid.sum()
    (grad_full,) = torch.autograd.grad(full, h2)
    _close(loss.detach(), full.detach(), atol=1e-6, rtol=1e-6)
    _close(grad, grad_full, atol=1e-6, rtol=1e-5)


def test_remat_gives_equal_loss_and_gradients(text_pair):
    """QwenTextConfig.remat recomputes each layer in backward: the same
    loss and parameter gradients, and the same parameter names."""
    _, params, _, hidden, labels, pos = text_pair
    emb = np.random.default_rng(1).standard_normal(hidden.shape).astype(np.float32)
    seg = np.zeros(labels.shape, np.int32)
    seg[:, 25:] = 1
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.float32, remat=remat)
        tm = load_from_jax(qt.QwenTextModel(cfg), params)
        logits, h, caches = tm(_t(emb), _t(pos), segment_ids=_t(seg), compute_logits=False)
        assert logits is None and (caches is None) == remat
        loss = tm.chunked_ce(h, _t(labels), ignore_index=-100, chunk=8)
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()
                                              if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    assert g0.keys() == g1.keys() and len(g0) > 10
    _close(l1, l0, atol=0, rtol=1e-6)
    for name in g0:
        _close(g1[name], g0[name], atol=1e-7, rtol=1e-5)


def test_traj_loss_nextdit_matches_jax_with_its_draws():
    """The port is handed the timesteps and noise the JAX loss draws from
    its key; loss and the latent gradient agree."""
    cfg = f32_config("nextdit")
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, cfg, seed=2)
    tm = load_from_jax(tpolicy.build_model(InternVLAN1Config.tiny("nextdit", dtype=torch.float32),
                                           device="cpu"),
                       params)
    r = np.random.default_rng(3)
    N, P = 3, cfg.predict_step_nums
    hidden = r.standard_normal((N, cfg.n_query, cfg.text.hidden_size)).astype(np.float32)
    poses = r.standard_normal((N, P, 3)).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    key = jax.random.PRNGKey(7)

    def jloss(p, h):
        return jm.apply({"params": p}, h, jnp.asarray(poses), key, loss_mask=jnp.asarray(mask),
                        method=jm.traj_loss_nextdit)

    ref, ref_grad = jax.jit(jax.value_and_grad(jloss, argnums=1))(params, jnp.asarray(hidden))
    r_t, r_n = jax.random.split(key)
    t = np.asarray((jax.random.uniform(r_t, (N,)) * 1000).astype(jnp.int32))
    noise = np.asarray(jax.random.normal(r_n, (N, P, 3)))
    h = _t(hidden).requires_grad_()
    loss = tm.traj_loss_nextdit(h, _t(poses), t=_t(t), noise=_t(noise), loss_mask=_t(mask))
    (grad,) = torch.autograd.grad(loss, h)
    _close(loss.detach(), ref)
    _close(grad, ref_grad, atol=1e-6)


# --------------------------------------------------------------- optimizer
class _Tiny(torch.nn.Module):
    """A parameter tree with every decay-mask case: kernels, biases, a norm
    scale, an embedding and a named parameter."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(6, 5)
        self.norm = qt.RMSNorm(5)
        self.embed = torch.nn.Embedding(7, 5)
        self.latent_queries = torch.nn.Parameter(torch.zeros(1, 2, 5))


def _tiny_trees(seed):
    r = np.random.default_rng(seed)
    jtree = {"proj": {"kernel": r.standard_normal((6, 5)), "bias": r.standard_normal(5)},
             "norm": {"scale": 1 + 0.1 * r.standard_normal(5)},
             "embed": {"embedding": r.standard_normal((7, 5))},
             "latent_queries": r.standard_normal((1, 2, 5))}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jtree)


@pytest.mark.parametrize("state_dtype", [None, "fp32", "bf16"])
def test_optimizer_matches_the_jax_chain(state_dtype):
    """Three steps of clip → Adam → decayed weights → warmup-cosine. The
    first update is zero (lr read at count 0); weight decay 0.1 shows the
    mask; the gradient norms straddle max_grad_norm so clipping acts on
    some steps only."""
    exp = JExpCfg()
    exp.il.weight_decay, exp.il.lr, exp.il.warmup_ratio = 0.1, 1e-2, 0.25
    exp.il.opt_state_dtype = state_dtype
    total = 4
    tx = jbase.make_optimizer(exp, total)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tiny_trees(0))
    jstate = tx.init(jparams)
    tm = load_from_jax(_Tiny(), _tiny_trees(0))
    opt = tbase.make_optimizer(ExpCfg.model_validate(exp.model_dump()), total, tm)
    for step, scale in enumerate((3.0, 0.05, 2.0)):
        grads = jax.tree_util.tree_map(lambda a: a * scale, _tiny_trees(10 + step))
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        jparams = optax.apply_updates(jparams, upd)
        gsd = {n: g.numpy() for n, g in load_from_jax(_Tiny(), grads).state_dict().items()}
        for n, p in tm.named_parameters():
            p.grad = torch.from_numpy(gsd[n])
        gnorm = opt.step()
        _close(gnorm, optax.global_norm(grads), atol=1e-6, rtol=1e-6)
        want = load_from_jax(_Tiny(), jax.device_get(jparams)).state_dict()
        for n, p in tm.named_parameters():
            if step == 0:
                assert torch.equal(p.detach(), before[n]), n  # lr(0) == 0
            _close(p.detach(), want[n], atol=1e-6, rtol=1e-6)
    stored = {"bf16": torch.bfloat16, "fp32": torch.float32, None: torch.float32}[state_dtype]
    assert all(m.dtype == stored for m in opt.mu.values())


def test_schedules_read_before_the_increment():
    for kind in ("cosine", "linear", "constant"):
        exp = JExpCfg()
        exp.il.lr_schedule, exp.il.warmup_ratio = kind, 0.2
        il = ExpCfg.model_validate(exp.model_dump()).il
        sched = tbase.make_schedule(il, 10)
        if kind == "cosine":
            ref = optax.warmup_cosine_decay_schedule(0.0, il.lr, 2, 10)
        elif kind == "linear":
            ref = optax.join_schedules([optax.linear_schedule(0.0, il.lr, 2),
                                        optax.linear_schedule(il.lr, 0.0, 8)], [2])
        else:
            ref = lambda c: il.lr  # noqa: E731
        for c in range(12):
            _close(sched(c), ref(c), atol=1e-9, rtol=1e-6)


# ----------------------------------------------------------------- trainer
def _pick_rows(path, tok, tpi, n_query, predict):
    """A STOP-or-action sample then a traj-bearing one, tokenized."""
    ds = N1SampleDataset(path, predict_step_nums=predict, num_history=2)
    plain = traj = None
    for s in ds:
        if s.has_traj and traj is None:
            traj = s
        if not s.has_traj and plain is None:
            plain = s
        if plain is not None and traj is not None:
            break
    return [tokenize_sample(s, tok, tokens_per_image=tpi, n_query=n_query) for s in (plain, traj)]


def test_trainer_two_steps_match_jax(tmp_path):
    """Two train_on_batches steps of the port and of the JAX
    InternVLAN1Trainer from the same weights and batch: lm_loss, s1_loss,
    grad_norm and the updated parameters; the vision tower stays bitwise
    frozen. The port is handed the JAX System-1 draws of each step."""
    path = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=2, T=6, hw=28)
    cfg = f32_config("nextdit")
    jm = jmodel.InternVLAN1Model(cfg)
    params = jax.tree_util.tree_map(np.array, n1_params(jm, cfg, seed=4))
    tcfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
    start = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params).state_dict()
    tpol = tpolicy.InternVLAN1Policy(load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params))
    # the JAX trainer donates its parameter buffers: give it its own copy
    jpol = JPolicy(jm, jax.tree_util.tree_map(jnp.array, params), cfg,
                   tokenizer=JTokenizer(cfg.text.vocab_size))
    rows = _pick_rows(path, tpol.tokenizer, tpol._tokens_per_image((28, 28)), cfg.n_query,
                      cfg.predict_step_nums)
    batch = n1_packed_collate_fn(rows, max_len=256, predict_step_nums=cfg.predict_step_nums)
    assert batch["traj_mask"].tolist() == [False, True]

    jexp = JExpCfg(name="n1p", model_name="internvla_n1", output_dir=str(tmp_path / "j"))
    jexp.il.lr = 1e-3
    jtrainer = JTrainer(jexp, jpol, total_steps=2)
    jm_out = jtrainer.train_on_batches([batch, batch])

    exp = ExpCfg.model_validate({**jexp.model_dump(), "output_dir": str(tmp_path / "t")})
    trainer = InternVLAN1Trainer(exp, tpol, total_steps=2)
    vision_before = {n: p.detach().clone() for n, p in tpol.model.visual.named_parameters()}
    # the JAX loop's keys: rng, sub = split(rng) per batch; loss splits sub
    rng, draws = jax.random.PRNGKey(0), []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        r_t, r_n = jax.random.split(sub)
        t = (jax.random.uniform(r_t, (2,)) * 1000).astype(jnp.int32)
        noise = jax.random.normal(r_n, (2, cfg.predict_step_nums, 3))
        draws.append((_t(t), _t(noise)))
    tm_out = trainer.train_on_batches([batch, batch], draws=draws)

    for k in ("lm_loss", "s1_loss", "loss", "grad_norm"):
        _close(tm_out[k], jm_out[k])
    assert jm_out["s1_loss"] > 0
    want = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), jax.device_get(jtrainer.params)).state_dict()
    got = tpol.model.state_dict()
    for name in ("language_model.layers.0.self_attn.q_proj.weight",
                 "language_model.embed_tokens.weight", "language_model.lm_head.weight",
                 "latent_queries", "cond_projector.0.weight", "action_decoder.weight",
                 "traj_dit.layers.0.attn1.to_q.weight"):
        assert not torch.equal(got[name], start[name]), name
        _close(got[name] - start[name], want[name] - start[name], atol=0.02 * jexp.il.lr, rtol=0)
    for n, p in tpol.model.visual.named_parameters():
        assert torch.equal(p.detach(), vision_before[n]), n
        assert not p.requires_grad


def test_train_n1_cli_trains_saves_and_restores(tmp_path):
    from internnav_tpu_torch.trainer import train_n1

    store = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=2, T=6, hw=28)
    out = str(tmp_path / "out")
    argv = ["--tiny", "--device", "cpu", "--store", store, "--steps", "2", "--batch-size", "2",
            "--max-len", "256", "--num-history", "2", "--output-dir", out, "--no-resume",
            "--remat", "--ce-chunk", "64", "--opt-state-dtype", "bf16"]
    metrics = train_n1.main(argv)
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    step_dir = tmp_path / "out" / "checkpoints" / "2"
    assert (step_dir / "state.pt").exists() and (step_dir / "exp_config.json").exists()

    cfg = dataclasses.replace(InternVLAN1Config.tiny("nextdit"), s1_image_hw=28)
    pol = tpolicy.InternVLAN1Policy.build(cfg, device="cpu", seed=1)
    exp = ExpCfg(name="restore", output_dir=out)
    exp.il.opt_state_dtype = "bf16"
    trainer = InternVLAN1Trainer(exp, pol, total_steps=2)
    assert trainer.maybe_restore() and trainer.step == 2
    saved = torch.load(step_dir / "state.pt", weights_only=True)
    for name, value in saved["params"].items():
        assert torch.equal(pol.model.state_dict()[name], value), name
    assert trainer.optimizer.count == 2


@pytest.mark.parametrize("mesh,accum", [(["--fsdp"], ["--grad-accum", "2"]), (["--tp", "2"], [])],
                         ids=["fsdp_accum2", "tp2"])
def test_train_n1_cli_under_torchrun_matches_one_device(tmp_path, mesh, accum):
    """train_n1 under torchrun in 2 gloo processes (the ranks' mesh from
    --fsdp or --tp, their process group from torchrun's environment) takes
    one step and rank 0 writes its checkpoint, full tensors; its metrics
    and updates equal the same command's in one process. A batch is one
    packed row, so at --fsdp every rank and micro-batch computes it whole."""
    import ast
    import os
    import sys
    from pathlib import Path

    from internnav_tpu_torch.trainer import train_n1

    store = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=2, T=6, hw=28)
    lr = 1e-3  # constant: the warmup schedule's first update is zero
    (tmp_path / "exp.py").write_text(
        "from internnav_tpu_torch.configs.trainer import ExpCfg\n"
        "exp_cfg = ExpCfg(name='cli', model_name='internvla_n1')\n"
        f"exp_cfg.il.lr, exp_cfg.il.lr_schedule = {lr}, 'constant'\n")
    argv = ["--tiny", "--device", "cpu", "--store", store, "--steps", "1", "--batch-size", "2",
            "--max-len", "256", "--num-history", "2", "--no-resume",
            "--config", str(tmp_path / "exp.py")]
    one = train_n1.main(argv + accum + ["--output-dir", str(tmp_path / "one")])
    repo = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    from torch_gloo_workers import run_bounded

    proc = run_bounded(  # the launcher and its two ranks killed at the limit
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "internnav_tpu_torch.trainer.train_n1", *argv, *mesh, *accum,
         "--output-dir", str(tmp_path / "two")], 120, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    finals = [ln for ln in proc.stdout.splitlines() if ln.startswith("final: ")]
    assert len(finals) == 1, proc.stdout[-4000:]  # rank 0 alone prints
    two = ast.literal_eval(finals[0][len("final: "):])
    for k in ("lm_loss", "s1_loss", "loss", "grad_norm"):
        _close(two[k], one[k])

    ref = torch.load(tmp_path / "one" / "checkpoints" / "1" / "state.pt", weights_only=True)
    got = torch.load(tmp_path / "two" / "checkpoints" / "1" / "state.pt", weights_only=True)
    assert got["step"] == 1 and got["opt_state"]["count"] == 1
    assert set(got["params"]) == set(ref["params"])
    start = tpolicy.InternVLAN1Policy.build(
        dataclasses.replace(InternVLAN1Config.tiny("nextdit"), s1_image_hw=28),
        device="cpu").model.state_dict()
    # Adam's first update lr·ĝ/(|ĝ| + eps) moves by at most lr·r/4 when ĝ
    # moves by a fraction r of itself: the updates are held within 0.02·lr
    # where the two gradients agree within 5%, and the elements where they
    # do not (gradients at float noise: the k biases', which softmax
    # ignores, and the random System-1's near-zero ones) are at most 1%
    n_noisy = n_reached = 0
    for name, mu in ref["opt_state"]["mu"].items():
        g = mu / (1 - tbase.B1)
        h = got["opt_state"]["mu"][name] / (1 - tbase.B1)
        _close(h, g, atol=1e-6, rtol=1e-4)
        noisy = (h - g).abs() > 0.05 * g.abs()
        n_noisy += int(noisy.sum())
        n_reached += int(((g != 0) | (h != 0)).sum())
        _close((got["params"][name] - start[name])[~noisy],
               (ref["params"][name] - start[name])[~noisy], atol=0.02 * lr, rtol=0)
    assert n_noisy <= 0.01 * n_reached, (n_noisy, n_reached)
    for name, value in ref["params"].items():
        if name.startswith("visual."):
            assert torch.equal(got["params"][name], value), name


def test_unported_options_raise(tmp_path):
    from internnav_tpu_torch.configs.trainer import MeshCfg
    from internnav_tpu_torch.trainer import train_n1

    pol = tpolicy.InternVLAN1Policy.build(InternVLAN1Config.tiny("nextdit"), device="cpu")
    # tensor parallel runs whole local heads only (JAX lets GSPMD partition
    # a fraction): the tiny decoder's 4 query heads do not split 3 ways,
    # its 2 KV heads not 4 ways
    mesh = MeshCfg(axes={"dp": -1, "tp": 3}, param_sharding="tp", fsdp_rest=True)
    with pytest.raises(NotImplementedError, match=r"layers\.0\.self_attn\.q_proj\.weight .*whole heads"):
        InternVLAN1Trainer(ExpCfg(mesh=mesh), pol)
    for tp, proj in (("3", "q_proj"), ("4", "k_proj")):
        with pytest.raises(NotImplementedError, match=rf"{proj}\.weight .*whole heads"):
            train_n1.main(["--store", "x", "--device", "cpu", "--tiny", "--tp", tp])
    # --ckpt is ported: a directory without weights raises, never trains
    # random weights in their place
    with pytest.raises(FileNotFoundError, match="no reference-format weights"):
        train_n1.main(["--store", "x", "--device", "cpu", "--tiny", "--ckpt", str(tmp_path)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_n1.main(["--store", "x"])
