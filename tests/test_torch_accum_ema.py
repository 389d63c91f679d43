"""Grad accumulation, the parameter EMA and NavDP's `forward_vlm_traj` of
the port held against the JAX package on the CPU.

Tiny fp32 models, the JAX weights through `model/weights/from_jax.py`, the
same inputs and the JAX System-1 draws on both sides. Tolerances: losses
and gradient norms at 1e-4; the EMA and the toy trainer's parameters
(the same fp32 arithmetic in another order) at 1e-6; the N1 steps as
test_torch_parallel.py's `_check_step` holds them (every trainable
gradient, and the updates to 2% of the learning rate where the gradient
decides them).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.configs.trainer import ExpCfg as JExpCfg
from internnav_tpu.configs.trainer import MeshCfg as JMeshCfg
from internnav_tpu.model.basemodel.internvla_n1.navdp_head import NavDPHead as JNavDPHead
from internnav_tpu.trainer import ema as jema
from internnav_tpu.trainer.base import Trainer as JTrainer
from internnav_tpu_torch.configs.trainer import ExpCfg
from internnav_tpu_torch.dataset.internvla_n1_dataset import (
    n1_packed_collate_fn,
    stack_packed_rows,
)
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.navdp_head import NavDPHead
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from internnav_tpu_torch.trainer import base as tbase
from internnav_tpu_torch.trainer import ema as tema
from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer
from test_torch_navdp import HW, rgbd
from test_torch_parallel import LR, _check_step, _jax_step, _samples, tiny_pair  # noqa: F401
# fp32_jax_nextdit: autouse, the JAX tiny NextDiT in fp32 for every test here
from test_torch_system1 import fp32_jax_nextdit, random_jax_params  # noqa: F401

torch.set_num_threads(2)


def _close(port, ref, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# --------------------------------------------------------------------- EMA
@pytest.mark.parametrize("kw", [{}, dict(update_after_step=3, inv_gamma=2.0, power=0.5,
                                         min_value=0.2, max_value=0.9)])
def test_ema_decay_matches_jax(kw):
    for step in range(51):
        _close(tema.ema_decay(step, **kw), jema.ema_decay(jnp.asarray(step), **kw),
               atol=1e-7, rtol=1e-6)


def test_ema_update_matches_jax():
    r = np.random.default_rng(0)
    e = {"a": r.standard_normal((3, 4)).astype(np.float32),
         "b": r.standard_normal(5).astype(np.float32)}
    p = {k: r.standard_normal(v.shape).astype(np.float32) for k, v in e.items()}
    want = jema.ema_update(jax.tree_util.tree_map(jnp.asarray, e),
                           jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(7), power=0.6)
    ema = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    d = tema.ema_update(ema, [(k, torch.from_numpy(v)) for k, v in p.items()], 7, power=0.6)
    _close(d, jema.ema_decay(jnp.asarray(7), power=0.6), atol=1e-7, rtol=1e-6)
    for k in e:
        _close(ema[k], want[k], atol=1e-6, rtol=1e-6)


# --------------------------------------------------------- the toy trainer
class _ToyModel(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


class _Toy(tbase.Trainer):
    """x @ w against y, a mean squared error (no random draws)."""

    def loss_fn(self, batch, draws=None):
        loss = ((batch["x"] @ self.model.w - batch["y"]) ** 2).mean()
        return loss, {"mse": loss}


def _toy_w():
    return np.random.RandomState(0).randn(4, 3).astype(np.float32)


def _toy_batch():
    rs = np.random.RandomState(1)
    return {"x": rs.randn(16, 4).astype(np.float32), "y": rs.randn(16, 3).astype(np.float32)}


def _toy(accum, use_ema=False, out="logs/toy"):
    cfg = ExpCfg(name="toy", output_dir=str(out))
    cfg.il.grad_accum_steps, cfg.il.use_ema = accum, use_ema
    cfg.il.lr, cfg.il.lr_schedule = 1e-2, "constant"
    policy = SimpleNamespace(model=_ToyModel(_toy_w()), device=torch.device("cpu"))
    return _Toy(cfg, policy, total_steps=10)


def _jax_toy(accum, use_ema):
    class Toy(JTrainer):
        def loss_fn(self, params, batch, rng):
            loss = jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
            return loss, {"mse": loss}

    cfg = JExpCfg(name="toy", mesh=JMeshCfg(axes={"dp": 8}))
    cfg.il.grad_accum_steps, cfg.il.use_ema = accum, use_ema
    cfg.il.lr, cfg.il.lr_schedule = 1e-2, "constant"
    return Toy(cfg, SimpleNamespace(params={"w": jnp.asarray(_toy_w())}), total_steps=10)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_toy_accum4_equals_accum1():
    """One optimizer step over 4 accumulated micro-batches of 4 rows equals
    one over the 16 rows (a mean loss over equal micro-batches; the port's
    counterpart of tests/test_trainer.py::test_grad_accum_matches_large_batch)."""
    t1, t4 = _toy(1), _toy(4)
    m1, m4 = t1.train_step(_t(_toy_batch())), t4.train_step(_t(_toy_batch()))
    _close(t4.model.w.detach(), t1.model.w.detach(), atol=1e-6, rtol=1e-5)
    for k in ("loss", "mse", "grad_norm"):
        _close(m4[k], m1[k], atol=1e-6, rtol=1e-5)
    assert not torch.equal(t1.model.w.detach(), torch.from_numpy(_toy_w()))


@pytest.mark.parametrize("accum", [1, 4])
def test_toy_two_steps_with_ema_match_jax(accum):
    """Two steps of the port's and of JAX's trainer with use_ema: loss,
    grad_norm, parameters and the EMA (decay 0 after step 1, 1 − 2^−0.75
    after step 2)."""
    port, jt = _toy(accum, use_ema=True), _jax_toy(accum, use_ema=True)
    step_fn = jt.build_train_step()
    for _ in range(2):
        m = port.train_step(_t(_toy_batch()))
        jt.params, jt.opt_state, jm = step_fn(jt.params, jt.opt_state,
                                              jt.shard_batch(_toy_batch()),
                                              jax.random.PRNGKey(0))
        jt.step += 1
        jt.ema_params = jt._ema_update(jt.ema_params, jt.params, jnp.asarray(jt.step))
        for k in ("loss", "mse", "grad_norm"):
            _close(m[k], jm[k], atol=1e-6, rtol=1e-5)
        _close(port.model.w.detach(), jt.params["w"], atol=1e-6, rtol=1e-6)
        _close(port.ema["w"], jt.ema_params["w"], atol=1e-6, rtol=1e-6)
    assert port.step == 2


def test_ema_checkpoint_restores_and_reseeds(tmp_path):
    """The EMA is saved with each step and restored; a checkpoint written
    without the EMA seeds it from the parameters (JAX base.py:372-378)."""
    t = _toy(1, use_ema=True, out=tmp_path / "ema")
    for _ in range(3):
        t.train_step(_t(_toy_batch()))
    t.save_checkpoint()
    t2 = _toy(1, use_ema=True, out=tmp_path / "ema")
    assert t2.maybe_restore() and t2.step == 3
    assert torch.equal(t2.ema["w"], t.ema["w"])
    assert not torch.equal(t.ema["w"], t.model.w.detach())  # decay > 0 by step 3

    plain = _toy(1, out=tmp_path / "plain")
    plain.train_step(_t(_toy_batch()))
    plain.save_checkpoint()
    t3 = _toy(1, use_ema=True, out=tmp_path / "plain")
    assert t3.maybe_restore() and t3.step == 1
    assert torch.equal(t3.ema["w"], plain.model.w.detach())


# ----------------------------------------------------------- N1 accumulation
def _n1_trainer(params, tmp, accum):
    tcfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
    pol = tpolicy.InternVLAN1Policy(load_from_jax(tpolicy.build_model(tcfg, device="cpu"),
                                                  params))
    exp = ExpCfg(name="accum", model_name="internvla_n1", output_dir=str(tmp))
    exp.il.lr, exp.il.lr_schedule, exp.il.grad_accum_steps = LR, "constant", accum
    return InternVLAN1Trainer(exp, pol, total_steps=1), tcfg


def test_n1_accum2_one_row_matches_jax(tiny_pair, tmp_path):
    """One packed row at accum 2: rows do not divide, so each micro-batch is
    the whole row with its own System-1 draws (JAX's fold_in(key, i)); the
    step averages the two micro-batches' gradients, as JAX's accum-2 step."""
    cfg, _, params, model = tiny_pair
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer, tcfg = _n1_trainer(params, tmp_path / "t", accum=2)
    rows = _samples(tmp_path, trainer.policy.tokenizer,
                    trainer.policy._tokens_per_image((28, 28)), cfg, 2)
    batch = n1_packed_collate_fn(rows, max_len=256, predict_step_nums=cfg.predict_step_nums)
    jax_out = _jax_step(params, cfg, batch, {"axes": {"dp": -1}}, tmp_path / "j", accum=2)
    draws = jax_out[3]
    assert not torch.equal(draws[0][1], draws[1][1])
    metrics = trainer.train_on_batches([batch], draws=[draws])
    _check_step(metrics, trainer.full_state(), jax_out, start, tcfg)


def test_n1_accum2_two_rows_is_the_global_token_mean(tiny_pair, tmp_path):
    """Two packed rows with different counts of IGNORE_INDEX labels at
    accum 2: a micro-batch a row, and the step's losses and gradient the
    token and trajectory means over both rows, which JAX computes on the
    two rows as one accum-1 batch (its accum-2 step cannot split these
    rows: F19). Each micro-batch takes the JAX draws of its samples."""
    cfg, _, params, model = tiny_pair
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer, tcfg = _n1_trainer(params, tmp_path / "t", accum=2)
    rows = _samples(tmp_path, trainer.policy.tokenizer,
                    trainer.policy._tokens_per_image((28, 28)), cfg, 3)
    packed = [n1_packed_collate_fn(g, max_len=192, predict_step_nums=cfg.predict_step_nums)
              for g in (rows[:1], rows[1:3])]
    batch = stack_packed_rows(packed)
    valid = (batch["labels"][:, 1:] != -100).sum(1)
    assert valid[0] != valid[1] and batch["traj_mask"].sum() >= 2
    jax_out = _jax_step(params, cfg, batch, {"axes": {"dp": -1}}, tmp_path / "j")
    t, noise = jax_out[3]
    # draw slot k is the k-th trajectory-bearing sample: row 1's follow row 0's
    n0 = packed[0]["traj_poses"].shape[0]
    k0 = int(packed[0]["traj_mask"].sum())
    n1 = packed[1]["traj_poses"].shape[0]
    draws = [(t[:n0], noise[:n0]), (t[k0:k0 + n1], noise[k0:k0 + n1])]
    metrics = trainer.train_on_batches([batch], draws=[draws])
    _check_step(metrics, trainer.full_state(), jax_out, start, tcfg)


# ------------------------------------------------------- forward_vlm_traj
def test_forward_vlm_traj_matches_jax():
    """The NavDP head's training forward at tiny widths, with JAX's draws
    (t = randint(key), noise = normal(fold_in(key, 1))) handed in."""
    kw = dict(memory_size=2, predict_size=8, temporal_depth=2, token_dim=32, heads=4,
              vlm_token_dim=64)
    jh = JNavDPHead(**kw)
    B, L, P = 3, 5, 8
    r = np.random.default_rng(11)
    lat = r.standard_normal((B, L, 64)).astype(np.float32)
    rgb, depth = rgbd(12, B)
    im = rgb.astype(np.float32) / 255.0
    labels = r.standard_normal((B, P, 3)).astype(np.float32)
    args = [jnp.asarray(a) for a in (lat, im, depth, labels)]
    key = jax.random.PRNGKey(13)
    shapes = jax.eval_shape(lambda k, *a: jh.init(k, *a, k, method=jh.forward_vlm_traj),
                            key, *args)
    params = random_jax_params(shapes["params"], seed=14)
    eps_ref, noise_ref = jax.jit(lambda p, *a: jh.apply({"params": p}, *a, key,
                                                        method=jh.forward_vlm_traj))(params, *args)
    t = np.array(jax.random.randint(key, (B,), 0, 20))
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), (B, P, 3)))
    _close(noise, noise_ref, atol=0, rtol=0)
    th = load_from_jax(NavDPHead(image_hw=HW, **kw), params)
    with torch.no_grad():
        eps, n = th.forward_vlm_traj(torch.from_numpy(lat), torch.from_numpy(im),
                                     torch.from_numpy(depth), torch.from_numpy(labels),
                                     t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    assert eps.shape == (B, P, 3) and torch.equal(n, torch.from_numpy(noise))
    _close(eps, eps_ref)
    assert len(set(t.tolist())) > 1  # per-row timesteps


def test_stack_packed_rows_keeps_each_rows_samples():
    a = {"input_ids": np.zeros((1, 4), np.int64), "labels": np.zeros((1, 4), np.int64),
         "segment_ids": np.array([[0, 0, 1, -1]], np.int32), "images": [np.zeros(1)] * 2,
         "traj_poses": np.zeros((2, 8, 3), np.float32), "traj_mask": np.array([True, False]),
         "num_packed": 2}
    b = dict(a, segment_ids=np.array([[0, 0, 0, 0]], np.int32), images=[np.ones(1)],
             traj_poses=np.ones((1, 8, 3), np.float32), traj_mask=np.array([True]),
             num_packed=1)
    out = stack_packed_rows([a, b])
    assert out["input_ids"].shape == (2, 4) and out["num_packed"] == 3
    assert out["traj_poses"].shape == (3, 8, 3) and out["traj_mask"].tolist() == [True, False,
                                                                                  True]
    assert len(out["images"]) == 3 and stack_packed_rows([a]) is a
    assert dataclasses.is_dataclass(InternVLAN1Config.tiny())
