"""CMA / Seq2Seq training in the port against the JAX package's on the CPU,
at tests/test_torch_cma.py's small widths (a ResNet-18 RGB tower, state
width 32; JAX's depth tower is its DD-PPO ResNet-50, here at 64x64):

- `inflection_weighted_ce` against JAX's within CE_TOL;
- one time-major batch from `make_vln_dataloader` through the port's
  `CMATrainer` / `Seq2SeqTrainer.loss_fn` and JAX's `loss_fn` under
  `jax.grad` on the same weights: the loss and its action / aux terms in
  fp32 within LOSS_TOL of JAX's; every gradient (frozen BatchNorm
  statistics included: both packages train them) with both packages in
  float64 (`float64_port`, `jax.enable_x64`; RGB of 0 or 255, which JAX's
  fp32 pixel division keeps exact) within GRAD64_TOL. fp32 gradients of
  these nets are only piecewise smooth: the depth tower's ReLUs and
  max-pools route a gradient by comparisons that fp32 rounding decides
  either way near a tie, so either package's fp32 gradient can sit ~1%
  from the float64 one in the tower's early layers, depending on the
  frames;
- `grad_accum_steps = 2` on a time-major batch: two micro-batches of the
  envs (axis 1), the same loss and a step as close to the whole batch's
  as the whole batch's own fp32 noise allows (measured with its envs
  reversed);
- three optimizer steps of the port's trainer next to JAX's optimizer
  chain over JAX's float64 gradients (the same losses and parameters),
  and a resume from the step-2 checkpoint taking the same third step.

JAX params come from `jax.eval_shape` and a numpy seed; the JAX gradient
is jitted once a model (its compile is most of this file's time).
"""

import contextlib
import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internnav_tpu.configs.trainer import ExpCfg as JExpCfg
from internnav_tpu.configs.trainer import IlCfg as JIlCfg
from internnav_tpu.dataset.vln_dataset import make_vln_dataloader, write_synthetic_dataset
from internnav_tpu.model import get_config as jget_config
from internnav_tpu.trainer import cma_trainer as jtrain
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model.weights.from_jax import cma_state_from_jax
from internnav_tpu_torch.trainer import cma_trainer as ttrain
from test_torch_cma import jax_net, jax_params, small_cfg

torch.set_num_threads(2)
#: the CE of fp32 logits, summed over steps and divided per env
CE_TOL = 1e-6
#: a batch's losses through the whole net (two ResNets, LSTM, two GRU scans)
LOSS_TOL = 1e-5
#: gradients through the same, relative to each tensor's largest entry
GRAD_TOL = 1e-4
#: float64 losses and gradients of the two packages, relative likewise
#: (JAX's RGB tower casts its pixels to fp32 in x64 too)
LOSS64_TOL, GRAD64_TOL = 1e-7, 1e-6
LR = 1e-4
#: parameters after Adam steps: Adam divides each gradient element by its
#: own magnitude, so an element whose gradient is within fp32 noise (the
#: depth tower's early layers) steps about ±lr, its sign either way, in
#: either package: two such steps land up to ~2 lr apart
ADAM_TOL = 3 * LR
#: the same, beyond the noise floor measured in the test
STEP_TOL = LR
#: accumulation's gradients against the whole batch's, each measured by
#: the whole batch's own fp32 noise (its envs reversed)
ACCURACY_FACTOR = 2.0
RGB, DEPTH, N, T = 32, 64, 4, 6


def test_inflection_weighted_ce_equals_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(7, 5, 4).astype(np.float32) * 3
    actions = rs.randint(0, 4, (7, 5))
    weights = np.where(rs.rand(7, 5) > 0.5, 3.2, 1.0).astype(np.float32)
    weights[5:, 1] = 0.0  # padding
    weights[:, 3] = 0.0  # an env with no valid step
    want = jtrain.inflection_weighted_ce(jnp.asarray(logits), jnp.asarray(actions),
                                         jnp.asarray(weights))
    got = ttrain.inflection_weighted_ce(torch.from_numpy(logits), torch.from_numpy(actions),
                                        torch.from_numpy(weights))
    np.testing.assert_allclose(float(got), float(want), atol=CE_TOL, rtol=CE_TOL)


def _cfgs(name):
    cfg_j, cfg_t = small_cfg(jget_config, name), small_cfg(tmodel_zoo.get_config, name)
    for c in (cfg_j, cfg_t):
        c.text_encoder.vocab_size = 1000  # the synthetic store's ids reach 900
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vln") / "store.bin")
    write_synthetic_dataset(path, n_episodes=N, T=T, hw=DEPTH, seed=3)
    b = next(make_vln_dataloader(path, N, rgb_size=RGB, depth_size=DEPTH)())
    assert b["observations"]["rgb"].shape[1] == N  # time-major
    return b


def _models(name, seed=10):
    cfg_j, cfg_t = _cfgs(name)
    jm = jax_net(name, cfg_j)
    layers = 2 if name == "cma" else 1
    rs = np.random.RandomState(1)
    init = ({"instruction": np.ones((1, 8), np.int32),
             "rgb": np.zeros((1, RGB, RGB, 3), np.float32),
             "depth": np.zeros((1, DEPTH, DEPTH, 1), np.float32)},
            rs.randn(1, layers, 32).astype(np.float32), np.zeros((1,), np.int32),
            np.ones((1,), np.float32))
    params = jax_params(jm, *init, seed=seed)
    pol = tmodel_zoo.get_policy(name).build(cfg_t, device="cpu", depth_hw=DEPTH)
    pol.net.load_state_dict(cma_state_from_jax(params, pol.net))
    return cfg_j, cfg_t, jm, params, pol


def _trainer(name, cfg_t, pol, tmp, **il):
    exp = ExpCfg(name="t", model_name=name, output_dir=str(tmp), model=cfg_t,
                 il=IlCfg(lr=LR, weight_decay=1e-5, **il))
    cls = ttrain.CMATrainer if name == "cma" else ttrain.Seq2SeqTrainer
    return cls(exp, pol, total_steps=3)


def _as_port(grads, pol):
    return cma_state_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), grads), pol.net)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(name):
    """JAX's `CMATrainer.loss_fn` under `jax.value_and_grad`, one jit a
    model (the same program for every test of this file)."""
    cfg_j, _ = _cfgs(name)
    jself = types.SimpleNamespace(cfg=JExpCfg(model_name=name, model=cfg_j),
                                  policy=types.SimpleNamespace(module=jax_net(name, cfg_j)))
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.CMATrainer.loss_fn(jself, p, b, None), has_aux=True))


@contextlib.contextmanager
def float64_port():
    """The port in float64: torch's default dtype float64, and
    Tensor.float() (the port's casts of its inputs to fp32) float64."""
    cast, default = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = cast
        torch.set_default_dtype(default)


def to64(tree):
    if isinstance(tree, dict):
        return {k: to64(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.double() if tree.is_floating_point() else tree
    return np.asarray(tree, np.float64) if np.asarray(tree).dtype == np.float32 else tree


def grads64(trainer, piece, *draws):
    """{name: float64 gradient} of `trainer.loss_fn` on a float64 copy of
    its net, and the float64 loss."""
    net = copy.deepcopy(trainer.model).double()
    model, trainer.model = trainer.model, net
    try:
        with float64_port():
            loss, _ = trainer.loss_fn(to64(piece), *draws)
            loss.backward()
    finally:
        trainer.model = model
    return {n: p.grad for n, p in net.named_parameters()}, loss.detach()


def assert_grads64_close(got, want, tol):
    """Each float64 gradient within tol of its tensor's largest entry, or
    of 1e-4 of the net's largest (a tensor whose exact gradient is ~0,
    text_k's bias: the softmax is blind to a shift of its logits)."""
    assert set(got) == set(want)
    floor = 1e-4 * max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        assert got[n] is not None, n
        scale = max(float(w.abs().max()), floor)
        assert float((got[n] - w.double()).abs().max()) <= tol * scale, n


def binary_rgb(batch):
    """The batch with RGB of 0 or 255 only: JAX's towers divide the pixels
    by 255 in fp32 even under x64, exactly so for these two values (the
    gradients' kinks make float64 comparisons feel an input's last bit)."""
    obs = dict(batch["observations"], rgb=np.where(batch["observations"]["rgb"] > 127, 255.0,
                                                  0.0).astype(np.float32))
    return dict(batch, observations=obs)


@pytest.mark.parametrize("name", ["cma", "seq2seq"])
def test_loss_and_every_gradient_equal_jax(name, batch, tmp_path):
    _, cfg_t, _, params, pol = _models(name)
    batch = binary_rgb(batch)
    with jax.enable_x64(True):
        (jloss, jmetrics), jgrads = _jax_grad_fn(name)(to64(params), to64(batch))
        assert jax.tree_util.tree_leaves(jgrads)[0].dtype == np.float64
    trainer = _trainer(name, cfg_t, pol, tmp_path)
    (piece,) = trainer.micro_batches(batch)
    with torch.no_grad():
        loss, metrics = trainer.loss_fn(piece)
    for k, v in (("loss", loss), *metrics.items()):
        np.testing.assert_allclose(float(v), float(jmetrics[k] if k != "loss" else jloss),
                                   atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=k)
    assert float(metrics["aux_loss"]) > 0
    got, loss64 = grads64(trainer, piece)
    np.testing.assert_allclose(float(loss64), float(jloss), rtol=LOSS64_TOL)
    assert_grads64_close(got, _as_port(jgrads, pol), GRAD64_TOL)


def jax_decay_mask(params):
    """Which leaves JAX's optimizer chain (`trainer.base.make_optimizer`)
    decays, read from what it does: from parameters of 1 and gradients of
    0, AdamW's update is −lr·wd on a decayed leaf and 0 on an exempt one.
    Each leaf as an array of its shape, 1.0 where decayed."""
    from internnav_tpu.trainer.base import make_optimizer

    tx = make_optimizer(JExpCfg(il=JIlCfg(lr=1.0, weight_decay=0.5, lr_schedule="constant")),
                        10)
    ones = jax.tree_util.tree_map(lambda x: np.ones(np.shape(x), np.float32), params)
    updates = jax.jit(lambda p: tx.update(jax.tree_util.tree_map(jnp.zeros_like, p),
                                          tx.init(p), p)[0])(ones)

    def leaf(u):
        u = np.asarray(u)
        assert set(np.unique(u)) <= {0.0, -0.5}
        return np.full(u.shape, float(u.min() < 0), np.float32)

    return jax.tree_util.tree_map(leaf, updates)


def assert_decay_mask_equals_jax(net, mapped):
    """The port's `decay_mask(net)` against JAX's mask carried across by
    the port's name mapping (`mapped`: port name → 0/1 tensor)."""
    from internnav_tpu_torch.trainer.base import decay_mask

    got = decay_mask(net)
    assert set(got) == {n for n, _ in net.named_parameters()}
    for n, decays in got.items():
        m = mapped[n]
        assert float(m.min()) == float(m.max()), n  # one JAX leaf's mask each
        assert decays == bool(m.max()), n
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("name", ["cma", "seq2seq"])
def test_decay_mask_equals_jax(name):
    """The port's weight-decay mask (shared trainer code) on every CMA /
    Seq2Seq parameter: biases, the LSTM's b_ih / b_hh but not the reverse
    direction's, the frozen BatchNorm statistics, the norms."""
    _, _, _, params, pol = _models(name)
    assert_decay_mask_equals_jax(pol.net, cma_state_from_jax(jax_decay_mask(params), pol.net))


def _snapshot_grads(trainer):
    """Record the gradients each optimizer step takes (after accumulation)."""
    seen, step = [], trainer.optimizer.step

    def snap():
        seen.append({n: p.grad.detach().clone() for n, p in trainer.optimizer.params})
        return step()

    trainer.optimizer.step = snap
    return seen


def _envs_reversed(batch):
    if isinstance(batch, dict):
        return {k: _envs_reversed(v) for k, v in batch.items()}
    return np.ascontiguousarray(batch[:, ::-1])


def test_grad_accum_on_time_major_batch_equals_the_whole_batch(batch, tmp_path):
    """Two micro-batches of 2 envs each (the envs are axis 1: splitting
    axis 0, the time steps, gives another loss) make the same step as the
    4-env batch at accum 1: the same loss, and gradients as close to the
    whole batch's as the whole batch's with its envs reversed is (the
    same function in another fp32 order: the depth tower's early layers
    differ by ~1% that way), within ACCURACY_FACTOR, + GRAD_TOL of the
    largest entry; the parameters after it as close, + STEP_TOL (Adam
    turns a gradient element within that noise into a step of ±lr)."""
    _, cfg_t, _, _, pol1 = _models("cma")
    pols = [pol1]
    for _ in range(2):
        pols.append(tmodel_zoo.get_policy("cma").build(cfg_t, device="cpu", depth_hw=DEPTH))
        pols[-1].net.load_state_dict(pol1.net.state_dict())
    whole, flipped = (_trainer("cma", cfg_t, p, tmp_path / str(i)) for i, p in
                      enumerate(pols[:2]))
    accum = _trainer("cma", cfg_t, pols[2], tmp_path / "2", grad_accum_steps=2)
    pieces = accum.micro_batches(batch)
    assert [p["observations"]["rgb"].shape[:2] for p in pieces] == [(T, 2)] * 2
    assert [p["observations"]["instruction"].shape[:2] for p in pieces] == [(T, 2)] * 2
    assert torch.equal(pieces[1]["masks"], torch.from_numpy(batch["masks"][:, 2:]))
    init = {n: p.detach().clone() for n, p in pol1.net.named_parameters()}
    seen = [_snapshot_grads(t) for t in (whole, flipped, accum)]
    for _ in range(2):  # step 1 is at lr 0 (the warmup), step 2 moves
        m1, m2 = whole.train_step(batch), accum.train_step(batch)
        flipped.train_step(_envs_reversed(batch))
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                                   rtol=GRAD_TOL)
    assert_as_close_as_reversed(seen, [dict(p.net.named_parameters()) for p in pols])
    assert not all(torch.equal(init[n], p) for n, p in pol1.net.named_parameters())


def assert_as_close_as_reversed(seen, params):
    """Each step's gradients (seen: the whole batch's, its envs
    reversed', the split run's) and the parameters after the steps
    (params, in the same order): the split run as close to the whole
    batch as the reversed run is, within ACCURACY_FACTOR, + GRAD_TOL of
    the largest entry / + STEP_TOL."""
    for g_whole, g_flip, g_split in zip(*seen):
        for n, g in g_whole.items():
            floor = float((g_flip[n] - g).abs().max())
            err = float((g_split[n] - g).abs().max())
            assert err <= ACCURACY_FACTOR * floor + GRAD_TOL * float(g.abs().max()), (n, err,
                                                                                       floor)
    whole, flip, split = params
    for n, a in whole.items():
        floor = float((flip[n] - a).detach().abs().max())
        assert float((split[n] - a).detach().abs().max()) <= ACCURACY_FACTOR * floor + STEP_TOL, n


def _jax_split(batch, dp, accum):
    """JAX's `CMATrainer.shard_batch` (`batch_axis` 1) on a dp mesh of CPU
    devices: for each dp rank, each leaf's block as that rank's device
    holds it, (accum, T, envs, ...) at accum > 1."""
    from jax.sharding import Mesh

    devices = jax.devices()[:dp]
    jself = types.SimpleNamespace(
        cfg=types.SimpleNamespace(mesh=types.SimpleNamespace(fsdp_axis="dp"),
                                  il=types.SimpleNamespace(grad_accum_steps=accum)),
        mesh=Mesh(np.asarray(devices), ("dp",)), batch_axis=jtrain.CMATrainer.batch_axis)
    placed = jtrain.CMATrainer.shard_batch(jself, batch)

    def block(x, d):
        if isinstance(x, dict):
            return {k: block(v, d) for k, v in x.items()}
        (shard,) = [s for s in x.addressable_shards if s.device == d]
        return np.asarray(shard.data)

    return [block(placed, d) for d in devices]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def test_dp2_accum2_splits_envs_as_jax_and_steps_as_the_whole_batch(batch, tmp_path):
    """CMA at dp = 2 (two gloo processes) x grad_accum_steps = 2 on a
    time-major batch: each rank's micro-batches hold the env columns that
    JAX's `Trainer.shard_batch` places on that rank's device (axis 1,
    nested observations included; a leaf of 2 envs split over dp alone, a
    leaf of 3 and a 1-D leaf whole), and the two steps' loss, grad_norm,
    gradients and parameters are the whole batch's at accum 1 on one
    process, as close as the whole batch with its envs reversed."""
    import pickle

    from torch_gloo_workers import join_ranks, start_ranks, time_major_dp_worker

    assert jtrain.CMATrainer.batch_axis == 1
    _, cfg_t, _, _, pol1 = _models("cma")
    pol2 = tmodel_zoo.get_policy("cma").build(cfg_t, device="cpu", depth_hw=DEPTH)
    pol2.net.load_state_dict(pol1.net.state_dict())
    torch.save(pol1.net.state_dict(), tmp_path / "state.pt")
    probe = dict(batch, pair=np.arange(2 * T, dtype=np.float32).reshape(T, 2),
                 odd=np.arange(3 * T, dtype=np.float32).reshape(T, 3),
                 flat=np.arange(5, dtype=np.float32))
    probe["observations"] = dict(batch["observations"],
                                 nested={"envs": np.arange(T * N * 2).reshape(T, N, 2)})
    with open(tmp_path / "spec.pkl", "wb") as f:
        pickle.dump({"name": "cma", "cfg": cfg_t, "depth_hw": DEPTH,
                     "state": str(tmp_path / "state.pt"), "probe": probe, "batch": batch,
                     "il": {"lr": LR, "weight_decay": 1e-5, "grad_accum_steps": 2}}, f)
    deadline_s = 120
    procs = start_ranks(time_major_dp_worker, 2, str(tmp_path / "store"),
                        str(tmp_path / "spec.pkl"), str(tmp_path))
    whole, flipped = (_trainer("cma", cfg_t, p, tmp_path / n) for p, n in
                      ((pol1, "whole"), (pol2, "flipped")))
    seen = [_snapshot_grads(t) for t in (whole, flipped)]
    metrics = [whole.train_step(batch) for _ in range(2)]
    for _ in range(2):
        flipped.train_step(_envs_reversed(batch))
    assert join_ranks(procs, deadline_s) == [0, 0]
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    want = _jax_split(probe, dp=2, accum=2)
    for r, got in enumerate(res):
        assert got["dp"] == (2, 2)
        for i, piece in enumerate(got["pieces"]):
            flat_got, flat_want = _leaves(piece), _leaves(want[r])
            assert set(flat_got) == set(flat_want)
            for k, w in flat_want.items():
                np.testing.assert_array_equal(np.asarray(flat_got[k]), w[i], err_msg=k)
        assert got["pieces"][1]["observations"]["rgb"].shape[:2] == (T, 1)
        envs = probe["observations"]["nested"]["envs"]  # micro-batch 1 is envs 2 and 3
        assert torch.equal(got["pieces"][1]["observations"]["nested"]["envs"],
                           torch.from_numpy(envs[:, 2 + r:3 + r]))
        assert torch.equal(got["pieces"][0]["pair"], torch.from_numpy(probe["pair"][:, r:r + 1]))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose([m[k] for m in got["metrics"]],
                                       [float(m[k]) for m in metrics],
                                       atol=LOSS_TOL, rtol=LOSS_TOL if k == "loss" else GRAD_TOL,
                                       err_msg=k)
        assert_as_close_as_reversed(seen + [got["grads"]],
                                    [{n: p.detach() for n, p in q.net.named_parameters()}
                                     for q in (pol1, pol2)] + [got["params"]])
    for n, p in res[0]["params"].items():
        assert torch.equal(p, res[1]["params"][n]), n  # the ranks hold one model


def test_three_steps_equal_jax_and_resume(batch, tmp_path):
    """JAX's optimizer chain (`trainer.base.make_optimizer`: clip, AdamW
    with the decay mask, the warmup-cosine schedule) over JAX's gradients
    against the port's trainer (fp32), step for step. JAX runs in float64,
    the gradient program test_loss_and_every_gradient_equal_jax compiles
    (one compile for the file): its steps are the exact ones the port's
    fp32 steps are held to."""
    import optax

    from internnav_tpu.trainer.base import make_optimizer

    cfg_j, cfg_t, _, params, pol = _models("cma", seed=12)
    jexp = JExpCfg(name="j", model_name="cma", model=cfg_j,
                   il=JIlCfg(lr=LR, weight_decay=1e-5))
    jlosses = []
    with jax.enable_x64(True):
        tx = make_optimizer(jexp, 3)
        update = jax.jit(lambda g, o, p: tx.update(g, o, p))
        jp, b64 = to64(params), to64(batch)
        jo = tx.init(jp)
        for _ in range(3):
            (loss, _), grads = _jax_grad_fn("cma")(jp, b64)
            updates, jo = update(grads, jo, jp)
            jp = optax.apply_updates(jp, updates)
            jlosses.append(float(loss))
    trainer = _trainer("cma", cfg_t, pol, tmp_path)
    losses = []
    for i in range(3):
        losses.append(float(trainer.train_step(batch)["loss"]))
        if i == 1:
            trainer.save_checkpoint()
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=LOSS_TOL)
    assert losses[0] == losses[1] != losses[2]  # step 1 at lr 0 (the warmup), step 2 moves
    want = cma_state_from_jax(jax.tree_util.tree_map(np.asarray, jp), pol.net)
    for name, prm in pol.net.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(), atol=ADAM_TOL,
                                   err_msg=name)

    _, _, _, _, pol2 = _models("cma", seed=99)  # other weights: the checkpoint replaces them
    resumed = _trainer("cma", cfg_t, pol2, tmp_path)
    assert resumed.maybe_restore() and resumed.step == 2
    np.testing.assert_allclose(float(resumed.train_step(batch)["loss"]), losses[2], atol=1e-7)
    for a, b in zip(pol.net.parameters(), pol2.net.parameters()):
        assert torch.allclose(a, b, atol=1e-7)
