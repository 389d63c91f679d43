"""Standalone NavDP in the port against the JAX package on the CPU, at
tests/test_vn.py's small size (image 28, memory 2, predict 6, a 1-layer
decoder), fp32. The four ViT-S towers keep their width (384, 6 heads) and
run TOWER_DEPTH blocks instead of 12 in both packages (`small_towers`
swaps each package's `navdp_backbone.DinoViT` for the shorter trunk while
the nets are built and JAX traces them): the blocks are one loop, the
full towers run on the card against the host in chip_smoke.py, and 12
blocks would make this file's JAX compiles and its 90M-parameter Adam
steps take minutes.

- `DinoViT` with 3, 6 and 7 input channels and its intermediates (patch
  tokens and cls), within FWD_TOL;
- the goal towers (`ImageGoalBackbone`, `PixelGoalBackbone`) and the RGB-D
  memory tokens, `predict_noise` and `predict_critic`, the target mask
  (strictly future waypoints; the last row blocked and its probabilities
  zero);
- the training forward with JAX's draws (t and ε of both branches, from
  the key as JAX's module splits it), `NavDPTrainer`'s loss terms, and
  every gradient within GRAD_TOL (no max-pool sits in this net, and fp32
  gradients of both packages agree to ~2e-6 of each tensor's largest
  entry: no float64 run is needed), the key biases' zero gradients within
  ZERO_GRAD_TOL;
- the four inference modes with JAX's x_init and step noises: the best and
  worst critic-ranked trajectories within TRAJ_TOL;
- the weight-decay mask; three optimizer steps of the port's trainer with
  the EMA against JAX's optimizer chain and `ema_update` over JAX's
  gradients;
- a reference-layout NavDPNet state dict (`navdp_reference_state_dict`)
  through JAX's `convert_navdp_policy` and through the port's
  `NavDPPolicy.from_pretrained` on a .pth file: the same tensors.

The JAX params come from `jax.eval_shape` and a numpy seed; JAX's train
step (forward, loss and gradients in one program) and its inference (the
towers and the four modes in one program) are jitted once for the file.
"""

import contextlib
import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internnav_tpu.model import get_config as jget_config
from internnav_tpu.model.basemodel import navdp as jnavdp
from internnav_tpu.model.encoder import navdp_backbone as jbackbone
from internnav_tpu.model.encoder import vit as jvit
from internnav_tpu.model.weights import convert as jconvert
from internnav_tpu.trainer import navdp_trainer as jtrainer
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model.basemodel import navdp as tnavdp
from internnav_tpu_torch.model.encoder import navdp_backbone as tbackbone
from internnav_tpu_torch.model.encoder import vit as tvit
from internnav_tpu_torch.model.weights import convert as tconvert
from internnav_tpu_torch.model.weights.from_jax import load_from_jax, state_dict_from_jax
from internnav_tpu_torch.trainer.navdp_trainer import NavDPTrainer
from test_torch_cma_train import assert_decay_mask_equals_jax, jax_decay_mask
from test_torch_system1 import random_jax_params

torch.set_num_threads(2)
#: fp32 forwards through the towers and the decoder, relative
FWD_TOL = 1e-5
#: trajectories after 10 DDPM steps from identical draws, absolute
TRAJ_TOL = 1e-4
#: the trainer's fp32 loss terms, relative
LOSS_TOL = 1e-5
#: fp32 gradients, relative to each tensor's largest entry (the largest
#: reading: 1.93e-6, rgbd_encoder.depth_model.block.1.attn.q_proj.bias)
GRAD_TOL = 1e-5
#: the attention key biases, whose exact gradient is zero (softmax ignores
#: a shift shared by a row's scores): both packages' fp32 values, relative
#: to the net's largest gradient entry (the largest reading: 2.97e-9)
ZERO_GRAD_TOL = 1e-7
#: parameters after Adam steps: an element whose gradient sits within fp32
#: noise steps about ±lr either way (tests/test_torch_cma_train.py)
LR = 1e-4
ADAM_TOL = 3 * LR
#: the "loss" after a step that moved: Adam turns gradient elements within
#: fp32 noise into steps of ±lr either way (ADAM_TOL), which moves a loss
#: of ~6 by ~1e-4
MOVED_LOSS_TOL = 1e-4
S, M, P, B, SAMPLES = 28, 2, 6, 2, 4
MODES = ("pointgoal", "nogoal", "imagegoal", "pixelgoal")
TOWER_DEPTH = 2


@contextlib.contextmanager
def small_towers():
    """Both packages' NavDP towers TOWER_DEPTH blocks deep while the block
    runs (net construction in the port, tracing in JAX)."""
    jvit_cls, tvit_cls = jbackbone.DinoViT, tbackbone.DinoViT
    jbackbone.DinoViT = functools.partial(jvit_cls, depth=TOWER_DEPTH)
    tbackbone.DinoViT = functools.partial(tvit_cls, depth=TOWER_DEPTH)
    try:
        yield
    finally:
        jbackbone.DinoViT, tbackbone.DinoViT = jvit_cls, tvit_cls


def in_small_towers(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with small_towers():
            return fn(*args, **kwargs)

    return run


def tiny(get_config):
    c = get_config("navdp")
    c.memory_size, c.predict_size, c.temporal_depth, c.image_size = M, P, 1, S
    return c


def close(want, got, tol=FWD_TOL, atol=None):
    np.testing.assert_allclose(got.detach().double().numpy(), np.asarray(want, np.float64),
                               rtol=tol, atol=tol if atol is None else atol)


def train_inputs(seed):
    rs = np.random.RandomState(seed)
    return {"goal_point": rs.randn(B, 3).astype(np.float32),
            "goal_image": rs.rand(B, S, S, 6).astype(np.float32),
            "goal_pixel": rs.rand(B, S, S, 7).astype(np.float32),
            "input_images": rs.rand(B, M, S, S, 3).astype(np.float32),
            "input_depths": (3 * rs.rand(B, M, S, S, 1)).astype(np.float32),
            "output_actions": rs.randn(B, P, 3).astype(np.float32),
            "augment_actions": rs.randn(B, P, 3).astype(np.float32)}


ORDER = ("goal_point", "goal_image", "goal_pixel", "input_images", "input_depths",
         "output_actions", "augment_actions")


@functools.lru_cache(maxsize=None)
@in_small_towers
def jax_pair():
    """(JAX NavDPNet, its params, the port's NavDPNet holding them)."""
    jm = jnavdp.NavDPNet(cfg=tiny(jget_config))
    x = train_inputs(0)
    shapes = jax.eval_shape(lambda k, *a: jm.init(k, *a, jax.random.PRNGKey(1)),
                            jax.random.PRNGKey(0), *[jnp.asarray(x[k]) for k in ORDER])
    params = random_jax_params(shapes["params"], 3)
    net = tnavdp.NavDPNet(tiny(tmodel_zoo.get_config), image_size=S).eval()
    load_from_jax(net, params)
    return jm, params, net


def train_draws(key):
    """What JAX's training forward draws from `key`: each branch's t from
    randint(r) and ε from normal(fold_in(r, 1)), r of split(key, 4)."""
    out = {}
    for branch, r in zip(("ng", "mg"), jax.random.split(key, 4)[:2]):
        t = jax.random.randint(r, (B,), 0, 10)
        out[f"{branch}_t"] = torch.from_numpy(np.array(t)).long()
        out[f"{branch}_noise"] = torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(r, 1), (B, P, 3))))
    return out


def infer_draws(key, rows):
    """What JAX's inference draws from `key`: x_init, then the step noises."""
    return {"x_init": torch.from_numpy(np.array(jax.random.normal(key, (rows, P, 3)))),
            "noises": torch.from_numpy(np.array(
                jax.random.normal(jax.random.fold_in(key, 1), (10, rows, P, 3))))}


@functools.lru_cache(maxsize=None)
def jax_train_fn():
    """JAX's `NavDPTrainer.loss_fn` under value_and_grad, with the module's
    8 forward outputs as aux: one jitted program."""
    jm, _, _ = jax_pair()
    seen = []

    class Recording:
        def apply(self, variables, *args):
            seen.append(jm.apply(variables, *args))
            return seen[-1]

    jself = types.SimpleNamespace(policy=types.SimpleNamespace(module=Recording()))

    def loss(p, batch, key):
        value, metrics = jtrainer.NavDPTrainer.loss_fn(jself, p, batch, key)
        return value, (metrics, seen.pop())

    return in_small_towers(jax.jit(jax.value_and_grad(loss, has_aux=True)))


def jax_batch(x, seed=1):
    rs = np.random.RandomState(seed)
    return {"observations": {k: x[k] for k in ORDER},
            "label_critic": rs.randn(B).astype(np.float32),
            "augment_critic": rs.randn(B).astype(np.float32)}


@pytest.fixture(scope="module")
def inference():
    """JAX's towers and four inference modes on one set of inputs and key,
    in one jitted program."""
    jm, params, _ = jax_pair()
    x = train_inputs(5)
    key = jax.random.PRNGKey(11)

    def run(module, gp, gi, gx, imgs, deps, key):
        rgbd = module.rgbd_encoder(imgs, deps)
        goals = {"pointgoal": module.point_encoder(gp)[:, None],
                 "nogoal": jnp.zeros_like(rgbd[:, :1]),
                 "imagegoal": module.image_encoder(gi)[:, None],
                 "pixelgoal": module.pixel_encoder(gx)[:, None]}
        out = {m: module._denoise_and_rank(g, rgbd, key, SAMPLES) for m, g in goals.items()}
        out.update(rgbd=rgbd, image=goals["imagegoal"][:, 0], pixel=goals["pixelgoal"][:, 0])
        return out

    fn = in_small_towers(jax.jit(lambda p, *a: fnn.apply(run, jm)({"params": p}, *a)))
    want = fn(params, *[jnp.asarray(x[k]) for k in ORDER[:5]], key)
    return x, key, want


# ------------------------------------------------------------------ towers
@pytest.mark.parametrize("channels,kw,outputs", [
    (3, {"intermediates": (0, 2, 3)}, 6), (6, {}, 1), (7, {}, 1),
    (7, {"intermediates": (1, 3)}, 4)], ids=["intermediates3", "plain6", "plain7",
                                             "intermediates7"])
def test_dino_vit_equals_jax(channels, kw, outputs):
    """A narrow 4-block DinoViT at 28 px with 3, 6 and 7 input channels and
    its intermediates (each through the final norm, as (patch, cls)
    pairs)."""
    jm = jvit.DinoViT(dim=32, depth=4, heads=2, in_channels=channels)
    x = np.random.RandomState(channels).rand(2, S, S, channels).astype(np.float32)
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, **kw), jax.random.PRNGKey(0),
                            jnp.asarray(x))
    params = random_jax_params(shapes["params"], channels)
    tm = tvit.DinoViT(dim=32, depth=4, heads=2, image_hw=S, in_channels=channels)
    load_from_jax(tm, params)
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a, **kw))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), **kw)
    flat_w, flat_g = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(
        got, is_leaf=torch.is_tensor)
    assert len(flat_w) == len(flat_g) == outputs
    for w, g in zip(flat_w, flat_g):
        assert tuple(w.shape) == tuple(g.shape)
        close(w, g)


@pytest.mark.parametrize("tower", ["image", "pixel", "rgbd"])
def test_goal_towers_and_memory_tokens_equal_jax(inference, tower):
    x, _, want = inference
    _, _, net = jax_pair()
    with torch.no_grad():
        if tower == "rgbd":
            got = net.rgbd_encoder(torch.from_numpy(x["input_images"]),
                                   torch.from_numpy(x["input_depths"]))
        else:
            got = getattr(net, f"{tower}_encoder")(torch.from_numpy(x[f"goal_{tower}"]))
    assert tuple(got.shape) == tuple(want[tower].shape)
    close(want[tower], got)


def test_target_mask_keeps_strictly_future_waypoints():
    got = tnavdp.navdp_tgt_mask(P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnavdp._ref_navdp_tgt_mask(P)))
    assert not got[-1].any() and got[0, 1:].all() and not got.diagonal().any()
    from internnav_tpu_torch.model.encoder.transformer import MultiHeadAttention

    attn = MultiHeadAttention(8, 2)
    x = torch.randn(1, P, 8)
    _, probs = attn(x, x, x, None, got, need_weights=True)
    assert float(probs[0, :, -1].abs().max().detach()) == 0.0  # the blocked row's weights are zero
    np.testing.assert_allclose(probs[0, :, :-1].sum(-1).detach().numpy(), 1.0, rtol=1e-6)


def test_predict_noise_and_critic_equal_jax():
    jm, params, net = jax_pair()
    rs = np.random.RandomState(2)
    x = rs.randn(3, P, 3).astype(np.float32)
    goal = rs.randn(3, 1, 384).astype(np.float32)
    rgbd = rs.randn(3, M * 16, 384).astype(np.float32)
    t = np.array([0, 4, 9])
    want_eps = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=jm.predict_noise))(
        params, x, t, goal, rgbd)
    want_critic = jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                                 method=jm.predict_critic))(params, x, rgbd)
    with torch.no_grad():
        got_eps = net.predict_noise(*(torch.from_numpy(a) for a in (x, t, goal, rgbd)))
        got_scalar_t = net.predict_noise(torch.from_numpy(x), torch.tensor(4),
                                         *(torch.from_numpy(a) for a in (goal, rgbd)))
        got_critic = net.predict_critic(torch.from_numpy(x), torch.from_numpy(rgbd))
    close(want_eps, got_eps)
    close(want_critic, got_critic)
    assert tuple(got_critic.shape) == (3,)
    want_t4 = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=jm.predict_noise))(
        params, x, 4, goal, rgbd)
    close(want_t4, got_scalar_t)


# ---------------------------------------------------------------- training
def test_training_forward_loss_and_every_gradient_equal_jax(tmp_path):
    jm, params, net = jax_pair()
    x = train_inputs(1)
    batch = jax_batch(x)
    key = jax.random.PRNGKey(7)
    (jloss, (jmetrics, jouts)), jgrads = jax_train_fn()(params, batch, key)
    draws = train_draws(key)
    with torch.no_grad():
        outs = net(*(torch.from_numpy(x[k]) for k in ORDER), draws)
    names = ("eps_ng", "eps_mg", "critic_label", "critic_augment", "ng_noise", "mg_noise",
             "image_aux", "pixel_aux")
    for name, w, g in zip(names, jouts, outs):
        assert tuple(w.shape) == tuple(g.shape), name
        close(w, g)
    # the multigoal pattern differs from the no-goal branch (i % 27, base 3)
    assert not torch.allclose(outs[0], outs[1])
    pol = tnavdp.NavDPPolicy(net, tiny(tmodel_zoo.get_config))
    trainer = NavDPTrainer(ExpCfg(name="n", model_name="navdp", output_dir=str(tmp_path),
                                  model=pol.cfg), pol, total_steps=3)
    (piece,) = trainer.micro_batches(batch)
    net.zero_grad()
    loss, metrics = trainer.loss_fn(piece, draws)
    loss.backward()
    close(jloss, loss, LOSS_TOL)
    for k in ("ng_action_loss", "mg_action_loss", "critic_loss", "aux_loss"):
        close(jmetrics[k], metrics[k], LOSS_TOL)
        assert float(metrics[k].detach()) > 0
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), net)
    largest = max(float(w.abs().max()) for w in want.values())
    floor = 1e-4 * largest
    worst, zero = (0.0, None), (0.0, None)
    for name, prm in net.named_parameters():
        assert prm.grad is not None, name
        if name.endswith("k_proj.bias"):
            zero = max(zero, (max(float(prm.grad.abs().max()),
                                  float(want[name].abs().max())) / largest, name))
            continue
        scale = max(float(want[name].abs().max()), floor)
        worst = max(worst, (float((prm.grad - want[name]).abs().max()) / scale, name))
    assert worst[0] <= GRAD_TOL, worst
    assert zero[1] is not None and zero[0] <= ZERO_GRAD_TOL, zero
    net.zero_grad(set_to_none=True)
    # the EMA: on unless use_ema was set, as JAX's NavDPTrainer decides
    assert trainer.cfg.il.use_ema and trainer.ema is not None
    for use in (False, True):
        t2 = NavDPTrainer(ExpCfg(name="n", model_name="navdp", output_dir=str(tmp_path),
                                 model=pol.cfg, il=IlCfg(use_ema=use)), pol, total_steps=2)
        assert (t2.ema is not None) == use


def test_decay_mask_equals_jax():
    _, params, net = jax_pair()
    assert_decay_mask_equals_jax(net, state_dict_from_jax(jax_decay_mask(params), net))


def test_three_trainer_steps_with_the_ema_equal_jax(tmp_path):
    """JAX's optimizer chain (`trainer.base.make_optimizer`) and
    `trainer.ema.ema_update` over JAX's gradients, a key a step, against
    the port's `NavDPTrainer.train_step` with those keys' draws: the losses,
    the parameters and the EMA after three steps."""
    import optax

    from internnav_tpu.configs.trainer import ExpCfg as JExpCfg
    from internnav_tpu.configs.trainer import IlCfg as JIlCfg
    from internnav_tpu.trainer.base import make_optimizer
    from internnav_tpu.trainer.ema import ema_init, ema_update

    jm, params, net = jax_pair()
    batch = jax_batch(train_inputs(2), seed=3)
    tx = make_optimizer(JExpCfg(name="j", model_name="navdp", model=tiny(jget_config),
                                il=JIlCfg(lr=LR)), 3)
    update = jax.jit(lambda g, o, p: tx.update(g, o, p))
    jp, jo, jema, jlosses = params, tx.init(params), ema_init(params), []
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    for i, key in enumerate(keys):
        (loss, _), grads = jax_train_fn()(jp, batch, key)
        updates, jo = update(grads, jo, jp)
        jp = optax.apply_updates(jp, updates)
        jema = ema_update(jema, jp, jnp.asarray(i + 1))
        jlosses.append(float(loss))
    with small_towers():
        port = tnavdp.NavDPNet(tiny(tmodel_zoo.get_config), image_size=S)
    port.load_state_dict(net.state_dict())
    pol = tnavdp.NavDPPolicy(port, tiny(tmodel_zoo.get_config))
    trainer = NavDPTrainer(ExpCfg(name="n", model_name="navdp", output_dir=str(tmp_path),
                                  model=pol.cfg, il=IlCfg(lr=LR)), pol, total_steps=3)
    losses = [float(trainer.train_step(batch, train_draws(k))["loss"]) for k in keys]
    np.testing.assert_allclose(losses[:2], jlosses[:2], rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(losses[2], jlosses[2], rtol=MOVED_LOSS_TOL)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp), port)
    want_ema = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jema), port)
    moved = 0
    for name, prm in port.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(), atol=ADAM_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(trainer.ema[name].numpy(), want_ema[name].numpy(),
                                   atol=ADAM_TOL, err_msg=name)
        moved += not torch.equal(prm.detach(), net.state_dict()[name])
    assert moved > 0  # step 1 is at lr 0 (the warmup), step 2 moves


# --------------------------------------------------------------- inference
@pytest.mark.parametrize("mode", MODES)
def test_inference_modes_equal_jax(inference, mode):
    x, key, want = inference
    _, params, net = jax_pair()
    pol = tnavdp.NavDPPolicy(net, tiny(tmodel_zoo.get_config))
    obs = {k: x[k] for k in ORDER[:5]}
    neg, pos = pol.forward({"mode": mode, "observations": obs, "sample_num": SAMPLES,
                            "draws": infer_draws(key, B * SAMPLES)})
    want_neg, want_pos = want[mode]
    assert tuple(pos.shape) == (B, SAMPLES, P, 3) == tuple(want_pos.shape)
    close(want_pos, pos, atol=TRAJ_TOL, tol=0)
    close(want_neg, neg, atol=TRAJ_TOL, tol=0)
    assert not pos.requires_grad


def test_policy_forward_draws_from_its_generator():
    _, _, net = jax_pair()
    pol = tnavdp.NavDPPolicy(net, tiny(tmodel_zoo.get_config), seed=4)
    obs = {k: v for k, v in train_inputs(6).items() if k in ORDER[:5]}
    batch = {"mode": "pointgoal", "observations": obs, "sample_num": 2}
    a, b = pol.forward(batch)[1], pol.forward(batch)[1]
    assert not torch.equal(a, b)  # the generator moves on
    again = tnavdp.NavDPPolicy(net, tiny(tmodel_zoo.get_config), seed=4)
    assert torch.equal(again.forward(batch)[1], a)
    with pytest.raises(KeyError, match="unknown NavDP mode"):
        pol.forward(dict(batch, mode="sidegoal"))


# ------------------------------------------------------------ conversion
def test_reference_checkpoint_converts_as_jax(tmp_path):
    """The port's net as a reference-layout state dict (the keys of the
    reference's NavDPNet: `blocks.N.attn.qkv`, `layers.N.multihead_attn.
    in_proj_*`, `layernorm`, `cond_pos_embed.position_embedding`): JAX's
    `convert_navdp_policy` gives the JAX tree of the same tensors, the
    port's `from_pretrained` on the .pth the same net, and a 224-grid
    position table is resized to the net's grid."""
    jm, params, net = jax_pair()
    sd = tconvert.navdp_reference_state_dict(net)
    assert "rgbd_encoder.rgb_model.blocks.0.attn.qkv.weight" in sd
    assert "decoder.layers.0.multihead_attn.in_proj_weight" in sd
    assert "rgbd_encoder.former_net.layers.1.norm3.bias" in sd
    tree = jconvert.convert_navdp_policy({k: v.numpy() for k, v in sd.items()})
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(params))
    for name, value in state_dict_from_jax(tree, net).items():
        assert torch.equal(value, net.state_dict()[name]), name
    torch.save(sd, tmp_path / "navdp.pth")
    with small_towers():
        pol = tmodel_zoo.get_policy("navdp").from_pretrained(
            str(tmp_path / "navdp.pth"), tiny(tmodel_zoo.get_config), device="cpu")
    for name, value in pol.net.state_dict().items():
        assert torch.equal(value, net.state_dict()[name]), name
    assert set(tconvert.navdp_reference_state_dict(pol.net)) == set(sd)
    # a checkpoint written at 224 px: its 16x16 position tables take the
    # net's 2x2 grid, as the reference interpolates them at run time
    big = dict(sd, **{"rgbd_encoder.rgb_model.pos_embed": torch.randn(1, 257, 384)})
    got = tconvert.convert_navdp_policy(big, net)["rgbd_encoder.rgb_model.pos_embed"]
    want = jconvert.interpolate_dino_pos_embed(big["rgbd_encoder.rgb_model.pos_embed"].numpy(),
                                               (2, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
