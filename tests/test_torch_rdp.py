"""The RDP family in the port against the JAX package on the CPU, at small
widths (text 1 layer, state width 32, a 48-wide 1-layer CLIP tower at
224x224, the DD-PPO depth tower at 256x256, a 1-layer 32-wide diffusion
transformer), fp32:

- each encoder against its JAX module within ENC_TOL: the RoBERTa-style
  LanguageEncoder, the cross-modal VisionLanguageEncoder (its first-head
  probabilities too), LongCLIP, the CLIP tower, the RGB-D image encoder in
  both modes, the diffusion transformer (with and without the condition
  encoder layer, type embeddings, a CFG token mask) and DistanceNetwork;
- `RDPNet` in modes update_rnn, train (JAX's t, ε and CFG mask rows drawn
  from its key and handed to the port) and act (x_init and the 20 step
  noises from JAX's keys): the trajectory within TRAJ_TOL;
- `RDPTrainer`'s loss terms in fp32 against JAX's `loss_fn`, and every
  gradient with both packages in float64 (`jax.grad` under
  `jax.enable_x64`; the port through tests/test_torch_cma_train.py's
  `float64_port`, which says why), and the EMA on unless `il.use_ema` is
  set;
- `CMACLIPNet` against JAX's, RoBERTa and LongCLIP text, single step and
  a (T, N) sequence;
- a reference-layout RDPNet state dict (the `TorchRDP` replica of
  tests/test_rdp_full_forward.py) through JAX's `convert_rdp_policy` and
  through the port's (`RDPPolicy.from_pretrained` on a .pth file): the
  same tensors, and the two forwards agree; the port's inverse map gives
  the file back.

JAX params come from `jax.eval_shape` and a numpy seed; JAX forwards are
jitted, one program shared by the tests that run it.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from internnav_tpu.model import base as jbase
from internnav_tpu.model import get_config as jget_config
from internnav_tpu.model.basemodel import cma_clip as jcma_clip
from internnav_tpu.model.basemodel import rdp as jrdp
from internnav_tpu.model.encoder import bert as jbert
from internnav_tpu.model.encoder import clip_vit as jclip
from internnav_tpu.model.encoder import diffusion_transformer as jdt
from internnav_tpu.model.encoder import longclip as jlong
from internnav_tpu.model.weights import convert as jconvert
from internnav_tpu.trainer import rdp_trainer as jtrainer
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model.basemodel import cma_clip as tcma_clip
from internnav_tpu_torch.model.basemodel import rdp as trdp
from internnav_tpu_torch.model.encoder import bert as tbert
from internnav_tpu_torch.model.encoder import clip_vit as tclip
from internnav_tpu_torch.model.encoder import diffusion_transformer as tdt
from internnav_tpu_torch.model.encoder import longclip as tlong
from internnav_tpu_torch.model.weights import convert as tconvert
from internnav_tpu_torch.model.weights.from_jax import state_dict_from_jax
from internnav_tpu_torch.trainer.rdp_trainer import RDPTrainer
from test_torch_cma import jax_params
from test_torch_cma_train import (
    GRAD64_TOL,
    LOSS64_TOL,
    assert_decay_mask_equals_jax,
    assert_grads64_close,
    binary_rgb,
    jax_decay_mask,
    grads64,
    to64,
)

torch.set_num_threads(2)
#: an encoder's outputs, fp32 through a few layers
ENC_TOL = 1e-5
#: RDPNet's heads and ε (two towers, a GRU, three transformers)
NET_TOL = 1e-5
#: the act trajectory after 20 DDPM steps
TRAJ_TOL = 1e-4
#: the trainer's fp32 losses
LOSS_TOL = 1e-5
RGB, DEPTH, B = 224, 256, 4


def tiny(get_config, text="roberta"):
    c = get_config("rdp")
    c.text_encoder.model_name = text
    c.text_encoder.num_l_layers = 1
    c.text_encoder.vocab_size = 1000
    c.vit_width, c.vit_layers, c.vit_heads = 48, 1, 2
    c.state_encoder.hidden_size = 32
    c.cross_modal_encoder.num_x_layers = 1
    c.diffusion_policy.n_layer = 1
    c.diffusion_policy.n_emb = 32
    return c


def close(want, got, tol):
    np.testing.assert_allclose(np.asarray(want, np.float64),
                               got.detach().double().numpy(), atol=tol, rtol=tol)


def t_(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ------------------------------------------------------------- encoders
def _ids(rs, b, L, pad, lo=2, hi=100):
    ids = np.full((b, L), pad, np.int32)
    for i in range(b):
        n = [L, L // 2, 3][i % 3]
        ids[i, :n] = rs.randint(lo, hi, n)
    return ids


def _encoder_case(case, rs):
    """(jax module, port module, jax args, port args)."""
    if case == "bert":
        ids = _ids(rs, 3, 9, pad=1)
        return (jbert.LanguageEncoder(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                                      intermediate_size=64),
                tbert.LanguageEncoder(100, 32, 2, 4, 64), (ids,), (torch.from_numpy(ids),))
    if case == "cross":
        q, kv = rs.randn(3, 6, 32).astype(np.float32), rs.randn(3, 9, 32).astype(np.float32)
        qv, kvv = rs.rand(3, 6) > 0.3, rs.rand(3, 9) > 0.3
        qv[:, 0] = kvv[:, 0] = True
        return (jbert.VisionLanguageEncoder(hidden_size=32, num_heads=4, num_layers=2),
                tbert.VisionLanguageEncoder(32, 4, 2), (q, kv, qv, kvv),
                tuple(torch.from_numpy(a) for a in (q, kv, qv, kvv)))
    if case == "longclip":
        ids = _ids(rs, 3, 12, pad=0, hi=110)
        ids[0, 11], ids[1, 5] = 119, 119  # the EOT token: the highest id
        return (jlong.LongCLIPTextEncoder(vocab_size=120, width=32, layers=2, heads=4,
                                          context_length=40, projection_dim=24, keep_len=4),
                tlong.LongCLIPTextEncoder(120, 32, 2, 4, 40, 24, 4), (ids,),
                (torch.from_numpy(ids),))
    if case == "clip_tower":
        px = rs.randn(2, 32, 32, 3).astype(np.float32)
        return (jclip.CLIPVisionTower(width=32, layers=2, heads=4),
                tclip.CLIPVisionTower(32, 2, 4, image_hw=32), (px,), (torch.from_numpy(px),))
    if case.startswith("image_encoder"):
        mode = case.split("-")[1]
        rgb = rs.randint(0, 255, (2, 32, 32, 3)).astype(np.float32)
        depth = rs.uniform(0, 1, (2, 128, 128, 1)).astype(np.float32)
        return (jclip.CLIPImageEncoder(projection_dim=32, img_mod=mode, vit_width=48,
                                       vit_layers=1, vit_heads=2),
                tclip.CLIPImageEncoder(32, mode, 48, 1, 2, image_hw=32, depth_hw=128),
                (rgb, depth), (torch.from_numpy(rgb), torch.from_numpy(depth)))
    if case.startswith("diffusion"):
        n_cond = int(case[-1])
        x = rs.randn(3, 8, 3).astype(np.float32)
        t = np.array([0, 7, 19])
        cond = rs.randn(3, 5, 16).astype(np.float32)
        types_ = rs.randn(3, 5, 32).astype(np.float32)
        mask = np.zeros((3, 6), np.float32)
        mask[1, 1:4] = 1.0
        args = (x, t, cond, types_, mask)
        return (jdt.TransformerForDiffusion(input_dim=3, output_dim=3, horizon=8, n_obs_steps=5,
                                            cond_dim=16, n_emb=32, n_layer=2,
                                            n_cond_layers=n_cond, head_dim=16),
                tdt.TransformerForDiffusion(3, 3, 8, 5, 16, 32, 2, n_cond, head_dim=16), args,
                tuple(torch.from_numpy(a) for a in args))
    norm = case.endswith("1")
    x = rs.randn(4, 64).astype(np.float32)
    return (jdt.DistanceNetwork(normalize=norm), tdt.DistanceNetwork(64, normalize=norm), (x,),
            (torch.from_numpy(x),))


@pytest.mark.parametrize("case", ["bert", "cross", "longclip", "clip_tower",
                                  "image_encoder-multi_patches_avg_pooling", "image_encoder-cls",
                                  "diffusion-0", "diffusion-1", "distance-0", "distance-1"])
def test_encoder_equals_jax(case):
    jm, tm, jargs, targs = _encoder_case(case, np.random.RandomState(0))
    p = jax_params(jm, *jargs, seed=1)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(p, *jargs)
    tm.load_state_dict(state_dict_from_jax(p, tm))
    with torch.no_grad():
        got = tm.eval()(*targs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(w.shape) == tuple(g.shape)
        close(w, g, ENC_TOL)


# ---------------------------------------------------------------- RDPNet
def rdp_inputs(rs, b=B):
    obs = {"instruction": _ids(rs, b, 16, pad=1, hi=1000),
           "rgb": rs.randint(0, 255, (b, RGB, RGB, 3)).astype(np.float32),
           "depth": rs.uniform(0, 1, (b, DEPTH, DEPTH, 1)).astype(np.float32),
           "imu": rs.randn(b, 3).astype(np.float32),
           "actions": rs.uniform(-1, 1, (b, 8, 3)).astype(np.float32)}
    return (obs, rs.randn(b, 1, 32).astype(np.float32),
            rs.uniform(-0.2, 0.2, (b, 4, 3)).astype(np.float32),
            (np.arange(b) % 3 != 0).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_rdp(text="roberta"):
    """(JAX module, params, one jitted apply per mode)."""
    jm = jrdp.RDPNet(cfg=tiny(jget_config, text))
    params = jax_params(jm, *rdp_inputs(np.random.RandomState(0), 1), "train",
                        jax.random.PRNGKey(1), seed=5)

    @functools.lru_cache(maxsize=None)
    def fn(mode):
        return jax.jit(lambda p, a, key: jm.apply({"params": p}, *a, mode=mode, rng=key))

    return jm, params, fn


def _port_rdp(params, text="roberta"):
    net = trdp.RDPNet(tiny(tmodel_zoo.get_config, text), depth_hw=DEPTH, rgb_hw=RGB).eval()
    net.load_state_dict(state_dict_from_jax(params, net))
    return net


def _train_draws(key, b, ratio):
    """JAX's train_forward draws from `key`, for the port."""
    r_t, r_n, r_m = jax.random.split(key, 3)
    return {"t": torch.from_numpy(np.array(jax.random.randint(r_t, (b,), 0, 20))).long(),
            "noise": torch.from_numpy(np.array(jax.random.normal(r_n, (b, 8, 3)))),
            "mask_rows": torch.from_numpy(np.array(jax.random.uniform(r_m, (b,)) < ratio))}


def _act_draws(key, b):
    """JAX's denoise draws from `key`: x_init, then the step noises."""
    return {"x_init": torch.from_numpy(np.array(jax.random.normal(key, (b, 8, 3)))),
            "noises": torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                                                  (20, b, 8, 3))))}


def _mixed_key(b, ratio):
    """A key whose CFG mask rows mask some rows and not others."""
    for i in range(100):
        rows = _train_draws(jax.random.PRNGKey(i), b, ratio)["mask_rows"]
        if 0 < int(rows.sum()) < b:
            return jax.random.PRNGKey(i)
    raise AssertionError("no key with mixed mask rows")


def test_rdp_net_modes_equal_jax():
    jm, params, fn = _jax_rdp()
    net = _port_rdp(params)
    args = rdp_inputs(np.random.RandomState(7))
    targs = (t_(args[0]), *(torch.from_numpy(a) for a in args[1:]))
    with torch.no_grad():
        want, got = fn("update_rnn")(params, args, None), net(*targs, mode="update_rnn")
        for w, g in zip(want, got):
            close(w, g, NET_TOL)
        key = _mixed_key(B, net.cfg.diffusion_policy.cls_mask_ratio)
        want = fn("train")(params, args, key)
        got = net(*targs, mode="train", draws=_train_draws(key, B, 0.25))
        assert got[-1] is None and want[-1] is None  # no distance head in rdp_cfg
        for w, g in zip(want[:-1], got[:-1]):
            close(w, g, NET_TOL)
        key = jax.random.PRNGKey(3)
        want = fn("act")(params, args, key)
        got = net(*targs, mode="act", draws=_act_draws(key, B))
    close(want[0], got[0], TRAJ_TOL)
    for w, g in zip(want[1:4], got[1:4]):
        close(w, g, NET_TOL)
    assert float(got[0].abs().max()) <= 1.0 + 1e-6  # x0 clamped at every step


def test_rdp_policy_forward_draws_from_its_generator():
    _, params, _ = _jax_rdp()
    pol = trdp.RDPPolicy(_port_rdp(params), tiny(tmodel_zoo.get_config), seed=4)
    obs, st, pa, m = rdp_inputs(np.random.RandomState(8), 2)
    batch = {"observations": t_(obs), "rnn_states": torch.from_numpy(st),
             "prev_actions": torch.from_numpy(pa), "masks": torch.from_numpy(m), "mode": "act"}
    def draws():
        return pol.net.act_draws(2, torch.Generator().manual_seed(9), pol.device)
    a = pol.forward(dict(batch, draws=draws()))[0]
    b = pol.forward(dict(batch, draws=draws()))[0]
    assert torch.equal(a, b) and not a.requires_grad
    c, d = pol.forward(batch)[0], pol.forward(batch)[0]
    assert not torch.equal(c, d)  # the policy's generator moves on
    wp = pol.unnormalize_actions(a)
    stats = trdp.RDPPolicy.ACTION_STATS
    deltas = (a.numpy() + 1.0) / 2.0 * (stats["max"] - stats["min"]) + stats["min"]
    np.testing.assert_allclose(wp, np.cumsum(deltas, axis=-2))


# --------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def rdp_batch(tmp_path_factory):
    from internnav_tpu_torch.dataset.rdp_dataset import (
        make_rdp_dataloader,
        write_synthetic_rdp_dataset,
    )

    path = str(tmp_path_factory.mktemp("rdp") / "store.bin")
    write_synthetic_rdp_dataset(path, n_episodes=2, T=10, hw=RGB, depth_hw=DEPTH, seed=2)
    batch = next(make_rdp_dataloader(path, B)())
    batch["observations"]["instruction"] = batch["observations"]["instruction"][:, :16]
    return batch


def test_rdp_trainer_loss_and_gradients_equal_jax(rdp_batch, tmp_path):
    jm, params, _ = _jax_rdp()
    cfg_j = tiny(jget_config)
    jself = types.SimpleNamespace(
        cfg=types.SimpleNamespace(model=cfg_j), stop_loss_alpha=10.0,
        policy=types.SimpleNamespace(module=jm))
    key = _mixed_key(B, cfg_j.diffusion_policy.cls_mask_ratio)
    batch = binary_rgb(rdp_batch)
    with jax.enable_x64(True):
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jtrainer.RDPTrainer.loss_fn(jself, p, b, key), has_aux=True))(
                to64(params), to64(batch))
        draws = _train_draws(key, B, cfg_j.diffusion_policy.cls_mask_ratio)  # x64's draws
    pol = trdp.RDPPolicy(_port_rdp(params), tiny(tmodel_zoo.get_config))
    trainer = RDPTrainer(ExpCfg(name="r", model_name="rdp", output_dir=str(tmp_path),
                                model=pol.cfg), pol, total_steps=2)
    (piece,) = trainer.micro_batches(batch)
    with torch.no_grad():
        loss, metrics = trainer.loss_fn(piece, dict(draws, noise=draws["noise"].float()))
    close(jloss, loss, LOSS_TOL)
    for k in ("diffusion_loss", "progress_loss", "stop_loss"):
        close(jmetrics[k], metrics[k], LOSS_TOL)
        assert float(metrics[k]) > 0
    got, loss64 = grads64(trainer, piece, draws)
    np.testing.assert_allclose(float(loss64), float(jloss), rtol=LOSS64_TOL)
    assert_grads64_close(got, state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), jgrads), pol.net), GRAD64_TOL)
    # the EMA: on unless use_ema was set, as JAX's RDPTrainer decides
    assert trainer.cfg.il.use_ema and trainer.ema is not None
    for use in (False, True):
        il = IlCfg(use_ema=use)
        t2 = RDPTrainer(ExpCfg(name="r", model_name="rdp", output_dir=str(tmp_path),
                               model=pol.cfg, il=il), pol, total_steps=2)
        assert (t2.ema is not None) == use
    metrics = trainer.train_step(rdp_batch)
    assert np.isfinite(float(metrics["loss"])) and trainer.step == 1


# --------------------------------------------------------------- CMA-CLIP
def cma_clip_cfg(get_config, text):
    c = tiny(get_config, text)
    c.policy_name = "CMA_CLIP_Policy"
    c.text_encoder.hidden_size = 32
    c.image_encoder.rgb.output_size = 16
    c.image_encoder.depth.output_size = 16
    return c


def _cma_clip_inputs(rs, text, lead):
    n = int(np.prod(lead))
    ids = _ids(rs, n, 10, pad=1 if text == "roberta" else 0, hi=900).reshape(lead + (10,))
    obs = {"instruction": ids,
           "rgb": rs.randint(0, 255, lead + (32, 32, 3)).astype(np.float32),
           "depth": rs.uniform(0, 1, lead + (128, 128, 1)).astype(np.float32)}
    return (obs, rs.randn(lead[-1], 2, 32).astype(np.float32), rs.randint(0, 4, lead),
            (rs.rand(*lead) > 0.3).astype(np.float32))


def _cma_clip_pair(text, single):
    """(JAX CMACLIPNet, its params from `single`'s shapes, the port's net
    holding them)."""
    jm = jcma_clip.CMACLIPNet(cfg=cma_clip_cfg(jget_config, text))
    p = jax_params(jm, *single, seed=6)
    net = tcma_clip.CMACLIPNet(cma_clip_cfg(tmodel_zoo.get_config, text), depth_hw=128,
                               rgb_hw=32).eval()
    net.load_state_dict(state_dict_from_jax(p, net))
    return jm, p, net


@pytest.mark.parametrize("text", ["roberta", "clip-long"])
def test_cma_clip_forward_equals_jax(text):
    rs = np.random.RandomState(4)
    single, seq = _cma_clip_inputs(rs, text, (3,)), _cma_clip_inputs(rs, text, (2, 3))
    jm, p, net = _cma_clip_pair(text, single)
    apply = jax.jit(lambda p, a: jm.apply({"params": p}, *a))
    for args in (single, seq):
        want = apply(p, args)
        with torch.no_grad():
            got = net(t_(args[0]), *(torch.from_numpy(np.asarray(a)) for a in args[1:]))
        for w, g in zip(want, got):
            assert tuple(w.shape) == tuple(g.shape)
            close(w, g, NET_TOL)
    assert tmodel_zoo.get_policy("cma_clip") is tcma_clip.CMACLIPPolicy
    assert tcma_clip.CMACLIPPolicy.name == jcma_clip.CMACLIPPolicy.name


@pytest.mark.parametrize("model,text", [("rdp", "roberta"), ("rdp", "clip-long"),
                                        ("cma_clip", "roberta"), ("cma_clip", "clip-long")])
def test_decay_mask_equals_jax(model, text):
    """The port's weight-decay mask (shared trainer code) on every RDP /
    CMA-CLIP parameter: the text encoders' norms and biases, the ViT's,
    the GRU's b_ih / b_hh, the diffusion transformer's."""
    if model == "rdp":
        _, params, _ = _jax_rdp(text)
        net = _port_rdp(params, text)
    else:
        _, params, net = _cma_clip_pair(text, _cma_clip_inputs(np.random.RandomState(4), text,
                                                               (3,)))
    assert_decay_mask_equals_jax(net, state_dict_from_jax(jax_decay_mask(params), net))


# ------------------------------------------------------------ conversion
def test_reference_checkpoint_converts_as_jax(tmp_path):
    """TorchRDP (the reference's RDPNet names, tests/test_rdp_full_forward.py)
    → JAX's convert_rdp_policy, and → the port's converter through
    `RDPPolicy.from_pretrained`: the same tensors; the same forward."""
    from test_rdp_full_forward import TorchRDP

    cfg_j = tiny(jget_config)
    torch.manual_seed(0)
    ref = TorchRDP(cfg_j).eval()
    with torch.no_grad():  # every tensor away from its init constant
        for name, prm in ref.named_parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(
                len(name))))
    sd = {k: v.detach() for k, v in ref.state_dict().items()}
    assert "instruction_encoder.embeddings.token_type_embeddings.weight" in sd
    torch.save(sd, tmp_path / "model.pth")
    jm, init, fn = _jax_rdp()
    jparams = jbase.merge_params(init, jconvert.convert_rdp_policy(
        {k: v.numpy() for k, v in sd.items()}))
    pol = trdp.RDPPolicy.from_pretrained(str(tmp_path / "model.pth"),
                                         tiny(tmodel_zoo.get_config), device="cpu")
    want = state_dict_from_jax(jparams, pol.net)
    for name, t in pol.net.state_dict().items():
        assert torch.equal(t, want[name]), name
    args = rdp_inputs(np.random.RandomState(9))
    targs = (t_(args[0]), *(torch.from_numpy(a) for a in args[1:]))
    key = _mixed_key(B, 0.25)
    with torch.no_grad():
        got = pol.net(*targs, mode="train", draws=_train_draws(key, B, 0.25))
    for w, g in zip(fn("train")(jparams, args, key)[:-1], got[:-1]):
        close(w, g, NET_TOL)
    back = tconvert.rdp_reference_state_dict(pol.net)
    for k, v in back.items():  # the inverse map: the keys JAX reads, the same values
        if k != "instruction_encoder.embeddings.position_embeddings.weight":
            assert torch.equal(v, sd[k]), k
    tt = sd["instruction_encoder.embeddings.token_type_embeddings.weight"][0]
    assert torch.allclose(back["instruction_encoder.embeddings.position_embeddings.weight"],
                          sd["instruction_encoder.embeddings.position_embeddings.weight"] + tt)
