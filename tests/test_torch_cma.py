"""The port's recurrent VLN policies (CMA, Seq2Seq) against the JAX
package's on the CPU, at small widths (the text encoder, the state width
and the RGB tower cut down; JAX's depth tower is its fixed DD-PPO
ResNet-50, so the port's runs at its default too):

- the encoders: `HabitatResNetEncoder(base_planes=8, layers=(1, 1, 1, 1))`,
  `TorchVisionResNet("resnet18")` spatial and pooled, the depth tower,
  JAX's `_adaptive_avg_pool` against torch's, which the port calls (an
  output larger than its input included),
  `FrozenBatchNorm`, `scaled_masked_attention`;
- `CMANet` and `Seq2SeqNet` (with and without the prev-action embedding)
  single-step and over a (T, N) sequence with resets, through `from_jax`;
- one reference-layout state dict (the keys JAX's `convert_cma_policy` /
  `convert_seq2seq_policy` read; 16 depth tokens, which that converter
  assumes) loaded through JAX's converter and through the port's loader,
  giving equal outputs: a transposed flatten or spatial table shows here;

The policies' persistence and the agents are in
tests/test_torch_recurrent_agents.py.

JAX params come from `jax.eval_shape` and a numpy seed (no init run), and
the JAX forwards are jitted (a few seconds each). fp32 throughout, within
NET_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internnav_tpu.model import get_config as jget_config
from internnav_tpu.model.basemodel import cma as jcma
from internnav_tpu.model.basemodel import seq2seq as jseq
from internnav_tpu.model.encoder import resnet as jres
from internnav_tpu.model.weights import convert as jconvert
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.model.basemodel import cma as tcma
from internnav_tpu_torch.model.basemodel import seq2seq as tseq
from internnav_tpu_torch.model.encoder import resnet as tres
from internnav_tpu_torch.model.weights import convert as tconvert
from internnav_tpu_torch.model.weights.from_jax import (
    cma_state_from_jax,
    seq2seq_state_from_jax,
    state_dict_from_jax,
)

torch.set_num_threads(2)
#: fp32 through two ResNets, a bi-LSTM and two GRUs (XLA's and torch's
#: convolution and GroupNorm orders differ in the last bits)
NET_TOL = 1e-4
RGB, DEPTH, B, L = 32, 64, 3, 12


def small_cfg(get_config, name):
    cfg = get_config(name)
    cfg.text_encoder.vocab_size = 50
    cfg.text_encoder.embedding_size = 8
    cfg.text_encoder.rnn_hidden_size = 8
    cfg.image_encoder.rgb.model_name = "resnet18"
    cfg.image_encoder.rgb.output_size = 16
    cfg.image_encoder.depth.output_size = 16
    cfg.state_encoder.hidden_size = 32
    return cfg


def jax_params(module, *args, seed=0):
    """A JAX module's params from jax.eval_shape (no init run) drawn from
    a numpy seed at sensible scales: kernels N(0, 1/fan_in), BatchNorm
    variances in [0.5, 1.5], norm scales near 1."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "var":
            v = rs.uniform(0.5, 1.5, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*s.shape)
        elif name in ("kernel", "w_ih", "w_hh", "rev_w_ih", "rev_w_hh"):
            fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" else s.shape[1]
            v = rs.randn(*s.shape) / np.sqrt(fan_in)
        elif name in ("embedding", "spatial_embeddings"):
            v = rs.randn(*s.shape)
        else:
            v = 0.1 * rs.randn(*s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def observations(rs, n=B, depth=DEPTH, seq=None):
    lead = (n,) if seq is None else (seq, n)
    tok = np.zeros(lead + (L,), np.int32)
    flat = tok.reshape(-1, L)
    for i in range(flat.shape[0]):
        k = [5, 0, L, 1][i % 4]
        flat[i, :k] = rs.randint(1, 50, k)
    return {"instruction": tok,
            "rgb": rs.randint(0, 255, lead + (RGB, RGB, 3)).astype(np.float32),
            "depth": rs.uniform(0, 1, lead + (depth, depth, 1)).astype(np.float32)}


def t_(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def close(a, b, tol=NET_TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=tol, rtol=tol)


# ------------------------------------------------------------- encoders
def test_habitat_resnet_encoder_equals_jax():
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    kw = dict(base_planes=8, ngroups=4, layers=(1, 1, 1, 1))
    for block in ("bottleneck", "basic"):
        jm = jres.HabitatResNetEncoder(block=block, **kw)
        p = jax_params(jm, x, seed=1)
        want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, x)
        tm = tres.HabitatResNetEncoder(block=block, input_hw=64, **kw)
        tm.load_state_dict(state_dict_from_jax(p, tm))
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert tm.side ** 2 == want.shape[1] and tm.out_channels == want.shape[2]
        close(want, got.flatten(2).transpose(1, 2))
        assert tm.compress_gn.eps == tm.backbone.stem_gn.eps == 1e-6  # Flax's GroupNorm


@pytest.mark.parametrize("spatial", [True, False])
def test_torchvision_resnet_equals_jax(spatial):
    rs = np.random.RandomState(2)
    for hw in (32, 40):  # a 1x1 and a 2x2 grid before the 4x4 pool
        x = rs.randint(0, 255, (2, hw, hw, 3)).astype(np.float32)
        jm = jres.TorchVisionResNet(version="resnet18", output_size=12, spatial_output=spatial,
                                    normalize_visual_inputs=True)
        p = jax_params(jm, x, seed=3)
        want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, x)
        tm = tres.TorchVisionResNet(version="resnet18", output_size=12, spatial_output=spatial,
                                    normalize_visual_inputs=True)
        tm.load_state_dict(state_dict_from_jax(p, tm))
        close(want, tm(torch.from_numpy(x)))


@pytest.mark.parametrize("spatial", [True, False])
def test_depth_encoder_equals_jax(spatial):
    rs = np.random.RandomState(4)
    x = rs.uniform(0, 1, (2, DEPTH, DEPTH, 1)).astype(np.float32)
    jm = jres.VlnResnetDepthEncoder(output_size=16, spatial_output=spatial)
    p = jax_params(jm, x, seed=5)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, x)
    tm = tres.VlnResnetDepthEncoder(output_size=16, spatial_output=spatial, input_hw=DEPTH)
    tm.load_state_dict(state_dict_from_jax(p, tm))
    close(want, tm(torch.from_numpy(x)))


@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (1, 1), (5, 3), (3, 9)])
def test_adaptive_avg_pool_equals_jax(hw):
    x = np.random.RandomState(6).randn(2, *hw, 3).astype(np.float32)
    want = jres._adaptive_avg_pool(jnp.asarray(x), 4)
    got = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 4)
    close(want, got.permute(0, 2, 3, 1), tol=1e-6)


def test_frozen_batch_norm_and_attention_equal_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 5, 6).astype(np.float32)
    jm = jres.FrozenBatchNorm(6)
    p = jax_params(jm, x, seed=8)
    tm = tres.FrozenBatchNorm(6)
    tm.load_state_dict(state_dict_from_jax(p, tm))
    close(jm.apply({"params": p}, x), tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1), tol=1e-6)
    q, k, v = rs.randn(3, 4), rs.randn(3, 7, 4), rs.randn(3, 7, 5)
    mask = rs.rand(3, 7) > 0.5
    for m in (None, mask):
        want = jcma.scaled_masked_attention(q, k, v, m, 0.5)
        got = tcma.scaled_masked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v),
                                           None if m is None else torch.from_numpy(m), 0.5)
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-6)


# ------------------------------------------------------------ the nets
def jax_net(name, cfg, use_prev_action=False):
    if name == "cma":
        return jcma.CMANet(cfg=cfg)
    return jseq.Seq2SeqNet(cfg=cfg, use_prev_action=use_prev_action)


def port_net(name, cfg, depth=DEPTH, use_prev_action=False):
    if name == "cma":
        return tcma.CMANet(cfg, depth_hw=depth).eval()
    return tseq.Seq2SeqNet(cfg, use_prev_action=use_prev_action, depth_hw=depth).eval()


def net_inputs(rs, layers, seq=None, n=B, depth=DEPTH):
    obs = observations(rs, n, depth, seq)
    lead = (n,) if seq is None else (seq, n)
    states = rs.randn(n, layers, 32).astype(np.float32)
    prev = rs.randint(0, 4, lead)
    masks = (rs.rand(*lead) > 0.3).astype(np.float32)
    return obs, states, prev, masks


@pytest.mark.parametrize("name,prev", [("cma", False), ("seq2seq", False), ("seq2seq", True)])
@pytest.mark.parametrize("seq", [None, 3])
def test_net_equals_jax_through_from_jax(name, prev, seq):
    cfg_j, cfg_t = small_cfg(jget_config, name), small_cfg(tmodel_zoo.get_config, name)
    layers = 2 if name == "cma" else 1
    obs, states, pa, masks = net_inputs(np.random.RandomState(9), layers, seq)
    jm = jax_net(name, cfg_j, prev)
    args = (obs, states, pa, masks)
    p = jax_params(jm, *args, seed=10)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(p, *args)
    tm = port_net(name, cfg_t, use_prev_action=prev)
    convert = cma_state_from_jax if name == "cma" else seq2seq_state_from_jax
    tm.load_state_dict(convert(p, tm))
    with torch.no_grad():
        got = tm(t_(obs), torch.from_numpy(states), torch.from_numpy(pa), torch.from_numpy(masks))
    for w, g in zip(want, got):
        assert tuple(w.shape) == tuple(g.shape)
        close(w, g)


@pytest.mark.parametrize("name", ["cma", "seq2seq"])
def test_reference_checkpoint_loads_as_jax_converts_it(name):
    """One reference-layout state dict (from a random port net through the
    inverse map) through JAX's converter + Flax and through the port's
    loader: equal outputs; the port's loader gives back the original
    weights."""
    cfg_j, cfg_t = small_cfg(jget_config, name), small_cfg(tmodel_zoo.get_config, name)
    src = port_net(name, cfg_t, depth=256)
    with torch.no_grad():
        for prm in src.parameters():  # away from torch's init scale, every tensor its own
            prm.add_(0.05 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(
                prm.numel())))
        for buf_name, buf in src.named_buffers():
            if buf_name.endswith(".var"):
                buf.uniform_(0.5, 1.5)
            elif buf_name.endswith(".mean"):
                buf.normal_(0.0, 0.1)
    sd = tconvert.recurrent_reference_state_dict(src)
    assert "depth_linear.1.weight" in sd or "depth_encoder.visual_fc.1.weight" in sd
    assert "rgb_encoder.cnn.4.0.conv1.weight" in sd
    assert "instruction_encoder.encoder_rnn.weight_ih_l0_reverse" in sd
    params = (jconvert.convert_cma_policy if name == "cma" else jconvert.convert_seq2seq_policy)(
        {k: v.numpy() for k, v in sd.items()}, rgb_version="resnet18")
    layers = 2 if name == "cma" else 1
    obs, states, pa, masks = net_inputs(np.random.RandomState(11), layers, depth=256, n=2)
    jm = jax_net(name, cfg_j)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, obs, states, pa, masks)
    net = port_net(name, cfg_t, depth=256)
    net.load_state_dict(tconvert.convert_recurrent_policy(
        {f"module.{k}": v for k, v in sd.items()}, net))  # DDP's prefix is stripped
    for k, v in src.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    with torch.no_grad():
        got = net(t_(obs), torch.from_numpy(states), torch.from_numpy(pa), torch.from_numpy(masks))
    for w, g in zip(want, got):
        close(w, g)
