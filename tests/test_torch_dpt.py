"""DepthAnythingV2's DPT depth head in the port against the JAX package on
the CPU, fp32:

- the align_corners=True bilinear resize (`F.interpolate` in the port)
  against JAX's two interpolation matrices, within RESIZE_TOL, up, down,
  to and from one pixel;
- `DPTHead` on random (patch, cls) intermediates over a 3x4 patch grid,
  and the whole `DepthAnythingV2` (a ViT-S trunk's blocks 2, 5, 8, 11) on
  42x42 pixels, within FWD_TOL;
- a reference-layout checkpoint (`depth_anything_reference_state_dict`:
  `pretrained.blocks.N.attn.qkv`, `depth_head.projects.N`,
  `depth_head.resize_layers.N`, `depth_head.scratch.refinenetN.
  resConfUnitM`) through JAX's `convert_depth_anything_v2` and the port's:
  the same tensors, its 518-pixel position table resized to the net's
  grid as JAX's `interpolate_dino_pos_embed` resizes it.

JAX params come from `jax.eval_shape` and a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internnav_tpu.model.encoder import dpt as jdpt
from internnav_tpu.model.weights import convert as jconvert
from internnav_tpu_torch.model.encoder import dpt as tdpt
from internnav_tpu_torch.model.weights import convert as tconvert
from internnav_tpu_torch.model.weights.from_jax import load_from_jax, state_dict_from_jax
from test_torch_system1 import random_jax_params

torch.set_num_threads(2)
#: one bilinear resize: the same two-tap sums in another order, relative
RESIZE_TOL = 1e-6
#: fp32 forwards through the trunk, the head's convs and resizes, relative
FWD_TOL = 1e-5
#: a 3x4 patch grid for the head alone, 3x3 for the whole model
GRID, PIXELS = (3, 4), (42, 42)


def close(want, got, tol):
    np.testing.assert_allclose(got.detach().double().numpy(), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hw,out", [((3, 4), (7, 9)), ((8, 6), (4, 3)), ((1, 5), (3, 5)),
                                    ((5, 5), (1, 1)), ((4, 4), (4, 4))])
def test_resize_align_corners_equals_jax(hw, out):
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 3).astype(np.float32)
    want = jdpt.resize_bilinear_align_corners(jnp.asarray(x), out)
    got = tdpt.resize_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), out)
    close(want, got.permute(0, 2, 3, 1), RESIZE_TOL)


def test_dpt_head_equals_jax():
    jm = jdpt.DPTHead()
    rs = np.random.RandomState(0)
    n = GRID[0] * GRID[1]
    feats = [(rs.randn(2, n, 384).astype(np.float32), rs.randn(2, 384).astype(np.float32))
             for _ in range(4)]
    shapes = jax.eval_shape(lambda k, f: jm.init(k, f, *GRID), jax.random.PRNGKey(0), feats)
    params = random_jax_params(shapes["params"], 1)
    tm = tdpt.DPTHead()
    load_from_jax(tm, params)
    assert not hasattr(tm.refinenet4, "res1")  # the first fusion block has no skip unit
    want = jax.jit(lambda p, f: jm.apply({"params": p}, f, *GRID))(params, feats)
    with torch.no_grad():
        got = tm([tuple(torch.from_numpy(a) for a in f) for f in feats], *GRID)
    assert tuple(got.shape) == (2, 1, 14 * GRID[0], 14 * GRID[1])
    close(want, got.permute(0, 2, 3, 1), FWD_TOL)


@pytest.fixture(scope="module")
def depth_anything():
    """(JAX DepthAnythingV2, its params, the port's module holding them)."""
    jm = jdpt.DepthAnythingV2()
    x = np.zeros((1, *PIXELS, 3), np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_jax_params(shapes["params"], 2)
    tm = tdpt.DepthAnythingV2(image_hw=PIXELS[0])
    load_from_jax(tm, params)
    return jm, params, tm


def test_depth_anything_v2_equals_jax(depth_anything):
    jm, params, tm = depth_anything
    x = np.random.RandomState(3).randn(2, *PIXELS, 3).astype(np.float32)
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, *PIXELS)
    close(want, got, FWD_TOL)
    assert 0.0 <= float(got.min()) and float(got.max()) <= tm.max_depth


def test_reference_checkpoint_converts_as_jax(depth_anything):
    _, params, tm = depth_anything
    sd = tconvert.depth_anything_reference_state_dict(tm)
    for key in ("pretrained.blocks.11.attn.qkv.weight", "depth_head.projects.3.bias",
                "depth_head.resize_layers.0.weight",
                "depth_head.scratch.refinenet2.resConfUnit1.conv2.weight",
                "depth_head.scratch.output_conv2.2.bias"):
        assert key in sd, key
    tree = jconvert.convert_depth_anything_v2({k: v.numpy() for k, v in sd.items()})
    unused = tree["depth_head"]["refinenet4"].pop("res1")  # the reference's, never run
    assert not any(np.any(a) for a in jax.tree_util.tree_leaves(unused))
    assert len(jax.tree_util.tree_leaves(tree)) == len(jax.tree_util.tree_leaves(params))
    for name, value in state_dict_from_jax(tree, tm).items():
        assert torch.equal(value, tm.state_dict()[name]), name
    for name, value in tconvert.convert_depth_anything_v2(sd, tm).items():
        assert torch.equal(value, tm.state_dict()[name]), name
    # the published checkpoint's 518-pixel (37x37) table on a net of 28
    # pixels (2x2), and on a 2x3 grid
    big = dict(sd, **{"pretrained.pos_embed": torch.randn(1, 1 + 37 * 37, 384)})
    square = tdpt.DepthAnythingV2(image_hw=28)
    got = tconvert.convert_depth_anything_v2(big, square)["pretrained.pos_embed"]
    want = jconvert.convert_depth_anything_v2({k: v.numpy() for k, v in big.items()},
                                              grid_hw=(2, 2))["pretrained"]["pos_embed"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tconvert.interpolate_dino_pos_embed(big["pretrained.pos_embed"], (2, 3)).numpy(),
        jconvert.interpolate_dino_pos_embed(big["pretrained.pos_embed"].numpy(), (2, 3)),
        rtol=1e-6, atol=1e-6)
