"""The whole InternVLA-N1 serving slice, port against the JAX package.

Both policies hold the same tiny fp32 weights (numpy draws, passed to the
port through `model/weights/from_jax.py`) and get the same frames and
instruction. Fused `s2_step`: greedy tokens exactly equal, traj latents at
atol/rtol 1e-4 (fp32, different summation order). `s1_step_latent`: the
port is handed the noise the JAX policy draws from its key, and the
trajectories agree at 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from test_torch_system1 import F32NextDiTConfig, f32_config, n1_params

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
INSTRUCTION = "walk past the sofa and stop at the kitchen door"


@pytest.fixture(scope="module")
def policies():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        cfg = f32_config()
        jm = jmodel.InternVLAN1Model(cfg)
        params = n1_params(jm, cfg, seed=1)
        tcfg = InternVLAN1Config.tiny("nextdit_async", dtype=torch.float32)
        tm = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
        yield JPolicy(jm, params, cfg), tpolicy.InternVLAN1Policy(tm)


def _frames(n, hw=56, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3)).astype(np.uint8)


def test_fused_s2_steps_match_jax(policies):
    """Two steps: the second prompt carries a history frame (vision cache)."""
    jpol, tpol = policies
    jpol.reset()
    tpol.reset()
    for frame in _frames(2):
        jout = jpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
        tout = tpol.s2_step(frame, INSTRUCTION, max_new_tokens=12)
        np.testing.assert_array_equal(tpol.last_gen_tokens, jpol.last_gen_tokens)
        assert tpol.llm_output == jpol.llm_output
        assert jout.output_latent is not None and tout.output_latent is not None
        np.testing.assert_allclose(tout.output_latent.numpy(), np.asarray(jout.output_latent),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(tout.output_pixel, jout.output_pixel)
    assert len(tpol.input_images) == 2


def test_s1_step_latent_matches_jax_with_injected_noise(policies):
    jpol, tpol = policies
    jpol.reset()
    tpol.reset()
    r = np.random.default_rng(3)
    latent = r.standard_normal((1, 2, 64)).astype(np.float32)
    rgb = _frames(2, seed=4)[None]
    depth = r.uniform(0, 5, (1, 2, 56, 56, 1)).astype(np.float32)
    jout = jpol.s1_step_latent(rgb, depth, jnp.asarray(latent))
    # the JAX policy's first draw: split(PRNGKey(0)) → normal(sub, ...)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    x0 = np.array(jax.random.normal(sub, (32, 8, 3)))
    tout = tpol.s1_step_latent(rgb, depth, torch.from_numpy(latent), x_init=torch.from_numpy(x0))
    np.testing.assert_allclose(tout.trajectory, np.asarray(jout.trajectory), atol=ATOL, rtol=RTOL)
    assert tout.idx == jout.idx


def test_s1_resizes_rgb_and_depth_each_on_its_own_grid(policies):
    """A depth stream at another resolution than rgb is fitted to the S1
    grid on its own (the JAX policy checks the rgb grid only)."""
    _, tpol = policies
    depth = np.ones((1, 2, 90, 90, 1), np.float32)
    assert tpolicy._fit_s1_grid(depth, 56).shape == (1, 2, 56, 56, 1)
    rgb = _frames(2)[None]
    assert tpolicy._fit_s1_grid(rgb, 56) is rgb  # grid matches: untouched
    big = _frames(2, hw=100)[None]
    assert tpolicy._fit_s1_grid(big, 56).shape == (1, 2, 56, 56, 3)
    out = tpol.s1_step_latent(rgb, depth, torch.zeros(1, 2, 64), num_sample_trajs=4)
    assert out.trajectory.shape == (4, 8, 3) and np.isfinite(out.trajectory).all()
