"""The port's NavDP System-1 in the tiny InternVLA-N1, against the JAX
package: `generate_traj_navdp_batched` and the serving slice (`s2_step` →
`s1_step_latent`) of a tiny `navdp_async` policy with JAX's draws
injected; the policy's own draws; the native save/load round trip; the
refusals (a reference-format checkpoint, an unknown System-1, no depth);
and the launcher serving `--system1 navdp_async` / `navdp` on the CPU.

Weights are numpy draws in the shape of the JAX param tree, carried to
the port by `model/weights/from_jax.py`. Tolerance: fp32 at atol/rtol
1e-4; actions exactly equal.
"""

import json

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
from test_torch_navdp import HW, STEPS, _close, _t, jax_noise_pair, rgbd
from test_torch_system1 import f32_config, n1_params

torch.set_num_threads(2)
INSTRUCTION = "walk past the sofa and stop at the kitchen door"


# ----------------------------------------------------------------- model
@pytest.fixture(scope="module", params=["navdp_async", "navdp"])
def n1_navdp(request):
    """The tiny N1 with a NavDP System-1 on both sides, same weights."""
    cfg = f32_config(request.param)
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, cfg, seed=2)
    tcfg = InternVLAN1Config.tiny(request.param, dtype=torch.float32)
    return jm, params, load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)


def test_generate_traj_navdp_batched_matches_jax(n1_navdp):
    """Two streams x 4 samples through the model's batched NavDP with JAX's
    x_init and step noises; the single-stream form equals its first row
    block."""
    jm, params, tm = n1_navdp
    r = np.random.default_rng(9)
    B, ns = 2, 4
    lat = r.standard_normal((B, 2, 64)).astype(np.float32)
    rgb, depth = rgbd(10, B)
    im = rgb.astype(np.float32) / 255.0
    x0, zs = jax_noise_pair(jax.random.PRNGKey(11), B * ns)
    ref = jax.jit(lambda p, lat, im, de, x, z: jm.apply(
        {"params": p}, method=lambda m: m.generate_traj_navdp_batched(
            lat, im, de, rng=jax.random.PRNGKey(0), sample_num=ns, x_init=x, step_noises=z)))(
        params, *(jnp.asarray(a) for a in (lat, im, depth, x0, zs)))
    with torch.no_grad():
        out = tm.generate_traj_navdp_batched(_t(lat), _t(im), _t(depth), x_init=_t(x0),
                                             step_noises=_t(zs), sample_num=ns)
        one = tm.generate_traj_navdp(_t(lat), _t(im), _t(depth), x_init=_t(x0[:ns]),
                                     step_noises=_t(zs[:, :ns]))
    _close(out, ref)
    _close(one, out[:ns])


# ----------------------------------------------------------------- slice
@pytest.fixture(scope="module")
def policies():
    cfg = f32_config("navdp_async")
    jm = jmodel.InternVLAN1Model(cfg)
    params = n1_params(jm, cfg, seed=1)
    tcfg = InternVLAN1Config.tiny("navdp_async", dtype=torch.float32)
    tm = load_from_jax(tpolicy.build_model(tcfg, device="cpu"), params)
    return JPolicy(jm, params, cfg), tpolicy.InternVLAN1Policy(tm)


def test_navdp_slice_matches_jax(policies):
    """s2_step → s1_step_latent on both policies: the greedy tokens
    exactly, the latent at 1e-4, then the NavDP System-1 on the latent
    with the RGBD pair; the port is handed the draws the JAX policy makes
    from its key (x_init, then the step noise from fold_in(key, 1))."""
    jpol, tpol = policies
    jpol.reset()
    tpol.reset()
    frame = np.random.default_rng(12).integers(0, 256, (HW, HW, 3)).astype(np.uint8)
    jout = jpol.s2_step(frame, INSTRUCTION, max_new_tokens=8)
    tout = tpol.s2_step(frame, INSTRUCTION, max_new_tokens=8)
    np.testing.assert_array_equal(tpol.last_gen_tokens, jpol.last_gen_tokens)
    assert jout.output_latent is not None and tout.output_latent is not None
    _close(tout.output_latent.numpy(), jout.output_latent)
    rgb, depth = rgbd(13, 1)
    _, sub = jax.random.split(jpol._rng)
    x0, zs = jax_noise_pair(sub, 32)
    j1 = jpol.s1_step_latent(rgb, depth, jout.output_latent)
    t1 = tpol.s1_step_latent(rgb, depth, tout.output_latent, x_init=_t(x0), step_noises=_t(zs))
    assert t1.trajectory.shape == (32, 8, 3)
    _close(t1.trajectory, j1.trajectory)
    assert t1.idx == j1.idx and len(t1.idx) > 0


def test_navdp_policy_draws_x_init_then_step_noise(policies):
    """Without injected noise the policy draws x_init, then the step noise,
    from its generator (the policy's seed); navdp_async without depth
    raises, as the JAX policy fails there."""
    _, tpol = policies
    tpol.reset()
    rgb, depth = rgbd(14, 1)
    lat = torch.from_numpy(np.random.default_rng(15).standard_normal((1, 2, 64)).astype(
        np.float32))
    got = tpol.s1_step_latent(rgb, depth, lat, num_sample_trajs=4)
    g = torch.Generator().manual_seed(tpol.seed)
    x0 = torch.randn((4, 8, 3), generator=g)
    zs = torch.randn((STEPS, 4, 8, 3), generator=g)
    want = tpol.s1_step_latent(rgb, depth, lat, num_sample_trajs=4, x_init=x0, step_noises=zs)
    np.testing.assert_array_equal(got.trajectory, want.trajectory)
    with pytest.raises(ValueError, match="needs depth"):
        tpol.s1_step_latent(rgb, None, lat)


# ------------------------------------------------------- save / load, refusals
def test_native_round_trip_keeps_the_navdp_head(policies, tmp_path):
    """save_pretrained records system1; from_pretrained gives every tensor
    back, and a config asking for another System-1 is refused."""
    _, tpol = policies
    tpol.save_pretrained(str(tmp_path / "native"))
    info = json.loads((tmp_path / "native" / "config.json").read_text())
    assert info["system1"] == "navdp_async"
    tcfg = InternVLAN1Config.tiny("navdp_async", dtype=torch.float32)
    back = tpolicy.InternVLAN1Policy.from_pretrained(str(tmp_path / "native"), tcfg, device="cpu")
    want = tpol.model.state_dict()
    got = back.model.state_dict()
    assert sorted(got) == sorted(want) and any(k.startswith("navdp.") for k in got)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0)
    with pytest.raises(ValueError, match="system1"):
        tpolicy.InternVLAN1Policy.from_pretrained(
            str(tmp_path / "native"), InternVLAN1Config.tiny("nextdit_async", dtype=torch.float32),
            device="cpu")


def test_reference_format_checkpoint_is_refused_for_navdp(tmp_path):
    """The reference-format converter maps no NavDP head: loading one for a
    NavDP config raises instead of leaving the head random."""
    from internnav_tpu_torch.model.weights.safetensors_io import write_safetensors

    path = tmp_path / "model.safetensors"
    write_safetensors(str(path), {"model.latent_queries": torch.zeros(1, 2, 64)})
    with pytest.raises(ValueError, match="NavDP head"):
        tpolicy.InternVLAN1Policy.from_pretrained_torch(
            str(path), InternVLAN1Config.tiny("navdp_async"), device="cpu")


@pytest.mark.parametrize("system1", ["navdp_async", "navdp"])
def test_launcher_builds_and_serves_navdp_on_the_cpu(system1, monkeypatch):
    """`realworld/serve.py --system1 navdp_async --device cpu` builds the
    NavDP policy (at the tiny config's widths) and its agent, which then
    acts on a frame with depth (and, for the sync head, without)."""
    from internnav_tpu_torch.realworld import serve

    served = []
    monkeypatch.setattr(serve.RealWorldServer, "run", lambda self: served.append(self))
    monkeypatch.setattr(InternVLAN1Config, "qwen25vl_7b",
                        classmethod(lambda cls, *a, **k: cls.tiny()))
    serve.main(["--system1", system1, "--device", "cpu", "--port", "0"])
    (server,) = served
    agent = server.agent
    assert agent.policy.cfg.system1 == system1
    assert agent.policy.device == torch.device("cpu")
    r = np.random.default_rng(16)
    obs = {"rgb": r.integers(0, 256, (HW, HW, 3)).astype(np.uint8), "instruction_text": "go"}
    if system1 == "navdp_async":
        obs["depth"] = r.uniform(0, 1, (HW, HW, 1)).astype(np.float32)
    try:
        for _ in range(2):
            out = agent.step([obs])[0]
            assert len(out["action"]) == 1
    finally:
        agent.close()
    assert agent.last_trajectory is not None and agent.last_trajectory.shape == (32, 8, 3)
    assert np.isfinite(agent.last_trajectory).all()
