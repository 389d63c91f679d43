"""The unfused System-2 API of the port against the JAX package: the rotary
helpers (`apply_rope`, `get_rope_index_2`), `s2_step(fused=False)` and
`generate_latents`, on the tiny policies of tests/test_torch_slice.py (the
same numpy weights on both sides, `model/weights/from_jax`).

Tolerances: `apply_rope` at 1e-6 in fp32 and exactly in bf16 (the same
fp32 products, one rounding); the rope indices exactly. The unfused step
in `parity` (fp32): tokens and text exactly equal, latents at atol/rtol
1e-4 (another summation order), as the fused slice tests; in `realtime`
(W8A8 projections, int8 KV cache): tokens exactly equal, latents at 1e-4,
except that each re-prefill after the first step holds F13's activation
code on a rounding tie (ROADMAP §3 F13): those are held at the slice
tests' REALTIME_LATENT_TOL, and at 1e-4 with that one code rounded as
XLA rounds it. The port's fused
step against its unfused one: text equal, latents at atol 2e-2, rtol 1e-2
(JAX tests/test_internvla_n1.py:165-180; the fused latents come from a
chunk decode over the generation's cache, the unfused from a re-prefill).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from internnav_tpu.ops import rope as jrope
from internnav_tpu_torch.ops import quant, rope
from test_torch_slice import (  # noqa: F401
    INSTRUCTION,
    REALTIME_LATENT_TOL,
    _frames,
    policies,
    realtime_policies,
)

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
FUSED_ATOL, FUSED_RTOL = 2e-2, 1e-2
NEW_TOKENS = 12
IMG, VID, VSTART, VEND = 151655, 151656, 151652, 151653


@pytest.mark.parametrize("cos_rank", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_rope_matches_jax(cos_rank, dtype):
    r = np.random.default_rng(cos_rank)
    q = r.standard_normal((2, 4, 7, 16)).astype(np.float32)
    k = r.standard_normal((2, 2, 7, 16)).astype(np.float32)
    pos = r.integers(0, 500, (2, 7) if cos_rank == 3 else (7,))
    cos, sin = (np.asarray(t) for t in jrope.rope_cos_sin(jnp.asarray(pos), 16))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk = jrope.apply_rope(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(cos),
                              jnp.asarray(sin))
    tq, tk = rope.apply_rope(torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
                             torch.from_numpy(cos), torch.from_numpy(sin))
    assert tq.dtype == tk.dtype == dtype
    tol = 0 if dtype == torch.bfloat16 else 1e-6
    for ours, ref in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


def test_get_rope_index_2_matches_jax_with_images_and_videos():
    """Two rows: an image then a two-frame video, and a video alone; the
    second row left-padded under an attention mask."""
    row0 = ([1, 2, VSTART] + [IMG] * 16 + [VEND, 7, VSTART] + [VID] * 8 + [VEND, 9])
    row1 = [0] * 9 + [3, VSTART] + [VID] * 18 + [VEND, 4, 5]
    assert len(row0) == len(row1) == 32
    ids = np.asarray([row0, row1])
    mask = np.ones_like(ids)
    mask[1, :9] = 0
    image_grid = np.asarray([[1, 8, 8]])
    video_grid = np.asarray([[2, 4, 4], [2, 6, 6]])  # in reading order: row 0's, row 1's
    ours = rope.get_rope_index_2(ids, image_grid, video_grid, attention_mask=mask)
    ref = jrope.get_rope_index_2(ids, image_grid, video_grid, attention_mask=mask)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    # video time advances one index a temporal grid (no seconds-per-grid scaling)
    pos = ours[0]
    vid = np.flatnonzero(ids[0] == VID)
    assert sorted(set(pos[0, 0, vid] - pos[0, 0, vid].min())) == [0, 1]


def _steps(pol, fused, n=2, look_down=False):
    """n System-2 steps of `pol` on the same frames from a reset (the
    second with a history frame), then with look_down a look-down frame;
    per step (generated tokens, text, latents or None, pixel)."""
    pol.reset()
    frames = _frames(n + 1)
    outs = []
    for i in range(n + look_down):
        out = pol.s2_step(frames[i], INSTRUCTION, look_down=i == n, max_new_tokens=NEW_TOKENS,
                          fused=fused)
        lat = out.output_latent
        outs.append((np.asarray(pol.last_gen_tokens), pol.llm_output,
                     None if lat is None else np.asarray(lat, np.float32), out.output_pixel))
    return outs


@pytest.mark.parametrize("profile", ["parity", "realtime"])
def test_unfused_s2_step_matches_jax(profile, request):
    """Two steps and a look-down step through both unfused paths: tokens and
    text exactly equal, the same pixel goal, latents within 1e-4, except in
    `realtime` the steps after the first, held at the slice tests'
    REALTIME_LATENT_TOL: their re-prefills hold F13's activation code on a
    rounding tie (`test_realtime_unfused_gap_is_the_f13_tie`)."""
    jpol, tpol = request.getfixturevalue(
        "policies" if profile == "parity" else "realtime_policies")
    steps = zip(_steps(tpol, False, look_down=True), _steps(jpol, False, look_down=True))
    for i, ((tg, tt, tl, tp), (jg, jt, jl, jp)) in enumerate(steps):
        np.testing.assert_array_equal(tg, jg)
        assert tt == jt
        assert jl is not None and tl is not None
        tol = REALTIME_LATENT_TOL if profile == "realtime" and i else ATOL
        np.testing.assert_allclose(tl, jl, atol=tol, rtol=tol)
        np.testing.assert_array_equal(tp, jp)
    assert len(tpol.input_images) == 3


def test_realtime_unfused_gap_is_the_f13_tie(realtime_policies):  # noqa: F811
    """Each realtime re-prefill quantizes exactly one activation on an exact
    tie (x / a_scale = k + 0.5): F13's code, token 19 element 26 of layer
    1's normed rows, which XLA's last bits put on the other side. Rounded
    to the other neighbour there, the port's latents of every step agree
    with the JAX policy's at 1e-4: the realtime gap of the test above is
    that one code."""
    jpol, tpol = realtime_policies
    ref = _steps(jpol, False, look_down=True)
    plain, ties = quant.quantize_rows, []

    def other_side_of_ties(x):
        xf = x.float()
        scale = quant.div_qmax(xf.abs().amax(-1, keepdim=True).clamp(min=1e-8), 8)
        r = xf / scale
        codes = torch.round(r)
        tie = (r - torch.floor(r)) == 0.5
        ties[-1] += torch.nonzero(tie).tolist()
        codes = torch.where(tie, 2 * torch.floor(r) + 1 - codes, codes)
        return codes.clamp(-127, 127).to(torch.int8), scale

    def generate_latents(*args, **kwargs):
        ties.append([])
        quant.quantize_rows = other_side_of_ties
        try:
            return type(tpol).generate_latents(tpol, *args, **kwargs)
        finally:
            quant.quantize_rows = plain

    tpol.generate_latents = generate_latents
    try:
        ours = _steps(tpol, False, look_down=True)
    finally:
        del tpol.generate_latents
    assert ties == [[[0, 19, 26]]] * 3
    for (tg, _, tl, _), (jg, _, jl, _) in zip(ours, ref):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=RTOL)


def test_port_fused_matches_its_unfused_step(policies):  # noqa: F811
    _, tpol = policies
    for (fg, ft, fl, _), (ug, ut, ul, _) in zip(_steps(tpol, True), _steps(tpol, False)):
        np.testing.assert_array_equal(fg, ug)
        assert ft == ut
        np.testing.assert_allclose(fl, ul, atol=FUSED_ATOL, rtol=FUSED_RTOL)


@pytest.mark.parametrize("generated", [[], [5, 17, 9]])
def test_generate_latents_matches_jax(policies, generated):  # noqa: F811
    """Directly, on a two-frame prompt and its vision tokens, for a pad-free
    and a padded length: the query states within 1e-4."""
    jpol, tpol = policies
    images = _frames(2, seed=3)
    ids = tpol._build_prompt_ids(INSTRUCTION, 2, images.shape[1:3])
    np.testing.assert_array_equal(ids, jpol._build_prompt_ids(INSTRUCTION, 2, images.shape[1:3]))
    jtok, jgrid = jpol._encode_images(images)
    ttok, tgrid = tpol._encode_images(images)
    np.testing.assert_array_equal(tgrid, jgrid)
    gen = np.asarray(generated, np.int64)
    ref = np.asarray(jpol.generate_latents(ids, gen, jtok, jgrid))
    ours = tpol.generate_latents(ids, gen, ttok, tgrid)
    assert ours.shape == ref.shape == (1, tpol.cfg.n_query, tpol.cfg.text.hidden_size)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=RTOL)
