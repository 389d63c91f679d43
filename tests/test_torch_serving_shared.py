"""`PipelinedN1Server.serve_stream` with the shared grouped decode
(`shared_decode=True`: every cohort's prefill, then one grouped decode
and latent chunk) and the shared System-1 (`shared_s1=True`: one grouped
denoise a micro-step), port against the JAX package's shared stream and
against the port's own per-cohort stream.

Two cohorts of two slots over two cycles, tiny fp32 weights on both sides
(see test_torch_serving_batched), the port's cohorts handed the JAX
cohorts' noise draws. Tolerances: decoded text exactly equal everywhere;
against JAX, latents and trajectories at atol/rtol 1e-4 (fp32, another
summation order); port shared against port per-cohort, latents and
trajectories at 1e-5: the stacked rows go through fp32 matrix products
whose CPU summation order depends on the number of rows (the tokens and
texts are exact).
"""

import numpy as np
import pytest
import torch

import jax

from internnav_tpu.model.basemodel.internvla_n1 import serving as jserving
from internnav_tpu_torch.model.basemodel.internvla_n1 import serving as tserving
from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import DecodeBuffers
from test_torch_serving_batched import (  # noqa: F401  (fp32_jax_nextdit: an autouse fixture)
    INSTR,
    build_pair,
    fp32_jax_nextdit,
    frames,
    jax_noise,
)

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
SHARED_TOL = 1e-5
CYCLES = 2


@pytest.fixture(scope="module")
def pair(fp32_jax_nextdit):
    return build_pair()


def _frames():
    f = frames(77, 6)
    return {(ci, t, ph): np.stack([f[(2 * t + ci + ph) % 6], f[(2 * t + ci + ph + 1) % 6]])
            for ci in range(2) for t in range(CYCLES) for ph in range(3)}


def _stream(server, cohorts, shared_decode, shared_s1, set_key):
    """Run CYCLES cycles; per (cohort, cycle): texts, latents, trajectories."""
    fr = _frames()
    got = {}

    def on_cycle(ci, t, s2out, s1res):
        got[(ci, t)] = ([s.llm_output for s in cohorts[ci].slots],
                        [np.asarray(o.output_latent) for o in s2out],
                        [np.asarray(o.trajectory) for call in s1res for o in call])

    for ci, pol in enumerate(cohorts):
        pol.reset(INSTR[ci:ci + 2])
        set_key(pol, jax.random.PRNGKey(500 + ci))
    server.serve_stream(lambda ci, t, ph: fr[(ci, t, ph)], CYCLES, max_new_tokens=5,
                        num_sample_trajs=2, s1_calls=2, on_cycle=on_cycle,
                        shared_decode=shared_decode, shared_s1=shared_s1)
    return got


def _port(tpol, shared_decode, shared_s1):
    server = tserving.PipelinedN1Server(tpol, batch_size=2, cohorts=2)

    def set_key(pol, key):
        pol.noise_fn = jax_noise(key)

    return _stream(server, server.cohorts, shared_decode, shared_s1, set_key)


def _jax(jpol, shared_decode, shared_s1):
    server = jserving.PipelinedN1Server(jpol.model, jpol.params, jpol.cfg, batch_size=2,
                                        cohorts=2, tokenizer=jpol.tokenizer)
    server.inner = jpol  # share the compiled programs
    for pol in server.cohorts:
        pol.inner = jpol

    def set_key(pol, key):
        pol._rng = key

    return _stream(server, server.cohorts, shared_decode, shared_s1, set_key)


def _assert_close(got, ref, tol):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k][0] == ref[k][0], k
        for part in (1, 2):
            for a, b in zip(got[k][part], ref[k][part]):
                np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("shared_s1", [False, True])
def test_shared_decode_stream_matches_jax(pair, shared_s1):
    jpol, tpol = pair
    _assert_close(_port(tpol, True, shared_s1), _jax(jpol, True, shared_s1), ATOL)


@pytest.mark.parametrize("shared_s1", [False, True])
def test_shared_stream_matches_per_cohort_stream(pair, shared_s1):
    _, tpol = pair
    _assert_close(_port(tpol, True, shared_s1), _port(tpol, False, False), SHARED_TOL)


def _mixed_stream(tpol, shared_decode, swap):
    """Two cohorts of three slots at mixed history lengths over CYCLES
    cycles: one slot of cohort 0 and two of cohort 1 start with a history
    frame (`swap`: the other way round), so a prompt bucket holds groups of
    different sizes, the smaller one first in cohort order."""
    server = tserving.PipelinedN1Server(tpol, batch_size=3, cohorts=2)
    f = frames(91, 8)
    got = {}

    def on_cycle(ci, t, s2out, s1res):
        got[(ci, t)] = ([s.llm_output for s in server.cohorts[ci].slots],
                        [np.asarray(o.output_latent) for o in s2out],
                        [np.asarray(o.trajectory) for call in s1res for o in call])

    for ci, pol in enumerate(server.cohorts):
        pol.reset(INSTR)
        pol.noise_fn = jax_noise(jax.random.PRNGKey(700 + ci))
        for r in range(2 - ci if swap else 1 + ci):
            pol.slots[r].rgb_list = [f[6 + ci]]
            pol.slots[r].episode_idx = 1
    server.serve_stream(lambda ci, t, ph: f[[(3 * ci + t + ph + j) % 6 for j in range(3)]],
                        CYCLES, max_new_tokens=5, num_sample_trajs=2, s1_calls=2,
                        on_cycle=on_cycle, shared_decode=shared_decode)
    return got


def test_shared_decode_of_mixed_group_sizes_matches_per_cohort(pair):
    """Groups of different sizes in one prompt bucket go to the shared
    decode largest first; every row still equals the per-cohort decode's.
    With the sizes swapped between the cohorts, the decodes find the loops
    made before (a loop is keyed by its cache sets, which go out by
    shape)."""
    _, tpol = pair
    tpol.decode_buffers = DecodeBuffers()
    shared = _mixed_stream(tpol, True, swap=False)
    loops = len(tpol.decode_buffers._loops)
    swapped = _mixed_stream(tpol, True, swap=True)
    assert len(tpol.decode_buffers._loops) == loops
    _assert_close(shared, _mixed_stream(tpol, False, swap=False), SHARED_TOL)
    _assert_close(swapped, _mixed_stream(tpol, False, swap=True), SHARED_TOL)
