"""The launch plan the realtime profile's decode kernel receives, and the
plain versions it is held against, checked on the CPU (the kernels
themselves run only on the card, where `test_torch_kernels_cuda.py` checks
their splits of the work through their results).

- K4/K5 (`csrc/decode_int8.cu`) launch one thread-block cluster of
  `decode_cluster_size(Tmax)` blocks per (batch, KV head): the wrapper
  passes that size to the kernel, which splits the live keys among them.
- The plain decode references (K4/K5's ground truth on the card) equal
  JAX's `gqa_decode_attention` / `gqa_chunk_decode_attention` past the
  4,096 keys the earlier kernel refused, in fp32 within 1e-5.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from internnav_tpu.ops.flash_attention import (
    gqa_chunk_decode_attention as jax_chunk_decode,
    gqa_decode_attention as jax_decode,
)
from internnav_tpu_torch.ops import flash_attention as fa


@settings(max_examples=300, deadline=None)
@given(Tmax=st.integers(1, 32768))
def test_decode_cluster_size_is_a_legal_cluster(Tmax):
    """At most the non-portable cluster size, and no more blocks than
    64-key slices of the cache."""
    S = fa.decode_cluster_size(Tmax)
    assert 1 <= S <= fa.DECODE_MAX_CLUSTER and S <= -(-Tmax // fa.DECODE_KEYS_PER_BLOCK)
    assert S == fa.DECODE_MAX_CLUSTER or S == -(-Tmax // fa.DECODE_KEYS_PER_BLOCK)


@pytest.mark.parametrize("lengths,offset,n,Tmax,want", [
    ((1089,), 0, 1, 1220, [1089]),          # decode: cache_len + 1 keys
    ((1216,), 1, 4, 1220, [1220]),          # the latent chunk: cache_len + n, capped
    ((4761, 12), 1, 4, 4893, [4765, 16]),   # a ragged batch past 4,096 keys
])
def test_decode_live_keys(lengths, offset, n, Tmax, want):
    assert fa.decode_live_keys(lengths, offset, n, Tmax) == want


def test_decode_cluster_size_at_the_serving_caches():
    # the realtime caches: prompt + 128 new tokens + 4 latent queries
    assert [fa.decode_cluster_size(T) for T in (484, 1220, 4893, 8192)] == [8, 16, 16, 16]


def _int8_cache(rng, B, KV, Tmax, D=128):
    data = rng.integers(-127, 128, (B, KV, Tmax, D)).astype(np.int8)
    scale = rng.uniform(1e-3, 0.05, (B, KV, Tmax)).astype(np.float32)
    return data, scale


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("Tmax,lengths", [(4893, (4761,)), (8192, (8000, 4100))])
def test_plain_decode_references_match_jax_past_4096_keys(n, Tmax, lengths):
    rng = np.random.default_rng(Tmax + n)
    B, H, KV, D = len(lengths), 28, 4, 128
    (kd, ks), (vd, vs) = _int8_cache(rng, B, KV, Tmax), _int8_cache(rng, B, KV, Tmax)
    cache_len = np.asarray(lengths, np.int32)
    if n == 1:
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        want = jax_decode(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
                          jnp.asarray(cache_len + 1), k_scale=jnp.asarray(ks),
                          v_scale=jnp.asarray(vs))
        got = fa.gqa_decode_reference(torch.from_numpy(q), torch.from_numpy(kd),
                                      torch.from_numpy(vd), torch.from_numpy(cache_len + 1),
                                      k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        q = rng.standard_normal((B, H, n, D)).astype(np.float32)
        want = jax_chunk_decode(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
                                jnp.asarray(cache_len), k_scale=jnp.asarray(ks),
                                v_scale=jnp.asarray(vs))
        got = fa.gqa_chunk_decode_reference(torch.from_numpy(q), torch.from_numpy(kd),
                                            torch.from_numpy(vd), torch.from_numpy(cache_len),
                                            k_scale=torch.from_numpy(ks),
                                            v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
