"""The port's grouped decode and its decode loop (`decode_graph`), against
the port's per-group decode and the JAX package's `greedy_generate`.

Tiny text models (fp32, and the fp32 weights quantized to W8A8 with an
int8 KV cache) with the JAX init's weights; numpy prompts, two cache
groups of 2 and 1 rows with their own prompt lengths. The stop token is
one that row 0 emits mid-sequence, so that row stops early while the
others run on. Tolerances:
- tokens and lengths exactly equal everywhere;
- grouped against per-group in the port: int8 latents exactly equal (the
  products are integer sums, every other op is per row); fp32 latents at
  atol/rtol 1e-6, because the CPU's fp32 matrix product sums a row in an
  order that depends on the number of rows;
- against JAX: fp32 latents at 1e-4 (another summation order), int8
  latents at 2e-2 (F13, settled: the two frameworks' fp32 RMSNorms differ in
  the last bit, which flips an int8 activation code at a rounding tie).
JAX's grouped decode compiles slowly (its own test is `slow`), so the
JAX side runs `greedy_generate` per group.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu.model.basemodel.internvla_n1 import qwen_text as jqt
from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph
from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import (
    DecodeBuffers,
    StaticCaches,
)
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from test_torch_qwen import INT8, _prompt, _text_pair

torch.set_num_threads(2)
MAX_NEW, N_Q = 12, 2
GROUPS = ((2, 21, 1), (1, 17, 2))  # (rows, prompt length, seed) of each group
FP32_GROUPED_TOL = 1e-6
JAX_TOL = 1e-4
INT8_LATENT_TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    jm, params, tm = _text_pair()
    qparams = jqt.quantize_qwen_text_params(jax.tree_util.tree_map(np.asarray, params))
    jm8 = jqt.QwenTextModel(dataclasses.replace(jqt.QwenTextConfig.tiny(), dtype=jnp.float32,
                                                **INT8))
    tm8 = qt.QwenTextModel(dataclasses.replace(qt.QwenTextConfig.tiny(), dtype=torch.float32,
                                               **INT8))
    load_from_jax(tm8, qparams)
    return {"fp32": (jm, params, tm), "int8": (jm8, qparams, tm8)}


def _groups(seed_offset=0):
    out = []
    for rows, P, seed in GROUPS:
        emb, pos, seg, plen, deltas = _prompt(512, B=rows, P=P, seed=seed + seed_offset)
        out.append(tuple(torch.from_numpy(np.array(a)) for a in (emb, pos, seg, plen, deltas)))
    return out


def _queries():
    return torch.from_numpy(np.random.default_rng(9).standard_normal((1, N_Q, 64))
                            .astype(np.float32))


def _latent_pos(plen, deltas, lengths):
    B = plen.shape[0]
    return ((plen + deltas + lengths)[None, :, None] + torch.arange(N_Q)).expand(3, B, N_Q)


@torch.no_grad()
def _per_group(tm, groups, eos, buffers=None):
    """Each group alone: `greedy_generate`, then the latent chunk; with
    `buffers`, as a server runs it: a cache set acquired from the pool,
    the prefill into it, a one-group decode loop of the pool, the latent
    chunk, the set released."""
    out = []
    for emb, pos, seg, plen, deltas in groups:
        if buffers is None:
            tok, ln, caches = qt.greedy_generate(
                tm, emb, pos, rope_deltas=deltas.long(), prompt_lengths=plen.long(),
                segment_ids=seg, max_new_tokens=MAX_NEW, eos_token_ids=eos,
                extra_cache_slots=N_Q)
        else:
            static = buffers.acquire(tm.cfg, emb.shape[0], emb.shape[1] + MAX_NEW + N_Q, "cpu")
            logits, _, _ = tm(emb, pos, segment_ids=seg, logits_indices=plen.long() - 1,
                              caches_out=static.entries)
            tok, ln = qt.greedy_decode_grouped(
                tm, logits[:, 0].argmax(-1), [static], prompt_lengths=plen.long(),
                rope_deltas=deltas.long(), max_new_tokens=MAX_NEW, eos_token_ids=eos,
                buffers=buffers)
            caches = static.entries
        q = _queries().expand(plen.shape[0], N_Q, 64)
        lat, _ = tm.decode_chunk(q, _latent_pos(plen.long(), deltas.long(), ln), caches,
                                 plen.long() + ln)
        if buffers is not None:
            buffers.release(static)
        out.append((tok, ln, lat))
    return out


@torch.no_grad()
def _grouped(tm, groups, eos):
    """Every group prefilled into its own static caches, then one grouped
    decode loop and one grouped latent chunk."""
    statics, firsts = [], []
    for emb, pos, seg, plen, _ in groups:
        caches = StaticCaches(tm.cfg, emb.shape[0], emb.shape[1] + MAX_NEW + N_Q, "cpu")
        logits, _, _ = tm(emb, pos, segment_ids=seg, logits_indices=plen.long() - 1,
                          caches_out=caches.entries)
        statics.append(caches)
        firsts.append(logits[:, 0].argmax(-1))
    plen = torch.cat([g[3] for g in groups]).long()
    deltas = torch.cat([g[4] for g in groups]).long()
    tok, ln = qt.greedy_decode_grouped(tm, torch.cat(firsts), statics, prompt_lengths=plen,
                                       rope_deltas=deltas, max_new_tokens=MAX_NEW,
                                       eos_token_ids=eos)
    start = plen + ln
    lens = [start[:GROUPS[0][0]], start[GROUPS[0][0]:]]
    q = _queries().expand(plen.shape[0], N_Q, 64)
    lat, _ = tm.decode_chunk_grouped(q, _latent_pos(plen, deltas, ln),
                                     [c.entries for c in statics], lens)
    return tok, ln, lat


def _split(x):
    r = GROUPS[0][0]
    return [x[:r], x[r:]]


def _early_eos(tm, groups):
    """A stop token row 0 of group 0 emits at step 3."""
    return (int(_per_group(tm, groups, (511,))[0][0][0, 3]),)


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_grouped_decode_equals_per_group_generate(models, fmt):
    _, _, tm = models[fmt]
    groups = _groups()
    eos = _early_eos(tm, groups)
    ref = _per_group(tm, groups, eos)
    tok, ln, lat = _grouped(tm, groups, eos)
    assert int(ln[0]) == 3 and int(ln.max()) > 3  # row 0 stops early, others run on
    for (rt, rl, rlat), t, l, la in zip(ref, _split(tok), _split(ln), _split(lat)):
        np.testing.assert_array_equal(t.numpy(), rt.numpy())
        np.testing.assert_array_equal(l.numpy(), rl.numpy())
        if fmt == "int8":
            np.testing.assert_array_equal(la.numpy(), rlat.numpy())
        else:
            np.testing.assert_allclose(la.numpy(), rlat.numpy(), atol=FP32_GROUPED_TOL,
                                       rtol=FP32_GROUPED_TOL)


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_grouped_decode_matches_jax_per_group(models, fmt):
    jm, params, tm = models[fmt]
    groups = _groups()
    eos = _early_eos(tm, groups)
    tok, ln, lat = _grouped(tm, groups, eos)
    q = np.asarray(_queries())
    for g, t, l, la in zip(groups, _split(tok), _split(ln), _split(lat)):
        emb, pos, seg, plen, deltas = (np.asarray(a) for a in g)
        jtok, jlen, jc = jqt.greedy_generate(
            jm, params, jnp.asarray(emb), jnp.asarray(pos), max_new_tokens=MAX_NEW,
            eos_token_ids=eos, rope_deltas=jnp.asarray(deltas), prompt_lengths=jnp.asarray(plen),
            segment_ids=jnp.asarray(seg), return_caches=True, extra_cache_slots=N_Q)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(l.numpy(), np.asarray(jlen))
        B = plen.shape[0]
        jpos = np.asarray(_latent_pos(torch.from_numpy(plen).long(),
                                      torch.from_numpy(deltas).long(), l))
        jlat, _ = jm.apply({"params": params}, jnp.asarray(np.broadcast_to(q, (B, N_Q, 64))),
                           jnp.asarray(jpos), jc, jnp.asarray(plen) + jlen,
                           method=jm.decode_chunk)
        tol = INT8_LATENT_TOL if fmt == "int8" else JAX_TOL
        np.testing.assert_allclose(la.numpy(), np.asarray(jlat), atol=tol, rtol=tol)


def test_chunked_done_check_equals_per_token_check(models, monkeypatch):
    """Every row stops by step 2: with one step a chunk the loop ends after
    step 2, with DECODE_CHUNK steps a chunk it runs on to the chunk's end.
    The steps past all-done change no token, length or latent."""
    _, _, tm = models["int8"]
    groups = _groups()
    first = _per_group(tm, groups, (511,))
    eos = tuple(sorted({int(t[r, 2]) for t, _, _ in first for r in range(t.shape[0])}))
    results = {}
    for chunk in (1, decode_graph.DECODE_CHUNK):
        monkeypatch.setattr(decode_graph, "DECODE_CHUNK", chunk)
        decode_graph.reset_stats()
        results[chunk] = _grouped(tm, groups, eos)
        results[chunk] += (decode_graph.stats["steps"],)
    one, many = results[1], results[decode_graph.DECODE_CHUNK]
    assert int(one[1].max()) <= 2
    assert one[3] == int(one[1].max()) + 1 and many[3] == decode_graph.DECODE_CHUNK
    for a, b in zip(one[:3], many[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_static_caches_are_reused_across_requests(models):
    """One owner's caches and loop serve request after request: a request
    decoded on the caches of an earlier one (their stale slots included)
    equals the same request on fresh caches."""
    _, _, tm = models["int8"]
    groups = _groups()
    eos = (511,)
    buffers = DecodeBuffers()
    _per_group(tm, _groups(seed_offset=10), eos, buffers)  # other prompts fill the slots
    reused = _per_group(tm, groups, eos, buffers)
    assert sum(len(sets) for sets in buffers._sets.values()) == 2  # one set a shape
    for (t0, l0, a0), (t1, l1, a1) in zip(_per_group(tm, groups, eos), reused):
        np.testing.assert_array_equal(t1.numpy(), t0.numpy())
        np.testing.assert_array_equal(l1.numpy(), l0.numpy())
        np.testing.assert_array_equal(a1.numpy(), a0.numpy())


def test_cache_pool_hands_out_sets_by_shape(models):
    """Sets of one shape go out in the order they were made, a set in use
    is never handed out twice, and a layout that recurs (whoever acquires
    its sets) finds the loop made over them before. Past MAX_CACHES the
    least recently used free set goes, with its loops; sets in use stay."""
    _, _, tm = models["int8"]
    buffers = DecodeBuffers()
    a, b = (buffers.acquire(tm.cfg, 2, 40, "cpu") for _ in range(2))
    assert a is not b
    loop = buffers.loop(tm, [a, b], MAX_NEW, (511,))
    for c in (a, b):
        buffers.release(c)
    again = [buffers.acquire(tm.cfg, 2, 40, "cpu") for _ in range(2)]
    assert again[0] is a and again[1] is b
    assert buffers.loop(tm, again, MAX_NEW, (511,)) is loop
    other = buffers.acquire(tm.cfg, 1, 40, "cpu")
    assert other is not a and other is not b
    buffers.release(a)
    for c in (b, other):
        buffers.release(c)
    limit = decode_graph.MAX_CACHES
    held = [buffers.acquire(tm.cfg, 3, 40, "cpu") for _ in range(limit)]
    kept = [c for sets in buffers._sets.values() for c in sets]
    assert len(kept) == limit and all(any(c is h for c in kept) for h in held)
    assert not buffers._loops  # a and b went, and the loop over them
    held.append(buffers.acquire(tm.cfg, 3, 40, "cpu"))  # every set in use: one more
    assert sum(len(sets) for sets in buffers._sets.values()) == limit + 1


def test_one_token_budget_equals_per_group_generate(models, monkeypatch):
    """A budget of one token: the loop runs its one step without the
    lm_head, and the grouped decode still equals each group alone."""
    _, _, tm = models["int8"]
    monkeypatch.setattr(sys.modules[__name__], "MAX_NEW", 1)
    groups = _groups()
    ref = _per_group(tm, groups, (511,))
    tok, ln, lat = _grouped(tm, groups, (511,))
    assert tok.shape == (3, 1)
    for (rt, rl, rlat), t, l, la in zip(ref, _split(tok), _split(ln), _split(lat)):
        np.testing.assert_array_equal(t.numpy(), rt.numpy())
        np.testing.assert_array_equal(l.numpy(), rl.numpy())
        np.testing.assert_array_equal(la.numpy(), rlat.numpy())
