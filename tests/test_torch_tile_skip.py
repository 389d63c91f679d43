"""Tile skipping of the flash kernels K1, K2 and K3, on the CPU.

`tile_segment_ranges` gives each 64-row tile [lo, hi] over its ids >= 0 and
[lo, hi] over its ids < 0; `live_tile_mask` keeps a (query tile, key tile)
pair when it is causally live and either range pair overlaps. K2 and K3
walk 64-row query tiles; K1 walks 128-row query blocks and keeps a key tile
live for either 64-row half (`query_block=FWD_QUERY_BLOCK`). The kernels
walk only live pairs, so the rule must never drop a pair that holds a
(q, k) the attention mask keeps: checked against `_attention_mask` (the
plain version's mask) over generated layouts, at both granularities.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke  # the repo root's smoke run: the packed row of its train phase
from internnav_tpu_torch.ops import flash_attention as fa

I32_MAX, I32_MIN = np.iinfo(np.int32).max, np.iinfo(np.int32).min


def _ranges_numpy(seg, block=64):
    B, T = seg.shape
    n = -(-T // block)
    out = np.empty((B, n, 4), np.int64)
    for b in range(B):
        for i in range(n):
            tile = seg[b, i * block:(i + 1) * block]
            pos, neg = tile[tile >= 0], tile[tile < 0]
            out[b, i] = (pos.min() if pos.size else I32_MAX, pos.max() if pos.size else I32_MIN,
                         neg.min() if neg.size else I32_MAX, neg.max() if neg.size else I32_MIN)
    return out


def _layout(kind, T, rng):
    if kind == "packed_pad_tail":  # monotone samples, then pads in segment -1
        lengths = rng.integers(20, 300, size=T)
        seg = np.repeat(np.arange(T), lengths)[:T]
        seg[T - int(rng.integers(1, 100)):] = -1
    elif kind == "interleaved":
        seg = (np.arange(T) // 7) % 3
    elif kind == "negatives":  # several negative ids among non-negative ones
        seg = rng.integers(-4, 3, size=T) * (np.arange(T) // 50 % 2)
        seg[rng.integers(0, T, size=T // 10)] = -7
    else:  # "random"
        seg = rng.integers(-2, 4, size=T)
    return seg.astype(np.int32)


def _dropped_pairs_hold_no_valid_key(tq, tk, causal, qseg, kseg, query_block=64):
    live = fa.live_tile_mask(tq, tk, causal=causal, segment_ids=qseg, kv_segment_ids=kseg,
                             query_block=query_block)
    q = torch.zeros((qseg.shape[0] if qseg is not None else 1, 1, tq, 1))
    k = torch.zeros((q.shape[0], 1, tk, 1))
    mask = fa._attention_mask(q, k, causal, qseg, kseg)
    mask = torch.ones((1, tq, tk), dtype=torch.bool) if mask is None else mask[:, 0]
    nq, nk = live.shape[1:]
    padded = torch.zeros((mask.shape[0], nq * query_block, nk * 64), dtype=torch.bool)
    padded[:, :tq, :tk] = mask
    any_valid = padded.view(-1, nq, query_block, nk, 64).any(dim=(2, 4))
    assert not (any_valid & ~live).any(), "a dropped tile pair holds a valid (q, k)"
    return live, any_valid


@pytest.mark.parametrize("kind", ["packed_pad_tail", "interleaved", "negatives", "random"])
@pytest.mark.parametrize("T", [1000, 64, 1, 200])
def test_tile_segment_ranges_matches_numpy(kind, T):
    seg = np.stack([_layout(kind, T, np.random.default_rng(s)) for s in (0, 1)])
    got = fa.tile_segment_ranges(torch.as_tensor(seg))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, -(-T // 64), 4)
    np.testing.assert_array_equal(got.numpy(), _ranges_numpy(seg))


@settings(max_examples=60, deadline=None)
@given(kinds=st.lists(st.sampled_from(["packed_pad_tail", "interleaved", "negatives", "random"]),
                      min_size=1, max_size=2),
       tq=st.integers(1, 400), tk=st.integers(1, 400), causal=st.booleans(),
       seed=st.integers(0, 2**16))
def test_dropped_tile_pairs_are_fully_masked(kinds, tq, tk, causal, seed):
    """Any layout, ragged T, B = 1 or 2 with different layouts per row,
    non-causal Tq != Tk: a dropped pair has an all-False mask block."""
    rng = np.random.default_rng(seed)
    if causal:
        tk = tq
    qseg = torch.as_tensor(np.stack([_layout(kd, tq, rng) for kd in kinds]))
    kseg = qseg if tq == tk and rng.random() < 0.5 else torch.as_tensor(
        np.stack([_layout(kd, tk, rng) for kd in kinds]))
    _dropped_pairs_hold_no_valid_key(tq, tk, causal, qseg, kseg)


def test_pad_tail_gets_its_own_range():
    """The tile that mixes the last sample with its -1 pads keeps only the
    tiles of that sample and of the pads, not every tile in between."""
    T = 1024
    seg = np.repeat(np.arange(8), 128)[None].astype(np.int32)
    seg[:, T - 40:] = -1
    live, any_valid = _dropped_pairs_hold_no_valid_key(T, T, True, torch.as_tensor(seg), None)
    assert live.sum() == any_valid.sum() == 8 * 3  # each 128-token sample: 3 tile pairs


@pytest.mark.parametrize("causal,tq,tk", [(True, 1000, 1000), (True, 64, 64), (False, 300, 130)])
def test_without_segments_only_the_causal_rule_applies(causal, tq, tk):
    live = fa.live_tile_mask(tq, tk, causal=causal)
    nq, nk = -(-tq // 64), -(-tk // 64)
    want = torch.ones((nq, nk), dtype=torch.bool)
    assert torch.equal(live[0], want.tril() if causal else want)
    assert fa.live_tile_pairs(tq, tk, causal=causal) == int(want.tril().sum() if causal else nq * nk)
    _dropped_pairs_hold_no_valid_key(tq, tk, causal, None, None)


def test_causal_needs_equal_lengths():
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.live_tile_mask(100, 200, causal=True)


def test_train_rows_live_tiles(tmp_path):
    """The train phase's packed rows (chip_smoke.packed_row from the
    synthetic store): 419 of 8,256 causal tiles at T=8192, 96 of 528 at
    T=2048, and no dropped pair holds a valid (q, k)."""
    from internnav_tpu_torch.dataset.internvla_n1_dataset import write_synthetic_n1_dataset

    store = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=24, T=10,
                                       hw=chip_smoke.TRAIN_HW)
    for T, live, causal_tiles in ((8192, 419, 8256), (2048, 96, 528)):
        seg = torch.as_tensor(chip_smoke.packed_row(store, T)["segment_ids"])
        assert fa.live_tile_pairs(T, T, causal=True, segment_ids=seg) == live
        assert fa.live_tile_pairs(T, T, causal=True) == causal_tiles
        _dropped_pairs_hold_no_valid_key(T, T, True, seg, None)
        if T == 8192:  # the last tile mixes a sample with its pads
            tail = seg[0, -64:]
            assert (tail[-10:] == -1).all() and (tail >= 0).any()


@settings(max_examples=60, deadline=None)
@given(kinds=st.lists(st.sampled_from(["packed_pad_tail", "interleaved", "negatives", "random"]),
                      min_size=1, max_size=2),
       tq=st.integers(1, 400), tk=st.integers(1, 400), causal=st.booleans(),
       seed=st.integers(0, 2**16))
def test_dropped_k1_block_pairs_are_fully_masked(kinds, tq, tk, causal, seed):
    """K1's union rule (a 128-row block keeps a key tile live for either
    64-row half): a dropped (block, key tile) pair has an all-False mask
    block, and the block keeps exactly the union of its halves' tiles."""
    rng = np.random.default_rng(seed)
    if causal:
        tk = tq
    qseg = torch.as_tensor(np.stack([_layout(kd, tq, rng) for kd in kinds]))
    kseg = qseg if tq == tk and rng.random() < 0.5 else torch.as_tensor(
        np.stack([_layout(kd, tk, rng) for kd in kinds]))
    live, _ = _dropped_pairs_hold_no_valid_key(tq, tk, causal, qseg, kseg,
                                               query_block=fa.FWD_QUERY_BLOCK)
    halves = fa.live_tile_mask(tq, tk, causal=causal, segment_ids=qseg, kv_segment_ids=kseg)
    for i in range(live.shape[1]):
        assert torch.equal(live[:, i], halves[:, 2 * i:2 * i + 2].any(dim=1))


def test_query_block_must_be_whole_tiles():
    with pytest.raises(ValueError, match="multiple of 64"):
        fa.live_tile_mask(100, 100, causal=True, query_block=96)


def test_train_rows_live_tiles_at_k1_blocks(tmp_path):
    """K1 on the train phase's packed rows: 269 (128-query, 64-key) pairs
    per head of 4,160 causal ones at T=8192 (the 419 live 64 x 64 pairs,
    grouped by two query tiles), 59 of 272 at T=2048; and the serving
    shapes' counts that chip_smoke.py reports."""
    from internnav_tpu_torch.dataset.internvla_n1_dataset import write_synthetic_n1_dataset
    from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_vision import vision_indices

    qb = fa.FWD_QUERY_BLOCK
    store = write_synthetic_n1_dataset(str(tmp_path / "store.bin"), n_episodes=24, T=10,
                                       hw=chip_smoke.TRAIN_HW)
    for T, live, causal_tiles in ((8192, 269, 4160), (2048, 59, 272)):
        seg = torch.as_tensor(chip_smoke.packed_row(store, T)["segment_ids"])
        assert fa.live_tile_pairs(T, T, causal=True, segment_ids=seg, query_block=qb) == live
        assert fa.live_tile_pairs(T, T, causal=True, query_block=qb) == causal_tiles
        _dropped_pairs_hold_no_valid_key(T, T, True, seg, None, query_block=qb)
    win = vision_indices((14, 2, 112), ((1, 30, 30),))["window_segments"]
    win = torch.as_tensor(np.asarray(win)[None], dtype=torch.int32)
    assert fa.live_tile_pairs(900, 900, causal=False, segment_ids=win) == 35
    assert fa.live_tile_pairs(900, 900, causal=False, segment_ids=win, query_block=qb) == 25
    assert fa.live_tile_pairs(900, 900, causal=False, query_block=qb) == 120
    _dropped_pairs_hold_no_valid_key(900, 900, False, win, None, query_block=qb)


def test_segment_tile_tables_share_one_table():
    seg = torch.as_tensor(_layout("packed_pad_tail", 300, np.random.default_rng(0))[None])
    q_tab, kv_tab = fa.segment_tile_tables(seg)
    assert kv_tab is q_tab and torch.equal(q_tab, fa.tile_segment_ranges(seg))
    q_tab, kv_tab = fa.segment_tile_tables(seg, seg[:, :200].clone())
    assert torch.equal(kv_tab, fa.tile_segment_ranges(seg[:, :200])) and kv_tab.shape[1] == 4
    assert fa.segment_tile_tables(None) is None
