"""The port's data pipeline against the JAX package's, on the same store.

Everything here is host-side numpy: samples, token rows and packed batches
must be exactly equal, and a store written by either package must read
back equal through the other's reader (the JAX one through its native
library where it builds).
"""

import numpy as np
import pytest

from internnav_tpu.dataset import internvla_n1_dataset as jds
from internnav_tpu.dataset.navdp_dataset import resample_path as jresample_path
from internnav_tpu.dataset.traj_store import TrajStore as JTrajStore
from internnav_tpu.model.basemodel.internvla_n1.policy import SimpleTokenizer as JTokenizer
from internnav_tpu_torch.dataset import internvla_n1_dataset as tds
from internnav_tpu_torch.dataset.base import TrajectoryDataset, batch_iterator
from internnav_tpu_torch.dataset.traj_store import TrajStore
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import SimpleTokenizer

VOCAB, TPI, N_QUERY, PREDICT = 512, 1, 2, 8


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Written by the port's pure-Python writer."""
    path = str(tmp_path_factory.mktemp("n1") / "store.bin")
    return tds.write_synthetic_n1_dataset(path, n_episodes=4, T=8, hw=28, seed=3)


def test_port_store_reads_back_equal_through_the_jax_reader(store):
    ours, theirs = TrajStore(store, writable=False), JTrajStore(store, writable=False)
    assert ours.keys() == theirs.keys() and len(ours) == 4
    for key in ours.keys():
        _equal_trees(ours.get_tree(key), theirs.get_tree(key))


def test_jax_store_reads_back_equal_through_the_port_reader(tmp_path):
    path = jds.write_synthetic_n1_dataset(str(tmp_path / "j.bin"), n_episodes=3, T=7, hw=28,
                                          seed=5)
    theirs, ours = JTrajStore(path, writable=False), TrajStore(path, writable=False)
    assert ours.keys() == theirs.keys()
    for key in ours.keys():
        _equal_trees(ours.get_tree(key), theirs.get_tree(key))


def test_store_appends_after_the_valid_size_and_drops_a_torn_tail(tmp_path):
    path = str(tmp_path / "s.bin")
    s = TrajStore(path)
    s.put("a", b"1")
    s.put("b", b"22")
    s.put("a", b"333")  # last write wins, first position kept
    with open(path, "ab") as f:
        f.write(b"\x05\x00\x00\x00\xff\xff\x00\x00abc")  # torn record past .size
    r = TrajStore(path, writable=False)
    assert r.keys() == ["a", "b"] and r.get("a") == b"333" and r.get("b") == b"22"
    s2 = TrajStore(path)  # appends at the recorded size, over the torn bytes
    s2.put("c", b"4")
    assert TrajStore(path, writable=False).get("c") == b"4"
    assert JTrajStore(path, writable=False).get("c") == b"4"


def test_samples_rows_and_batches_equal_jax(store):
    ours = list(tds.N1SampleDataset(store, num_history=2, predict_step_nums=PREDICT))
    theirs = list(jds.N1SampleDataset(store, num_history=2, predict_step_nums=PREDICT))
    assert len(ours) == len(theirs) > 4
    assert any(s.has_traj for s in ours) and not all(s.has_traj for s in ours)
    for a, b in zip(ours, theirs):
        assert (a.prompt, a.answer, a.has_traj) == (b.prompt, b.answer, b.has_traj)
        np.testing.assert_array_equal(a.images, b.images)
        if a.traj is None:
            assert b.traj is None
        else:
            np.testing.assert_array_equal(a.traj, b.traj)
    rows = [tds.tokenize_sample(s, SimpleTokenizer(VOCAB), tokens_per_image=TPI, n_query=N_QUERY)
            for s in ours]
    jrows = [jds.tokenize_sample(s, JTokenizer(VOCAB), tokens_per_image=TPI, n_query=N_QUERY)
             for s in theirs]
    for a, b in zip(rows, jrows):
        _equal_trees(a, b)
    for max_len in (64, 256):  # 64 stops packing early
        _equal_trees(tds.n1_packed_collate_fn(rows[:6], max_len=max_len, predict_step_nums=PREDICT),
                     jds.n1_packed_collate_fn(jrows[:6], max_len=max_len,
                                              predict_step_nums=PREDICT))
    _equal_trees(tds.n1_collate_fn(rows[:3], predict_step_nums=PREDICT),
                 jds.n1_collate_fn(jrows[:3], predict_step_nums=PREDICT))


def test_packed_pads_carry_segment_minus_one(store):
    rows = [tds.tokenize_sample(s, SimpleTokenizer(VOCAB), tokens_per_image=TPI,
                                n_query=N_QUERY)
            for s in tds.N1SampleDataset(store, num_history=2, predict_step_nums=PREDICT)][:2]
    batch = tds.n1_packed_collate_fn(rows, max_len=512, predict_step_nums=PREDICT)
    n = sum(len(r["input_ids"]) for r in rows)
    assert batch["segment_ids"].dtype == np.int32 and batch["num_packed"] == 2
    assert (batch["segment_ids"][0, n:] == -1).all() and (batch["labels"][0, n:] == -100).all()


def test_episode_iteration_and_batching(store):
    ds = TrajectoryDataset(store, rank=1, world_size=2, shuffle_block=1, seed=2)
    keys = [t["__key__"] for t in ds]
    assert sorted(keys) == ["ep0001", "ep0003"]
    batches = list(batch_iterator(range(5), 2, list, drop_last=False))
    assert batches == [[0, 1], [2, 3], [4]]


def test_resample_path_equals_jax():
    pts = np.random.default_rng(0).standard_normal((7, 2)).cumsum(0)
    for n in (2, 9, 33):
        np.testing.assert_array_equal(tds.resample_path(pts, n), jresample_path(pts, n))
    np.testing.assert_array_equal(tds.resample_path(pts[:1], 4), jresample_path(pts[:1], 4))
