"""The port's LMDB data path against the JAX package's on the CPU:

- files written by either package's `LMDBWriter` read by the other's
  `LMDBReader`, with inline and overflow values and trees of one or many
  leaves (a branch page), the files byte-equal;
- the msgpack-numpy codec across the packages (the port's pure-Python
  msgpack against msgpack-python: equal bytes, and each decodes the
  other's);
- `LmdbTrajectoryReader` over a reference-style trajectory LMDB, and
  `lmdb_to_store` of both packages (the JAX script in a subprocess, the
  port's main in this process) giving equal trajectory stores.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from internnav_tpu.dataset import lmdb_reader as jlmdb
from internnav_tpu_torch.dataset import lmdb_reader as tlmdb
from internnav_tpu_torch.dataset.traj_store import TrajStore

REPO = Path(__file__).resolve().parents[1]


def _items(n, big_every=0, seed=0):
    rs = np.random.RandomState(seed)
    out = {}
    for i in range(n):
        size = 9000 if big_every and i % big_every == 0 else rs.randint(1, 300)
        out[f"key{i:05d}".encode()] = rs.bytes(size)
    return out


@pytest.mark.parametrize("n,big_every", [(0, 0), (3, 0), (5, 2), (400, 0), (300, 7)],
                         ids=["empty", "one-leaf", "overflow", "multi-leaf", "multi-leaf-overflow"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lmdb_files_cross_read(tmp_path, n, big_every, writer):
    kv = _items(n, big_every)
    paths = {}
    for name, mod in (("jax", jlmdb), ("port", tlmdb)):
        with mod.LMDBWriter(str(tmp_path / name)) as w:
            for k in reversed(list(kv)):
                w.put(k, kv[k])
        paths[name] = tmp_path / name / "data.mdb"
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    src = str(tmp_path / writer)
    for reader in (jlmdb.LMDBReader(src), tlmdb.LMDBReader(src), tlmdb.open_lmdb(src)):
        assert len(reader) == n
        assert dict(reader.items()) == kv
        assert reader.keys() == sorted(kv)
    if n:
        k = sorted(kv)[n // 2]
        assert tlmdb.LMDBReader(src).get(k) == kv[k] == jlmdb.LMDBReader(src).get(k)
        assert tlmdb.LMDBReader(src).get(b"absent") is None
    if n >= 300:  # a branch page over many leaves
        buf = paths[writer].read_bytes()
        assert tlmdb.LMDBReader(src)._page(tlmdb.LMDBReader(src)._root)[1] & tlmdb.P_BRANCH
        assert len(buf) // 4096 > 10


def _records(seed=0):
    rs = np.random.RandomState(seed)
    return [
        {"rgb": rs.randint(0, 255, (3, 8, 8, 3)).astype(np.uint8),
         "depth": rs.rand(3, 8, 8).astype(np.float32), "stuck": np.int32(1),
         "progress": np.float64(0.5), "n": 7, "neg": [-1, -33, -200, -70000, -2 ** 40],
         "big": [200, 70000, 2 ** 40, 2 ** 63], "f": 1.25, "none": None, "flags": [True, False],
         "text": "go to the kitchen " * 3, "bytes": b"\x00\xff" * 40, "nested": {"a": [1, {"b": 2}]},
         5: "int key", b"raw": np.arange(4, dtype=np.int64)},
        list(range(20)), {i: i for i in range(17)}, "y" * 300, b"z" * 70000,
        (1, 2.5, "t"), np.zeros((0, 3), np.float32), np.float16(3.5),
    ]


@pytest.mark.parametrize("i", range(8))
def test_codec_equals_msgpack_numpy(i):
    obj = _records()[i]
    data = jlmdb.packb(obj)
    assert tlmdb.packb(obj) == data
    for got in (tlmdb.unpackb(data), jlmdb.unpackb(tlmdb.packb(obj))):
        want = jlmdb.unpackb(data)
        assert repr(got) == repr(want)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape


def test_trajectory_reader_and_lmdb_to_store_equal_jax(tmp_path):
    import importlib.util

    rs = np.random.RandomState(3)
    trajs = {}
    with tlmdb.LMDBWriter(str(tmp_path / "lmdb")) as w:
        for i in range(5):
            t = int(rs.randint(6, 12))
            ep = {"rgb": rs.randint(0, 255, (t, 16, 16, 3)).astype(np.uint8),
                  "depth": rs.rand(t, 16, 16).astype(np.float32),
                  "instruction": rs.randint(2, 900, int(rs.randint(5, 20))).astype(np.int32),
                  "actions": rs.randint(0, 4, t).astype(np.int32),
                  "progress": np.linspace(0, 1, t).astype(np.float32), "stuck": np.int32(i % 2)}
            trajs[f"path_{i}"] = ep
            # the reference wraps some records in "episode_data"
            w.put(f"path_{i}", tlmdb.packb({"episode_data": ep} if i % 2 else ep))
    src = str(tmp_path / "lmdb")
    treader, jreader = tlmdb.LmdbTrajectoryReader(src), jlmdb.LmdbTrajectoryReader(src)
    assert treader.keys() == jreader.keys() == sorted(trajs) and len(treader) == 5
    for key in trajs:
        got, want = treader[key], jreader[key]
        assert sorted(got) == sorted(want)
        for k in want:
            g, x = got[k], want[k]
            if isinstance(x, dict):
                assert all(np.array_equal(g[f], x[f]) for f in x)
            else:
                assert np.array_equal(g, x)
    with pytest.raises(KeyError):
        treader["absent"]

    proc = subprocess.run([sys.executable, "scripts/dataset_converters/lmdb_to_store.py",
                           "--lmdb", src, "--out", str(tmp_path / "jax.bin")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    spec = importlib.util.spec_from_file_location("port_l2s", REPO / "scripts/torch/lmdb_to_store.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    assert cli.main(["--lmdb", src, "--out", str(tmp_path / "port.bin")]) == 5
    assert cli.main(["--lmdb", src, "--out", str(tmp_path / "two.bin"), "--limit", "2"]) == 2
    jstore, tstore = TrajStore(str(tmp_path / "jax.bin"), False), TrajStore(str(tmp_path / "port.bin"), False)
    assert sorted(jstore.keys()) == sorted(tstore.keys()) == sorted(trajs)
    for key, ep in trajs.items():
        a, b = jstore.get_tree(key), tstore.get_tree(key)
        assert sorted(a) == sorted(b) == sorted(ep)
        for k in ep:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) and np.array_equal(b[k], ep[k])
