"""The port's LeRobot reader (`dataset/lerobot.py`) and its dataset
converters (`scripts/torch/vlnce_to_store.py`, `store_to_lerobot.py`)
against the JAX package's on the CPU (pyarrow and cv2, both on the host
here; a missing one fails the tests, as it fails the module):

- a LeRobot directory written by the port's `LeRobotWriter` reads the same
  through both packages' `LerobotAsTrajStore` (parquet columns exactly,
  the mp4 frames as decoded), and the JAX writer's directory through the
  port's reader; the meta files of both writers are equal;
- the episode listing without `meta/episodes.jsonl` (parquet files found
  under data/) equals JAX's;
- `vlnce_to_store.py --lerobot` and `store_to_lerobot.py` as the JAX
  scripts: the same stores and the same LeRobot parquet tables and meta.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np

from internnav_tpu.dataset import lerobot as jlerobot
from internnav_tpu.dataset.traj_store import TrajStore as JTrajStore
from internnav_tpu_torch.dataset import lerobot as tlerobot
from internnav_tpu_torch.dataset.traj_store import TrajStore

REPO = Path(__file__).resolve().parents[1]


def script(path: str):
    spec = importlib.util.spec_from_file_location(
        "s_" + path.replace("/", "_").removesuffix(".py"), REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def episodes(seed=0, n=2):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        T = 6 + i
        out.append({"rgb": rs.randint(0, 255, (T, 32, 48, 3)).astype(np.uint8),
                    "actions": rs.randint(0, 4, (T,)).astype(np.int64),
                    "positions": rs.randn(T, 3).astype(np.float32),
                    "yaws": rs.randn(T).astype(np.float32),
                    "instruction_text": f"walk to the chair {i}"})
    return out


def same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def write(writer_cls, root, eps):
    w = writer_cls(str(root), fps=5)
    for ep in eps:
        w.add_episode(ep)
    w.finalize()


def test_lerobot_round_trip_equals_jax(tmp_path):
    eps = episodes()
    write(script("scripts/torch/store_to_lerobot.py").LeRobotWriter, tmp_path / "port", eps)
    write(script("scripts/dataset_converters/store_to_lerobot.py").LeRobotWriter,
          tmp_path / "jax", eps)
    for name in ("info.json", "tasks.jsonl", "episodes.jsonl", "episodes_stats.jsonl"):
        assert ((tmp_path / "port" / "meta" / name).read_text()
                == (tmp_path / "jax" / "meta" / name).read_text()), name
    for root in ("port", "jax"):
        t = tlerobot.LerobotAsTrajStore(str(tmp_path / root))
        j = jlerobot.LerobotAsTrajStore(str(tmp_path / root))
        assert t.keys() == j.keys() and len(t) == len(j) == 2
        assert t.get_tree("ep9999") is None and j.get_tree("ep9999") is None
        for i, key in enumerate(t.keys()):
            got = t.get_tree(key)
            same_tree(got, j.get_tree(key))
            np.testing.assert_array_equal(got["actions"], eps[i]["actions"])
            assert got["instruction_text"] == eps[i]["instruction_text"]
            assert got["rgb"].shape == eps[i]["rgb"].shape  # mp4 is lossy
    reader = tlerobot.LeRobotEpisodeReader(str(tmp_path / "port"))
    assert [e["episode_index"] for e in reader.episodes] == [0, 1]
    assert [sorted(x) for x in reader] == [sorted(x) for x in
                                           jlerobot.LeRobotEpisodeReader(str(tmp_path / "port"))]


def test_listing_without_episode_meta_equals_jax(tmp_path):
    write(script("scripts/torch/store_to_lerobot.py").LeRobotWriter, tmp_path / "lr",
          episodes(seed=1, n=3))
    (tmp_path / "lr" / "meta" / "episodes.jsonl").unlink()
    shutil.rmtree(tmp_path / "lr" / "videos")
    t = tlerobot.LeRobotEpisodeReader(str(tmp_path / "lr"))
    j = jlerobot.LeRobotEpisodeReader(str(tmp_path / "lr"))
    assert t.episodes == j.episodes and len(t) == 3
    for i in range(3):
        got = t.read(i)
        assert "rgb" not in got
        same_tree(got, j.read(i))
    assert tlerobot.decode_video(str(tmp_path / "missing.mp4")).shape == (0, 0, 0, 3)


def test_converter_scripts_equal_jax(tmp_path, monkeypatch):
    """A raw StreamVLN-style episode root (jpgs + meta.json, one episode
    with depth pngs) through both packages' vlnce_to_store.py --lerobot,
    then their stores through store_to_lerobot.py."""
    import cv2

    rs = np.random.RandomState(2)
    for e in range(2):
        raw = tmp_path / "raw" / f"ep{e}"
        (raw / "rgb").mkdir(parents=True)
        if e == 1:
            (raw / "depth").mkdir()
        for i in range(3):
            cv2.imwrite(str(raw / "rgb" / f"{i:06d}.jpg"),
                        rs.randint(0, 255, (16, 16, 3)).astype(np.uint8))
            if e == 1:
                cv2.imwrite(str(raw / "depth" / f"{i:06d}.png"),
                            rs.randint(100, 5000, (16, 16)).astype(np.uint16))
        (raw / "meta.json").write_text(json.dumps({
            "instruction": f"go {e}", "actions": [1, 1, 0], "instruction_tokens": [3, 4, 5],
            "positions": [[0, 0], [0.25, 0], [0.5, 0]], "yaws": [0, 0, 0.1]}))
    (tmp_path / "raw" / "broken").mkdir()  # no meta.json: skipped by both
    for side, path in (("port", "scripts/torch/vlnce_to_store.py"),
                       ("jax", "scripts/dataset_converters/vlnce_to_store.py")):
        monkeypatch.setattr(sys, "argv", [path, "--raw", str(tmp_path / "raw"), "--out",
                                          str(tmp_path / f"{side}.bin"), "--lerobot",
                                          str(tmp_path / f"{side}_lr")])
        script(path).main()
    t, j = TrajStore(str(tmp_path / "port.bin"), False), JTrajStore(str(tmp_path / "jax.bin"),
                                                                    False)
    assert sorted(t.keys()) == sorted(j.keys()) == ["ep0", "ep1"]
    for key in t.keys():
        same_tree(t.get_tree(key), j.get_tree(key))
    assert t.get_tree("ep1")["depth"].shape == (3, 16, 16)
    for side in ("port", "jax"):
        assert tlerobot.LerobotAsTrajStore(str(tmp_path / f"{side}_lr")).get_tree(
            "ep0001")["actions"].tolist() == [1, 1, 0]
    same_tree(tlerobot.read_episode_parquet(
        str(tmp_path / "port_lr" / "data" / "chunk-000" / "episode_000001.parquet")),
        jlerobot.read_episode_parquet(
            str(tmp_path / "jax_lr" / "data" / "chunk-000" / "episode_000001.parquet")))
    for side, path in (("port", "scripts/torch/store_to_lerobot.py"),
                       ("jax", "scripts/dataset_converters/store_to_lerobot.py")):
        monkeypatch.setattr(sys, "argv", [path, "--store", str(tmp_path / f"{side}.bin"),
                                          "--out", str(tmp_path / f"{side}_ds"), "--fps", "4"])
        script(path).main()
    for name in ("info.json", "tasks.jsonl", "episodes.jsonl", "episodes_stats.jsonl"):
        assert ((tmp_path / "port_ds" / "meta" / name).read_text()
                == (tmp_path / "jax_ds" / "meta" / name).read_text()), name
    t, j = (m.LerobotAsTrajStore(str(tmp_path / f"{s}_ds")) for m, s in
            ((tlerobot, "port"), (jlerobot, "jax")))
    for key in t.keys():
        a, b = t.get_tree(key), j.get_tree(key)
        rgb_a, rgb_b = a.pop("rgb"), b.pop("rgb")
        assert rgb_a.shape == rgb_b.shape == (3, 16, 16, 3)
        same_tree(a, b)
