"""The port's NavDP dataset against the JAX package's, on one store.

Everything here is host-side numpy, so every field of every sample, and
every collated batch, must be exactly equal (dtypes too): the memory
stacks, the goal point, image and pixel goals (the pixel-goal mask), the
label and augmented actions (the `RandomState` goal offsets and augment
noise), and both critic labels (the depth penalty included). The store is
written by the port's `write_synthetic_navdp_dataset`, read by each
package's own `TrajectoryDataset`.
"""

import numpy as np
import pytest

from internnav_tpu.dataset import navdp_dataset as jds
from internnav_tpu_torch.dataset import navdp_dataset as tds

FIELDS = ("goal_point", "goal_image", "goal_pixel", "input_images", "input_depths",
          "output_actions", "augment_actions", "label_critic", "augment_critic")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("navdp") / "store.bin")
    return tds.write_synthetic_navdp_dataset(path, n_episodes=5, T=20, hw=28, seed=3)


def assert_equal(want, got, where):
    assert type(want) is type(got) or np.isscalar(want), where
    if isinstance(want, dict):
        assert want.keys() == got.keys(), where
        for k in want:
            assert_equal(want[k], got[k], f"{where}.{k}")
        return
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype, where
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("kw", [
    {}, {"memory_size": 2, "predict_size": 6}, {"memory_size": 3, "predict_size": 10, "seed": 5},
    {"memory_size": 4, "predict_size": 8, "rank": 1, "world_size": 2, "seed": 1}],
    ids=["defaults", "m2_p6", "m3_p10_seed5", "rank1_of_2"])
def test_samples_equal_jax(store, kw):
    want = list(jds.NavDPSampleDataset(store, image_hw=28, **kw))
    got = list(tds.NavDPSampleDataset(store, image_hw=28, **kw))
    assert len(want) == len(got) > 0
    m = kw.get("memory_size", 8)
    p = kw.get("predict_size", 24)
    for i, (w, g) in enumerate(zip(want, got)):
        assert tuple(g) == FIELDS
        assert_equal(w, g, f"sample {i}")
        assert g["input_images"].shape == (m, 28, 28, 3)
        assert g["input_depths"].shape == (m, 28, 28, 1)
        assert g["output_actions"].shape == g["augment_actions"].shape == (p, 3)
        assert g["goal_pixel"][..., 4].sum() == 28  # one mask column
    # the augment noise and the depth penalty are drawn and taken
    assert any(not np.array_equal(g["output_actions"], g["augment_actions"]) for g in got)
    penalised = [tds.critic_label(np.cumsum(g["augment_actions"][:, :2] / 4.0, 0),
                                  g["goal_point"][:2]) != float(g["augment_critic"])
                 for g in got]
    assert any(penalised)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_collated_batches_equal_jax(store, batch_size):
    kw = {"memory_size": 2, "predict_size": 6, "image_hw": 28, "seed": 2}
    want = list(jds.make_navdp_dataloader(store, batch_size, **kw)())
    got = list(tds.make_navdp_dataloader(store, batch_size, **kw)())
    assert len(want) == len(got) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert_equal(w, g, f"batch {i}")
        assert g["label_critic"].shape == (batch_size,)
        assert g["observations"]["goal_pixel"].shape == (batch_size, 28, 28, 7)
    samples = list(tds.NavDPSampleDataset(store, **kw))[:batch_size]
    assert_equal(jds.navdp_collate_fn(samples), tds.navdp_collate_fn(samples), "collate")


def test_critic_label_and_resample_path_equal_jax():
    rs = np.random.RandomState(0)
    for n in (1, 2, 7):
        pts = rs.randn(n, 2)
        for k in (1, 6, 24):
            np.testing.assert_array_equal(tds.resample_path(pts, k), jds.resample_path(pts, k))
    for _ in range(20):
        traj, goal = rs.randn(6, 2) * 2, rs.randn(2) * 3
        depth = rs.uniform(0.1, 1.0, (28, 28, 1)).astype(np.float32)
        for d in (None, depth, depth[:0]):
            assert tds.critic_label(traj, goal, d) == jds.critic_label(traj, goal, d)
