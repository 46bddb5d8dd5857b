"""Pipeline on the card against the same pipeline on the CPU (marker ``gpu``).

Run on a machine with a GPU:
``TREEE_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from treee_tpu.config import Config, SegmentationConfig
from treee_tpu.io import las
from treee_tpu.pipeline import full_pipeline

CFG = Config(segmentation=SegmentationConfig(
    grid_size=128, max_bands=32, max_segments=256, max_trees_per_band=64))


@pytest.mark.gpu
def test_full_pipeline_gpu_matches_cpu_and_repeats(gpu_device):
    pts = las.synthetic_forest(n_trees=25, points_per_tree=4000,
                               ground_points=30_000, seed=4)
    out = {}
    for name, dev in (("gpu", gpu_device), ("cpu", jax.devices("cpu")[0])):
        pos = jax.device_put(jnp.asarray(pts), dev)
        valid = jax.device_put(jnp.ones(len(pts), bool), dev)
        runs = [jax.tree_util.tree_map(
            np.asarray, full_pipeline(pos, valid, 0.75, CFG)[:2])
            for _ in range(2)]
        # deterministic ids and classes run to run on each device
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a, b)
        out[name] = runs[0]
    (seg_g, cls_g), (seg_c, cls_c) = out["gpu"], out["cpu"]
    assert (seg_g == seg_c).mean() >= 0.9999
    np.testing.assert_array_equal(cls_g, cls_c)
