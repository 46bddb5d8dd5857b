"""What the package needs to start: its imports, its pytree helper, and the
refusals of the GPU entry points when no GPU (or too few devices) exist."""

import dataclasses
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from treee_tpu.utils import struct

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_IMPORTS = """
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "PIL"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Block())
"""


def test_package_runs_without_flax_and_pil(tmp_path):
    """import treee_tpu and a tiny segment + render + PNG in a process where
    flax and PIL cannot be imported."""
    code = _BLOCK_IMPORTS + f"""
import numpy as np
import treee_tpu
from treee_tpu.config import (CharacteristicsConfig, Config, RenderConfig,
                              SegmentationConfig)
from treee_tpu.io import las
from treee_tpu.pipeline import Session
from treee_tpu.serve import png_encode

cfg = Config(
    segmentation=SegmentationConfig(grid_size=64, max_bands=16,
                                    max_segments=32, max_trees_per_band=16),
    characteristics=CharacteristicsConfig(max_slices=64),
    render=RenderConfig(width=48, height=32))
pts = las.synthetic_forest(n_trees=2, points_per_tree=300, ground_points=200)
s = Session.from_points(pts, cfg)
assert int(s.segment(0.75).n_segments) > 0
img = s.render()
with open({str(tmp_path / 'f.png')!r}, "wb") as f:
    f.write(png_encode(img))
assert "flax" not in sys.modules and "PIL" not in sys.modules
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", TREEE_NO_COMPILE_CACHE="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
    assert (tmp_path / "f.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


class _Node(struct.PyTreeNode):
    a: jax.Array
    b: jax.Array
    tag: str = struct.field(pytree_node=False, default="x")


def test_struct_pytree_leaves_static_fields_and_replace():
    n = _Node(a=jnp.ones(2), b=jnp.zeros(3), tag="t")
    leaves, treedef = jax.tree_util.tree_flatten(n)
    assert [x.shape for x in leaves] == [(2,), (3,)]
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tag == "t"
    m = n.replace(a=jnp.full(2, 5.0))
    assert float(m.a[0]) == 5.0 and m.tag == "t" and float(n.a[0]) == 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        n.a = jnp.zeros(2)


def test_struct_static_field_is_part_of_the_jit_key():
    traces = []

    @jax.jit
    def f(node):
        traces.append(node.tag)
        return node.a * 2

    np.testing.assert_array_equal(np.asarray(f(_Node(jnp.ones(2),
                                                     jnp.ones(1), "p"))),
                                  [2.0, 2.0])
    f(_Node(jnp.ones(2), jnp.ones(1), "p"))
    f(_Node(jnp.ones(2), jnp.ones(1), "q"))
    assert traces == ["p", "q"]


def test_chip_smoke_device_check_refuses_cpu():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    fake = types.SimpleNamespace(
        devices=lambda: [types.SimpleNamespace(platform="cpu")])
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(fake)
    gpu = types.SimpleNamespace(platform="gpu")
    assert chip_smoke.require_gpu(
        types.SimpleNamespace(devices=lambda: [gpu])) == [gpu]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU (in the checkout, or copied alone into an empty directory)
    the script exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_dryrun_multichip_refuses_missing_devices():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.remove(REPO)
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        ge.dryrun_multichip(64)
