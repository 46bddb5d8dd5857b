"""treee-tpu: a GPU-accelerated forest-LiDAR point-cloud framework.

A ground-up JAX/XLA rebuild of the capability set of antonWetzel/treee
(Rust/wgpu importer, tree segmenter, interactive viewer — see SURVEY.md): .las/.laz
ingest, Morton linear octree, per-tree segmentation, per-segment characteristics,
interactive editing as pure jitted state transitions, and a splat renderer with
eye-dome lighting, all over fixed-capacity structure-of-arrays device buffers.
"""

from .config import Config, DEFAULT_CONFIG
from .cloud import PointCloud, DELETED_SEGMENT, CLASS_GROUND, CLASS_TRUNK, CLASS_CROWN

__all__ = [
    "Config",
    "DEFAULT_CONFIG",
    "PointCloud",
    "DELETED_SEGMENT",
    "CLASS_GROUND",
    "CLASS_TRUNK",
    "CLASS_CROWN",
]

__version__ = "0.1.0"
