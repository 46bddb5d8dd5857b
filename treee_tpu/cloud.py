"""Canonical structure-of-arrays point store.

The reference scatters points across per-phase containers: a ``HashMap<isize,
Vec<Point3>>`` of 1 m height slices while loading (treee/src/loading.rs:14-29), a
``HashMap<u32, Vec<Point3>>`` after segmentation (treee/src/segmenting.rs:156), and a
``HashMap<u32, SegmentData>`` with per-segment ``Vec``s interactively
(treee/src/interactive/mod.rs:31).  Every edit shuffles Vec elements and re-uploads
whole segments to the GPU (interactive/mod.rs:116-149,182-221).

The array-native design is one fixed-capacity SoA buffer that never changes shape:

- ``pos``            f32[N, 3]   point positions, y-up, centered at world_offset
- ``segment``        i32[N]      segment id per point; 0 == deleted
                                 (DELETED_INDEX, interactive/mod.rs:19)
- ``classification`` i32[N]      0 Ground / 1 Trunk / 2 Crown (calculations.rs:55-59)
- ``valid``          bool[N]     capacity-padding mask (False = padding slot)

All phase transitions and interactive edits are pure jitted functions
``PointCloud -> PointCloud`` over these arrays; nothing ever leaves the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .utils import struct

# Segment id 0 doubles as "deleted" AND "no tree assigned", exactly like the
# reference (interactive/mod.rs:19 DELETED_INDEX == segmenting.rs:198's
# no-tree id): points the segmenter leaves unassigned are hidden/excluded
# the same way user-deleted points are until re-segmented or drawn back in.
DELETED_SEGMENT = 0

CLASS_GROUND = 0
CLASS_TRUNK = 1
CLASS_CROWN = 2

# Classification filters for hull/RBV/export selection
# (IncludeMode, interactive/hull.rs:15-35).
INCLUDE_MODES = ("all", "crown", "trunk", "ground", "tree", "nocrown")


def include_mask(classification: jax.Array, mode: str) -> jax.Array:
    """bool[N] class filter for ``mode`` (IncludeMode::valid, hull.rs:26-35)."""
    if mode == "all":
        return jnp.ones_like(classification, bool)
    if mode == "crown":
        return classification == CLASS_CROWN
    if mode == "trunk":
        return classification == CLASS_TRUNK
    if mode == "ground":
        return classification == CLASS_GROUND
    if mode == "tree":
        return (classification == CLASS_CROWN) | (classification == CLASS_TRUNK)
    if mode == "nocrown":
        return (classification == CLASS_TRUNK) | (classification == CLASS_GROUND)
    raise ValueError(f"unknown include mode {mode!r} (one of {INCLUDE_MODES})")


class PointCloud(struct.PyTreeNode):
    """Fixed-capacity SoA point store; the single source of truth on device."""

    pos: jax.Array            # f32[N, 3]
    segment: jax.Array        # i32[N]
    classification: jax.Array # i32[N]
    valid: jax.Array          # bool[N]

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def count(self) -> jax.Array:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.valid.astype(jnp.int32))

    @classmethod
    def empty(cls, capacity: int) -> "PointCloud":
        return cls(
            pos=jnp.zeros((capacity, 3), jnp.float32),
            segment=jnp.zeros((capacity,), jnp.int32),
            classification=jnp.zeros((capacity,), jnp.int32),
            valid=jnp.zeros((capacity,), bool),
        )

    @classmethod
    def from_numpy(
        cls,
        pos: np.ndarray,
        capacity: int | None = None,
        segment: np.ndarray | None = None,
        classification: np.ndarray | None = None,
    ) -> "PointCloud":
        """Build a device cloud from host arrays, padding to ``capacity``.

        Capacity defaults to the next multiple of 1024 rows, so scenes of
        similar size share compiled shapes.
        """
        n = pos.shape[0]
        if capacity is None:
            capacity = max(1024, ((n + 1023) // 1024) * 1024)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < point count {n}")

        def pad(a: np.ndarray, fill) -> np.ndarray:
            out = np.full((capacity,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return out

        seg = segment if segment is not None else np.ones(n, np.int32)
        cls_ = classification if classification is not None else np.zeros(n, np.int32)
        return cls(
            pos=jnp.asarray(pad(pos.astype(np.float32), 0.0)),
            segment=jnp.asarray(pad(seg.astype(np.int32), DELETED_SEGMENT)),
            classification=jnp.asarray(pad(cls_.astype(np.int32), CLASS_GROUND)),
            valid=jnp.asarray(np.arange(capacity) < n),
        )

    # ---- masks ----------------------------------------------------------------

    @property
    def alive(self) -> jax.Array:
        """Valid and not deleted."""
        return self.valid & (self.segment != DELETED_SEGMENT)

    def masked_pos(self, fill: float = jnp.inf) -> jax.Array:
        """Positions with padding slots replaced by ``fill`` (for min/argmin ops)."""
        return jnp.where(self.valid[:, None], self.pos, fill)

    # ---- reductions -----------------------------------------------------------

    def bounds(self) -> tuple[jax.Array, jax.Array]:
        """(min, max) over alive points; zeros if none (calculations.rs:136-147)."""
        m = self.alive[:, None]
        big = jnp.float32(3.0e38)
        lo = jnp.min(jnp.where(m, self.pos, big), axis=0)
        hi = jnp.max(jnp.where(m, self.pos, -big), axis=0)
        any_alive = jnp.any(self.alive)
        zero = jnp.zeros(3, jnp.float32)
        return (
            jnp.where(any_alive, lo, zero),
            jnp.where(any_alive, hi, zero),
        )

    # ---- host export ----------------------------------------------------------

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Copy valid points to host (for exports and checkpoints).

        Selects on device and fetches only the valid rows in <32 MB chunks
        (utils/transfer) — a full-capacity `np.asarray(pos)` costs ~10x at
        scale on this host's slow fresh-page path."""
        from .utils import transfer

        ids, _ = transfer.mask_ids(self.valid)
        return {
            "pos": transfer.gather_rows(self.pos, ids),
            "segment": transfer.gather_rows(self.segment, ids),
            "classification": transfer.gather_rows(self.classification, ids),
        }
