"""Interactive editing as pure jit-compiled state transitions.

Capability parity with the reference Interactive phase
(treee/src/interactive/mod.rs): sphere-brush point removal / reassignment
(:116-149), sphere reclassification (:152-179), segment combine (:938-951),
spawn-new-segment (:737-767), delete (:815-837), and two-phase ray picking
(:680-710 bbox-then-exact; :60-112).

Where the reference shuffles points between per-segment ``Vec``s and re-uploads
whole GPU buffers per brush stroke (:182-221), every edit here is a masked
update of the fixed SoA arrays — an O(N) fused elementwise op that never leaves
the device; "moving a point between segments" is writing one i32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .cloud import DELETED_SEGMENT, PointCloud

INF = jnp.float32(3.0e38)


def _in_sphere(cloud: PointCloud, center: jax.Array, radius) -> jax.Array:
    d2 = jnp.sum((cloud.pos - center) ** 2, axis=-1)
    return cloud.valid & (d2 <= radius * radius)


@jax.jit
def remove_points(
    cloud: PointCloud, center: jax.Array, radius: jax.Array,
    target: jax.Array | int = DELETED_SEGMENT,
    source: jax.Array | int = -1,
) -> PointCloud:
    """Move every in-sphere point to ``target`` (SegmentData::remove semantics).

    ``source`` >= 0 restricts to one segment (the focused-view delete); -1 edits
    all segments (whole-forest Delete/Draw modes).  Deleted points are only
    touched when source == DELETED_SEGMENT (the reference edits the deleted set
    only when shown, mod.rs:866-869).
    """
    hit = _in_sphere(cloud, center, radius)
    src_ok = jnp.where(
        jnp.asarray(source) >= 0,
        cloud.segment == source,
        cloud.segment != DELETED_SEGMENT,
    )
    seg = jnp.where(hit & src_ok, target, cloud.segment)
    return cloud.replace(segment=seg.astype(jnp.int32))


@jax.jit
def restore_deleted(cloud: PointCloud, center, radius, target) -> PointCloud:
    """Pull deleted points inside the brush into ``target`` (mod.rs:901-907)."""
    hit = _in_sphere(cloud, center, radius) & (cloud.segment == DELETED_SEGMENT)
    return cloud.replace(
        segment=jnp.where(hit, target, cloud.segment).astype(jnp.int32)
    )


@jax.jit
def change_classification(
    cloud: PointCloud, center, radius, classification, segment
) -> PointCloud:
    """Reclassify in-sphere points of one segment (mod.rs:152-179)."""
    hit = _in_sphere(cloud, center, radius) & (cloud.segment == segment)
    cls = jnp.where(hit, classification, cloud.classification)
    return cloud.replace(classification=cls.astype(jnp.int32))


@jax.jit
def combine_segments(cloud: PointCloud, a, b) -> PointCloud:
    """Merge segment ``a`` into ``b`` (drag-combine, mod.rs:938-951)."""
    seg = jnp.where(cloud.segment == a, b, cloud.segment)
    return cloud.replace(segment=seg.astype(jnp.int32))


@jax.jit
def spawn_segment(cloud: PointCloud, center, radius, new_id) -> PointCloud:
    """Carve a new segment out of every alive point in the sphere (mod.rs:737-767)."""
    hit = _in_sphere(cloud, center, radius) & (cloud.segment != DELETED_SEGMENT)
    seg = jnp.where(hit, new_id, cloud.segment)
    return cloud.replace(segment=seg.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("include_deleted",))
def pick(
    cloud: PointCloud,
    origin: jax.Array,
    direction: jax.Array,
    point_scale: jax.Array | float,
    include_deleted: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """First point hit by a ray -> (segment id, along-ray distance, hit?).

    Matches SegmentData::exact_distance (mod.rs:83-112): a point is hit when its
    perpendicular distance to the ray is within the splat radius
    (``point_scale``) and it lies ahead of the origin; the nearest along-ray
    distance wins.  The reference prunes with per-segment bboxes first
    (mod.rs:680-710) because its test is a serial scan; one fused vectorized
    pass needs no pruning.
    """
    eligible = cloud.valid
    if not include_deleted:
        eligible &= cloud.segment != DELETED_SEGMENT
    diff = cloud.pos - origin
    # HIGHEST: the dot feeds a squared-distance subtraction; a TF32 `along`
    # makes perp2 garbage far from origin
    along = jnp.dot(diff, direction, precision=jax.lax.Precision.HIGHEST)
    perp2 = jnp.sum(diff * diff, axis=-1) - along * along
    ok = eligible & (along >= 0.0) & (perp2 <= point_scale * point_scale)
    dist = jnp.where(ok, along, INF)
    best = jnp.argmin(dist)
    found = dist[best] < INF
    seg = jnp.where(found, cloud.segment[best], -1)
    return seg, dist[best], found


@jax.jit
def segment_exists(cloud: PointCloud, seg) -> jax.Array:
    return jnp.any(cloud.valid & (cloud.segment == seg))

