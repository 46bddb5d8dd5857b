"""Radial bounding volumes + forestry traits for a focused segment.

Capability parity with treee/src/interactive/hull.rs:631-995: approximate a
segment (or its crown/trunk split) with a cylinder of ``slices`` x ``sectors``
radial distances around a center axis, optionally symmetrized; derive landmark
points and the forestry traits (DBH, trunk cross area, crown diameter /
projected area / volume / surface, stem & wood volume, hull.rs:926-995).

Array redesign notes:
- the per-(slice, sector) max/mean distances are one scatter reduction instead
  of a point loop (hull.rs:745-764);
- the reference centers the cylinder with Ritter's sequential bounding-sphere
  pass (hull.rs:707-726) — inherently serial, so we use the classic parallel
  2-step variant: p = farthest point from the (x,z) centroid, q = farthest
  point from p, center = midpoint(p, q).  Same approximation family, one
  argmax-reduction each.
- an optional trunk-axis transform tilts the cylinder (points are moved into
  axis space with the inverse affine, hull.rs:669-679).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .utils import struct

INF = jnp.float32(3.0e38)

METHOD_MAX = 0
METHOD_MEAN = 1


class RadialBoundingVolume(struct.PyTreeNode):
    """Distances grid + cylinder frame (hull.rs:631-645)."""

    center: jax.Array       # f32[2] (x, z) in axis space
    min_y: jax.Array        # f32 cylinder base height
    slice_height: jax.Array # f32
    distances: jax.Array    # f32[slices * sectors]
    transform: jax.Array    # f32[4,4] axis frame (identity when untilted)
    slices: int = struct.field(pytree_node=False)
    sectors: int = struct.field(pytree_node=False)


def _apply_inverse(transform: jax.Array, pos: jax.Array) -> jax.Array:
    r = transform[:3, :3]
    t = transform[:3, 3]
    return (pos - t) @ r  # R^-1 = R^T for the rigid axis frame


@functools.partial(jax.jit, static_argnames=("slices", "sectors", "method", "symmetric"))
def build_rbv(
    pos: jax.Array,
    mask: jax.Array,
    slices: int = 8,
    sectors: int = 8,
    method: int = METHOD_MAX,
    symmetric: bool = False,
    transform: jax.Array | None = None,
) -> RadialBoundingVolume:
    """Compute the RBV of the masked points (hull.rs:656-858)."""
    centered = transform is not None
    tf = transform if transform is not None else jnp.eye(4)
    p = _apply_inverse(tf, pos)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]

    any_pt = jnp.any(mask)
    min_y = jnp.where(any_pt, jnp.min(jnp.where(mask, y, INF)), 0.0)
    max_y = jnp.where(any_pt, jnp.max(jnp.where(mask, y, -INF)), 1.0)

    if centered:
        center = jnp.zeros(2)  # axis space is already centered (hull.rs:724-726)
    else:
        xz = jnp.stack([x, z], axis=-1)
        n = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
        centroid = jnp.sum(jnp.where(mask[:, None], xz, 0.0), axis=0) / n
        d0 = jnp.where(mask, jnp.sum((xz - centroid) ** 2, axis=-1), -1.0)
        pa = xz[jnp.argmax(d0)]
        d1 = jnp.where(mask, jnp.sum((xz - pa) ** 2, axis=-1), -1.0)
        pb = xz[jnp.argmax(d1)]
        center = jnp.where(any_pt, (pa + pb) / 2.0, jnp.zeros(2))

    slice_h = jnp.maximum((max_y - min_y) / slices, 1e-6)
    sector_angle = 2.0 * math.pi / sectors

    si = jnp.clip(((y - min_y) / slice_h).astype(jnp.int32), 0, slices - 1)
    dx = x - center[0]
    dz = z - center[1]
    dist = jnp.sqrt(dx * dx + dz * dz)
    ang = jnp.arctan2(dz, dx) + 2.0 * math.pi
    sec = jnp.clip(((ang / sector_angle) % sectors).astype(jnp.int32), 0, sectors - 1)
    bucket = jnp.where(mask, si * sectors + sec, slices * sectors)

    if method == METHOD_MAX:
        d = jnp.zeros(slices * sectors + 1).at[bucket].max(
            jnp.where(mask, dist, 0.0)
        )[:-1]
    else:
        s = jnp.zeros(slices * sectors + 1).at[bucket].add(
            jnp.where(mask, dist, 0.0)
        )[:-1]
        c = jnp.zeros(slices * sectors + 1).at[bucket].add(
            mask.astype(jnp.float32)
        )[:-1]
        d = s / jnp.maximum(c, 1.0)

    if symmetric and sectors % 2 == 0:
        dg = d.reshape(slices, sectors)
        half = sectors // 2
        avg = (dg[:, :half] + dg[:, half:]) / 2.0
        d = jnp.concatenate([avg, avg], axis=1).reshape(-1)

    return RadialBoundingVolume(
        center=center,
        min_y=min_y,
        slice_height=slice_h,
        distances=d,
        transform=tf,
        slices=slices,
        sectors=sectors,
    )


def landmarks(rbv: RadialBoundingVolume, base, interpolate_height: bool) -> jax.Array:
    """Characteristic points, flat [slices*sectors*3] (hull.rs:880-904).

    ``interpolate_height``: the reference uses 0..1 layer interpolation for
    Ground/NoCrown volumes and mid-slice (0.5) otherwise (hull.rs:891-898).

    Component order is [cos*d, sin*d, height] — height THIRD — which is NOT
    the codebase's y-up convention but IS the reference's landmark txt
    format byte-for-byte (hull.rs:889-900 pushes cos, sin, then the
    vertical; mod.rs:402's apex is [0, 0, top]).  Do not "fix" to y-up.
    """
    s, k = rbv.slices, rbv.sectors
    sector_angle = 2.0 * math.pi / k
    si = jnp.repeat(jnp.arange(s, dtype=jnp.float32), k)
    ki = jnp.tile(jnp.arange(k, dtype=jnp.float32), s)
    ang = (ki + 0.5) * sector_angle
    d = rbv.distances
    off = si / max(s - 1, 1) if interpolate_height else 0.5
    yy = base + (si + off) * rbv.slice_height
    return jnp.stack([jnp.cos(ang) * d, jnp.sin(ang) * d, yy], axis=-1).reshape(-1)


class Traits(struct.PyTreeNode):
    """Forestry traits (hull.rs:998-1008)."""

    diameter_breast_height: jax.Array
    trunk_cross_area: jax.Array
    crown_diameter: jax.Array
    crown_projected_area: jax.Array
    crown_volume: jax.Array
    crown_surface: jax.Array
    stem_volume: jax.Array
    wood_volume: jax.Array

    def to_json(self) -> str:
        import json

        return json.dumps(
            {k: float(getattr(self, k)) for k in (
                "diameter_breast_height", "trunk_cross_area", "crown_diameter",
                "crown_projected_area", "crown_volume", "crown_surface",
                "stem_volume", "wood_volume",
            )},
            indent=2,
        )


@jax.jit
def traits(crown: RadialBoundingVolume, trunk: RadialBoundingVolume) -> Traits:
    """Derived forestry traits from the split RBV (hull.rs:926-995 formulas)."""
    t_s, t_k = trunk.slices, trunk.sectors
    c_s, c_k = crown.slices, crown.sectors
    trunk_height = trunk.slice_height * t_s
    height = crown.min_y + crown.slice_height * c_s - trunk.min_y

    # DBH: mean distance * 2 of the slice at 1.3 m (hull.rs:931-936)
    sl = jnp.clip((1.3 / trunk.slice_height).astype(jnp.int32), 0, t_s - 1)
    td = trunk.distances.reshape(t_s, t_k)
    dbh = jnp.sum(td[sl]) * 2.0 / t_k
    trunk_cross_area = math.pi * (dbh / 2.0) ** 2

    cd = crown.distances.reshape(c_s, c_k)
    sector_max = jnp.max(cd, axis=0)                       # [sectors]
    crown_sum = jnp.sum(cd)
    crown_diameter = jnp.sum(sector_max) * 2.0 / c_k
    crown_projected_area = jnp.sum(sector_max**2) * math.pi / c_k
    crown_volume = jnp.sum(cd**2) * math.pi * crown.slice_height / c_k
    crown_surface = (
        2.0 * crown_projected_area
        + 2.0 * math.pi * crown.slice_height / c_k * crown_sum
    )
    stem_volume = trunk_cross_area * (trunk_height + (height - trunk_height) / 3.0)
    wood_volume = stem_volume + trunk_cross_area / (c_s * c_k) * crown_sum

    return Traits(
        diameter_breast_height=dbh,
        trunk_cross_area=trunk_cross_area,
        crown_diameter=crown_diameter,
        crown_projected_area=crown_projected_area,
        crown_volume=crown_volume,
        crown_surface=crown_surface,
        stem_volume=stem_volume,
        wood_volume=wood_volume,
    )


def split_rbv(
    pos: jax.Array,
    classification: jax.Array,
    mask: jax.Array,
    transform: jax.Array | None = None,
    crown_slices: int = 26,
    crown_sectors: int = 32,
    trunk_slices: int = 5,
    trunk_sectors: int = 32,
    method: int = METHOD_MAX,
    symmetric: bool = False,
) -> tuple[RadialBoundingVolume, RadialBoundingVolume]:
    """Crown 26x32 + trunk 5x32 split (hull.rs:185-208 defaults); ``method``
    and ``symmetric`` map the reference's RBV widgets (hull.rs:248-285)."""
    from .cloud import CLASS_CROWN, CLASS_TRUNK

    crown = build_rbv(
        pos, mask & (classification == CLASS_CROWN),
        slices=crown_slices, sectors=crown_sectors, transform=transform,
        method=method, symmetric=symmetric,
    )
    trunk = build_rbv(
        pos, mask & (classification == CLASS_TRUNK),
        slices=trunk_slices, sectors=trunk_sectors, transform=transform,
        method=method, symmetric=symmetric,
    )
    return crown, trunk


class BatchedRBV(struct.PyTreeNode):
    """RBVs of EVERY segment at once, [S]-leading (axis-space, center = 0).

    Row i carries the same quantities as build_rbv(transform=axes[i]) on
    segment i; the whole-forest inventory builds all S in one scatter pass
    instead of the reference's one-focused-tree-at-a-time loop."""

    min_y: jax.Array        # f32[S]
    slice_height: jax.Array # f32[S]
    distances: jax.Array    # f32[S, slices*sectors]
    slices: int = struct.field(pytree_node=False)
    sectors: int = struct.field(pytree_node=False)


def _batched_rbv_grid(x, z, y, mask, segment, n_segments, slices, sectors,
                      method, symmetric, axis_name=None):
    """One [S, slices*sectors] distance grid via segmented scatters
    (hull.rs:729-764 per-point loop -> one keyed reduction).  ``axis_name``
    composes point shards: pmin/pmax for extents and max grids (exact),
    psum for the mean grids' sums/counts."""
    seg_t = jnp.where(mask, segment, n_segments)
    min_y = jnp.full(n_segments + 1, INF).at[seg_t].min(
        jnp.where(mask, y, INF))[:n_segments]
    max_y = jnp.full(n_segments + 1, -INF).at[seg_t].max(
        jnp.where(mask, y, -INF))[:n_segments]
    if axis_name is not None:
        min_y = jax.lax.pmin(min_y, axis_name)
        max_y = jax.lax.pmax(max_y, axis_name)
    any_pt = min_y < INF
    min_y = jnp.where(any_pt, min_y, 0.0)
    max_y = jnp.where(any_pt, max_y, 1.0)
    slice_h = jnp.maximum((max_y - min_y) / slices, 1e-6)

    si = jnp.clip(
        ((y - jnp.take(min_y, segment)) / jnp.take(slice_h, segment))
        .astype(jnp.int32),
        0, slices - 1,
    )
    dist = jnp.sqrt(x * x + z * z)
    sector_angle = 2.0 * math.pi / sectors
    ang = jnp.arctan2(z, x) + 2.0 * math.pi
    sec = jnp.clip(((ang / sector_angle) % sectors).astype(jnp.int32),
                   0, sectors - 1)
    cells = slices * sectors
    bucket = jnp.where(mask, segment * cells + si * sectors + sec,
                       n_segments * cells)

    if method == METHOD_MAX:
        d = jnp.zeros(n_segments * cells + 1).at[bucket].max(
            jnp.where(mask, dist, 0.0))[:-1]
        if axis_name is not None:
            d = jax.lax.pmax(d, axis_name)
    else:
        s = jnp.zeros(n_segments * cells + 1).at[bucket].add(
            jnp.where(mask, dist, 0.0))[:-1]
        c = jnp.zeros(n_segments * cells + 1).at[bucket].add(
            mask.astype(jnp.float32))[:-1]
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
            c = jax.lax.psum(c, axis_name)
        d = s / jnp.maximum(c, 1.0)

    if symmetric and sectors % 2 == 0:
        dg = d.reshape(n_segments, slices, sectors)
        half = sectors // 2
        avg = (dg[:, :, :half] + dg[:, :, half:]) / 2.0
        d = jnp.concatenate([avg, avg], axis=2)

    return BatchedRBV(
        min_y=min_y, slice_height=slice_h,
        distances=d.reshape(n_segments, cells),
        slices=slices, sectors=sectors,
    )


@functools.partial(jax.jit, static_argnames=(
    "n_segments", "crown_slices", "crown_sectors", "trunk_slices",
    "trunk_sectors", "method", "symmetric", "axis_name"))
def batched_split_rbv(
    pos: jax.Array,
    classification: jax.Array,
    mask: jax.Array,
    segment: jax.Array,
    n_segments: int,
    transforms: jax.Array,  # f32[S,4,4] per-segment axis frames
    crown_slices: int = 26,
    crown_sectors: int = 32,
    trunk_slices: int = 5,
    trunk_sectors: int = 32,
    method: int = METHOD_MAX,
    symmetric: bool = False,
    axis_name: str | None = None,
) -> tuple[BatchedRBV, BatchedRBV]:
    """Crown + trunk RBVs for every segment in one pass (hull.rs:185-208
    split, batched).  Each point moves into ITS segment's axis frame —
    twelve flat [S]->[N] component gathers instead of a gathered [N,3,3]
    matrix.  ``axis_name`` composes point shards (transforms must be
    replicated)."""
    from .cloud import CLASS_CROWN, CLASS_TRUNK

    def g(i, j):
        return jnp.take(transforms[:, i, j], segment)

    px = pos[:, 0] - g(0, 3)
    py = pos[:, 1] - g(1, 3)
    pz = pos[:, 2] - g(2, 3)
    # (pos - t) @ R, R orthonormal (axis_transform): column j of R per point
    x = px * g(0, 0) + py * g(1, 0) + pz * g(2, 0)
    y = px * g(0, 1) + py * g(1, 1) + pz * g(2, 1)
    z = px * g(0, 2) + py * g(1, 2) + pz * g(2, 2)

    crown = _batched_rbv_grid(
        x, z, y, mask & (classification == CLASS_CROWN), segment, n_segments,
        crown_slices, crown_sectors, method, symmetric, axis_name)
    trunk = _batched_rbv_grid(
        x, z, y, mask & (classification == CLASS_TRUNK), segment, n_segments,
        trunk_slices, trunk_sectors, method, symmetric, axis_name)
    return crown, trunk


@jax.jit
def batched_traits(crown: BatchedRBV, trunk: BatchedRBV) -> Traits:
    """Traits for every segment at once: [S]-leading Traits matching
    traits() row-for-row (hull.rs:926-995 formulas)."""
    t_s, t_k = trunk.slices, trunk.sectors
    c_s, c_k = crown.slices, crown.sectors
    n = crown.min_y.shape[0]
    trunk_height = trunk.slice_height * t_s
    height = crown.min_y + crown.slice_height * c_s - trunk.min_y

    sl = jnp.clip((1.3 / trunk.slice_height).astype(jnp.int32), 0, t_s - 1)
    td = trunk.distances.reshape(n, t_s, t_k)
    dbh_slice = jnp.take_along_axis(td, sl[:, None, None], axis=1)[:, 0, :]
    dbh = jnp.sum(dbh_slice, axis=-1) * 2.0 / t_k
    trunk_cross_area = math.pi * (dbh / 2.0) ** 2

    cd = crown.distances.reshape(n, c_s, c_k)
    sector_max = jnp.max(cd, axis=1)                      # [S, sectors]
    crown_sum = jnp.sum(cd, axis=(1, 2))
    crown_diameter = jnp.sum(sector_max, axis=-1) * 2.0 / c_k
    crown_projected_area = jnp.sum(sector_max**2, axis=-1) * math.pi / c_k
    crown_volume = jnp.sum(cd**2, axis=(1, 2)) * math.pi * crown.slice_height / c_k
    crown_surface = (
        2.0 * crown_projected_area
        + 2.0 * math.pi * crown.slice_height / c_k * crown_sum
    )
    stem_volume = trunk_cross_area * (trunk_height + (height - trunk_height) / 3.0)
    wood_volume = stem_volume + trunk_cross_area / (c_s * c_k) * crown_sum

    return Traits(
        diameter_breast_height=dbh,
        trunk_cross_area=trunk_cross_area,
        crown_diameter=crown_diameter,
        crown_projected_area=crown_projected_area,
        crown_volume=crown_volume,
        crown_surface=crown_surface,
        stem_volume=stem_volume,
        wood_volume=wood_volume,
    )


def rbv_lines(rbv: RadialBoundingVolume, arc_detail: int = 4) -> np.ndarray:
    """Wireframe cage endpoints f32[L,2,3] (hull.rs:780-841 geometry).

    Per (slice, sector): center vertical, radials at both heights, the outer
    vertical edge, and an ``arc_detail``-segment arc at each height.  Points
    are mapped back through the axis transform like the reference's
    ``transform * p`` (hull.rs:784-786).
    """
    s, k = rbv.slices, rbv.sectors
    d = np.asarray(rbv.distances).reshape(s, k)
    cx, cz = float(rbv.center[0]), float(rbv.center[1])
    min_y = float(rbv.min_y)
    sh = float(rbv.slice_height)
    sector_angle = 2.0 * math.pi / k
    tf = np.asarray(rbv.transform)

    lines = []

    def pt(x, y, z):
        v = tf[:3, :3] @ np.array([x, y, z]) + tf[:3, 3]
        return v

    for si in range(s):
        y0, y1 = min_y + sh * si, min_y + sh * (si + 1)
        lines.append((pt(cx, y0, cz), pt(cx, y1, cz)))
        for ki in range(k):
            dist = d[si, ki]
            a0 = sector_angle * ki
            x0, z0 = cx + math.cos(a0) * dist, cz + math.sin(a0) * dist
            lines.append((pt(cx, y0, cz), pt(x0, y0, z0)))
            lines.append((pt(cx, y1, cz), pt(x0, y1, z0)))
            lines.append((pt(x0, y0, z0), pt(x0, y1, z0)))
            px, pz = x0, z0
            for j in range(1, arc_detail + 1):
                a = a0 + sector_angle * j / arc_detail
                nx, nz = cx + math.cos(a) * dist, cz + math.sin(a) * dist
                lines.append((pt(px, y0, pz), pt(nx, y0, nz)))
                lines.append((pt(px, y1, pz), pt(nx, y1, nz)))
                px, pz = nx, nz
    return np.asarray(lines, np.float32)


def split_landmarks(crown: RadialBoundingVolume, trunk: RadialBoundingVolume) -> np.ndarray:
    """Landmark export of the split RBV: trunk rows + crown rows + apex
    (hull.rs:398-402)."""
    lm_t = np.asarray(landmarks(trunk, 0.0, interpolate_height=False))
    base = float(crown.min_y - trunk.min_y)
    lm_c = np.asarray(landmarks(crown, base, interpolate_height=False))
    top = base + float(crown.slice_height) * crown.slices
    return np.concatenate([lm_t, lm_c, [0.0, 0.0, top]])
