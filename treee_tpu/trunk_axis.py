"""Trunk-axis estimation for a focused segment.

Capability parity with treee/src/interactive/trunk_axis.rs: two algorithms that
fit an origin + direction to the trunk-classified points —

- AverageDirection (:108-178): split the trunk into ``layers`` horizontal
  layers; origin = mean (x,z) of points with y in [min+0.4, min+0.6) (fallback:
  lowest layer mean); direction = normalized sum of unit vectors from the
  origin to each layer's mean.
- LowHighLayer (:181-232): means of the lowest and highest ``layer_width``
  bands, connected.

Both are masked reductions over the segment's points (scatter-mean per layer),
no loops.  ``axis_transform`` reproduces TrunkAxis::transform (:56-70): the
affine frame whose y-axis is the trunk direction, used to align RBVs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .utils import struct

INF = jnp.float32(3.0e38)


class TrunkAxis(struct.PyTreeNode):
    origin: jax.Array     # f32[3]
    direction: jax.Array  # f32[3] unit, roughly +y
    found: jax.Array      # bool — False when no trunk points


def _masked_minmax_y(pos, mask):
    y = pos[:, 1]
    lo = jnp.min(jnp.where(mask, y, INF))
    hi = jnp.max(jnp.where(mask, y, -INF))
    any_pt = jnp.any(mask)
    return jnp.where(any_pt, lo, 0.0), jnp.where(any_pt, hi, 0.0), any_pt


@functools.partial(jax.jit, static_argnames=("layers",))
def average_direction(pos: jax.Array, mask: jax.Array, layers: int = 10) -> TrunkAxis:
    """AverageDirection algorithm (trunk_axis.rs:108-178)."""
    lo, hi, found = _masked_minmax_y(pos, mask)
    xz = jnp.stack([pos[:, 0], pos[:, 2]], axis=-1)
    y = pos[:, 1]

    # origin: mean of the 0.4-0.6 m band above the base (trunk_axis.rs:133-139)
    band = mask & (y >= lo + 0.4) & (y < lo + 0.6)
    band_n = jnp.sum(band.astype(jnp.float32))
    band_sum = jnp.sum(jnp.where(band[:, None], xz, 0.0), axis=0)

    layer_h = jnp.maximum((hi - lo) / layers, 1e-6)
    li = jnp.clip(((y - lo) / layer_h).astype(jnp.int32), 0, layers - 1)
    tgt = jnp.where(mask, li, layers)
    lsum_x = jnp.zeros(layers + 1).at[tgt].add(jnp.where(mask, pos[:, 0], 0.0))[:layers]
    lsum_z = jnp.zeros(layers + 1).at[tgt].add(jnp.where(mask, pos[:, 2], 0.0))[:layers]
    lcnt = jnp.zeros(layers + 1).at[tgt].add(mask.astype(jnp.float32))[:layers]
    lmean = jnp.stack(
        [lsum_x / jnp.maximum(lcnt, 1.0), lsum_z / jnp.maximum(lcnt, 1.0)], axis=-1
    )

    origin_xz = jnp.where(
        band_n > 0, band_sum / jnp.maximum(band_n, 1.0), lmean[0]
    )
    origin = jnp.array([origin_xz[0], 0.0, origin_xz[1]]) + jnp.array([0.0, 1.0, 0.0]) * lo

    heights = lo + (jnp.arange(layers, dtype=jnp.float32) + 0.5) * layer_h
    means3 = jnp.stack([lmean[:, 0], heights, lmean[:, 1]], axis=-1)
    vecs = means3 - origin
    norms = jnp.linalg.norm(vecs, axis=-1, keepdims=True)
    unit = jnp.where((lcnt > 0)[:, None], vecs / jnp.maximum(norms, 1e-6), 0.0)
    direction = jnp.sum(unit, axis=0)
    direction = direction / jnp.maximum(jnp.linalg.norm(direction), 1e-6)
    direction = jnp.where(found, direction, jnp.array([0.0, 1.0, 0.0]))
    origin = jnp.where(found, origin, jnp.zeros(3))
    return TrunkAxis(origin=origin, direction=direction, found=found)


@jax.jit
def low_high_layer(pos: jax.Array, mask: jax.Array, layer_width=1.0) -> TrunkAxis:
    """LowHighLayer algorithm (trunk_axis.rs:181-232)."""
    lo, hi, found = _masked_minmax_y(pos, mask)
    y = pos[:, 1]
    # floor the layer width: a height-degenerate slice (hi == lo) would
    # otherwise make both band masks empty and the means collapse to x=z=0
    layer = jnp.maximum(
        jnp.minimum(jnp.asarray(layer_width, jnp.float32), (hi - lo) / 2.0),
        1e-3,
    )
    low = mask & (y - lo < layer)
    high = mask & (hi - y < layer)

    def mean_xz(m):
        n = jnp.maximum(jnp.sum(m.astype(jnp.float32)), 1.0)
        sx = jnp.sum(jnp.where(m, pos[:, 0], 0.0))
        sz = jnp.sum(jnp.where(m, pos[:, 2], 0.0))
        return jnp.array([sx / n, sz / n])

    lm, hm = mean_xz(low), mean_xz(high)
    origin = jnp.array([lm[0], lo, lm[1]])
    target = jnp.array([hm[0], hi, hm[1]])
    direction = target - origin
    norm = jnp.linalg.norm(direction)
    # degenerate (zero-extent) axis: report vertical instead of a zero
    # vector, which would make axis_transform singular
    direction = jnp.where(
        norm > 1e-6, direction / jnp.maximum(norm, 1e-6),
        jnp.array([0.0, 1.0, 0.0]),
    )
    direction = jnp.where(found, direction, jnp.array([0.0, 1.0, 0.0]))
    origin = jnp.where(found, origin, jnp.zeros(3))
    return TrunkAxis(origin=origin, direction=direction, found=found)


def _segment_minmax_y(y, mask, seg_t, n_segments, axis_name=None):
    """Per-segment (lo, hi, found) over masked y via scatter reductions;
    ``axis_name`` composes shard-local tables exactly (min/max commute)."""
    lo = jnp.full(n_segments + 1, INF).at[seg_t].min(
        jnp.where(mask, y, INF))[:n_segments]
    hi = jnp.full(n_segments + 1, -INF).at[seg_t].max(
        jnp.where(mask, y, -INF))[:n_segments]
    if axis_name is not None:
        lo = jax.lax.pmin(lo, axis_name)
        hi = jax.lax.pmax(hi, axis_name)
    found = lo < INF
    return jnp.where(found, lo, 0.0), jnp.where(found, hi, 0.0), found


# fixed-point x/z sums: offsets from the masked minimum in power-of-two
# steps of at least 2**-16 m, held below 2**30 steps and split into four
# 8-bit digits, so every i32 digit sum stays below 2**31 for up to
# 8,421,504 points per target (255 * n < 2**31)
_MIN_STEP_LOG2 = -16
_SPAN_LOG2 = 30
_DIGITS = 4


def _exact_means_xz(pos, m, tgt, n_targets, axis_name=None):
    """Per-target (count, mean x, mean z) over the points with ``m`` set,
    independent of the order in which the points are summed.

    The GPU's float scatter-adds use atomics whose order changes from run
    to run, and point shards sum in yet another order; an axis moved by one
    ulp can move a point across an RBV sector and change a tree's DBH by
    centimetres.  So x and z are summed as exact integers: fixed-point
    offsets from the masked minimum, split into 8-bit digits.  Integer sums
    also compose exactly over shards (``axis_name``), so the means are
    bit-identical on one device and on a mesh.  They are the means of the
    quantized positions, within half a step of the float means.
    """
    xz = jnp.stack([pos[:, 0], pos[:, 2]], axis=-1)             # [N,2]
    lo = jnp.min(jnp.where(m[:, None], xz, INF), axis=0)
    hi = jnp.max(jnp.where(m[:, None], xz, -INF), axis=0)
    if axis_name is not None:
        lo = jax.lax.pmin(lo, axis_name)
        hi = jax.lax.pmax(hi, axis_name)
    lo = jnp.where(lo < INF, lo, 0.0)
    extent = jnp.max(jnp.maximum(hi - lo, 1e-30))
    k = jnp.maximum(jnp.ceil(jnp.log2(extent)) - _SPAN_LOG2,
                    _MIN_STEP_LOG2).astype(jnp.int32)
    step = jax.lax.bitcast_convert_type((k + 127) << 23, jnp.float32)  # 2**k
    q = jnp.round((jnp.where(m[:, None], xz, lo) - lo) / step).astype(
        jnp.int32)
    cols = jnp.concatenate(
        [m.astype(jnp.int32)[:, None]]
        + [(q >> (8 * i)) & 255 for i in range(_DIGITS)], axis=1)
    t = jnp.where(m, tgt, n_targets)
    sums = jnp.zeros((n_targets + 1, cols.shape[1]), jnp.int32).at[t].add(
        cols)[:n_targets]
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
    cnt = sums[:, 0].astype(jnp.float32)
    c = jnp.maximum(cnt, 1.0)[:, None]
    mean = lo + sum(sums[:, 1 + 2 * i:3 + 2 * i].astype(jnp.float32) / c
                    * (step * 2.0 ** (8 * i)) for i in range(_DIGITS))
    return cnt, mean[:, 0], mean[:, 1]


@functools.partial(jax.jit, static_argnames=("n_segments", "layers",
                                             "axis_name"))
def batched_average_direction(
    pos: jax.Array, mask: jax.Array, segment: jax.Array,
    n_segments: int, layers: int = 10, axis_name: str | None = None,
) -> TrunkAxis:
    """AverageDirection for EVERY segment at once (trunk_axis.rs:108-178).

    The reference runs its per-tree loop one focused segment at a time; the
    whole-forest inventory needs all S axes, so each per-tree reduction
    becomes one scatter keyed by ``segment`` (or ``segment * layers + layer``)
    — the same sort-free segmented-reduction pattern as characteristics.py.
    Fields are [S]-leading; row i matches average_direction on segment i.

    ``axis_name``: set inside ``shard_map`` over point shards; the per-
    segment tables then compose with pmin/pmax and integer psums, all exact,
    so a mesh reproduces the one-device axes bit for bit.
    """
    y = pos[:, 1]
    seg_t = jnp.where(mask, segment, n_segments)
    lo, hi, found = _segment_minmax_y(y, mask, seg_t, n_segments, axis_name)

    lo_p = jnp.take(lo, segment)  # per-point base height of ITS segment
    band = mask & (y >= lo_p + 0.4) & (y < lo_p + 0.6)
    band_n, band_x, band_z = _exact_means_xz(pos, band, segment, n_segments,
                                             axis_name)

    layer_h = jnp.maximum((hi - lo) / layers, 1e-6)  # [S]
    li = jnp.clip(
        ((y - lo_p) / jnp.take(layer_h, segment)).astype(jnp.int32),
        0, layers - 1,
    )
    lcnt, lmean_x, lmean_z = (
        v.reshape(n_segments, layers) for v in _exact_means_xz(
            pos, mask, segment * layers + li, n_segments * layers,
            axis_name))
    return _axis_from_tables(lo, hi, found, layer_h, band_n, band_x, band_z,
                             lmean_x, lmean_z, lcnt, layers)


def _axis_from_tables(lo, hi, found, layer_h, band_n, band_x, band_z,
                      lmean_x, lmean_z, lcnt, layers):
    """[S]-level tail of AverageDirection from the per-segment counts and
    means (band: ``band_*`` [S]; layers: ``l*`` [S, layers])."""
    origin_x = jnp.where(band_n > 0, band_x, lmean_x[:, 0])
    origin_z = jnp.where(band_n > 0, band_z, lmean_z[:, 0])
    origin = jnp.stack([origin_x, lo, origin_z], axis=-1)  # [S,3]

    heights = lo[:, None] + (
        jnp.arange(layers, dtype=jnp.float32)[None, :] + 0.5
    ) * layer_h[:, None]
    means3 = jnp.stack([lmean_x, heights, lmean_z], axis=-1)  # [S,layers,3]
    vecs = means3 - origin[:, None, :]
    norms = jnp.linalg.norm(vecs, axis=-1, keepdims=True)
    unit = jnp.where((lcnt > 0)[:, :, None], vecs / jnp.maximum(norms, 1e-6), 0.0)
    direction = jnp.sum(unit, axis=1)
    direction = direction / jnp.maximum(
        jnp.linalg.norm(direction, axis=-1, keepdims=True), 1e-6)
    up = jnp.array([0.0, 1.0, 0.0])
    direction = jnp.where(found[:, None], direction, up)
    origin = jnp.where(found[:, None], origin, 0.0)
    return TrunkAxis(origin=origin, direction=direction, found=found)


@functools.partial(jax.jit, static_argnames=("n_segments", "axis_name"))
def batched_low_high_layer(
    pos: jax.Array, mask: jax.Array, segment: jax.Array,
    n_segments: int, layer_width=1.0, axis_name: str | None = None,
) -> TrunkAxis:
    """LowHighLayer for every segment at once (trunk_axis.rs:181-232);
    [S]-leading TrunkAxis, row i == low_high_layer on segment i.
    ``axis_name`` composes point shards (see batched_average_direction)."""
    y = pos[:, 1]
    seg_t = jnp.where(mask, segment, n_segments)
    lo, hi, found = _segment_minmax_y(y, mask, seg_t, n_segments, axis_name)
    layer = jnp.maximum(
        jnp.minimum(jnp.asarray(layer_width, jnp.float32), (hi - lo) / 2.0),
        1e-3,
    )  # [S]
    lo_p, hi_p = jnp.take(lo, segment), jnp.take(hi, segment)
    layer_p = jnp.take(layer, segment)
    low = mask & (y - lo_p < layer_p)
    high = mask & (hi_p - y < layer_p)

    def mean_xz(m):
        _, mx, mz = _exact_means_xz(pos, m, segment, n_segments, axis_name)
        return mx, mz

    (lmx, lmz), (hmx, hmz) = mean_xz(low), mean_xz(high)
    origin = jnp.stack([lmx, lo, lmz], axis=-1)
    target = jnp.stack([hmx, hi, hmz], axis=-1)
    direction = target - origin
    norm = jnp.linalg.norm(direction, axis=-1, keepdims=True)
    up = jnp.array([0.0, 1.0, 0.0])
    direction = jnp.where(norm > 1e-6, direction / jnp.maximum(norm, 1e-6), up)
    direction = jnp.where(found[:, None], direction, up)
    origin = jnp.where(found[:, None], origin, 0.0)
    return TrunkAxis(origin=origin, direction=direction, found=found)


@jax.jit
def axis_transform(axis: TrunkAxis) -> jax.Array:
    """4x4 affine with y = trunk direction at the origin (trunk_axis.rs:56-70)."""
    yv = axis.direction
    xv = jnp.cross(yv, jnp.array([0.0, 0.0, 1.0]))
    xv = xv / jnp.maximum(jnp.linalg.norm(xv), 1e-6)
    zv = jnp.cross(xv, yv)
    m = jnp.eye(4)
    m = m.at[:3, 0].set(xv).at[:3, 1].set(yv).at[:3, 2].set(zv)
    m = m.at[:3, 3].set(axis.origin)
    return m


@jax.jit
def batched_axis_transform(axes: TrunkAxis) -> jax.Array:
    """[S,4,4] axis frames for [S]-leading axes (vmap of axis_transform)."""
    return jax.vmap(axis_transform)(axes)


def axis_lines(axis: TrunkAxis, scale) -> jax.Array:
    """Render lines: axis + ground cross, f32[6,2,3] endpoints
    (TrunkAxisRender, trunk_axis.rs:24-43 geometry, 3 lines there, axis+2 cross)."""
    o, d = axis.origin, axis.direction
    ex = jnp.array([2.5, 0.0, 0.0])
    ez = jnp.array([0.0, 0.0, 2.5])
    return jnp.stack(
        [
            jnp.stack([o, o + d * scale]),
            jnp.stack([o - ex, o + ex]),
            jnp.stack([o - ez, o + ez]),
        ]
    )
