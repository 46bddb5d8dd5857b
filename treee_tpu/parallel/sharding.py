"""Multi-device scaling: point-sharded pipeline over a jax.sharding.Mesh.

The reference is single-process shared-memory (SURVEY.md §2.6: rayon pools +
crossbeam channels; no distributed backend).  Scaling the long axis there means
scaling point count — so the distribution here is data parallelism over
points with small replicated state:

- points are sharded along N across the ``data`` mesh axis; ``shard_points``
  splits whatever order the caller provides, and ``shard_points_morton``
  pre-orders by Morton key on the host (an ingest-side reorder) so each
  shard's contiguous range is spatially compact — the layout that keeps any
  future halo/neighbor traffic local to few devices;
- segmentation's only cross-shard coupling is the band moment grids: each
  device rasterizes its local points, one ``psum`` over NVLink produces the global
  grids, the tracking scan runs replicated (tiny state), and Voronoi assignment
  is local per shard;
- characteristics likewise reduce per-(segment, slice) support maxima with
  ``pmax``;
- rendering composites shards by depth: ``pmin`` on the z-buffer, then a
  winner-takes resolve.

This is the 100M+ point path (BASELINE.md config 5): grid psums are O(B*G^2),
independent of N, so NVLink traffic does not grow with the survey size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import segmentation as seg
from ..config import Config, DEFAULT_CONFIG


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_points(mesh: Mesh, pos, valid, axis: str = "data"):
    """Place padded point arrays with the batch dim sharded over the mesh."""
    sh = NamedSharding(mesh, P(axis))
    return (
        jax.device_put(pos, NamedSharding(mesh, P(axis, None))),
        jax.device_put(valid, sh),
    )


def shard_points_morton(mesh: Mesh, pos, valid, axis: str = "data"):
    """Morton-range sharding: host-side Z-order reorder, then contiguous
    shards.

    Points are sorted once by their Morton key (ops/morton) before upload —
    ingest already passes through the host, so the reorder is one argsort —
    and the contiguous range each device receives is then spatially compact
    (a run of Z-order cells) instead of an arbitrary slice of file order.
    The grid-psum pipeline is layout-agnostic (its collective is O(B*G^2)
    regardless), but compact shards bound each device's touched grid area
    and keep any future halo/neighbor exchange between Morton-adjacent
    devices.  Padding (invalid) rows sort to the end.

    Returns (pos_sharded, valid_sharded, order) where ``order`` maps shard
    row -> original point index (for scattering per-point results back).
    """
    from ..ops import morton

    pos_np = np.asarray(pos)
    valid_np = np.asarray(valid)
    if valid_np.any():
        lo = pos_np[valid_np].min(axis=0)
        hi = pos_np[valid_np].max(axis=0)
    else:
        lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    keys = np.asarray(
        morton.encode_positions(
            jnp.asarray(pos_np), jnp.asarray(lo, jnp.float32),
            jnp.asarray(hi, jnp.float32),
        )
    )
    keys = np.where(valid_np, keys, np.iinfo(np.int32).max)
    order = np.argsort(keys, kind="stable")
    pos_s, valid_s = shard_points(
        mesh, jnp.asarray(pos_np[order]), jnp.asarray(valid_np[order]), axis
    )
    return pos_s, valid_s, order


def _segment_local(pos, valid, d, scfg, axis):
    """Shard-local segmentation body, shared by every sharded step builder
    (ONE copy of the invariant-laden sequence: the all-padding-shard bounds
    guard, the stride-exact anchor histogram, the grid psum — review r4).

    Returns (segment, n_alloc, tracked_pos, tracked_active, overflow).
    """
    # global bounds: local reduce + cross-device min/max.
    # identity-valued local bounds: an all-padding shard must not pull
    # the global box to scene_bounds' (0,1) fallback (seg.scene_bounds_raw)
    lo_l, hi_l = seg.scene_bounds_raw(pos, valid)
    lo = jax.lax.pmin(lo_l, axis)
    hi = jax.lax.pmax(hi_l, axis)
    any_v = jax.lax.pmax(jnp.any(valid).astype(jnp.float32), axis) > 0
    lo, hi = seg.scene_bounds_finalize(lo, hi, any_v)
    s = seg.cell_size(lo, hi, d, scfg)
    # robust band anchor: local strided histogram + psum is EXACTLY the
    # global histogram (shard sizes are multiples of the stride)
    hist = jax.lax.psum(
        seg.anchor_histogram(pos, valid, lo[1], hi[1]), axis
    )
    top = seg.band_anchor(hist, lo[1], hi[1], scfg)
    band, cx, cz = seg.point_cells(pos, valid, lo, hi, s, scfg, top=top)
    cnt = seg.moment_grids(pos, valid, band, cx, cz, scfg)
    # the one big collective: global band count grids over NVLink
    cnt = jax.lax.psum(cnt, axis)
    # replicated tracking scan (identical on every device)
    slot_grids, n_alloc, tracked_pos_b, active_b = seg.band_scan(
        cnt, lo, s, d, scfg)
    # local assignment
    segment = seg.assign_points(slot_grids, band, cx, cz, valid)
    n_occ = jnp.sum((cnt > 0).astype(jnp.int32))
    return (segment, n_alloc, tracked_pos_b, active_b,
            n_occ > scfg.cc_occupied_cap)


def sharded_segment(mesh: Mesh, cfg: Config = DEFAULT_CONFIG, axis: str = "data"):
    """Build the sharded segmentation step: (pos f32[N,3], valid, d) -> ids.

    N must be divisible by the mesh size.  Inside ``shard_map`` each device
    sees its local shard; collectives ride the mesh axis.
    """
    scfg = cfg.segmentation

    def local_step(pos, valid, d):
        segment, n_alloc, _, _, _ = _segment_local(pos, valid, d, scfg, axis)
        return segment, n_alloc

    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P()),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_pipeline_step(mesh: Mesh, cfg: Config = DEFAULT_CONFIG, axis: str = "data"):
    """Full sharded step: segmentation + FULL characteristics + classification.

    This is the multi-chip "training step" shape the driver dry-runs: point
    shards in; collectives are the O(B*G^2) band-grid psum (segmentation) and
    the O(S*MS) support-table pmax (characteristics) — both independent of
    the per-shard point count; per-point outputs stay sharded, the analytics
    table is replicated.
    """
    from .. import characteristics as ch

    scfg = cfg.segmentation

    def local_step(pos, valid, d):
        segment, n_alloc, _, _, _ = _segment_local(pos, valid, d, scfg, axis)
        table, classification = ch.compute_segments(
            pos, segment, valid, scfg.max_segments + 1, cfg.characteristics,
            full_bbox=False, axis_name=axis,
        )
        return segment, classification, n_alloc, table

    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P()),
        out_specs=(P(axis), P(axis), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_session_step(mesh: Mesh, cfg: Config = DEFAULT_CONFIG,
                         axis: str = "data"):
    """:func:`sharded_pipeline_step` + the SegmentationResult extras the
    Session API reports: (pos, valid, d) -> (segment, classification,
    table, SegmentationResult) — the mesh-mode body of Session.segment.

    The tracked-centroid aux fields and the occupied-overflow flag come
    from the replicated band scan / the psum'd global count grids, so they
    match the single-device segment_points exactly.
    """
    from .. import characteristics as ch

    scfg = cfg.segmentation

    def local_step(pos, valid, d):
        segment, n_alloc, tracked_pos_b, active_b, overflow = _segment_local(
            pos, valid, d, scfg, axis)
        table, classification = ch.compute_segments(
            pos, segment, valid, scfg.max_segments + 1, cfg.characteristics,
            full_bbox=False, axis_name=axis,
        )
        return (segment, classification, table, n_alloc, tracked_pos_b,
                active_b, overflow)

    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P()),
        out_specs=(P(axis), P(axis), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    jitted = jax.jit(fn)

    def run(pos, valid, d):
        (segment, classification, table, n_alloc, tracked_pos_b, active_b,
         overflow) = jitted(pos, valid, d)
        res = seg.SegmentationResult(
            segment=segment, n_segments=n_alloc, tracked_pos=tracked_pos_b,
            tracked_active=active_b, occupied_overflow=overflow,
        )
        return segment, classification, table, res

    return run


def sharded_characteristics(mesh: Mesh, cfg: Config = DEFAULT_CONFIG,
                            axis: str = "data", full_bbox: bool = True):
    """Sharded Calculations phase over EXISTING segments: (pos, segment,
    valid) -> (SegmentTable replicated, classification sharded) — the
    mesh-mode body of Session.characteristics (post-edit recompute)."""
    from .. import characteristics as ch

    def local(pos, segment, valid):
        return ch.compute_segments(
            pos, segment, valid, cfg.segmentation.max_segments + 1,
            cfg.characteristics, full_bbox=full_bbox, axis_name=axis,
        )

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=(P(), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_inventory(mesh: Mesh, cfg: Config = DEFAULT_CONFIG,
                      axis: str = "data", method: int = 0,
                      symmetric: bool = False, axis_algo: str = "average",
                      **rbv_kw):
    """Whole-forest inventory over point shards: (pos, segment,
    classification, valid) -> (Traits [S], counts i32[S,3], found bool[S]).

    The batched inventory reductions (trunk_axis.batched_*,
    rbv.batched_split_rbv, Session.inventory's device core) are all
    per-segment scatter tables, so the sharded form is shard-local scatters
    + one collective per table: pmin/pmax for extents and max-method
    distance grids and integer psums for the axis means (all EXACT), float
    psums for mean-method grids (shard order).  Collective volume is
    O(S * slices * sectors), independent of the per-shard point count — same
    scaling shape as the segmentation grid psum.  The per-segment [S]-math (directions,
    frames, trait formulas) then runs replicated.
    """
    from .. import rbv as rbv_mod
    from .. import trunk_axis as ta
    from ..cloud import CLASS_TRUNK
    from ..pipeline import _segment_class_counts

    S = cfg.segmentation.max_segments + 1
    axis_fn = (ta.batched_low_high_layer if axis_algo == "lowhigh"
               else ta.batched_average_direction)

    def local(pos, segment, classification, valid):
        live = valid & (segment > 0) & (segment < S)
        axes = axis_fn(pos, live & (classification == CLASS_TRUNK), segment,
                       S, axis_name=axis)
        tfs = ta.batched_axis_transform(axes)  # replicated [S,4,4]
        crown, trunk = rbv_mod.batched_split_rbv(
            pos, classification, live, segment, S, tfs,
            method=method, symmetric=symmetric, axis_name=axis, **rbv_kw)
        tr = rbv_mod.batched_traits(crown, trunk)
        counts = _segment_class_counts(segment, classification, live, S,
                                       axis_name=axis)
        # axes (origin for stem positions) replicated: Session.inventory's
        # stem_easting/northing key on the trunk-axis origin (change.py)
        return tr, counts, axes.found, axes.origin

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_render(mesh: Mesh, cfg: Config = DEFAULT_CONFIG, axis: str = "data"):
    """Sharded splat frame: (pos, prop, mask, cam, palette) -> f32[H,W,3].

    Each device rasterizes its local point shard into the packed
    (depth << 8 | palette) key image; ONE ``pmin`` over the mesh composites
    depth — exact at the key level, because the z-test is a min over an
    associative integer key (render/splat.rasterize_keys).  Dilation, palette
    and eye-dome then run replicated on the composited [H,W] image
    (O(pixels), independent of N; the float shading may fuse slightly
    differently than the single-device program, see tests).
    The reference has no multi-GPU analogue; its wgpu pass draws every chunk
    on one queue (program.rs:309-311).
    """
    from ..render import splat

    rcfg = cfg.render

    def local_frame(pos, prop, mask, cam, palette):
        kimg = splat.rasterize_keys(pos, prop, mask, cam, rcfg)
        kimg = jax.lax.pmin(kimg, axis)
        color, z01, _ = splat.resolve_keys(kimg, cam, palette, rcfg)
        return splat.eye_dome(color, z01, rcfg)

    fn = jax.shard_map(
        local_frame,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_rasters(mesh: Mesh, pos_s, classification_s, live_s, lo, hi,
                    cell: float, cap: int = 4096, y_offset: float = 0.0,
                    axis: str = "data"):
    """DTM/DSM/CHM over a point-sharded cloud; bit-identical to the
    single-device rasters.compute_rasters.

    Each device scatter-min/maxes its local shard into the full [H, W]
    height grid; ONE ``pmin`` (ground) + ``pmax`` (surface) over NVLink
    composite them — f32 min/max are exact, so the composited sentinel
    grids equal the single-device scatters bit-for-bit.  Hole fill and
    NODATA conversion then run replicated (O(grid), independent of N).
    Returns (grids dict, (rows, cols), cell) like compute_rasters.
    """
    from .. import rasters as rs

    (rows, cols), (ph, pw), cell = rs.grid_dims(lo, hi, cell, cap=cap)
    fn = _sharded_height_fn(mesh, (ph, pw), (rows, cols), axis)
    dtm_raw, dsm_raw = fn(
        pos_s, classification_s, live_s,
        jnp.float32(lo[0]), jnp.float32(lo[2]), jnp.float32(1.0 / cell),
    )
    return (
        rs.finalize_rasters(dtm_raw, dsm_raw, rows, cols, y_offset=y_offset),
        (rows, cols), cell,
    )


# --- sharded interactive path: octree masks + pick (VERDICT r2 task 2) ----
#
# Requires MORTON-RANGE sharding (shard_points_morton): each shard holds a
# contiguous ascending run of Morton keys, so the concatenation of the
# shard-local stable sorts equals the global stable sort restricted to real
# keys (each local sort pushes its own INVALID padding to the shard's end;
# the single-device build pushes all padding to the global end — the mask
# math below counts only real/live slots, so the padding interleave is
# unobservable).  Cross-shard node runs are handled with scalar carries:
# every scan used by the masks is a running max/min/sum of values that are
# MONOTONE in slot order, so a shard's carry folds in with one elementwise
# max/min against the prefix — the same shifted-doubling trick as
# ops/octree._cummax, lifted one level to the mesh.  Each carry is one
# all_gather of a per-shard scalar over NVLink.


def _prev_max(x, axis: str, sentinel):
    """max of scalar ``x`` over shards with LOWER mesh index (else sentinel)."""
    g = jax.lax.all_gather(x, axis)
    i = jax.lax.axis_index(axis)
    return jnp.max(jnp.where(jnp.arange(g.shape[0]) < i, g, sentinel))


def _prev_sum(x, axis: str):
    g = jax.lax.all_gather(x, axis)
    i = jax.lax.axis_index(axis)
    return jnp.sum(jnp.where(jnp.arange(g.shape[0]) < i, g, 0))


def _next_min(x, axis: str, sentinel):
    g = jax.lax.all_gather(x, axis)
    i = jax.lax.axis_index(axis)
    return jnp.min(jnp.where(jnp.arange(g.shape[0]) > i, g, sentinel))


def _local_octree(pos, valid, axis: str):
    """Shard-local linear octree with GLOBAL quantization bounds.

    Mirrors ops/octree.build except the bounding cube reduces over the mesh
    (pmin/pmax), so every shard's Morton keys live on the same grid."""
    from ..ops import morton, octree

    n = pos.shape[0]
    big = jnp.float32(3.0e38)
    lo_l = jnp.min(jnp.where(valid[:, None], pos, big), axis=0)
    hi_l = jnp.max(jnp.where(valid[:, None], pos, -big), axis=0)
    lo = jax.lax.pmin(lo_l, axis)
    hi = jax.lax.pmax(hi_l, axis)
    any_v = jax.lax.pmax(jnp.any(valid).astype(jnp.float32), axis) > 0
    lo = jnp.where(any_v, lo, 0.0)
    hi = jnp.where(any_v, hi, 1.0)
    keys = morton.encode_positions(pos, lo, hi)
    keys = jnp.where(valid, keys, octree.INVALID_KEY)
    keys_sorted, order = morton.sort_by_key(
        keys, jnp.arange(n, dtype=jnp.int32))
    zero = jnp.zeros(n, jnp.int32)
    return octree.Octree(keys=keys_sorted, order=order, rank=zero, inv=zero,
                         lo=lo, hi=hi)


def sharded_octree(mesh: Mesh, axis: str = "data"):
    """Build the shard-local octree pieces ONCE: (pos, valid) ->
    (keys_sorted i32[N] sharded, order i32[N] sharded, lo f32[3], hi f32[3]).

    The tree depends only on positions/validity — edits touch segment and
    classification, never pos — so a Session caches this result across
    brush strokes and feeds it to the ``prebuilt=True`` mask builders
    below instead of re-sorting 15M keys per stroke (VERDICT r3 weak #4:
    sharded_lod_mask rebuilt the local octree per call).
    """

    def local(pos, valid):
        tree = _local_octree(pos, valid, axis)
        return tree.keys, tree.order, tree.lo, tree.hi

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis), P(axis), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _tree_from_pieces(keys, order, lo, hi):
    from ..ops import octree

    zero = jnp.zeros(keys.shape[0], jnp.int32)
    return octree.Octree(keys=keys, order=order, rank=zero, inv=zero,
                         lo=lo, hi=hi)


def sharded_lod_mask(mesh: Mesh, level: int, points_per_node: int = 1,
                     axis: str = "data", use_frustum: bool = False,
                     prebuilt: bool = False):
    """Sharded ops/octree.lod_mask: (pos, valid, live, planes) -> keep mask.

    Bit-exact with the single-device ``lod_mask(build(pos, valid), level,
    points_per_node, live, frustum)`` on the same (Morton-preordered) rows;
    the keep mask comes back in sharded row order.  ``planes`` f32[6,4] is
    ignored unless ``use_frustum``.  With ``prebuilt`` the returned fn
    takes ``(keys, order, lo, hi, live, planes)`` from
    :func:`sharded_octree` instead of re-sorting per call.
    """
    from ..ops import morton, octree

    shift = 3 * (morton.MORTON_BITS - level)
    IBIG = jnp.int32(0x7FFFFFFF)

    def local_tree(tree, live, planes):
        n = tree.keys.shape[0]
        keys_sorted, order = tree.keys, tree.order
        real = keys_sorted != octree.INVALID_KEY
        coarse = keys_sorted >> shift
        live_sorted = live[order] & real
        if use_frustum:
            lo_c, hi_c = octree._cell_bounds(tree, coarse, level)
            live_sorted &= octree.aabb_in_frustum(lo_c, hi_c, planes)

        # cross-shard carries (all monotone in global slot order)
        last_real_key = jnp.max(jnp.where(real, keys_sorted, -1))
        prev_real_coarse = _prev_max(last_real_key, axis, jnp.int32(-1)) >> shift
        first_real_key = jnp.min(jnp.where(real, keys_sorted, IBIG))
        next_real_coarse = _next_min(first_real_key, axis, IBIG) >> shift

        # global live cumsum: local + sum of earlier shards
        cum_local = jnp.cumsum(live_sorted.astype(jnp.int32))
        cum = cum_local + _prev_sum(cum_local[-1], axis)

        # node starts among REAL slots only (padding must not poison the
        # forward carry; single-device padding sits at the global end)
        new_node = real & jnp.concatenate([
            (coarse[:1] != prev_real_coarse),
            coarse[1:] != coarse[:-1],
        ])
        start_vals = jnp.where(new_node, cum - live_sorted, 0)
        start_local = octree._cummax(start_vals)
        start_excl = jnp.maximum(
            start_local, _prev_max(start_local[-1], axis, jnp.int32(0)))

        # node ends among REAL slots: the shard's last real slot compares
        # against the NEXT shard's first real coarse (its local neighbor is
        # padding, which would falsely end a node that spans shards)
        n_real = jnp.sum(real.astype(jnp.int32))
        next_c = jnp.concatenate([coarse[1:], jnp.full((1,), IBIG)])
        next_c = jnp.where(
            jnp.arange(n) == n_real - 1, next_real_coarse, next_c)
        is_end = real & (next_c != coarse)
        end_local = octree._revcummin(jnp.where(is_end, cum, IBIG))
        end_incl = jnp.minimum(end_local, _next_min(end_local[0], axis, IBIG))

        rank = cum - 1 - start_excl
        count = end_incl - start_excl
        stride = jnp.maximum(
            (count + points_per_node - 1) // points_per_node, 1)
        keep_sorted = live_sorted & (rank % stride == 0)
        return jnp.zeros(n, bool).at[order].set(keep_sorted)

    if prebuilt:
        def local_pre(keys, order, lo, hi, live, planes):
            return local_tree(_tree_from_pieces(keys, order, lo, hi),
                              live, planes)

        fn = jax.shard_map(
            local_pre, mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P(), P(axis), P()),
            out_specs=P(axis),
            check_vma=False,
        )
        return jax.jit(fn)

    def local(pos, valid, live, planes):
        return local_tree(_local_octree(pos, valid, axis), live, planes)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)


def _adaptive_keeps(tree, live_sorted, cam_pos, px_scale, taus,
                    level_min, level_max, planes, use_frustum, axis):
    """Shared body of the sharded adaptive mask/counts: cross-shard
    prev-live-key carry + per-level ring/first-live keeps, one bool[n]
    mask per tau (ONE copy of the shard-boundary trap handling)."""
    from ..ops import octree

    n = tree.keys.shape[0]
    keys_sorted = tree.keys
    last_live_key = jnp.max(jnp.where(live_sorted, keys_sorted, -1))
    carry = _prev_max(last_live_key, axis, jnp.int32(-1))
    run_key = jnp.maximum(
        octree._cummax(jnp.where(live_sorted, keys_sorted, -1)), carry)
    prev_key = jnp.concatenate([carry[None], run_key[:-1]])
    ps = jnp.asarray(px_scale, jnp.float32)
    keeps = [jnp.zeros(n, bool) for _ in taus]
    for lvl in range(level_min, level_max + 1):
        shift, coarse, lo_c, hi_c, proj = octree._level_proj(
            tree, lvl, cam_pos, ps)
        in_frustum = (octree.aabb_in_frustum(lo_c, hi_c, planes)
                      if use_frustum else None)
        first_live = live_sorted & ((prev_key >> shift) < coarse)
        for k, tau in enumerate(taus):
            ring, near_all = octree._level_ring(
                proj, tau, lvl, level_min, level_max)
            if near_all is None:
                near_all = jnp.zeros(n, bool)
            sel = live_sorted & ring
            if in_frustum is not None:
                sel &= in_frustum
            keeps[k] |= sel & (near_all | first_live)
    return keeps


def sharded_adaptive_mask(mesh: Mesh, px_scale: float, tau_px: float = 1.5,
                          level_min: int = 4, level_max: int = 10,
                          axis: str = "data", use_frustum: bool = False,
                          prebuilt: bool = False):
    """Sharded ops/octree.adaptive_mask: (pos, valid, live, cam_pos, planes)
    -> keep mask, bit-exact with the single-device screen-error cut on the
    same Morton-preordered rows.

    The only scan is the previous-live-key running max; its carry is the
    last live key of the earlier shards (keys ascend across Morton-range
    shards).  Everything else is elementwise per slot.
    """
    from ..ops import octree

    def local_tree(tree, live, cam_pos, planes):
        n = tree.keys.shape[0]
        order = tree.order
        live_sorted = live[order] & (tree.keys != octree.INVALID_KEY)
        (keep_sorted,) = _adaptive_keeps(
            tree, live_sorted, cam_pos, px_scale, (tau_px,), level_min,
            level_max, planes, use_frustum, axis)
        return jnp.zeros(n, bool).at[order].set(keep_sorted)

    if prebuilt:
        def local_pre(keys, order, lo, hi, live, cam_pos, planes):
            return local_tree(_tree_from_pieces(keys, order, lo, hi),
                              live, cam_pos, planes)

        fn = jax.shard_map(
            local_pre, mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P(), P(axis), P(), P()),
            out_specs=P(axis),
            check_vma=False,
        )
        return jax.jit(fn)

    def local(pos, valid, live, cam_pos, planes):
        return local_tree(_local_octree(pos, valid, axis), live, cam_pos,
                          planes)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_adaptive_counts(mesh: Mesh, px_scale: float,
                            taus: tuple[float, ...],
                            level_min: int = 4, level_max: int = 10,
                            axis: str = "data", use_frustum: bool = False):
    """Sharded ops/octree.adaptive_counts: the whole tau LADDER's keep
    counts in one pass over the prebuilt sharded octree —
    (keys, order, lo, hi, live, cam_pos, planes) -> i32[len(taus)]
    replicated, equal to summing :func:`sharded_adaptive_mask` per tau.
    Powers Session.solve_adaptive_tau(budget_rows=...) in mesh mode
    without materializing a full single-device tree (review r4).
    """
    from ..ops import octree

    def local(keys, order, lo, hi, live, cam_pos, planes):
        tree = _tree_from_pieces(keys, order, lo, hi)
        live_sorted = live[order] & (keys != octree.INVALID_KEY)
        keeps = _adaptive_keeps(tree, live_sorted, cam_pos, px_scale, taus,
                                level_min, level_max, planes, use_frustum,
                                axis)
        counts = jnp.stack([jnp.sum(k.astype(jnp.int32)) for k in keeps])
        return jax.lax.psum(counts, axis)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_pick(mesh: Mesh, axis: str = "data",
                 include_deleted: bool = False):
    """Sharded interactive.pick: local ray test + two pmin composites.

    (pos, segment, valid, origin, direction, point_scale) ->
    (segment id, along-ray distance, hit?) replicated — identical winner to
    the single-device pick (ties break to the lowest global row, matching
    argmin's first-match rule).
    """
    from ..cloud import DELETED_SEGMENT
    from ..interactive import INF

    IBIG = jnp.int32(0x7FFFFFFF)

    def local(pos, segment, valid, origin, direction, point_scale):
        n = pos.shape[0]
        eligible = valid
        if not include_deleted:
            eligible &= segment != DELETED_SEGMENT
        diff = pos - origin
        along = jnp.dot(diff, direction,
                        precision=jax.lax.Precision.HIGHEST)
        perp2 = jnp.sum(diff * diff, axis=-1) - along * along
        ok = eligible & (along >= 0.0) & (perp2 <= point_scale * point_scale)
        dist = jnp.where(ok, along, INF)
        best = jnp.argmin(dist)
        best_dist = dist[best]
        gmin = jax.lax.pmin(best_dist, axis)
        my_row = jax.lax.axis_index(axis) * n + best
        gidx = jax.lax.pmin(
            jnp.where(best_dist == gmin, my_row.astype(jnp.int32), IBIG),
            axis)
        seg_best = jax.lax.pmin(
            jnp.where(my_row.astype(jnp.int32) == gidx, segment[best], IBIG),
            axis)
        found = gmin < INF
        seg = jnp.where(found, seg_best, -1)
        return seg, gmin, found

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(), P(), P()),
        out_specs=(P(), P(), P()),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _sharded_height_fn(mesh: Mesh, shape, live_dims, axis: str):
    """Jitted pmin/pmax height-grid compositor, cached per (mesh, grid) so
    repeated exports at the same cell size reuse the executable (grid
    origin and scale stay traced arguments)."""
    from .. import rasters as rs
    from ..cloud import CLASS_GROUND

    def local(pos, cls, live, lo_x, lo_z, inv_cell):
        ground = live & (cls == CLASS_GROUND)
        dtm, dsm = rs.height_grids(
            pos, ground, live, lo_x, lo_z, inv_cell, shape, live_dims
        )
        return jax.lax.pmin(dtm, axis), jax.lax.pmax(dsm, axis)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)
