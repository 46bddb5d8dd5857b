"""Per-segment characteristics, batched over every segment at once.

Capability parity with the reference Calculations phase
(treee/src/calculations.rs), which iterates segments with rayon and, per segment,
bins points into 0.1 m height slices, grows a convex polygon per slice to get
slice areas (calculations.rs:430-452), derives ground/crown separator heights
from the area profile (:201-267), classifies points (:150-163), and later
computes per-point expansion/height/curvature properties (:269-376).

The array redesign runs ALL segments in one fused pass over fixed [S, MS] tables:

- *Sorted, scatter-free reduction*: one lexicographic ``lax.sort`` by
  (segment, y) makes every (segment, slice) bucket a contiguous run; per-bucket
  support maxima and bboxes then come from log-depth segmented doubling scans +
  a ``searchsorted`` table extraction: one sort in place of ~11 scatter
  passes over [N] operand columns (whether that trade still wins on the GPU
  is an open question in PERF.md).
- *Slice areas*: each point scores K support directions (one [N,2]x[2,K]
  product); the per-bucket max scores define half-planes whose intersection
  polygon's shoelace area approximates the hull area (exact up to the K-gon
  circumscription error, ~2.6% for K=16 on a disk).
- *Separators*: the reference's sequential find-first scans over the area
  profile become masked argmax-of-boolean reductions over [S, MS].
- *Classification and properties*: pure per-point gathers from the tables.

Curvature stays on demand per segment (the reference computes it only for the
viewed segment, calculations.rs:328-373) via the neighbors engine.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from .cloud import CLASS_CROWN, CLASS_GROUND, CLASS_TRUNK
from .config import CharacteristicsConfig
from .ops import eigen, neighbors
from .utils import struct

INF = jnp.float32(3.0e38)


class SegmentTable(struct.PyTreeNode):
    """Per-segment analytics, indexed by segment id (row 0 = deleted/unused).

    Mirrors SegmentData/SegmentInformation (calculations.rs:35-43,191-197).
    """

    present: jax.Array       # bool[S]
    count: jax.Array         # i32[S]
    lo: jax.Array            # f32[S,3]
    hi: jax.Array            # f32[S,3]
    areas: jax.Array         # f32[S,MS] slice convex areas
    n_slices: jax.Array      # i32[S]
    ground_sep: jax.Array    # f32[S] absolute y of ground/trunk split
    crown_sep: jax.Array     # f32[S] absolute y of trunk/crown split
    trunk_height: jax.Array  # f32[S]
    crown_height: jax.Array  # f32[S]


def _support_directions(k: int) -> jax.Array:
    ang = jnp.arange(k, dtype=jnp.float32) * (2.0 * math.pi / k)
    return jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=0)  # [2, K]


def _areas_from_supports(s: jax.Array, k_dirs: int) -> jax.Array:
    """Convex area from per-direction support values s f32[B,K].

    The hull is approximated by the circumscribed polygon cut by the
    half-planes {x . u_k <= s_k}; its vertices are adjacent boundary-line
    intersections (a 2x2 solve, pure elementwise) and the shoelace formula
    gives the area.  Buckets with no points (s = -INF) get 0.
    """
    dirs = _support_directions(k_dirs)
    ux, uz = dirs[0], dirs[1]                            # [K]
    nx_, nz_ = jnp.roll(ux, -1), jnp.roll(uz, -1)
    s_next = jnp.roll(s, -1, axis=1)
    det = ux * nz_ - uz * nx_                            # sin(2*pi/K), constant
    vx = (s * nz_[None, :] - s_next * uz[None, :]) / det[None, :]
    vz = (ux[None, :] * s_next - nx_[None, :] * s) / det[None, :]

    wx = jnp.roll(vx, -1, axis=1)
    wz = jnp.roll(vz, -1, axis=1)
    area = 0.5 * jnp.abs(jnp.sum(vx * wz - wx * vz, axis=1))
    has_any = s[:, 0] > -INF
    return jnp.where(has_any, area, 0.0)


_SCAN_BLOCK = 256  # log2 = 8 in-block passes


def _segmented_cummax(key: jax.Array, val: jax.Array) -> jax.Array:
    """Forward inclusive per-run cumulative max of ``val`` f32[N] or f32[N,K].

    ``key`` i32[N] must be sorted (equal values contiguous).  Two-level form:
    shifted-doubling passes within 256-element blocks (log2(256)=8 passes over
    the full array instead of log2(N)=24 — the passes are the dominant cost at
    15M points), then a tiny cross-block carry scan on per-block summaries
    (``lax.associative_scan`` is safe at N/256 elements; at full N it blows up
    XLA compile time, see ops/octree._cummax) whose result is applied to each
    block's leading run.  Keys being sorted makes "leading run" simply the
    cells equal to the block's first key.  After this every element holds the
    max over its run's prefix, so each run's LAST element holds the run max.
    """
    n = key.shape[0]
    blk = _SCAN_BLOCK
    if n <= blk:
        idx = jnp.arange(n, dtype=jnp.int32)
        s = 1
        while s < n:
            ok = (idx >= s) & (key == jnp.roll(key, s))
            cand = jnp.roll(val, s, axis=0)
            ok_b = ok[:, None] if val.ndim == 2 else ok
            val = jnp.maximum(val, jnp.where(ok_b, cand, -INF))
            s *= 2
        return val

    nb = -(-n // blk)
    pad = nb * blk - n
    kmax = jnp.iinfo(jnp.int32).max
    kp = jnp.pad(key, (0, pad), constant_values=kmax)
    vp = jnp.pad(
        val, ((0, pad),) + ((0, 0),) * (val.ndim - 1), constant_values=-INF
    )
    kb = kp.reshape(nb, blk)
    vb = vp.reshape((nb, blk) + vp.shape[1:])

    idx = jnp.arange(blk, dtype=jnp.int32)[None, :]
    s = 1
    while s < blk:
        ok = (idx >= s) & (kb == jnp.roll(kb, s, axis=1))
        cand = jnp.roll(vb, s, axis=1)
        ok_b = ok[..., None] if vb.ndim == 3 else ok
        vb = jnp.maximum(vb, jnp.where(ok_b, cand, -INF))
        s *= 2

    # per-block summary: (max of the run containing the block's last element,
    # first key, last key, does that run reach the block's start)
    kf, kl = kb[:, 0], kb[:, -1]
    v_last = vb[:, -1]
    reach = kf == kl

    def comb(a, b):
        av, akf, akl, ar = a
        bv, bkf, bkl, br = b
        connect = (akl == bkf) & br
        cb = connect[..., None] if bv.ndim > connect.ndim else connect
        return (
            jnp.where(cb, jnp.maximum(av, bv), bv),
            akf,
            bkl,
            connect & ar,
        )

    sv, _, skl, _ = jax.lax.associative_scan(comb, (v_last, kf, kl, reach))
    prev_v = jnp.concatenate([jnp.full_like(sv[:1], -INF), sv[:-1]])
    prev_kl = jnp.concatenate([jnp.full_like(skl[:1], kmax), skl[:-1]])
    conn = prev_kl == kf
    cb = conn[..., None] if sv.ndim == 2 else conn
    carry = jnp.where(cb, prev_v, -INF)

    lead = kb == kf[:, None]  # sorted keys: leading run = cells == first key
    lb = lead[..., None] if vb.ndim == 3 else lead
    vb = jnp.where(lb, jnp.maximum(vb, carry[:, None]), vb)
    return vb.reshape((nb * blk,) + vb.shape[2:])[:n]


def _run_end_index(
    key_sorted: jax.Array, n_buckets: int, stride: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """(idx, hit): run-END sorted slot per bucket, from one searchsorted.

    ``searchsorted(side=right) - 1`` lands on each bucket's run END, where a
    segmented cummax holds the full run max; absent buckets miss the equality
    check.  Computed ONCE and reused across column chunks of the same key
    array.

    With ``stride`` (keys grouped as group*stride + sub, e.g. segment*MS +
    slice), a two-level search replaces the flat one: a coarse searchsorted
    of the few-thousand group boundaries seeds every bucket query's
    bisection window, and a while_loop stops as soon as all windows close —
    log2(longest group run) data-adaptive rounds instead of the flat
    log2(N) = 24 lockstep rounds.  Bit-identical to the flat search
    (tools/probe_ss.py: equal outputs, 41.6 vs 49.3 ms at 15M/262k).
    """
    n = key_sorted.shape[0]
    q = jnp.arange(n_buckets, dtype=key_sorted.dtype)
    if n == 0:
        return jnp.zeros(n_buckets, jnp.int32), jnp.zeros(n_buckets, bool)
    if stride is None or n_buckets % stride != 0:
        idx = jnp.searchsorted(
            key_sorted, q, side="right", method="scan_unrolled"
        ).astype(jnp.int32) - 1
    else:
        ng = n_buckets // stride
        coarse = jnp.searchsorted(
            key_sorted,
            jnp.arange(ng + 1, dtype=key_sorted.dtype) * stride,
            side="left", method="scan_unrolled",
        ).astype(jnp.int32)
        gq = q // stride
        lo0, hi0 = coarse[gq], coarse[gq + 1]

        def cond(c):
            lo, hi = c
            return jnp.any(lo < hi)

        def body(c):
            lo, hi = c
            mid = (lo + hi) >> 1
            le = key_sorted[mid] <= q
            return jnp.where(le, mid + 1, lo), jnp.where(le, hi, mid)

        lo, _ = jax.lax.while_loop(cond, body, (lo0, hi0))
        idx = lo - 1
    idx = jnp.clip(idx, 0, n - 1)
    hit = key_sorted[idx] == q
    return idx, hit


def _run_last_table(
    key_sorted: jax.Array, val_cum: jax.Array, n_buckets: int, fill,
    stride: int | None = None,
) -> jax.Array:
    """table[b] = run max for bucket b, from the cummax'd sorted values.

    One row gather of [n_buckets, C]; n_buckets = S*MS is N-independent."""
    idx, hit = _run_end_index(key_sorted, n_buckets, stride)
    v = val_cum[idx]
    hit_b = hit[:, None] if v.ndim == 2 else hit
    return jnp.where(hit_b, v, fill)


def _chunked_support_table(
    bucket_s: jax.Array,
    make_scores,
    n_cols: int,
    cfg,
    n_buckets: int,
    stride: int | None = None,
) -> jax.Array:
    """Per-bucket support maxima f32[n_buckets, n_cols], column-chunked.

    ``make_scores(c0, c1)`` materializes score columns [N, c1-c0].  Peak
    memory of the characteristics phase scales with the widest live score
    buffer; chunking divides that by K/chunk at identical total pass work.  The run-end searchsorted is shared across chunks.
    """
    chunk = cfg.score_chunk
    if chunk <= 0 or chunk >= n_cols:
        cum = _segmented_cummax(bucket_s, make_scores(0, n_cols))
        return _run_last_table(bucket_s, cum, n_buckets, -INF, stride)
    idx, hit = _run_end_index(bucket_s, n_buckets, stride)
    tabs = []
    for c0 in range(0, n_cols, chunk):
        c1 = min(c0 + chunk, n_cols)
        cum = _segmented_cummax(bucket_s, make_scores(c0, c1))
        tabs.append(jnp.where(hit[:, None], cum[idx], -INF))
    return jnp.concatenate(tabs, axis=1)


def slice_areas(
    xz: jax.Array,          # f32[N,2]
    bucket: jax.Array,      # i32[N] flat (segment*MS + slice), >= S*MS to drop
    include: jax.Array,     # bool[N]
    n_buckets: int,
    k_dirs: int,
) -> jax.Array:
    """Convex area per bucket via K support half-planes + shoelace.

    Replaces per-slice convex polygon growth (calculations.rs:430-452,
    segmenting.rs:526-545 centroid/area).  One [N,2]x[2,K] product scores
    every point against K angularly ordered directions; one scatter-max per
    bucket yields the support values s_k; the bucket's hull is approximated by
    the circumscribed polygon cut by the half-planes {x . u_k <= s_k}, whose
    vertices are adjacent boundary-line intersections (a 2x2 solve, pure
    elementwise) — +1.3% area bias on a disk at K=16, and only ONE colliding
    scatter pass over the N*K scores (the support-POINT variant needs three).
    Returns f32[n_buckets].
    """
    dirs = _support_directions(k_dirs)                   # [2,K]
    # HIGHEST: the support maxima feed hull areas and the separators, and
    # the GPU would otherwise round the product to TF32
    scores = jnp.dot(xz, dirs, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)  # [N,K]
    tgt = jnp.where(include, bucket, n_buckets)
    s = jnp.full((n_buckets + 1, k_dirs), -INF).at[tgt].max(scores)[:n_buckets]
    return _areas_from_supports(s, k_dirs)


def _find_first(cond: jax.Array) -> tuple[jax.Array, jax.Array]:
    """First True index along axis 1 of [S,MS]; (idx, found)."""
    found = jnp.any(cond, axis=1)
    return jnp.argmax(cond, axis=1).astype(jnp.int32), found


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_segments", "full_bbox", "axis_name")
)
def compute_segments(
    pos: jax.Array,
    segment: jax.Array,
    valid: jax.Array,
    num_segments: int,
    cfg: CharacteristicsConfig = CharacteristicsConfig(),
    full_bbox: bool = True,
    axis_name: str | None = None,
) -> tuple[SegmentTable, jax.Array]:
    """Characteristics for every segment + per-point classification.

    Args:
      pos: f32[N,3] y-up; segment: i32[N] ids in [0, num_segments);
      valid: bool[N]; id 0 is the deleted bucket and gets no analytics.
      full_bbox: when False, only the y extent is reduced (4 fewer 15M-point
        scatter passes); the fused benchmark pipeline needs only y, the
        interactive session recomputes full boxes on demand.
      axis_name: when set (inside ``shard_map`` over a point-sharded mesh),
        per-segment reductions merge across devices: scene y bounds and
        per-segment y extents via pmin/pmax, counts via psum, and the
        per-(segment, slice) support table via ONE pmax of [S*MS, K(+4)] —
        separators then compute replicated and classification stays local.
        The collectives are O(S*MS), independent of the shard's point count.
    Returns:
      (SegmentTable with S=num_segments rows, classification i32[N]).
    """
    s_cap = num_segments
    ms = cfg.max_slices
    sw = cfg.slice_width
    n = pos.shape[0]
    k_dirs = cfg.hull_directions

    live0 = valid & (segment > 0) & (segment < s_cap)
    seg = jnp.where(live0, segment, 0)  # original-order ids (0 = dump row)

    # --- ONE sort by a packed (segment | quantized-y) i32 key: every
    # (segment, slice) bucket becomes a contiguous ascending run, making all
    # per-segment and per-bucket reductions scatter-free (module docstring).
    # Packing beats a 2-key lexicographic sort (~140 ms vs ~250 ms at 15M);
    # 19 y-bits resolve ~0.03 mm on a 16 m tree — far below the 0.1 m slice
    # width the y values feed (the exact y is only ever compared against
    # separators in original order below). ---
    # adaptive y-quantization bits: the packed key (segment << qbits | qy)
    # must stay in positive int32 (max key = (s_cap << qbits) | qmax < 2^31
    # requires s_cap < 2^(31-qbits)), so huge segment capacities trade y
    # resolution.  The 12-bit floor keeps quantization at <= yext/4095 —
    # well under the 0.1 m slice width for any realistic scene height — and
    # bounds capacity at 2^19 segments; the [S,MS] bucket space must also
    # fit int32.
    qbits = min(19, 31 - max(s_cap.bit_length(), 1))
    if qbits < 12 or s_cap * ms >= 2**31:
        raise ValueError(
            f"num_segments={num_segments} (max_slices={ms}) exceeds the "
            "packed int32 key space; supported capacity is < 2^19 segments"
        )
    qmax = (1 << qbits) - 1
    y = pos[:, 1]
    any_valid = jnp.any(valid)
    ylo = jnp.where(any_valid, jnp.min(jnp.where(valid, y, INF)), 0.0)
    yhi = jnp.where(any_valid, jnp.max(jnp.where(valid, y, -INF)), 1.0)
    if axis_name is not None:
        # global quantization grid so slice buckets align across shards
        ylo = jax.lax.pmin(ylo, axis_name)
        yhi = jax.lax.pmax(yhi, axis_name)
    yext = jnp.maximum(yhi - ylo, 1e-6)
    qy = jnp.clip(((y - ylo) * (qmax / yext)).astype(jnp.int32), 0, qmax)
    key = (jnp.where(live0, segment, s_cap).astype(jnp.int32) << qbits) | qy
    # is_stable=False: a stable sort costs more, and everything downstream
    # is tie-order independent: y_s/run boundaries come from the KEYS
    # (identical either way), and x_s/z_s only ever feed per-run MAXIMA
    # (support scans gathered at run ends) — commutative reductions.
    key_s, x_s, z_s = jax.lax.sort((key, pos[:, 0], pos[:, 2]), num_keys=1,
                                   is_stable=False)
    seg_s = key_s >> qbits
    y_s = ylo + (key_s & qmax).astype(jnp.float32) * (yext / qmax)
    live_s = seg_s < s_cap

    # --- per-segment count + y extent from run boundaries
    # (calculations.rs:136-147) ---
    # ONE searchsorted of S+1 queries: right[s] == left[s+1] by construction
    # (the segment-s run ends exactly where the segment-(s+1) run begins in
    # the packed key space), so the second S-query pass is redundant
    qs1 = jnp.arange(s_cap + 1, dtype=jnp.int32)
    bounds = jnp.searchsorted(
        key_s, qs1 << qbits, side="left", method="scan_unrolled"
    ).astype(jnp.int32)
    left = bounds[:s_cap]
    right = bounds[1:]
    count = right - left
    min_y_raw = jnp.where(count > 0, y_s[jnp.clip(left, 0, n - 1)], INF)
    max_y_raw = jnp.where(count > 0, y_s[jnp.clip(right - 1, 0, n - 1)], -INF)
    if axis_name is not None:
        count = jax.lax.psum(count, axis_name)
        min_y_raw = jax.lax.pmin(min_y_raw, axis_name)
        max_y_raw = jax.lax.pmax(max_y_raw, axis_name)
    present = count > 0
    min_y = jnp.where(present, min_y_raw, 0.0)
    max_y = jnp.where(present, max_y_raw, 0.0)

    # --- per-point slice bucket relative to the segment's min y ---
    if axis_name is None:
        # broadcast min y down each run by a fill-from-run-start segmented
        # scan (cheaper than an N-lookup gather)
        is_start = jnp.concatenate([jnp.ones(1, bool), seg_s[1:] != seg_s[:-1]])
        min_y_pt = _segmented_cummax(seg_s, jnp.where(is_start, y_s, -INF))
    else:
        # sharded: the global min may live on another shard; read the merged
        # table (s_cap is tiny and replicated)
        min_y_pt = jnp.append(min_y, 0.0)[jnp.clip(seg_s, 0, s_cap)]
    slice_s = jnp.clip(
        jnp.floor((y_s - min_y_pt) / sw).astype(jnp.int32), 0, ms - 1
    )
    bucket_s = jnp.where(live_s, seg_s * ms + slice_s, s_cap * ms)

    # --- slice-area supports (+ x/z extents when full_bbox) in segmented
    # scans keyed by bucket, COLUMN-CHUNKED for peak memory (30M-point
    # headroom); bucket runs are sub-runs of segment runs, so segment-level
    # x/z extents reduce from the bucket table afterwards
    # (calculations.rs:218, :136-147) ---
    xz_s = jnp.stack([x_s, z_s], axis=-1)
    dirs = _support_directions(k_dirs)
    n_cols = k_dirs + (4 if full_bbox else 0)

    def make_scores(c0, c1):
        # elementwise broadcast FMA rather than a [N,2]x[2,K] gemm: identical
        # bandwidth (the pass is memory-bound), and bit-identical results for
        # any column chunking (gemm associativity varies with the K shape)
        cols = []
        if c0 < k_dirs:
            d = dirs[:, c0:min(c1, k_dirs)]
            cols.append(xz_s[:, :1] * d[0][None, :] + xz_s[:, 1:] * d[1][None, :])
        if c1 > k_dirs:
            ext = jnp.concatenate([xz_s, -xz_s], axis=1)
            cols.append(ext[:, max(c0 - k_dirs, 0):c1 - k_dirs])
        sc = cols[0] if len(cols) == 1 else jnp.concatenate(cols, axis=1)
        return jnp.where(live_s[:, None], sc, -INF)

    tab = _chunked_support_table(
        bucket_s, make_scores, n_cols, cfg, s_cap * ms, stride=ms
    )
    if axis_name is not None:
        tab = jax.lax.pmax(tab, axis_name)  # the one big collective, O(S*MS)
    areas = _areas_from_supports(tab[:, :k_dirs], k_dirs).reshape(s_cap, ms)

    if full_bbox:
        ext = jnp.max(tab[:, k_dirs:].reshape(s_cap, ms, 4), axis=1)
        lo = jnp.stack([-ext[:, 2], min_y, -ext[:, 3]], axis=-1)
        hi = jnp.stack([ext[:, 0], max_y, ext[:, 1]], axis=-1)
    else:
        zero = jnp.zeros(s_cap, jnp.float32)
        lo = jnp.stack([zero, min_y, zero], axis=-1)
        hi = jnp.stack([zero, max_y, zero], axis=-1)
    lo = jnp.where(present[:, None], lo, 0.0)
    hi = jnp.where(present[:, None], hi, 0.0)

    height = max_y - min_y
    n_slices = jnp.clip((height / sw).astype(jnp.int32) + 1, 1, ms)

    # --- separators (calculations.rs:219-259) ---
    sl = jnp.arange(ms, dtype=jnp.int32)[None, :]
    in_range = sl < n_slices[:, None]

    # min_area: min of areas over slices [1m, 11m), floored at 0.5
    lo_i = int(1.0 / sw)
    hi_i = lo_i + int(10.0 / sw)
    m = in_range & (sl >= lo_i) & (sl < hi_i)
    min_area = jnp.min(jnp.where(m, areas, INF), axis=1)
    min_area = jnp.where(jnp.any(m, axis=1), min_area, 0.5)
    min_area = jnp.maximum(min_area, cfg.min_area_floor)

    thresh = min_area * cfg.ground_min_area_scale
    # ground: first slice below 1m whose area exceeds the threshold
    g_lim = int(cfg.ground_max_search_height / sw)
    ground_idx, ground_found = _find_first(
        in_range & (sl < g_lim) & (areas > thresh[:, None])
    )
    # ground_sep: first slice after `ground` (within the lower half) whose area
    # drops back below the threshold; 0 if none
    half = n_slices[:, None] // 2
    gs_idx, gs_found = _find_first(
        (sl >= ground_idx[:, None]) & (sl < half) & (areas < thresh[:, None])
    )
    ground_sep_idx = jnp.where(ground_found & gs_found, gs_idx, 0)

    # crown_sep: first slice at/above ground_sep with area > pi*(min_d/2)^2
    min_crown_area = math.pi * (cfg.min_crown_diameter / 2.0) ** 2
    cs_idx, cs_found = _find_first(
        in_range & (sl >= ground_sep_idx[:, None]) & (areas > min_crown_area)
    )
    crown_sep_idx = jnp.where(cs_found, cs_idx, 0)

    ground_sep = min_y + ground_sep_idx.astype(jnp.float32) * sw
    crown_sep = min_y + crown_sep_idx.astype(jnp.float32) * sw

    table = SegmentTable(
        present=present,
        count=count,
        lo=lo,
        hi=hi,
        areas=areas,
        n_slices=n_slices,
        ground_sep=ground_sep,
        crown_sep=crown_sep,
        trunk_height=jnp.where(present, crown_sep - ground_sep, 0.0),
        crown_height=jnp.where(present, hi[:, 1] - crown_sep, 0.0),
    )

    # --- classification (calculations.rs:150-163); both separators ride ONE
    # [N] gather of a PACKED i32 (16+16-bit quantized seps), one dense [N]
    # column instead of an [N,2] gather output.  Quantization (yext/65535 <= ~1 mm) only moves the
    # class boundary for points within that distance of a separator. ---
    qsc = 65535.0 / yext
    qg = jnp.clip(((ground_sep - ylo) * qsc).astype(jnp.int32), 0, 65535)
    qc = jnp.clip(((crown_sep - ylo) * qsc).astype(jnp.int32), 0, 65535)
    packed = ((qg << 16) | qc)[seg]
    # mask after the ARITHMETIC >>: qg >= 32768 makes packed negative in
    # int32 and the shift sign-extends (gs would come back ~ground_sep-yext
    # for any separator above the scene's y midpoint)
    gs = ylo + ((packed >> 16) & 0xFFFF).astype(jnp.float32) * (yext / 65535.0)
    cs = ylo + (packed & 0xFFFF).astype(jnp.float32) * (yext / 65535.0)
    classification = jnp.where(
        y < gs,
        CLASS_GROUND,
        jnp.where(y < cs, CLASS_TRUNK, CLASS_CROWN),
    ).astype(jnp.int32)
    classification = jnp.where(live0, classification, CLASS_GROUND)
    return table, classification


@jax.jit
def update_separators_from_classes(
    pos: jax.Array,
    segment: jax.Array,
    valid: jax.Array,
    classification: jax.Array,
    table: SegmentTable,
    segment_id: jax.Array | int,
) -> SegmentTable:
    """Re-derive one segment's separators from its EDITED classification.

    The reference recomputes ground_sep/crown_sep from the per-class y extents
    after every brush stroke in the focused view (SegmentData::changed,
    interactive/mod.rs:182-221): ground_sep = lowest Trunk point, crown_sep =
    lowest Crown point, trunk/crown heights = the class extents.  This is how
    "change the trunk/crown starting height" by brushing works; re-running the
    area-profile pass would silently overwrite the user's intent.  Also
    refreshes the segment's y bbox row like ``changed`` does.
    """
    member = valid & (segment == segment_id)
    y = pos[:, 1]
    sid = jnp.asarray(segment_id)

    def extent(m):
        has = jnp.any(m)
        mn = jnp.min(jnp.where(m, y, INF))
        mx = jnp.max(jnp.where(m, y, -INF))
        return has, jnp.where(has, mn, 0.0), jnp.where(has, mx, 0.0)

    has_t, t_min, t_max = extent(member & (classification == CLASS_TRUNK))
    has_c, c_min, c_max = extent(member & (classification == CLASS_CROWN))
    has_m, m_min, m_max = extent(member)

    ground_sep = jnp.where(has_t, t_min, table.ground_sep[sid])
    crown_sep = jnp.where(has_c, c_min, table.crown_sep[sid])
    trunk_height = jnp.where(has_t, t_max - t_min, 0.0)
    crown_height = jnp.where(has_c, c_max - c_min, 0.0)
    count = jnp.sum(member.astype(jnp.int32))
    lo_y = jnp.where(has_m, m_min, table.lo[sid, 1])
    hi_y = jnp.where(has_m, m_max, table.hi[sid, 1])
    return table.replace(
        ground_sep=table.ground_sep.at[sid].set(ground_sep),
        crown_sep=table.crown_sep.at[sid].set(crown_sep),
        trunk_height=table.trunk_height.at[sid].set(trunk_height),
        crown_height=table.crown_height.at[sid].set(crown_height),
        count=table.count.at[sid].set(count),
        present=table.present.at[sid].set(count > 0),
        lo=table.lo.at[sid, 1].set(lo_y),
        hi=table.hi.at[sid, 1].set(hi_y),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "num_segments"))
def segment_properties(
    pos: jax.Array,
    segment: jax.Array,
    valid: jax.Array,
    classification: jax.Array,
    table: SegmentTable,
    num_segments: int,
    cfg: CharacteristicsConfig = CharacteristicsConfig(),
) -> tuple[jax.Array, jax.Array]:
    """Per-point expansion and relative height (calculations.rs:297-326).

    Expansion: crown-filtered slice areas -> per-slice diameter relative to the
    segment's max crown diameter; each point reads its slice's ratio.  Height:
    y normalized to the segment's extent.  Returns (expansion f32[N], height
    f32[N]).
    """
    s_cap = num_segments
    ms = cfg.max_slices
    sw = cfg.slice_width
    k_dirs = cfg.hull_directions

    seg = jnp.where(valid & (segment > 0) & (segment < s_cap), segment, 0)
    live = seg > 0
    min_y = table.lo[:, 1]
    # (min_y, 1/height) per point via ONE packed-i32 [N] gather: both
    # 16-bit-quantized values share a dense column (see compute_segments)
    height_ext = jnp.maximum(table.hi[:, 1] - table.lo[:, 1], 1e-6)
    ylo_s = jnp.min(min_y)
    yext_s = jnp.maximum(jnp.max(table.hi[:, 1]) - ylo_s, 1e-6)
    qsc = 65535.0 / yext_s
    qmy = jnp.clip(((min_y - ylo_s) * qsc).astype(jnp.int32), 0, 65535)
    # height in [~0, yext]: quantize 1/height via height itself
    qh = jnp.clip((height_ext * qsc).astype(jnp.int32), 1, 65535)
    packed = ((qmy << 16) | qh)[seg]
    # & 0xFFFF after the arithmetic >>: see the compute_segments twin — a
    # negative packed value would sign-extend min_y_pt to ~min_y - yext
    min_y_pt = ylo_s + ((packed >> 16) & 0xFFFF).astype(jnp.float32) \
        * (yext_s / 65535.0)
    inv_h_pt = 1.0 / ((packed & 0xFFFF).astype(jnp.float32)
                      * (yext_s / 65535.0))
    slice_idx = jnp.clip(
        jnp.floor((pos[:, 1] - min_y_pt) / sw).astype(jnp.int32), 0, ms - 1
    )

    # crown-filtered slice areas via the same sorted scatter-free reduction
    # as compute_segments: sort by the flat (segment*MS + slice) bucket (it
    # already determines the run order — no y key needed here since the
    # slice index is precomputed from the table), then a segmented cummax +
    # run-end extraction.  ~2x cheaper than the scatter formulation at 15M.
    # non-crown points route straight to the dump bucket: their buckets read
    # as absent runs (area 0), same as the masked-scatter formulation, and
    # the sort carries no extra crown payload
    crown_only = live & (classification == CLASS_CROWN)
    bucket = jnp.where(crown_only, seg * ms + slice_idx, s_cap * ms)
    bucket_s, x_s, z_s = jax.lax.sort(
        (bucket, pos[:, 0], pos[:, 2]), num_keys=1, is_stable=False
    )  # run maxima only -> tie-order independent (probe_sort4)
    dirs = _support_directions(k_dirs)
    xz_s = jnp.stack([x_s, z_s], axis=-1)
    tab = _chunked_support_table(
        bucket_s,
        lambda c0, c1: (xz_s[:, :1] * dirs[0, c0:c1][None, :]
                        + xz_s[:, 1:] * dirs[1, c0:c1][None, :]),
        k_dirs, cfg, s_cap * ms, stride=ms,
    )
    areas_crown = _areas_from_supports(tab, k_dirs).reshape(s_cap, ms)

    # crown area: max area at/above the crown separator slice (calculations.rs:301-306)
    crown_sep_idx = jnp.clip(
        ((table.crown_sep - min_y) / sw).astype(jnp.int32), 0, ms - 1
    )
    sl = jnp.arange(ms, dtype=jnp.int32)[None, :]
    crown_area = jnp.max(
        jnp.where(sl >= crown_sep_idx[:, None], areas_crown, -INF), axis=1
    )
    crown_area = jnp.maximum(crown_area, 0.0)

    # diameter ratio per slice (approximate_diameter, calculations.rs:460-462)
    crown_diam = 2.0 * jnp.sqrt(crown_area / math.pi)
    slice_diam = 2.0 * jnp.sqrt(areas_crown / math.pi)
    ratio = slice_diam / jnp.maximum(crown_diam[:, None], 1e-6)

    expansion = jnp.where(live, ratio[seg, slice_idx], 0.0)
    # clip: the packed gather quantizes min_y/height (<=1/65535 rel), and the
    # reference's normalized height is in [0,1] by construction
    height = jnp.where(
        live, jnp.clip((pos[:, 1] - min_y_pt) * inv_h_pt, 0.0, 1.0), 0.0
    )
    return expansion, height


def _curv_per_row(i, d, nb):
    """knn_grid_reduce per_row: covariance eigenvalue ratio (stable
    module-level identity so eager op caches hit across calls)."""
    return eigen.curvature_from_cov(
        neighbors.neighbor_covariance_from(nb, nbr_valid=d < INF))


def _normals_per_row(i, d, nb):
    """knn_grid_reduce per_row: smallest eigenvector split into
    per-component [T] leaves (knn_grid_reduce maps [T]-shaped leaves)."""
    v = eigen.smallest_eigenvector(
        neighbors.neighbor_covariance_from(nb, nbr_valid=d < INF))
    return v[:, 0], v[:, 1], v[:, 2]


def segment_curvature(
    pos: jax.Array,
    member: jax.Array,
    k: int = 31,
    use_grid: bool = False,
    cell_size: jax.Array | float = 0.5,
) -> jax.Array:
    """Per-point curvature for one segment's members (calculations.rs:328-373).

    k-NN within the member set, covariance of the neighborhood, then
    3*lambda_min/trace via the analytic eigenvalues.  Non-members get 0.

    ``use_grid`` switches the exact tiled brute force (the reference's typical
    per-tree sizes) to the grid-hash candidate k-NN for very large member
    sets, where O(N^2) distances would not fit the time or memory budget —
    the reference's unbounded KD-tree query has no such cliff but also no
    vectorization (k-nearest/src/kd_tree.rs:105-143).

    NOT itself jitted: the grid branch must stay EAGER so
    knn_grid_reduce's host-side slab/block dispatch can run (a traced
    multi-million-row grid call takes the single fused map instead).  The brute path dispatches
    to a jitted inner function, so jitted callers inline it as before.
    """
    if use_grid:
        # fused per-tile k-NN + covariance + eigenvalues: the separate
        # [N,k] / [N,k,3] forms are tens of GB at scan scale
        curve = neighbors.knn_grid_reduce(pos, member, cell_size,
                                          _curv_per_row, k=k)
        return jnp.where(member, curve, 0.0)
    return _segment_curvature_brute(pos, member, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _segment_curvature_brute(pos, member, k=31):
    # segments with < k members (fresh brush spawns, sparse understory) pad
    # the k slots with INF-distance non-members — exclude them from the
    # covariance like the reference's KD-tree, which only returns members
    idx, dist = neighbors.knn_bruteforce(pos, member, k=k)
    cov = neighbors.neighbor_covariance(pos, idx, nbr_valid=dist < INF)
    curve = eigen.curvature_from_cov(cov)
    return jnp.where(member, curve, 0.0)


def segment_normals(
    pos: jax.Array,
    member: jax.Array,
    k: int = 31,
    use_grid: bool = False,
    cell_size: jax.Array | float = 0.5,
) -> jax.Array:
    """Per-point unit surface normals for one segment's members, f32[N,3].

    The smallest eigenvector of the SAME k-NN neighborhood covariance the
    curvature property diagonalizes (calculations.rs:328-373 computes only
    the eigenvalues; the reference viewer has no normals — its sole depth
    cue is eye-dome lighting).  Sign fixed upward (y >= 0, aerial scans);
    non-members get the +y fallback so downstream shading stays defined.
    """
    if use_grid:
        nx, ny, nz = neighbors.knn_grid_reduce(
            pos, member, cell_size, _normals_per_row, k=k)
        nrm = jnp.stack([nx, ny, nz], axis=-1)
    else:
        idx, dist = neighbors.knn_bruteforce(pos, member, k=k)
        cov = neighbors.neighbor_covariance(pos, idx, nbr_valid=dist < INF)
        nrm = eigen.smallest_eigenvector(cov)
    up = jnp.zeros_like(nrm).at[:, 1].set(1.0)
    return jnp.where(member[:, None], nrm, up)
