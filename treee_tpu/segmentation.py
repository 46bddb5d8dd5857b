"""Deterministic array-native tree segmentation.

Capability parity with the reference segmenter (treee/src/segmenting.rs:110-235),
which processes 1 m height slices top-down: per slice it merges points into convex
"tree" polygons under a max distance d (segmenting.rs:424-466), filters degenerate
trees (:468-483), greedily matches tree centroids to the slice above within 2d
(:485-523), and assigns every slice point to the Voronoi cell of the matched
centroids (:182-206).  That pipeline is sequential (bounded(1) channel chain),
order-dependent (points shuffled, :425) and randomly keyed (:516-521).

The array redesign keeps the observable capability — "cluster trees separated by
>= d, tracked coherently down the height axis, every point assigned to a tracked
centroid's Voronoi cell" — with deterministic, massively parallel building blocks:

1. *Rasterize*: one scatter-add bins every point into a [bands, G, G] occupancy
   grid over (x, z) cells of size d, plus first/second-moment accumulators.
2. *Cluster per band*: connected components on the occupancy grid by iterated
   3x3 min-label pooling (``lax.reduce_window``) + pointer jumping.  Cell size d
   guarantees any two points within d land in 8-neighbor cells, so reference
   clusters are never split; diagonal over-merge is bounded by 2*sqrt(2)*d.
3. *Track top-down*: a ``lax.scan`` over bands carries a fixed table of tracked
   centroids; new clusters match to it by iterated mutual-nearest pairing within
   2d (deterministic replacement for the reference's hash-order greedy loop),
   unmatched clusters allocate fresh slots (sequential ids, not rand::random).
4. *Assign*: per band, a Jump-Flooding pass propagates the nearest tracked
   centroid across the grid (the discrete Voronoi diagram the reference gets
   from ``voronator``), and every point gathers its cell's winner.

Re-running with a new distance is the same compiled function (d is traced), which
reproduces the reference's restart-on-slider semantics (segmenting.rs:77-107)
without cancellation machinery.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .config import SegmentationConfig
from .utils import struct

INF = jnp.float32(3.0e38)
IBIG = jnp.int32(0x7FFFFFFF)


class SegmentationResult(struct.PyTreeNode):
    """Output of :func:`segment_points`.

    Attributes:
      segment:   i32[N] per-point segment id (0 = unassigned).
      n_segments:i32 number of allocated segment ids.
      tracked_pos:   f32[B,T,2] tracked centroid per band per slot (aux).
      tracked_active:bool[B,T] slot liveness per band (aux).
      occupied_overflow: bool — occupied cells exceeded cc_occupied_cap, so
        cluster counts/centroids silently truncated; raise
        SegmentationConfig.cc_occupied_cap (pathological density only).
    """

    segment: jax.Array
    n_segments: jax.Array
    tracked_pos: jax.Array
    tracked_active: jax.Array
    occupied_overflow: jax.Array


def _connected_components(
    occupied: jax.Array, iters: int, occ_cap: int = 1 << 19,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Label CC of [B,G,G] boolean grids with 8-connectivity, all bands at once.

    Iterated min-pool over the per-band 3x3 window + pointer jumping; labels
    are flat in-band cell indices, unoccupied cells hold IBIG.  One batched
    while_loop across all bands utilizes the VPU far better than 64 small
    sequential loops and converges in the max (not sum) of per-band sweeps.

    The occupied cells (a few 100k of the B*G*G grid at forest densities) are
    compacted once up front so each pointer jump is two occ_cap-sized gathers
    + one scatter instead of a full-grid gather.  Cells beyond ``occ_cap`` still converge through the
    min-pool sweeps, just without the jump shortcut.

    Returns (labels [B,G,G], occ_idx i32[occ_cap] global flat indices of
    occupied cells, occ_valid bool[occ_cap]) — the compaction is reused by
    cluster extraction.
    """
    b, g, _ = occupied.shape
    gg = g * g
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (b, g, g), 1) * g
        + jax.lax.broadcasted_iota(jnp.int32, (b, g, g), 2)
    )
    lbl0 = jnp.where(occupied, idx, IBIG)

    flat_occ = occupied.reshape(-1)
    rank = jnp.cumsum(flat_occ.astype(jnp.int32)) - 1
    gidx = jnp.arange(b * gg, dtype=jnp.int32)
    tgt = jnp.where(flat_occ & (rank < occ_cap), rank, occ_cap)
    occ_idx = jnp.zeros(occ_cap + 1, jnp.int32).at[tgt].set(
        gidx, mode="drop"
    )[:occ_cap]
    n_occ = jnp.sum(flat_occ.astype(jnp.int32))
    occ_valid = jnp.arange(occ_cap, dtype=jnp.int32) < n_occ
    band_off = occ_idx // gg * gg
    jump_tgt = jnp.where(occ_valid, occ_idx, b * gg)

    def body(state):
        lbl, _, it = state
        # three cheap min-pool sweeps (pure reduce_window image ops) ...
        new = lbl
        for _ in range(3):
            pooled = jax.lax.reduce_window(
                new, 0x7FFFFFFF, jax.lax.min, (1, 3, 3), (1, 1, 1), "SAME"
            )
            new = jnp.where(occupied, jnp.minimum(new, pooled), IBIG)
        # ... then one compact pointer jump: occupied cells' labels always
        # name occupied cells, so padding rows (reading cell 0) are the only
        # garbage and the drop-mode scatter discards them
        flat = new.reshape(-1)
        l1 = flat[occ_idx]  # in-band label per occupied cell
        l2 = flat[band_off + jnp.clip(l1, 0, gg - 1)]
        flat = flat.at[jump_tgt].min(jnp.minimum(l1, l2), mode="drop")
        new = flat.reshape(b, g, g)
        changed = jnp.any(new != lbl)
        return new, changed, it + 1

    max_bodies = -(-iters // 4)

    def cond(state):
        _, changed, it = state
        return changed & (it < max_bodies)

    lbl, _, _ = jax.lax.while_loop(
        cond, body, (lbl0, jnp.bool_(True), jnp.int32(0))
    )
    return lbl, occ_idx, occ_valid


def _extract_clusters(
    labels: jax.Array,       # i32[B,G,G]
    cnt: jax.Array,          # i32[B,G,G]
    lo: jax.Array,           # f32[3] scene lower bound
    s: jax.Array,            # f32 cell size
    max_clusters: int,
    min_points: int,
    occ_idx: jax.Array,      # i32[occ_cap] global flat occupied-cell indices
    occ_valid: jax.Array,    # bool[occ_cap]
    use_sorted: bool = True,
):
    """Top-``max_clusters`` clusters per band by point count, batched.

    Centroids are count-weighted cell centers.  Aggregation scatters only the
    compacted occupied cells (from :func:`_connected_components`) instead of
    the full grid (a scatter pays for every operand row, masked or not).

    Selection: cluster accumulation targets are sparse in the [B, G*G] grid
    (thousands of a few 100k occupied cells), so instead of a batched
    ``top_k`` over the full grid, the compacted candidates are lex-sorted by
    (band, -count) — lax.sort is stable and the candidates arrive in
    ascending cell order, reproducing top_k's biggest-first order and
    lowest-index tie-break EXACTLY (A/B'd bit-identical,
    test_sorted_extract_matches_topk) — and ranked into [B, C] slots with
    one small scatter.  ``use_sorted=False`` keeps the top_k path for
    comparison.

    CAVEAT: occupied cells beyond the compaction capacity contribute neither
    counts nor centroid weight (they also lose the CC jump shortcut), and in
    the sorted path an accumulation target that itself lies beyond the cap is
    not a candidate at all (top_k scanned the full grid and could still find
    it) — at the default 512k cap that needs >3.5 fully dense 384^2 bands,
    far denser than forest scans; the ``occupied_overflow`` flag marks the
    regime and SegmentationConfig.cc_occupied_cap raises it.  Returns
    (centroids f32[B,C,2], mask bool[B,C]).
    """
    b, g, _ = labels.shape
    gg = g * g
    occ_cap = occ_idx.shape[0]
    flat_lbl = labels.reshape(-1)
    l_occ = flat_lbl[occ_idx]
    root = occ_idx // gg * gg + jnp.clip(l_occ, 0, gg - 1)
    tgt = jnp.where(occ_valid & (l_occ != IBIG), root, b * gg)
    cnt_occ = cnt.reshape(-1)[occ_idx]
    cell_flat = occ_idx % gg
    pcount = jnp.zeros(b * gg + 1, jnp.int32).at[tgt].add(cnt_occ, mode="drop")

    def index_sum(cell_index, at):
        """sum(count * cell_index) per accumulation target, read at ``at``.

        Fixed point: integer adds are exact, so the order in which the
        scatter accumulates (atomics on the GPU) cannot move a centroid and
        with it the segment ids.  The index is split into base-8 digits so
        every i32 digit sum stays below 7 * N < 2^31."""
        total = jnp.zeros(at.shape, jnp.float32)
        scale = 1
        while scale < g:
            digit = (cell_index // scale) % 8
            part = jnp.zeros(b * gg + 1, jnp.int32).at[tgt].add(
                cnt_occ * digit, mode="drop")
            total = total + part[at].astype(jnp.float32) * float(scale)
            scale *= 8
        return total

    if use_sorted:
        # candidates are ACCUMULATION TARGETS: occupied cells that received
        # pcount (labels always name occupied cells, so occ rows cover all
        # of them).  NOT "self-rooted" cells only — under bounded CC
        # iterations a large component can carry several intermediate label
        # targets, and the top_k semantics this path reproduces select those
        # fragments too.  Everything else sorts to the tail via the sentinel
        # band.
        cnt_self = pcount[occ_idx]
        is_cand = occ_valid & (cnt_self >= max(min_points, 1))
        key_band = jnp.where(is_cand, occ_idx // gg, b)
        key_cnt = jnp.where(is_cand, -cnt_self, IBIG)
        sk_band, sk_cnt, sorted_root = jax.lax.sort(
            (key_band, key_cnt, occ_idx), num_keys=2
        )
        starts = jnp.searchsorted(
            sk_band, jnp.arange(b, dtype=jnp.int32), side="left",
            method="scan_unrolled",
        ).astype(jnp.int32)
        rank = (
            jnp.arange(occ_cap, dtype=jnp.int32)
            - starts[jnp.clip(sk_band, 0, b - 1)]
        )
        keep = (sk_band < b) & (rank < max_clusters)
        slot = jnp.where(keep, sk_band * max_clusters + rank, b * max_clusters)
        groots = (
            jnp.zeros(b * max_clusters + 1, jnp.int32)
            .at[slot].set(sorted_root, mode="drop")[:-1]
            .reshape(b, max_clusters)
        )
        top = (
            jnp.zeros(b * max_clusters + 1, jnp.int32)
            .at[slot].set(-sk_cnt, mode="drop")[:-1]
            .reshape(b, max_clusters)
        )
    else:
        score = jnp.where(
            pcount[: b * gg].reshape(b, gg) >= min_points,
            pcount[: b * gg].reshape(b, gg),
            0,
        )
        top, roots = jax.lax.top_k(score, max_clusters)  # batched over bands
        groots = roots + jnp.arange(b, dtype=jnp.int32)[:, None] * gg
    mask = top > 0
    denom = jnp.maximum(pcount[groots], 1).astype(jnp.float32)
    # count-weighted mean cell centre: lo + (mean index + 1/2) * s
    cx = lo[0] + (index_sum(cell_flat // g, groots) / denom + 0.5) * s
    cz = lo[2] + (index_sum(cell_flat % g, groots) / denom + 0.5) * s
    cents = jnp.stack([cx, cz], axis=-1)
    return cents, mask


def _match_band(
    tracked_pos: jax.Array,     # f32[T,2]
    active: jax.Array,          # bool[T]
    n_alloc: jax.Array,         # i32
    cents: jax.Array,           # f32[C,2]
    cmask: jax.Array,           # bool[C]
    match_radius: jax.Array,
    rounds: int,
):
    """Match band clusters to tracked centroids; allocate slots for the rest.

    Deterministic equivalent of TreeSet::tree_positions (segmenting.rs:485-523):
    iterated mutual-nearest pairing within ``match_radius`` replaces the
    hash-order greedy; new ids are sequential slot numbers instead of
    rand::random.  Unmatched tracked centroids persist at their old position,
    exactly as the reference keeps them in the map.
    """
    t_cap = tracked_pos.shape[0]
    c_cap = cents.shape[0]
    taken = ~cmask  # cols already consumed

    def round_body(_, state):
        tracked_pos, active, taken = state
        diff = tracked_pos[:, None, :] - cents[None, :, :]
        d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        d = jnp.where(active[:, None] & ~taken[None, :], d, INF)
        row_best = jnp.argmin(d, axis=1)                       # [T]
        col_best = jnp.argmin(d, axis=0)                       # [C]
        row_val = jnp.min(d, axis=1)
        mutual = (
            (col_best[row_best] == jnp.arange(t_cap))
            & (row_val <= match_radius)
            & active
        )
        # move matched tracked centroids to the new cluster position
        new_pos = cents[row_best]
        tracked_pos = jnp.where(mutual[:, None], new_pos, tracked_pos)
        # mark consumed columns
        consumed_col = jnp.where(mutual, row_best, c_cap)
        taken = taken.at[consumed_col].set(True, mode="drop")
        return tracked_pos, active, taken

    tracked_pos, active, taken = jax.lax.fori_loop(
        0, rounds, round_body, (tracked_pos, active, taken)
    )

    # allocate new slots for surviving clusters
    is_new = cmask & ~taken
    free_order = jnp.argsort(active)  # stable: free (False) slots first, by index
    n_free = t_cap - jnp.sum(active.astype(jnp.int32))
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    ok = is_new & (new_rank < n_free)
    slot = jnp.where(ok, free_order[jnp.clip(new_rank, 0, t_cap - 1)], t_cap)
    tracked_pos = tracked_pos.at[slot].set(cents, mode="drop")
    active = active.at[slot].set(True, mode="drop")
    n_alloc = n_alloc + jnp.sum(ok.astype(jnp.int32))
    return tracked_pos, active, n_alloc


def _jump_flood(
    seed_slot: jax.Array,   # i32[B,G,G], -1 where no seed
    seed_pos: jax.Array,    # f32[B,G,G,2] absolute centroid position of the seed
    cell_center: jax.Array, # f32[G,G,2]
) -> jax.Array:
    """Discrete Voronoi by Jump Flooding: nearest seed slot per cell, i32[B,G,G].

    Batched over all bands at once — each step is 8 shifted comparisons over
    the full [B,G,G] stack (one fused VPU op each) instead of a per-band loop.
    Seed positions are absolute coordinates, so wrap-around candidates from
    ``jnp.roll`` simply lose the distance comparison — no masking needed.
    """
    g = seed_slot.shape[-1]
    d0 = jnp.where(
        seed_slot >= 0,
        jnp.sum((seed_pos - cell_center[None]) ** 2, axis=-1),
        INF,
    )
    best = (seed_slot, seed_pos, d0)

    step = g // 2
    while step >= 1:
        slot, pos, dist = best
        for dx in (-step, 0, step):
            for dz in (-step, 0, step):
                if dx == 0 and dz == 0:
                    continue
                cs = jnp.roll(slot, (dx, dz), axis=(1, 2))
                cp = jnp.roll(pos, (dx, dz), axis=(1, 2))
                cd = jnp.where(
                    cs >= 0,
                    jnp.sum((cp - cell_center[None]) ** 2, axis=-1),
                    INF,
                )
                better = cd < dist
                slot = jnp.where(better, cs, slot)
                pos = jnp.where(better[..., None], cp, pos)
                dist = jnp.where(better, cd, dist)
        best = (slot, pos, dist)
        step //= 2
    return best[0]


def _jump_flood_packed(
    seed_slot: jax.Array,   # i32[B,G,G], -1 where no seed
    seed_pos: jax.Array,    # f32[B,G,G,2] absolute centroid position of the seed
    cell_center: jax.Array, # f32[G,G,2]
    lo: jax.Array,          # f32[3] scene lower bound (grid origin)
    s: jax.Array,           # f32 cell size
) -> jax.Array:
    """Jump flood carrying (slot, packed-quantized-pos) — half the plane bytes.

    Identical schedule to :func:`_jump_flood`, but the seed position rides as
    ONE i32 plane (two 15-bit fixed-point grid coordinates at s/64 resolution,
    ~1.2 cm at the d=0.75 default) instead of two f32 planes, cutting the
    rolled+carried HBM traffic per direction from 4 planes to ~3 (slot,
    packed, running dist).  Positions quantize to the s/64 lattice, so a
    candidate's distance moves by at most ~s/45 — winners flip only on
    near-exact ties.  Used when the brute-force Voronoi is off
    (SegmentationConfig.use_packed_jfa).
    """
    g = seed_slot.shape[-1]
    qs = s / 64.0
    inv_qs = 1.0 / qs
    qmax = g * 64 - 1  # 15 bits hold g*64 for any g <= 512

    def quant(p, axis_lo):
        return jnp.clip(
            jnp.round((p - axis_lo) * inv_qs).astype(jnp.int32), 0, qmax
        )

    packed0 = jnp.where(
        seed_slot >= 0,
        (quant(seed_pos[..., 0], lo[0]) << 15)
        | quant(seed_pos[..., 1], lo[2]),
        -1,
    )
    ccx = cell_center[None, ..., 0]
    ccz = cell_center[None, ..., 1]

    def unpack_dist(slot, packed):
        px = lo[0] + (packed >> 15).astype(jnp.float32) * qs
        pz = lo[2] + (packed & 0x7FFF).astype(jnp.float32) * qs
        return jnp.where(
            slot >= 0, (px - ccx) ** 2 + (pz - ccz) ** 2, INF
        )

    best = (seed_slot, packed0, unpack_dist(seed_slot, packed0))

    step = g // 2
    while step >= 1:
        slot, packed, dist = best
        for dx in (-step, 0, step):
            for dz in (-step, 0, step):
                if dx == 0 and dz == 0:
                    continue
                cs = jnp.roll(slot, (dx, dz), axis=(1, 2))
                cq = jnp.roll(packed, (dx, dz), axis=(1, 2))
                cd = unpack_dist(cs, cq)
                better = cd < dist
                slot = jnp.where(better, cs, slot)
                packed = jnp.where(better, cq, packed)
                dist = jnp.where(better, cd, dist)
        best = (slot, packed, dist)
        step //= 2
    return best[0]


def _bruteforce_voronoi(
    occ_idx: jax.Array,        # i32[occ_cap] global flat occupied-cell indices
    occ_valid: jax.Array,      # bool[occ_cap]
    tracked_pos_b: jax.Array,  # f32[B,T,2] tracked centroid per band per slot
    active_b: jax.Array,       # bool[B,T]
    lo: jax.Array,             # f32[3] scene lower bound
    s: jax.Array,              # f32 cell size
    n_bands: int,
    g: int,
    chunk: int,
) -> jax.Array:
    """EXACT banded Voronoi computed only at occupied cells, i32[B,G,G].

    The JFA computes a winner for every one of the B*G*G cells, but
    ``assign_points`` only ever reads cells that contain points (a few 100k of
    9.4M at forest densities).  Here each occupied cell scores every tracked
    slot of its own band directly: a [occ, B] one-hot of the cell's band
    matmul'd against the [B, T] tracked tables broadcasts each band's
    centroids to its cells in one matmul (HIGHEST precision makes the one-hot
    product an exact row select), chunked over T with a running min so no
    [occ, T] buffer materializes.  Unlike the flood fill this is the TRUE
    nearest centroid (JFA can propagate a non-optimal seed); ties break to
    the lowest slot id.  Cells beyond ``cc_occupied_cap`` get no winner
    (their points stay unassigned — the ``occupied_overflow`` flag already
    marks that regime).  The DEFAULT Voronoi path since the 2026-08-18
    measurements (SegmentationConfig.use_bruteforce_voronoi=True): 4.3 ms
    vs 6.9/12.3 ms for the packed/plain JFA at bench scale, and it deletes
    the JFA's seed-grid scatters (tools/probe_voronoi.py).
    """
    gg = g * g
    t_cap = tracked_pos_b.shape[1]
    occ_band = occ_idx // gg
    # cell centers arithmetically from the flat index — no [occ,2]-output
    # row gather; identical f32 expression to band_scan's cell_center iota
    cell_flat = occ_idx % gg
    ccx = lo[0] + ((cell_flat // g).astype(jnp.float32) + 0.5) * s  # [occ]
    ccz = lo[2] + ((cell_flat % g).astype(jnp.float32) + 0.5) * s
    onehot = (
        occ_band[:, None] == jnp.arange(n_bands, dtype=jnp.int32)[None, :]
    ).astype(jnp.float32)                                    # [occ,B]
    hp = jax.lax.Precision.HIGHEST
    n_occ_cap = occ_idx.shape[0]
    best_d = jnp.full(n_occ_cap, INF, jnp.float32)
    best = jnp.full(n_occ_cap, -1, jnp.int32)
    for c0 in range(0, t_cap, chunk):
        c1 = min(c0 + chunk, t_cap)
        cxt = jnp.dot(onehot, tracked_pos_b[:, c0:c1, 0], precision=hp)
        czt = jnp.dot(onehot, tracked_pos_b[:, c0:c1, 1], precision=hp)
        at = jnp.dot(
            onehot, active_b[:, c0:c1].astype(jnp.float32), precision=hp
        ) > 0.5
        dist = (ccx[:, None] - cxt) ** 2 + (ccz[:, None] - czt) ** 2
        dist = jnp.where(at, dist, INF)
        j = jnp.argmin(dist, axis=1).astype(jnp.int32)
        dm = jnp.min(dist, axis=1)
        upd = dm < best_d
        best = jnp.where(upd & (dm < INF), c0 + j, best)
        best_d = jnp.where(upd, dm, best_d)
    tgt = jnp.where(occ_valid, occ_idx, n_bands * gg)
    return (
        jnp.full(n_bands * gg + 1, -1, jnp.int32)
        .at[tgt].set(best, mode="drop")[: n_bands * gg]
        .reshape(n_bands, g, g)
    )


def scene_bounds_raw(pos: jax.Array, valid: jax.Array):
    """(lo, hi) f32[3] with +/-big identities when nothing is valid.

    Collective-safe form: a shard with only padding must contribute the
    min/max IDENTITIES to a cross-device pmin/pmax, not the unit-box
    fallback (which would pull the global lo to 0 and silently change cell
    size / anchor bins vs the single-device run).  Apply
    ``scene_bounds_finalize`` AFTER the collective."""
    big = jnp.float32(3.0e38)
    lo = jnp.min(jnp.where(valid[:, None], pos, big), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], pos, -big), axis=0)
    return lo, hi


def scene_bounds_finalize(lo, hi, any_valid):
    """Unit box when no point anywhere was valid (single-device semantics)."""
    return jnp.where(any_valid, lo, 0.0), jnp.where(any_valid, hi, 1.0)


def scene_bounds(pos: jax.Array, valid: jax.Array):
    """(lo, hi) f32[3] over valid points; unit box if none."""
    lo, hi = scene_bounds_raw(pos, valid)
    return scene_bounds_finalize(lo, hi, jnp.any(valid))


def cell_size(lo, hi, d, cfg: SegmentationConfig):
    """CC cell size: d, grown if the scene exceeds the static grid."""
    extent = jnp.maximum(hi[0] - lo[0], hi[2] - lo[2])
    return jnp.maximum(d, extent / (cfg.grid_size - 1))


# Strided-subsample histogram parameters for the robust band anchor.  The
# stride divides every shard size the sharded path produces (multiples of
# n_devices * 128), making shard-local histograms + one psum EXACTLY equal to
# the single-device histogram — exact shard-vs-single segmentation equality
# survives (tests/test_sharding.py).
ANCHOR_STRIDE = 64
ANCHOR_BINS = 1024


def anchor_histogram(pos, valid, lo_y, hi_y):
    """y histogram of every ANCHOR_STRIDE-th point -> i32[ANCHOR_BINS].

    ~N/64 scatter rows buys outlier robustness for
    the band window below.
    """
    y = pos[::ANCHOR_STRIDE, 1]
    v = valid[::ANCHOR_STRIDE]
    ext = jnp.maximum(hi_y - lo_y, 1e-6)
    b = jnp.clip(((y - lo_y) * (ANCHOR_BINS / ext)).astype(jnp.int32),
                 0, ANCHOR_BINS - 1)
    tgt = jnp.where(v, b, ANCHOR_BINS)
    return jnp.zeros(ANCHOR_BINS + 1, jnp.int32).at[tgt].add(1)[:ANCHOR_BINS]


def band_anchor(hist, lo_y, hi_y, cfg: SegmentationConfig):
    """Robust TOP anchor for the band window from the y histogram.

    The bands are a fixed-height window hung from the scene top
    (point_cells); a handful of high outliers (birds, atmospheric returns —
    present in real ALS tiles) would otherwise hoist the window above the
    canopy and pool every tree into the bottom clip band.  The reference is
    immune by construction (absolute floor(y) 1 m slices, loading.rs:98-101);
    here the anchor is the 99.9th percentile y of a 1/64 subsample plus one
    band of margin, capped at the true max — identical to the max for clean
    scenes (the quantile bin then IS the top bin).
    """
    c = jnp.cumsum(hist)
    total = c[-1]
    idx = jnp.argmax(c >= 0.999 * total.astype(jnp.float32))
    ext = jnp.maximum(hi_y - lo_y, 1e-6)
    top = lo_y + (idx.astype(jnp.float32) + 1.0) * (ext / ANCHOR_BINS)
    top = jnp.minimum(top + cfg.band_height, hi_y)
    return jnp.where(total > 0, top, hi_y)


def point_cells(pos, valid, lo, hi, s, cfg: SegmentationConfig, top=None):
    """Quantize points to (band, cx, cz).

    Bands ordered top (0) -> bottom, mirroring the reference's 1 m floor(y)
    slices processed top-down (segmenting.rs:121-146, loading.rs:98-101).
    ``top`` overrides the window anchor (band_anchor's outlier-robust top);
    points above it clip into band 0.
    """
    g = cfg.grid_size
    anchor = hi[1] if top is None else top
    band = jnp.clip(
        jnp.floor((anchor - pos[:, 1]) / cfg.band_height).astype(jnp.int32),
        0, cfg.max_bands - 1,
    )
    cx = jnp.clip(jnp.floor((pos[:, 0] - lo[0]) / s).astype(jnp.int32), 0, g - 1)
    cz = jnp.clip(jnp.floor((pos[:, 2] - lo[2]) / s).astype(jnp.int32), 0, g - 1)
    return band, cx, cz


def moment_grids(pos, valid, band, cx, cz, cfg: SegmentationConfig):
    """Scatter points into per-band occupancy-count grids.

    This is the only stage that touches all N points before assignment; under
    multi-device sharding each shard scatters locally and the grids are summed
    over NVLink (parallel/sharding.py).  Only counts are scattered — cluster
    centroids are recovered as count-weighted CELL centers (error <= cell/2 =
    d/2, well inside the 2d matching radius), saving two full-N scatter passes.
    """
    g = cfg.grid_size
    b_cap = cfg.max_bands
    flat = (band * g + cx) * g + cz
    flat = jnp.where(valid, flat, b_cap * g * g)
    cnt = jnp.zeros(b_cap * g * g + 1, jnp.int32).at[flat].add(valid.astype(jnp.int32))
    return cnt[:-1].reshape(b_cap, g, g)


def band_scan(cnt, lo, s, d, cfg: SegmentationConfig):
    """Top-down tracking scan over band count grids; returns per-band Voronoi.

    Returns (slot_grids i32[B,G,G], n_alloc, tracked_pos f32[B,T,2],
    tracked_active bool[B,T]).  Runs on replicated (post-psum) grids under
    sharding — the state is small and every device computes it identically.
    """
    g = cfg.grid_size
    t_cap = cfg.max_segments
    c_cap = cfg.max_trees_per_band

    cell_center = jnp.stack(
        [
            lo[0] + (jax.lax.broadcasted_iota(jnp.float32, (g, g), 0) + 0.5) * s,
            lo[2] + (jax.lax.broadcasted_iota(jnp.float32, (g, g), 1) + 0.5) * s,
        ],
        axis=-1,
    )

    # cluster every band at once (batched CC + extraction); only centroid
    # matching and the per-band Voronoi stay sequential in the scan
    labels, occ_idx, occ_valid = _connected_components(
        cnt > 0, cfg.cc_iters, cfg.cc_occupied_cap)
    cents_b, cmask_b = _extract_clusters(
        labels, cnt, lo, s, c_cap, cfg.min_points, occ_idx, occ_valid,
        use_sorted=cfg.use_sorted_extract,
    )

    # the sequential part of the scan carries only the tiny [T,2] matching
    # state; the expensive per-band Voronoi moves out and runs batched below
    def band_step(carry, xs):
        tracked_pos, active, n_alloc = carry
        cents, cmask = xs
        tracked_pos, active, n_alloc = _match_band(
            tracked_pos, active, n_alloc, cents, cmask,
            cfg.match_radius_factor * d, cfg.match_rounds,
        )
        return (tracked_pos, active, n_alloc), (tracked_pos, active)

    init = (
        jnp.zeros((t_cap, 2), jnp.float32),
        jnp.zeros((t_cap,), bool),
        jnp.int32(0),
    )
    (_, _, n_alloc), (tracked_pos_b, active_b) = jax.lax.scan(
        band_step, init, (cents_b, cmask_b)
    )

    b = cnt.shape[0]
    gg = g * g

    if cfg.use_bruteforce_voronoi:
        # exact nearest tracked centroid at occupied cells only — no seed
        # grids, no flood fill (see _bruteforce_voronoi)
        slot_grids = _bruteforce_voronoi(
            occ_idx, occ_valid, tracked_pos_b, active_b, lo, s,
            b, g, cfg.voronoi_chunk,
        )
        return slot_grids, n_alloc, tracked_pos_b, active_b

    # batched seed grids: B*T tiny scatters (slot by max for deterministic
    # collision resolve, then positions only for the winning slots — never a
    # per-cell gather from the tracked table)
    tcx = jnp.clip(
        jnp.floor((tracked_pos_b[..., 0] - lo[0]) / s).astype(jnp.int32),
        0, g - 1,
    )
    tcz = jnp.clip(
        jnp.floor((tracked_pos_b[..., 1] - lo[2]) / s).astype(jnp.int32),
        0, g - 1,
    )
    band_off = jnp.arange(b, dtype=jnp.int32)[:, None] * gg
    seed_cell = jnp.where(active_b, band_off + tcx * g + tcz, b * gg)
    slot_ids = jnp.broadcast_to(
        jnp.arange(t_cap, dtype=jnp.int32)[None, :], (b, t_cap)
    )
    seed_slot = jnp.full(b * gg + 1, -1, jnp.int32).at[
        seed_cell.reshape(-1)
    ].max(slot_ids.reshape(-1), mode="drop")[: b * gg]
    won = seed_slot[jnp.clip(seed_cell.reshape(-1), 0, b * gg - 1)] \
        == slot_ids.reshape(-1)
    pos_tgt = jnp.where(won, seed_cell.reshape(-1), b * gg)
    seed_pos = jnp.zeros((b * gg + 1, 2), jnp.float32).at[pos_tgt].set(
        tracked_pos_b.reshape(-1, 2), mode="drop"
    )[: b * gg]
    seed_slot = seed_slot.reshape(b, g, g)
    seed_pos = seed_pos.reshape(b, g, g, 2)

    if cfg.use_packed_jfa and g <= 512:  # 15-bit packed coords need g*64 <= 2^15
        slot_grids = _jump_flood_packed(seed_slot, seed_pos, cell_center, lo, s)
    else:
        slot_grids = _jump_flood(seed_slot, seed_pos, cell_center)
    return slot_grids, n_alloc, tracked_pos_b, active_b


def assign_points(slot_grids, band, cx, cz, valid):
    """Per-point assignment: gather the band's Voronoi winner (O(1)/point).

    The index is flattened by hand: XLA lowers the 3-D form
    ``slot_grids[band, cx, cz]`` to a general 3-vector gather instead of one
    flat lookup.  band/cx/cz are pre-clipped by point_cells, so flat is
    always in bounds.
    """
    g = slot_grids.shape[-1]
    flat = (band * g + cx) * g + cz
    slot = slot_grids.reshape(-1)[flat]
    return jnp.where(valid & (slot >= 0), slot + 1, 0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def segment_points(
    pos: jax.Array,
    valid: jax.Array,
    max_distance: jax.Array | float,
    cfg: SegmentationConfig = SegmentationConfig(),
) -> SegmentationResult:
    """Segment a point cloud into trees; see module docstring.

    Args:
      pos: f32[N,3] y-up positions.
      valid: bool[N].
      max_distance: minimum separation d between trees (traced; re-run with a
        new value reuses the compiled executable — the reference's restart
        slider, segmenting.rs:77-107).
    Returns:
      SegmentationResult with per-point ids (0 = unassigned).
    """
    d = jnp.asarray(max_distance, jnp.float32)
    lo, hi = scene_bounds(pos, valid)
    s = cell_size(lo, hi, d, cfg)
    hist = anchor_histogram(pos, valid, lo[1], hi[1])
    top = band_anchor(hist, lo[1], hi[1], cfg)
    band, cx, cz = point_cells(pos, valid, lo, hi, s, cfg, top=top)
    cnt = moment_grids(pos, valid, band, cx, cz, cfg)
    slot_grids, n_alloc, tracked_pos_b, active_b = band_scan(
        cnt, lo, s, d, cfg
    )
    n_occ = jnp.sum((cnt > 0).astype(jnp.int32))
    return SegmentationResult(
        segment=assign_points(slot_grids, band, cx, cz, valid),
        n_segments=n_alloc,
        tracked_pos=tracked_pos_b,
        tracked_active=active_b,
        occupied_overflow=n_occ > cfg.cc_occupied_cap,
    )
