"""k-nearest-neighbor search: tiled brute force (exact) and grid hash (scalable).

Replaces the reference's ``k-nearest`` KD-tree crate (k-nearest/src/kd_tree.rs:19-143)
used for the 31-neighbor curvature property (treee/src/calculations.rs:328-373).
Pointer-chasing KD-trees are hostile to wide vector hardware; the array designs are:

- ``knn_bruteforce``: tiled exact search.  Distances via the matmul identity
  ``|q-p|^2 = |q|^2 + |p|^2 - 2 q.p`` so the inner product is one matmul, then
  ``lax.top_k``.  Queries are processed in fixed tiles with ``lax.map`` to bound
  memory; exact for any k, used for segment-sized inputs and as the test oracle.

- ``knn_grid``: grid-hash candidate search.  Points are bucketed into cells of a
  chosen radius via one sort; each query gathers a capped number of candidates
  from its 27 neighboring cells and runs top-k on that pool.  Approximate when a
  cell overflows its cap or all true neighbors lie further than one cell away;
  exactness improves with ``cell_capacity``.

Both return self in the neighbor set (the reference KD-tree does too: the query
point is a member of the tree, distance 0).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.float32(3.0e38)


def _pairwise_sqdist(q: jax.Array, p: jax.Array) -> jax.Array:
    """|q_i - p_j|^2 for f32[T,3] x f32[N,3] -> f32[T,N] via one matmul."""
    qn = jnp.sum(q * q, axis=-1, keepdims=True)
    pn = jnp.sum(p * p, axis=-1)
    # HIGHEST keeps the product in full f32: the GPU's default TF32 (about
    # three decimal digits) is far too coarse for squared-distance
    # cancellation.
    cross = jnp.dot(
        q, p.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.maximum(qn + pn[None, :] - 2.0 * cross, 0.0)


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def knn_bruteforce(
    pos: jax.Array,
    valid: jax.Array,
    k: int = 31,
    tile: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Exact k-NN of every point against all valid points.

    Returns (indices i32[N,k], sqdist f32[N,k]); rows of invalid queries contain
    self-padding.  Exact counterpart of KDTree::k_nearest with unbounded radius
    (calculations.rs:279-280: k=31, max_distance=f32::MAX).
    """
    n = pos.shape[0]
    pad = (-n) % tile
    qpos = jnp.pad(pos, ((0, pad), (0, 0)))
    p_masked = jnp.where(valid[:, None], pos, INF)

    def one_tile(q: jax.Array) -> tuple[jax.Array, jax.Array]:
        d = _pairwise_sqdist(q, p_masked)
        d = jnp.where(valid[None, :], d, INF)
        neg, idx = jax.lax.top_k(-d, k)
        return idx.astype(jnp.int32), -neg

    tiles = qpos.reshape(-1, tile, 3)
    idx, dist = jax.lax.map(one_tile, tiles)
    return idx.reshape(-1, k)[:n], dist.reshape(-1, k)[:n]


class GridHash:
    """Static-shape spatial hash built from one sort; see module docstring."""

    def __init__(self, pos, valid, cell_size, grid_bits: int = 7, lo=None):
        """grid_bits: per-axis resolution 2^grid_bits cells (wraps by
        clipping).  ``lo`` overrides the grid origin — the slab-split path
        passes the GLOBAL minimum so every slab quantizes cells
        identically to the whole-cloud hash."""
        self.cell_size = cell_size
        self.grid_bits = grid_bits
        g = 1 << grid_bits
        if lo is None:
            lo = jnp.min(jnp.where(valid[:, None], pos, INF), axis=0)
        self.lo = lo
        cell = jnp.clip(
            jnp.floor((pos - lo) / cell_size).astype(jnp.int32), 0, g - 1
        )
        cid = (cell[:, 0] << (2 * grid_bits)) | (cell[:, 1] << grid_bits) | cell[:, 2]
        cid = jnp.where(valid, cid, jnp.int32(0x7FFFFFFF))
        self.cell_ids_sorted, self.point_order = jax.lax.sort(
            (cid, jnp.arange(pos.shape[0], dtype=jnp.int32)), dimension=0, num_keys=1
        )
        self.cell = cell
        self.pos = pos
        self.valid = valid


def _knn_grid_map(
    pos: jax.Array,
    valid: jax.Array,
    cell_size,
    per_tile,
    k: int,
    cell_capacity: int,
    tile: int,
    grid_bits: int,
    with_nbrs: bool = False,
):
    """Shared grid-hash query machinery: map ``per_tile(idx [T,k],
    dist [T,k][, nbrs [T,k,3]]) -> pytree of [T,...] leaves`` over query
    tiles.  Leaves keep their trailing dims in the [n_tiles, T, ...]
    stack — callers that fuse reductions (knn_grid_reduce) must return
    [T]-shaped leaves.

    Gather rule (a workaround for a crash on the backend this engine was
    first built for; not re-measured on the GPU): inside the lax.map tile
    body, no gather from a full-[N] array uses DATA-DEPENDENT indices —
    only CONTIGUOUS slot ranges (`order[slots]`, `spx[slots]`).
    So: coordinate columns are permuted into cell-sorted order ONCE
    outside the map, every in-tile gather uses the contiguous
    ``start + arange(cap)`` slot ranges, neighbor coordinates for
    per_tile come from take_along_axis on tile-local arrays, and
    validity needs no gather at all — invalid points carry the
    0x7FFFFFFF cid sentinel, sort to the end, and can never fall inside
    a real cell's searchsorted [start, end) run.

    Scale rule (same origin): one map execution spans at most ~512
    tiles.  Large eager callers go through knn_grid_reduce's host-side
    query blocking, which dispatches one _grid_query_map per <= 2^20-row
    block against a hash built once.

    ``with_nbrs=True`` additionally hands per_tile the top-k neighbor
    coordinates so reduction callers never touch ``pos`` themselves."""
    n = pos.shape[0]
    lo, cell_size = _effective_cell(pos, valid, cell_size, grid_bits)
    hash_arrays = _build_grid_hash(pos, valid, cell_size, grid_bits, lo=lo)
    pad = (-n) % tile
    q_cells = jnp.pad(hash_arrays[-1], ((0, pad), (0, 0)))
    q_pos = jnp.pad(pos, ((0, pad), (0, 0)))
    return _grid_query_map(hash_arrays, q_cells, q_pos, per_tile, n,
                           k, cell_capacity, tile, grid_bits, with_nbrs)


def _effective_cell(pos, valid, cell_size, grid_bits):
    """(lo, cell_size_eff): grid origin + a cell size coarsened so the
    2^grid_bits-per-axis grid COVERS the scene.  With the raw cell size a
    large scene clips en masse into the boundary cells (a 350 m stand at
    0.5 m cells / grid_bits=7 puts >80% of points in edge cells — garbage
    candidates AND an unsplittable slab).  Coarser cells trade per-cell
    candidate truncation for full coverage; callers wanting the raw
    granularity on a big scene should raise grid_bits."""
    g = 1 << grid_bits
    lo = jnp.min(jnp.where(valid[:, None], pos, INF), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], pos, -INF), axis=0)
    ext = jnp.maximum(jnp.max(hi - lo), 0.0)
    cs = jnp.maximum(jnp.asarray(cell_size, jnp.float32), ext / (g - 1))
    return lo, cs


def _build_grid_hash(pos, valid, cell_size, grid_bits, lo=None):
    """(n, sorted_cids, order, spx, spy, spz, cell): the cell-sorted hash
    plus coordinate columns permuted into cell order — built ONCE, outside
    any tile map, so tile bodies only gather contiguous slot ranges."""
    grid = GridHash(pos, valid, cell_size, grid_bits, lo=lo)
    order = grid.point_order
    return (pos.shape[0], grid.cell_ids_sorted, order,
            pos[:, 0][order], pos[:, 1][order], pos[:, 2][order],
            grid.cell)


def _grid_query_map(hash_arrays, q_cells, q_pos, per_tile, n_out,
                    k, cell_capacity, tile, grid_bits, with_nbrs):
    """Map ``per_tile`` over the given query rows (padded to a multiple of
    ``tile``) against a prebuilt hash; returns leaves trimmed to
    ``n_out`` rows.  See _knn_grid_map for the crash/scale rules this
    shape obeys."""
    n, sorted_cids, order, spx, spy, spz, _ = hash_arrays
    g = 1 << grid_bits

    # 27 neighbor-cell offsets
    offs = jnp.array(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        jnp.int32,
    )  # [27, 3]

    cap = cell_capacity
    slot_off = jnp.arange(cap, dtype=jnp.int32)

    def one_tile(args):
        qc, qp = args  # [T,3], [T,3]
        nc = qc[:, None, :] + offs[None, :, :]  # [T,27,3]
        in_grid = jnp.all((nc >= 0) & (nc < g), axis=-1)  # [T,27]
        ncid = (nc[..., 0] << (2 * grid_bits)) | (nc[..., 1] << grid_bits) | nc[..., 2]
        # scan_unrolled: ~3x cheaper than the default scan method at these
        # query counts (CLAUDE.md searchsorted rule, tools/microbench.py)
        start = jnp.searchsorted(sorted_cids, ncid, side="left",
                                 method="scan_unrolled")  # [T,27]
        end = jnp.searchsorted(sorted_cids, ncid, side="right",
                               method="scan_unrolled")
        slots = start[..., None] + slot_off  # [T,27,cap]
        cand_ok = in_grid[..., None] & (slots < end[..., None])
        slots = jnp.clip(slots, 0, n - 1).reshape(tile, -1)  # [T, 27*cap]
        cand_ok = cand_ok.reshape(tile, -1)
        # contiguous-range gathers from the cell-sorted columns (the
        # gather rule, docstring).
        # Validity is free: the 0x7FFFFFFF-cid sentinel sorts invalid
        # points past every real [start, end) run, so cand_ok alone masks.
        cx = spx[slots]
        cy = spy[slots]
        cz = spz[slots]
        dx = cx - qp[:, 0:1]
        dy = cy - qp[:, 1:2]
        dz = cz - qp[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        d = jnp.where(cand_ok, d, INF)
        neg, ci = jax.lax.top_k(-d, k)
        cand = order[slots]  # [T, 27*cap] point indices (contiguous slots)
        # select via one-hot compare-sums instead of take_along_axis(·,
        # ci) inside the map (the gather rule in _knn_grid_map's
        # docstring).  Exact: ci rows are distinct slots, so each sum has
        # one live term.
        oh = ci[:, :, None] == jnp.arange(slots.shape[1],
                                          dtype=jnp.int32)  # [T,k,C]
        idx_t = jnp.sum(jnp.where(oh, cand[:, None, :], 0), axis=-1)
        if not with_nbrs:
            return per_tile(idx_t, -neg)
        nbrs_t = jnp.stack([
            jnp.sum(jnp.where(oh, cx[:, None, :], 0.0), axis=-1),
            jnp.sum(jnp.where(oh, cy[:, None, :], 0.0), axis=-1),
            jnp.sum(jnp.where(oh, cz[:, None, :], 0.0), axis=-1),
        ], axis=-1)
        return per_tile(idx_t, -neg, nbrs_t)

    tiles = (q_cells.reshape(-1, tile, 3), q_pos.reshape(-1, tile, 3))
    out = jax.lax.map(one_tile, tiles)
    return jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:])[:n_out], out)


@functools.partial(jax.jit, static_argnames=("k", "cell_capacity", "tile", "grid_bits"))
def knn_grid(
    pos: jax.Array,
    valid: jax.Array,
    cell_size: jax.Array | float,
    k: int = 31,
    cell_capacity: int = 16,
    tile: int = 2048,
    grid_bits: int = 7,
) -> tuple[jax.Array, jax.Array]:
    """Approximate k-NN via 27-cell candidate gather; see module docstring.

    WARNING: the [N,k] outputs are GBs at multi-million rows.
    Multi-million-row callers that only need a
    per-row reduction of the neighborhoods must use
    :func:`knn_grid_reduce` instead.
    """
    return _knn_grid_map(pos, valid, cell_size, lambda i, d: (i, d),
                         k, cell_capacity, tile, grid_bits)


def knn_grid_reduce(
    pos: jax.Array,
    valid: jax.Array,
    cell_size: jax.Array | float,
    per_row,
    k: int = 31,
    cell_capacity: int = 16,
    tile: int = 2048,
    grid_bits: int = 7,
    query_block: int = 1 << 20,
):
    """Fused grid k-NN + per-row reduction over the full cloud.

    ``per_row(idx i32[T,k], dist f32[T,k], nbrs f32[T,k,3]) -> pytree of
    f32[T] leaves`` runs INSIDE each query tile, so nothing [N,k]-shaped
    ever materializes: the [N,k] and [N,k,3] forms are GBs at scan
    scale, while per tile everything is KBs and XLA fuses the
    gather -> covariance -> eigen chain without materialization.
    ``nbrs`` holds the neighbors' coordinates, gathered per column by the
    machinery — per_row must NOT gather rows of the full cloud itself
    (the gather rule in _knn_grid_map) and must return [T]-shaped
    leaves (split vectors into per-component arrays).  Not jitted:
    callers run under their own jit or rely on the op-by-op cache;
    per_row identity doesn't key a trace cache here.

    Above ``src_max`` (2^21) rows, EAGER callers are driven through an
    exact SLAB DECOMPOSITION: the cloud is split along x-cell slices
    into slabs of <= 2^21 points each (plus a one-cell halo on both
    sides, so every interior query's full 27-cell neighborhood is
    present), each slab gets its own hash — anchored at the GLOBAL grid
    origin, so cells quantize identically — and its own map executions.
    2^21 comes from the same crash workaround as the gather rule (not
    re-measured on the GPU).  Within-cell candidate order can differ from the global
    hash where a cell overflows cell_capacity (sort ties), the usual
    approximation knob.  TRACED callers can't host-loop and get the
    single fused map — a jitted caller at multi-million rows must run
    eagerly instead (bench.py's grid branch does).
    """
    n = pos.shape[0]
    traced = any(isinstance(a, jax.core.Tracer)
                 for a in (pos, valid, cell_size))
    if traced or n <= query_block:
        return _knn_grid_map(pos, valid, cell_size, per_row,
                             k, cell_capacity, tile, grid_bits,
                             with_nbrs=True)
    src_max = GRID_SRC_MAX
    if n <= src_max:
        return _blocked_queries(pos, valid, cell_size, per_row, k,
                                cell_capacity, tile, grid_bits,
                                query_block, lo=None)
    return _grid_slab_reduce(pos, valid, cell_size, per_row, k,
                             cell_capacity, tile, grid_bits, query_block,
                             src_max)


def _blocked_queries(pos, valid, cell_size, per_row, k, cell_capacity,
                     tile, grid_bits, query_block, lo, row_ids=None):
    """One hash, one map execution per <= query_block query rows (the
    proven-clean execution size; see knn_grid_reduce).

    ``row_ids`` (i32[n], optional): global id of each local row.  The slab
    path passes its compaction indices so per_row's ``idx`` argument is
    in GLOBAL cloud-row space in every regime — without the remap, slab
    callers using idx would silently receive slab-local indices."""
    n = pos.shape[0]
    if lo is None:
        lo, cell_size = _effective_cell(pos, valid, cell_size, grid_bits)
    qb = query_block - (query_block % tile) or tile
    hash_arrays = _build_grid_hash(pos, valid, cell_size, grid_bits, lo=lo)
    if row_ids is not None:
        # remap the hash's point order to global ids: cand/idx become
        # global everywhere downstream (one [n] gather, outside the map)
        ha = list(hash_arrays)
        ha[2] = jnp.take(row_ids, ha[2])
        hash_arrays = tuple(ha)
    cell = hash_arrays[-1]
    pad = (-n) % qb
    cells_p = jnp.pad(cell, ((0, pad), (0, 0)))
    pos_p = jnp.pad(pos, ((0, pad), (0, 0)))
    parts = []
    for q0 in range(0, n + pad, qb):
        parts.append(_grid_query_map(
            hash_arrays, cells_p[q0:q0 + qb], pos_p[q0:q0 + qb],
            per_row, qb, k, cell_capacity, tile, grid_bits,
            with_nbrs=True))
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.concatenate(leaves)[:n], *parts)


GRID_SRC_MAX = 1 << 21  # largest in-map array size (see _grid_slab_reduce)


def _grid_slab_reduce(pos, valid, cell_size, per_row, k, cell_capacity,
                      tile, grid_bits, query_block, src_max,
                      axis=0, lo=None, row_ids=None):
    """Exact slab decomposition for > src_max rows; see knn_grid_reduce.

    Splits along ``axis``'s cell slices (one-cell halos both sides).  A
    single slice denser than src_max recurses along the next axis — each
    level masks its own axis's halo rows, so a row surviving every
    interior mask had its full 27-cell neighborhood present.  A single
    CELL (all three axes recursed) denser than src_max raises."""
    from . import octree

    n = pos.shape[0]
    g = 1 << grid_bits
    if lo is None:
        lo, cell_size = _effective_cell(pos, valid, cell_size, grid_bits)
    cell_a = jnp.clip(
        jnp.floor((pos[:, axis] - lo[axis]) / cell_size).astype(jnp.int32),
        0, g - 1)
    cell_a = jnp.where(valid, cell_a, g)  # invalid rows: own bin, no slab
    counts = np.asarray(
        jnp.zeros(g + 1, jnp.int32).at[cell_a].add(1))[:g]

    def wsum(a, b):  # slab point count including the one-cell halos
        return int(counts[max(a - 1, 0):min(b + 2, g)].sum())

    slabs = []
    a = 0
    while a < g:
        if counts[a] == 0:
            a += 1
            continue
        b = a
        while b + 1 < g and wsum(a, b + 1) <= src_max:
            b += 1
        slabs.append((a, b))
        a = b + 1

    out = None
    for xa, xb in slabs:
        sel = valid & (cell_a >= xa - 1) & (cell_a <= xb + 1)
        m = wsum(xa, xb)
        # power-of-two slab capacity: exact per-slab caps would compile a
        # fresh executable chain per slab (~40 s each on the remote
        # service); pow2 caps bound the shape set to ~11 sizes reused
        # across slabs AND calls, at <=2x padded-tile compute waste
        cap_s = max(tile, 1 << (max(m, 1) - 1).bit_length())
        cnt_s, idx_s = octree.compact_indices(sel, cap_s)
        row_ok = jnp.arange(cap_s, dtype=jnp.int32) < cnt_s
        sub_pos = jnp.take(pos, idx_s, axis=0)
        # global cloud-row id of each slab row, composed through any
        # recursion level, so per_row's idx stays global everywhere
        sub_ids = idx_s if row_ids is None else jnp.take(row_ids, idx_s)
        if m <= src_max:
            res = _blocked_queries(sub_pos, row_ok, cell_size, per_row,
                                   k, cell_capacity, tile, grid_bits,
                                   query_block, lo=lo, row_ids=sub_ids)
        elif axis < 2:
            res = _grid_slab_reduce(sub_pos, row_ok, cell_size, per_row,
                                    k, cell_capacity, tile, grid_bits,
                                    query_block, src_max,
                                    axis=axis + 1, lo=lo, row_ids=sub_ids)
        else:
            raise RuntimeError(
                "grid k-NN: a one-cell 3x3x3 neighborhood holds > "
                f"{src_max} points after splitting along all three axes "
                "— beyond the in-map array bound; raise grid_bits "
                "when the effective cell is extent-limited "
                "(_effective_cell coarsening), or reduce cell_size when "
                "the caller's raw granularity is what's binding")
        # keep interior rows only (halo rows belong to their own slab)
        interior = (row_ok
                    & (jnp.take(cell_a, idx_s) >= xa)
                    & (jnp.take(cell_a, idx_s) <= xb))
        tgt = jnp.where(interior, idx_s, n)
        if out is None:
            out = jax.tree_util.tree_map(
                lambda leaf: jnp.zeros((n,) + leaf.shape[1:], leaf.dtype),
                res)
        out = jax.tree_util.tree_map(
            lambda acc, leaf: acc.at[tgt].set(leaf, mode="drop"),
            out, res)
    if out is None:  # nothing valid
        probe = per_row(
            jnp.zeros((1, k), jnp.int32), jnp.full((1, k), INF),
            jnp.zeros((1, k, 3), jnp.float32))
        out = jax.tree_util.tree_map(
            lambda leaf: jnp.zeros((n,) + leaf.shape[1:], leaf.dtype),
            probe)
    return out


def _cov_block(pos, nbr_idx, nbr_valid):
    return neighbor_covariance_from(pos[nbr_idx], nbr_valid)


def neighbor_covariance_from(nbrs, nbr_valid=None):
    """Covariance from pre-gathered neighbor coordinates f32[M,k,3] —
    the form knn_grid_reduce per_row callbacks use (they receive ``nbrs``
    from the tile machinery and must not gather rows of the full cloud
    themselves)."""
    if nbr_valid is None:
        count = jnp.float32(nbrs.shape[1])
        mean = jnp.mean(nbrs, axis=1, keepdims=True)
        diff = nbrs - mean
        return jnp.einsum("nki,nkj->nij", diff, diff,
                          precision=jax.lax.Precision.HIGHEST) / count
    w = nbr_valid.astype(jnp.float32)[..., None]          # [M,k,1]
    count = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1.0)  # [M,1,1]
    mean = jnp.sum(nbrs * w, axis=1, keepdims=True) / count      # [M,1,3]
    diff = (nbrs - mean) * w
    # HIGHEST: curvature is an eigenvalue ratio of this matrix, and TF32's
    # ~1e-3 relative error would move the small eigenvalue it divides by
    cov = jnp.einsum("nki,nkj->nij", diff, diff,
                     precision=jax.lax.Precision.HIGHEST)
    return cov / count


def neighbor_covariance(
    pos: jax.Array, nbr_idx: jax.Array, nbr_valid: jax.Array | None = None
) -> jax.Array:
    """Covariance of each point's neighbor set, f32[N,3,3].

    Mean over neighbors then outer-product accumulation, matching
    calculations.rs:342-365 (division by neighbor count, not count-1).

    WARNING: materializes a [N,k,3] neighbor gather — over 10 GB at 30M
    rows x k=31.  Fine for brute-path segment subsets (<=131072 rows at
    the default brute_force_max); full-cloud callers must fuse through
    :func:`knn_grid_reduce`.
    """
    return _cov_block(pos, nbr_idx, nbr_valid)
