"""Morton-coded linear octree: sort-based build, LOD subsampling, node tables.

The reference renders brute-force — every chunk's full point buffer every frame, no
octree/LOD/culling (treee/src/program.rs:309-311; SURVEY.md §0 negative findings).
This module is the improvement the reference lacks, designed as array programs:

- *Build* = one ``jax.lax.sort`` over Morton keys (ops/morton.py) plus segmented
  rank computation.  No pointers, no recursion: a node at level ``l`` is the run of
  sorted points sharing the key prefix ``key >> 3*(10-l)``.
- *LOD* = per-point rank within its leaf-level node; level-of-detail ``d`` keeps
  points whose rank is a multiple of a stride, giving a deterministic nested
  point hierarchy (coarser levels are subsets of finer ones).
- *Node tables* = padded (start, count, key-prefix) arrays per level for culling
  and Morton-range sharding.

Everything is fixed-shape and jit-compatible.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import morton
from ..utils import struct

INVALID_KEY = jnp.int32(0x7FFFFFFF)


def _dtype_min(dtype):
    return (
        jnp.finfo(dtype).min
        if jnp.issubdtype(dtype, jnp.floating)
        else jnp.iinfo(dtype).min
    )


_CUMMAX_BLOCK = 256


def _cummax(x: jax.Array) -> jax.Array:
    """Cumulative max, two-level: blocked doubling + tiny cross-block scan.

    ``lax.associative_scan``'s recursive odd/even slicing blows up XLA
    *compile* time somewhere between 1M and 4M elements.  Flat shifted-max
    doubling takes 24 passes at 15M; the blocked form cuts that to log2(256)=8 in-block passes plus an
    ``associative_scan`` over the N/256 block maxima (safe at that size —
    same structure as characteristics._segmented_cummax).
    """
    n = x.shape[0]
    blk = _CUMMAX_BLOCK
    if n <= blk:
        y = x
        s = 1
        while s < n:
            pad = jnp.broadcast_to(y[:1], (s,))  # filler; masked out below
            shifted = jnp.concatenate([pad, y[:-s]])
            y = jnp.where(jnp.arange(n) >= s, jnp.maximum(y, shifted), y)
            s *= 2
        return y

    nb = -(-n // blk)
    fill = _dtype_min(x.dtype)
    xb = jnp.pad(x, (0, nb * blk - n), constant_values=fill).reshape(nb, blk)
    idx = jnp.arange(blk)[None, :]
    s = 1
    while s < blk:
        shifted = jnp.concatenate([xb[:, :s], xb[:, :-s]], axis=1)
        xb = jnp.where(idx >= s, jnp.maximum(xb, shifted), xb)
        s *= 2
    carry = jax.lax.associative_scan(jnp.maximum, xb[:, -1])
    prev = jnp.concatenate([jnp.full((1,), fill, x.dtype), carry[:-1]])
    xb = jnp.maximum(xb, prev[:, None])
    return xb.reshape(nb * blk)[:n]


def _revcummin(x: jax.Array) -> jax.Array:
    """Reverse cumulative min: flips around the forward max scan."""
    return -jnp.flip(_cummax(jnp.flip(-x)))


class Octree(struct.PyTreeNode):
    """Linear octree over a fixed-capacity point set.

    Attributes:
      keys:   i32[N] sorted Morton keys; padding slots hold INVALID_KEY.
      order:  i32[N] original point index per sorted slot.
      rank:   i32[N] rank of each sorted slot within its leaf node.
      inv:    i32[N] sorted slot per original point index (inverse permutation).
      lo, hi: f32[3] bounding cube used for quantization.
    """

    keys: jax.Array
    order: jax.Array
    rank: jax.Array
    inv: jax.Array
    lo: jax.Array
    hi: jax.Array

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def _bounds_and_keys(pos: jax.Array, valid: jax.Array):
    """Shared build prologue: masked bounds with the (0,1) empty-cloud
    fallback + Morton keys with INVALID_KEY padding.  One copy for
    :func:`build` and :func:`build_keys` — the sentinel masking and the
    fallback are past bug-fix sites (all-padding-shard bounds corruption,
    review 2026-08-19); two copies would let a future fix desynchronize
    the bench's keys from the tree's."""
    big = jnp.float32(3.0e38)
    lo = jnp.min(jnp.where(valid[:, None], pos, big), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], pos, -big), axis=0)
    any_valid = jnp.any(valid)
    lo = jnp.where(any_valid, lo, 0.0)
    hi = jnp.where(any_valid, hi, 1.0)
    keys = morton.encode_positions(pos, lo, hi)
    keys = jnp.where(valid, keys, INVALID_KEY)
    return keys, lo, hi


def build_keys(pos: jax.Array, valid: jax.Array) -> jax.Array:
    """Sorted Morton keys only — the fused-pipeline form of :func:`build`.

    The benchmark's fused step consumes only ``tree.keys`` (XLA DCEs the
    order/rank/inv payloads), and a KEY-ONLY sort returns the identical
    sorted array whether stable or not (same multiset), and a stable sort
    costs more.  Callers that need ``order``/``rank`` (LOD masks) use
    :func:`build`, whose stable sort keeps tie order canonical so the
    sharded shard-local sorts compose to the global one bit-exactly
    (parallel/sharding.py Morton-range notes).
    """
    keys, _, _ = _bounds_and_keys(pos, valid)
    (keys_sorted,) = jax.lax.sort((keys,), num_keys=1, is_stable=False)
    return keys_sorted


def build(pos: jax.Array, valid: jax.Array) -> Octree:
    """Build the linear octree for f32[N,3] positions with a validity mask."""
    n = pos.shape[0]
    keys, lo, hi = _bounds_and_keys(pos, valid)
    idx = jnp.arange(n, dtype=jnp.int32)
    keys_sorted, order = morton.sort_by_key(keys, idx)

    # Rank within leaf node: position since the last key change.
    new_node = jnp.concatenate(
        [jnp.ones(1, bool), keys_sorted[1:] != keys_sorted[:-1]]
    )
    slot = jnp.arange(n, dtype=jnp.int32)
    node_start = _cummax(jnp.where(new_node, slot, 0))
    rank = slot - node_start

    inv = jnp.zeros(n, jnp.int32).at[order].set(slot)
    return Octree(keys=keys_sorted, order=order, rank=rank, inv=inv, lo=lo, hi=hi)


def _cell_bounds(tree: Octree, coarse: jax.Array, level: int):
    """AABB (lo, hi) of the level-``level`` cell with prefix ``coarse``.

    Elementwise over any shape of prefixes — shared by the per-node table
    (node_bounds) and the per-sorted-slot frustum test (lod_mask)."""
    shift = 3 * (morton.MORTON_BITS - level)
    base_keys = (coarse << shift).astype(jnp.int32)
    cell = morton.decode(base_keys).astype(jnp.float32)
    extent = jnp.maximum(jnp.max(tree.hi - tree.lo), 1e-6)
    # same denominator as morton.quantize (extent/(MORTON_SIZE-1) per grid
    # step): a /MORTON_SIZE cell size under-covered each node by span/1024,
    # breaking the frustum test's conservativeness for boundary points
    cell_size = (extent / (morton.MORTON_SIZE - 1)
                 * (1 << (morton.MORTON_BITS - level)))
    lo = tree.lo + cell / (morton.MORTON_SIZE - 1) * extent
    return lo, lo + cell_size


def _node_ranks(
    new_node: jax.Array, live_sorted: jax.Array, cum: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(rank among live slots of the node, live count of the node) per slot.

    ``cum`` is the inclusive cumulative live count (shared across levels when
    ranking the same liveness at several octree levels): the node-start
    exclusive value broadcasts forward, the node-end inclusive value
    broadcasts backward.
    """
    start_excl = _cummax(jnp.where(new_node, cum - live_sorted, 0))
    is_end = jnp.concatenate([new_node[1:], jnp.ones(1, bool)])
    end_incl = _revcummin(jnp.where(is_end, cum, jnp.int32(0x7FFFFFFF)))
    return cum - 1 - start_excl, end_incl - start_excl


def aabb_in_frustum(lo: jax.Array, hi: jax.Array, planes: jax.Array) -> jax.Array:
    """Conservative AABB-vs-frustum test, elementwise over [..., 3] boxes.

    ``planes`` f32[6,4] from Camera.frustum_planes; a box passes when its
    positive vertex is inside every plane (the standard p-vertex test — the
    improvement the reference left dead at camera_3d.rs:20-51).
    """
    n = planes[:, :3]                                 # [6,3]
    pv = jnp.where(n > 0, hi[..., None, :], lo[..., None, :])  # [...,6,3]
    d = jnp.sum(pv * n, axis=-1) + planes[:, 3]
    return jnp.all(d >= 0.0, axis=-1)


def lod_mask(
    tree: Octree,
    level: int,
    points_per_node: int = 1,
    live: jax.Array | None = None,
    frustum: jax.Array | None = None,
) -> jax.Array:
    """Boolean mask (in ORIGINAL point order) of the LOD subset for ``level``.

    ``level`` in [0, 10]: points are grouped by the level-``level`` key prefix and
    up to ``points_per_node`` representatives per node survive, strided evenly
    through the node's Morton run so the subset stays spatially spread (taking the
    first k would bias toward one child octant).  Coarser levels select subsets of
    finer levels' selections per nesting of the Morton prefixes.

    ``live`` (original order, e.g. validity minus deleted points) makes ranks
    and strides count only live points, so deleting a node's first Morton
    point promotes a live sibling instead of leaving the node unrepresented —
    required when the octree is cached across edits (pipeline.Session).

    ``frustum`` (f32[6,4] planes from Camera.frustum_planes) culls whole
    level-``level`` nodes outside the view before selection: each sorted
    slot's node AABB decodes elementwise from its own key prefix (no node
    table, no gather), so an off-screen forest compacts to ~nothing.
    """
    shift = 3 * (morton.MORTON_BITS - level)
    coarse = tree.keys >> shift
    n = tree.capacity
    new_node = jnp.concatenate([jnp.ones(1, bool), coarse[1:] != coarse[:-1]])
    slot = jnp.arange(n, dtype=jnp.int32)
    live_sorted = (
        tree.keys != INVALID_KEY
        if live is None
        else live[tree.order] & (tree.keys != INVALID_KEY)
    )
    if frustum is not None:
        lo_c, hi_c = _cell_bounds(tree, coarse, level)
        live_sorted &= aabb_in_frustum(lo_c, hi_c, frustum)
    # rank among LIVE slots of the node + live count per node, from one
    # cumulative live count: exclusive value at the node start broadcast
    # forward, inclusive value at the node end broadcast backward
    cum = jnp.cumsum(live_sorted.astype(jnp.int32))
    rank, count = _node_ranks(new_node, live_sorted, cum)
    stride = jnp.maximum((count + points_per_node - 1) // points_per_node, 1)
    keep_sorted = live_sorted & (rank % stride == 0)
    # scatter back to original order
    keep = jnp.zeros(n, bool).at[tree.order].set(keep_sorted)
    return keep


def _level_proj(tree: Octree, lvl: int, cam_pos, px_scale):
    """Per-slot (shift, prefix, cell AABB, projected pixel size) at one
    octree level — the screen-error geometry shared by adaptive_mask,
    adaptive_counts, and parallel/sharding.sharded_adaptive_mask (single
    source so the three selection loops cannot drift)."""
    shift = 3 * (morton.MORTON_BITS - lvl)
    coarse = tree.keys >> shift
    lo_c, hi_c = _cell_bounds(tree, coarse, lvl)
    center = 0.5 * (lo_c + hi_c)
    dist = jnp.sqrt(jnp.sum((center - cam_pos) ** 2, axis=-1))
    extent = jnp.maximum(jnp.max(tree.hi - tree.lo), 1e-6)
    cell = extent / jnp.float32(1 << lvl)
    proj = cell * px_scale / jnp.maximum(dist, 1e-3)
    return shift, coarse, lo_c, hi_c, proj


def _level_ring(proj, tau_px, lvl: int, level_min: int, level_max: int):
    """(ring, near_all) membership for one level's screen-error band:
    ``proj_l <= tau < 2*proj_l`` rings partition by monotonicity; the
    coarsest level absorbs the far field, the finest keeps every live
    point whose cells still project larger than tau (near_all)."""
    if lvl == level_min:
        ring = proj <= tau_px
    else:
        ring = (proj <= tau_px) & (2.0 * proj > tau_px)
    if lvl == level_max:
        near_all = proj > tau_px
        ring = ring | near_all
    else:
        near_all = None
    return ring, near_all


def adaptive_mask(
    tree: Octree,
    cam_pos: jax.Array,        # f32[3] camera position (world)
    px_scale: jax.Array | float,  # f_proj * height/2: world->pixel size at d=1
    tau_px: float = 1.5,
    level_min: int = 4,
    level_max: int = 10,
    live: jax.Array | None = None,
    frustum: jax.Array | None = None,
) -> jax.Array:
    """Screen-error-driven LOD cut: per-region octree level by camera distance.

    Classic point-cloud-viewer selection (the reference has no LOD at all —
    program.rs:309-311 draws every point every frame): a node is rendered at
    the COARSEST level whose cell projects to at most ``tau_px`` pixels at the
    node's distance, so nearby regions keep full detail while the far field
    collapses to one representative per coarse cell.  For each candidate level
    the ring test is ``proj_l <= tau < 2*proj_l`` (the parent cell projects
    ~2x the child at the same distance); the finest ring (``level_max``) keeps
    ALL live points, since even its cells project larger than ``tau_px``.
    Rings partition by monotonicity, so every live point is represented
    exactly once.  Everything is elementwise over the sorted keys (cell
    centers decode from each slot's own prefix — no node table, no gathers);
    only the final original-order scatter touches indexed memory, exactly
    like :func:`lod_mask`.

    Returns a boolean keep-mask in ORIGINAL point order.
    """
    n = tree.capacity
    live_sorted = (
        tree.keys != INVALID_KEY
        if live is None
        else live[tree.order] & (tree.keys != INVALID_KEY)
    )
    px_scale = jnp.asarray(px_scale, jnp.float32)
    keep_sorted = jnp.zeros(n, bool)

    # previous live slot's FULL key, via ONE doubling scan shared by every
    # level: sorted keys are non-decreasing, so the running max of live keys
    # before a slot IS the previous live key, and "first live slot of the
    # level-l node" is just a shift+compare (max commutes with the monotone
    # >> shift) — this replaces a per-level _cummax with a per-level ALU op
    run_key = _cummax(jnp.where(live_sorted, tree.keys, -1))
    prev_key = jnp.concatenate(
        [jnp.full((1,), -1, run_key.dtype), run_key[:-1]]
    )

    for lvl in range(level_min, level_max + 1):
        shift, coarse, lo_c, hi_c, proj = _level_proj(
            tree, lvl, cam_pos, px_scale)
        ring, near_all = _level_ring(proj, tau_px, lvl, level_min, level_max)
        sel = live_sorted & ring
        if near_all is None:
            near_all = jnp.zeros(n, bool)
        if frustum is not None:
            sel &= aabb_in_frustum(lo_c, hi_c, frustum)
        # arithmetic shift keeps the no-previous-live sentinel: -1 >> s == -1
        first_live = live_sorted & ((prev_key >> shift) < coarse)
        keep_sorted |= sel & (near_all | first_live)

    keep = jnp.zeros(n, bool).at[tree.order].set(keep_sorted)
    return keep


@functools.partial(
    jax.jit, static_argnames=("taus", "level_min", "level_max"))
def adaptive_counts(
    tree: Octree,
    cam_pos: jax.Array,
    px_scale: jax.Array | float,
    taus: tuple[float, ...],
    level_min: int = 4,
    level_max: int = 10,
    live: jax.Array | None = None,
    frustum: jax.Array | None = None,
) -> jax.Array:
    """Keep-counts of :func:`adaptive_mask` for a LADDER of taus in ONE pass.

    The expensive per-level work (cell decode, camera distance, the shared
    previous-live-key scan) is tau-independent; each candidate tau adds only
    elementwise ring compares, so solving "which tau fits my row budget"
    costs one dispatch instead of len(taus) mask builds.  Counts are exactly
    ``adaptive_mask(..., tau).sum()`` per tau (pinned by test) — the
    monotone-decreasing count curve is what Session.solve_adaptive_tau
    bisects.  Returns i32[len(taus)].
    """
    n = tree.capacity
    live_sorted = (
        tree.keys != INVALID_KEY
        if live is None
        else live[tree.order] & (tree.keys != INVALID_KEY)
    )
    px_scale = jnp.asarray(px_scale, jnp.float32)
    run_key = _cummax(jnp.where(live_sorted, tree.keys, -1))
    prev_key = jnp.concatenate(
        [jnp.full((1,), -1, run_key.dtype), run_key[:-1]]
    )
    keeps = [jnp.zeros(n, bool) for _ in taus]
    for lvl in range(level_min, level_max + 1):
        shift, coarse, lo_c, hi_c, proj = _level_proj(
            tree, lvl, cam_pos, px_scale)
        in_frustum = (
            aabb_in_frustum(lo_c, hi_c, frustum)
            if frustum is not None else None
        )
        first_live = live_sorted & ((prev_key >> shift) < coarse)
        for k, tau in enumerate(taus):
            ring, near_all = _level_ring(proj, tau, lvl, level_min,
                                         level_max)
            if near_all is None:
                near_all = jnp.zeros(n, bool)
            sel = live_sorted & ring
            if in_frustum is not None:
                sel &= in_frustum
            keeps[k] |= sel & (near_all | first_live)
    return jnp.stack([jnp.sum(k.astype(jnp.int32)) for k in keeps])


class NodeTable(struct.PyTreeNode):
    """Padded per-level node table: contiguous sorted-point ranges per node.

    Attributes:
      prefix: i32[M] level-l key prefix per node (INVALID_KEY padding).
      start:  i32[M] first sorted slot of the node.
      count:  i32[M] number of points in the node.
      n:      i32    number of real nodes.
    """

    prefix: jax.Array
    start: jax.Array
    count: jax.Array
    n: jax.Array


def node_table(tree: Octree, level: int, max_nodes: int) -> NodeTable:
    """Extract the level-``level`` node table, padded to ``max_nodes`` entries.

    Nodes beyond ``max_nodes`` are DROPPED (``n`` still reports the true
    count, so ``n > max_nodes`` signals the truncation).  Clamping them into
    the last slot instead would leave entry max_nodes-1 with an arbitrary
    winner's prefix/start but the summed count of every overflow node — an
    inconsistent range a consumer could walk out of bounds."""
    shift = 3 * (morton.MORTON_BITS - level)
    coarse = jnp.where(tree.keys != INVALID_KEY, tree.keys >> shift, INVALID_KEY)
    new_node = jnp.concatenate([jnp.ones(1, bool), coarse[1:] != coarse[:-1]])
    new_node &= coarse != INVALID_KEY
    n_cap = tree.capacity

    node_id = jnp.cumsum(new_node.astype(jnp.int32)) - 1  # per sorted slot
    slot = jnp.arange(n_cap, dtype=jnp.int32)
    n_nodes = jnp.sum(new_node.astype(jnp.int32))

    in_cap = node_id < max_nodes
    tgt = jnp.where(new_node & in_cap, node_id, max_nodes)
    prefix = jnp.full(max_nodes + 1, INVALID_KEY, jnp.int32).at[tgt].set(coarse)
    start = jnp.zeros(max_nodes + 1, jnp.int32).at[tgt].set(slot)
    # counts via segment_sum over node ids of valid slots
    valid_slot = coarse != INVALID_KEY
    seg = jnp.where(valid_slot & in_cap, node_id, max_nodes)
    count = jax.ops.segment_sum(
        valid_slot.astype(jnp.int32), seg, num_segments=max_nodes + 1
    )
    return NodeTable(
        prefix=prefix[:max_nodes],
        start=start[:max_nodes],
        count=count[:max_nodes],
        n=n_nodes,  # true count: n > max_nodes flags dropped nodes
    )


def compact(
    mask: jax.Array, capacity: int, *arrays: jax.Array
) -> tuple[jax.Array, tuple[jax.Array, ...]]:
    """Gather masked rows into dense fixed-capacity buffers.

    Returns (count, compacted arrays).  Rows beyond ``capacity`` are dropped;
    padding rows are zero.  Used to materialize LOD subsets once per scene so
    per-frame rasterization touches only the subset (the reference draws every
    point every frame, program.rs:309-311 — this is the LOD path it lacks).
    """
    pos_idx = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (pos_idx < capacity), pos_idx, capacity)
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), capacity)
    outs = []
    for a in arrays:
        shape = (capacity + 1,) + a.shape[1:]
        out = jnp.zeros(shape, a.dtype).at[tgt].set(a, mode="drop")
        outs.append(out[:capacity])
    return count, tuple(outs)


def node_bounds(table: NodeTable, tree: Octree, level: int) -> tuple[jax.Array, jax.Array]:
    """AABB (lo, hi) f32[M,3] for each node in the table (frustum culling —
    same cell math as lod_mask's per-slot test, via _cell_bounds)."""
    return _cell_bounds(tree, table.prefix, level)


def compact_indices(mask: jax.Array, capacity: int) -> tuple[jax.Array, jax.Array]:
    """Dense original-order indices of masked rows -> (count, idx i32[cap]).

    The index form makes LOD refresh after edits O(subset): positions never
    move, so ``pos[idx]`` is computed once per rebuild and per-edit state
    (segment/valid) re-reads through the same indices with subset-sized
    gathers instead of full-N compaction passes (pipeline.Session.build_lod).
    Padding slots hold index 0 — mask them with ``arange < count``.

    Implementation: pack ``(~mask << 30) | row`` into one i32 and key-only
    unstable-sort it — masked rows land first, in ascending row order, so
    the head slice IS the compaction, with no cumsum + [N]-operand
    scatter.  Output is bit-identical to that form: both forms keep the first
    ``capacity`` masked rows in ascending original order with 0-padding.
    The packed form needs row indices < 2^30; larger arrays take the
    scatter fallback.
    """
    n = mask.shape[0]
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), capacity)
    if n <= (1 << 30):
        src = jnp.arange(n, dtype=jnp.int32)
        keys = jnp.where(mask, src, src | (1 << 30))
        keys = jax.lax.sort(keys, is_stable=False)
        take = min(capacity, n)
        head = keys[:take] & ((1 << 30) - 1)
        if take < capacity:
            head = jnp.concatenate(
                [head, jnp.zeros(capacity - take, jnp.int32)])
        idx = jnp.where(jnp.arange(capacity, dtype=jnp.int32) < count,
                        head, 0)
        return count, idx
    pos_idx = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (pos_idx < capacity), pos_idx, capacity)
    src = jnp.arange(n, dtype=jnp.int32)
    idx = jnp.zeros(capacity + 1, jnp.int32).at[tgt].set(src, mode="drop")
    return count, idx[:capacity]


def snug_capacity(n: int, headroom: float = 1.25, floor: int = 4096) -> int:
    """Snug padded row capacity for an ``n``-row LOD subset (host-side int).

    Projection/scatter frame cost scales with the PADDED row count, not the
    live count.  Next-power-of-two padding wastes up to 2x at
    multi-million-row subsets, so the granule is 1/16 of the magnitude (2^max(12, b-4)):
    at most ~6% padding waste while keeping XLA-friendly aligned sizes and a
    small reusable-shape set.  ``headroom`` leaves room for draw/restore edits
    growing the subset before the next rebuild.
    """
    t = max(int(n * headroom), 1)
    g = 1 << max(12, t.bit_length() - 4)
    return max(floor, -(-t // g) * g)
