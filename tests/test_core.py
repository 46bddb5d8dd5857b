"""Core types, Morton codes, octree build, eigenvalues, k-NN — golden unit tests
(SURVEY.md §4 plan item 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from treee_tpu.cloud import PointCloud
from treee_tpu.ops import eigen, morton, neighbors, octree


def test_pointcloud_padding_and_bounds():
    pos = np.array([[0.0, 1.0, 2.0], [3.0, -1.0, 5.0]], np.float32)
    pc = PointCloud.from_numpy(pos, capacity=16)
    assert pc.capacity == 16
    assert int(pc.count) == 2
    lo, hi = pc.bounds()
    np.testing.assert_allclose(np.asarray(lo), [0.0, -1.0, 2.0])
    np.testing.assert_allclose(np.asarray(hi), [3.0, 1.0, 5.0])


def test_pointcloud_empty_bounds():
    pc = PointCloud.empty(8)
    lo, hi = pc.bounds()
    np.testing.assert_allclose(np.asarray(lo), 0.0)
    np.testing.assert_allclose(np.asarray(hi), 0.0)


def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    cells = rng.integers(0, morton.MORTON_SIZE, size=(1000, 3)).astype(np.uint32)
    keys = morton.encode(jnp.asarray(cells))
    back = np.asarray(morton.decode(keys))
    np.testing.assert_array_equal(back, cells)


def test_morton_order_locality():
    # points in the same octant share high key bits
    a = morton.encode(jnp.array([[0, 0, 0]], jnp.uint32))
    b = morton.encode(jnp.array([[511, 511, 511]], jnp.uint32))
    c = morton.encode(jnp.array([[512, 512, 512]], jnp.uint32))
    assert int(a[0]) >> 27 == int(b[0]) >> 27 == 0
    assert int(c[0]) >> 27 == 7


def test_octree_build_sorted_and_ranks():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-10, 10, size=(500, 3)).astype(np.float32)
    valid = np.ones(500, bool)
    valid[490:] = False
    tree = octree.build(jnp.asarray(pos), jnp.asarray(valid))
    keys = np.asarray(tree.keys)
    assert np.all(np.diff(keys) >= 0)
    # invalid points pushed to the end
    assert np.all(keys[-10:] == int(octree.INVALID_KEY))
    # inverse permutation consistent
    order = np.asarray(tree.order)
    inv = np.asarray(tree.inv)
    np.testing.assert_array_equal(order[inv], np.arange(500))


def test_octree_lod_nested():
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 100, size=(2000, 3)).astype(np.float32)
    valid = np.ones(2000, bool)
    tree = octree.build(jnp.asarray(pos), jnp.asarray(valid))
    m_coarse = np.asarray(octree.lod_mask(tree, level=2))
    m_fine = np.asarray(octree.lod_mask(tree, level=5))
    # every coarse representative also survives at finer level
    assert m_coarse.sum() <= m_fine.sum()
    assert np.all(m_fine[m_coarse])


def test_node_table_counts():
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 100, size=(1000, 3)).astype(np.float32)
    valid = np.ones(1000, bool)
    tree = octree.build(jnp.asarray(pos), jnp.asarray(valid))
    table = octree.node_table(tree, level=1, max_nodes=16)
    n = int(table.n)
    assert 1 <= n <= 8
    counts = np.asarray(table.count)[:n]
    assert counts.sum() == 1000


def test_eigvals_match_numpy():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(200, 3, 3)).astype(np.float32)
    sym = (a + np.transpose(a, (0, 2, 1))) / 2
    ours = np.asarray(eigen.eigvals_sym3(jnp.asarray(sym)))
    ref = np.linalg.eigvalsh(sym.astype(np.float64))[:, ::-1]
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_eigvals_diagonal():
    d = jnp.asarray(np.diag([3.0, 1.0, 2.0]).astype(np.float32))[None]
    out = np.asarray(eigen.eigvals_sym3(d))[0]
    np.testing.assert_allclose(out, [3.0, 2.0, 1.0])


def test_knn_bruteforce_exact():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 10, size=(300, 3)).astype(np.float32)
    valid = np.ones(300, bool)
    idx, dist = neighbors.knn_bruteforce(jnp.asarray(pos), jnp.asarray(valid), k=5, tile=64)
    idx, dist = np.asarray(idx), np.asarray(dist)
    # oracle
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    ref_sorted = np.sort(d2, axis=1)[:, :5]
    np.testing.assert_allclose(np.sort(dist, axis=1), ref_sorted, atol=1e-4)
    # self is a neighbor at distance 0
    assert np.all(dist.min(axis=1) < 1e-6)


def test_knn_bruteforce_respects_valid():
    pos = np.zeros((10, 3), np.float32)
    pos[:, 0] = np.arange(10)
    valid = np.ones(10, bool)
    valid[5:] = False
    idx, _ = neighbors.knn_bruteforce(jnp.asarray(pos), jnp.asarray(valid), k=3, tile=8)
    assert np.all(np.asarray(idx)[:5] < 5)


def test_knn_grid_matches_bruteforce_on_dense_cloud():
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, 4, size=(2000, 3)).astype(np.float32)
    valid = np.ones(2000, bool)
    k = 8
    bi, bd = neighbors.knn_bruteforce(jnp.asarray(pos), jnp.asarray(valid), k=k)
    gi, gd = neighbors.knn_grid(
        jnp.asarray(pos), jnp.asarray(valid), cell_size=1.0, k=k,
        cell_capacity=64, tile=256,
    )
    bd, gd = np.asarray(bd), np.asarray(gd)
    # distances agree for the overwhelming majority (grid is approximate only
    # at cell-cap overflow)
    match = np.isclose(np.sort(gd, 1), np.sort(bd, 1), atol=1e-4).mean()
    assert match > 0.98


def test_neighbor_covariance_plane():
    # points on the y=0 plane: smallest eigenvalue ~0 -> curvature ~0
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, 1, size=(100, 3)).astype(np.float32)
    pos[:, 1] = 0.0
    idx, _ = neighbors.knn_bruteforce(jnp.asarray(pos), jnp.ones(100, bool), k=10)
    cov = neighbors.neighbor_covariance(jnp.asarray(pos), idx)
    curve = np.asarray(eigen.curvature_from_cov(cov))
    assert np.all(curve < 1e-3)


def test_neighbor_covariance_sphere():
    # isotropic blob: eigenvalues similar -> curvature near 1
    rng = np.random.default_rng(8)
    pos = rng.normal(size=(500, 3)).astype(np.float32)
    idx, _ = neighbors.knn_bruteforce(jnp.asarray(pos), jnp.ones(500, bool), k=100)
    cov = neighbors.neighbor_covariance(jnp.asarray(pos), idx)
    curve = np.asarray(eigen.curvature_from_cov(cov))
    assert curve.mean() > 0.3


def test_lod_mask_live_promotes_siblings():
    """Deleting a node's first Morton point must promote a live sibling into
    the LOD subset instead of leaving the node unrepresented (the octree is
    cached across edits; pipeline.Session.build_lod passes live=)."""
    import jax.numpy as jnp

    from treee_tpu.ops import octree, morton

    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 100, size=(5000, 3)).astype(np.float32)
    valid = jnp.ones(5000, bool)
    tree = octree.build(jnp.asarray(pos), valid)
    level = 4

    keep_all = np.asarray(octree.lod_mask(tree, level))
    # drop exactly the selected representatives; nodes with >1 point must
    # re-elect a different live point
    live = jnp.asarray(~keep_all)
    keep_live = np.asarray(octree.lod_mask(tree, level, live=live))
    assert not (keep_live & keep_all).any()  # only live points selected

    shift = 3 * (morton.MORTON_BITS - level)
    prefix = np.asarray(tree.keys) >> shift
    order = np.asarray(tree.order)
    node_of = np.empty(5000, np.int64)
    node_of[order] = prefix
    nodes_with_live = set(np.unique(node_of[np.asarray(live)]))
    nodes_kept = set(np.unique(node_of[keep_live]))
    assert nodes_kept == nodes_with_live  # every live node re-represented


def test_adaptive_mask_near_full_far_sparse():
    """Screen-error cut: points near the camera all survive; far nodes keep
    one representative per coarse cell; everything kept is live."""
    rng = np.random.default_rng(11)
    near = rng.uniform(0.0, 2.0, (400, 3)).astype(np.float32)
    far = (rng.uniform(0.0, 8.0, (400, 3)) + np.array([200.0, 0, 0])).astype(
        np.float32)
    pos = jnp.asarray(np.concatenate([near, far]))
    valid = jnp.ones(800, bool)
    tree = octree.build(pos, valid)
    cam_pos = jnp.asarray(np.array([1.0, 1.0, 1.0], np.float32))
    # px_scale ~ 720p at 45deg fov: f_proj*(h/2) ~ 869 px
    keep = np.asarray(octree.adaptive_mask(
        tree, cam_pos, 869.0, tau_px=8.0, level_min=2, level_max=10))
    assert keep[:400].all()          # near field: full detail
    n_far = int(keep[400:].sum())
    assert 0 < n_far < 200           # far field: heavily decimated
    # far representatives still cover the far cluster spatially
    kept_far = far[keep[400:]]
    assert np.ptp(kept_far[:, 0]) > 4.0

    # moving the camera into the far cluster flips the densities
    keep2 = np.asarray(octree.adaptive_mask(
        tree, jnp.asarray(np.array([204.0, 4.0, 4.0], np.float32)), 869.0,
        tau_px=8.0, level_min=2, level_max=10))
    assert keep2[400:].all()
    assert int(keep2[:400].sum()) < 200


def test_adaptive_mask_respects_live_and_frustum():
    from treee_tpu.render.camera import Camera

    rng = np.random.default_rng(12)
    pos = jnp.asarray(rng.uniform(0, 50, (1000, 3)).astype(np.float32))
    valid = jnp.ones(1000, bool)
    tree = octree.build(pos, valid)
    live = jnp.asarray(rng.random(1000) > 0.5)
    cam = Camera.orbital(distance=500.0)
    keep = np.asarray(octree.adaptive_mask(
        tree, cam.position, 869.0, tau_px=2.0, live=live))
    assert not np.any(keep & ~np.asarray(live))
    # a frustum pointing away culls everything
    away = Camera.orbital(distance=500.0).rotate_orbital(3.14159, 0.0)
    planes = away.frustum_planes(16 / 9)
    keep_away = np.asarray(octree.adaptive_mask(
        tree, away.position, 869.0, tau_px=2.0, live=live, frustum=planes))
    assert keep_away.sum() <= keep.sum()


def test_adaptive_mask_tau_monotone():
    """A finer error budget (smaller tau) never keeps fewer points: each
    region's chosen level is the coarsest with proj <= tau, which is monotone
    in tau."""
    rng = np.random.default_rng(14)
    pos = jnp.asarray(
        (rng.uniform(0, 60, (3000, 3)) ** 1.3).astype(np.float32))
    valid = jnp.ones(3000, bool)
    tree = octree.build(pos, valid)
    cam_pos = jnp.asarray(np.array([-20.0, 10.0, -20.0], np.float32))
    counts = [
        int(np.asarray(octree.adaptive_mask(
            tree, cam_pos, 869.0, tau_px=t, level_min=2, level_max=10)).sum())
        for t in (0.5, 2.0, 8.0, 32.0)
    ]
    assert counts == sorted(counts, reverse=True), counts
    assert counts[0] == 3000  # tau below 1px at this scale: full detail


def test_cummax_blocked_matches_numpy():
    rng = np.random.default_rng(13)
    for n in (1, 7, 255, 256, 257, 1000, 4096, 5000):
        xi = rng.integers(-100, 100, n).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(octree._cummax(jnp.asarray(xi))),
            np.maximum.accumulate(xi))
        xf = rng.normal(size=n).astype(np.float32) * 50
        np.testing.assert_array_equal(
            np.asarray(octree._cummax(jnp.asarray(xf))),
            np.maximum.accumulate(xf))
        np.testing.assert_array_equal(
            np.asarray(octree._revcummin(jnp.asarray(xf))),
            np.minimum.accumulate(xf[::-1])[::-1])


def test_node_table_overflow_drops_consistently():
    """Nodes beyond max_nodes are dropped whole: every retained entry's
    (prefix, start, count) stays a consistent sorted-run descriptor, and
    table.n reporting the TRUE node count flags the truncation.  (Clamping
    overflow nodes into the last slot used to leave it with one node's
    start but the summed count of all overflow nodes.)"""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 100, size=(2000, 3)).astype(np.float32)
    valid = np.ones(2000, bool)
    tree = octree.build(jnp.asarray(pos), jnp.asarray(valid))
    full = octree.node_table(tree, level=2, max_nodes=512)
    n_true = int(full.n)
    assert n_true > 4  # level-2 grid of a uniform cloud has many nodes
    cap = 4
    t = octree.node_table(tree, level=2, max_nodes=cap)
    assert int(t.n) == n_true  # true count: n > max_nodes signals drops
    # retained entries must match the untruncated table exactly
    np.testing.assert_array_equal(np.asarray(t.prefix),
                                  np.asarray(full.prefix)[:cap])
    np.testing.assert_array_equal(np.asarray(t.start),
                                  np.asarray(full.start)[:cap])
    np.testing.assert_array_equal(np.asarray(t.count),
                                  np.asarray(full.count)[:cap])


def test_node_bounds_cover_their_points():
    """Conservative AABBs: every point of a node lies inside the node's
    reported bounds (the cell-size scale once used /1024 against quantize's
    /1023, under-covering each node by span/1024)."""
    rng = np.random.default_rng(6)
    pos = rng.uniform(-40, 60, size=(3000, 3)).astype(np.float32)
    valid = np.ones(3000, bool)
    tree = octree.build(jnp.asarray(pos), jnp.asarray(valid))
    level = 2
    table = octree.node_table(tree, level=level, max_nodes=512)
    blo, bhi = octree.node_bounds(table, tree, level)
    blo, bhi = np.asarray(blo), np.asarray(bhi)
    n = int(table.n)
    starts = np.asarray(table.start)
    counts = np.asarray(table.count)
    order = np.asarray(tree.order)
    eps = 1e-3
    for i in range(n):
        pts = pos[order[starts[i]:starts[i] + counts[i]]]
        assert (pts >= blo[i] - eps).all() and (pts <= bhi[i] + eps).all()


def test_smallest_eigenvector_matches_eigh():
    """smallest_eigenvector vs numpy.linalg.eigh on random symmetric 3x3s:
    unit norm, y >= 0 orientation, |dot| with the eigh vector ~ 1."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((256, 3, 3)).astype(np.float32)
    sym = (a + np.transpose(a, (0, 2, 1))) / 2
    v = np.asarray(eigen.smallest_eigenvector(jnp.asarray(sym)))
    w, vecs = np.linalg.eigh(sym.astype(np.float64))
    ref = vecs[:, :, 0]  # eigh is ascending: column 0 = smallest
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    assert (v[:, 1] >= -1e-6).all()
    # skip near-degenerate pairs where the eigenvector is ill-conditioned
    gap = (w[:, 1] - w[:, 0]) > 1e-3
    dots = np.abs(np.sum(v[gap] * ref[gap], axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)


def test_smallest_eigenvector_degenerate():
    """Rank-deficient inputs (zero matrix, isotropic) fall back to unit +y."""
    z = jnp.zeros((2, 3, 3), jnp.float32).at[1].set(jnp.eye(3))
    v = np.asarray(eigen.smallest_eigenvector(z))
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(v[0], [0.0, 1.0, 0.0], atol=1e-6)


def test_build_keys_matches_build():
    """octree.build_keys (keys-only, unstable sort) returns bit-identical
    sorted keys to octree.build — same multiset, minus the stable-sort tax
    the fused benchmark step doesn't need."""
    from treee_tpu.ops import octree

    rng = np.random.default_rng(3)
    pos = rng.uniform(-40, 40, (6000, 3)).astype(np.float32)
    # force Morton-key collisions: duplicate rows (ties are where stable
    # and unstable sorts may differ — keys must still match exactly)
    pos[3000:3500] = pos[:500]
    valid = rng.random(6000) < 0.9
    tree = octree.build(jnp.asarray(pos), jnp.asarray(valid))
    keys = octree.build_keys(jnp.asarray(pos), jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(keys), np.asarray(tree.keys))


def test_transfer_fetch_chunked_and_gather_rows():
    """utils/transfer: chunked device->host fetch is bit-identical to a
    monolithic np.asarray, counts bytes, and gather_rows moves only the
    selected rows."""
    import jax.numpy as jnp

    from treee_tpu.utils import transfer

    rng = np.random.default_rng(3)
    host = rng.normal(size=(5000, 3)).astype(np.float32)
    dev = jnp.asarray(host)

    transfer.fetched_bytes = 0
    got = transfer.fetch(dev, chunk_bytes=4096)  # forces many chunks
    np.testing.assert_array_equal(got, host)
    assert transfer.fetched_bytes == host.nbytes

    out = np.empty_like(host)
    got2 = transfer.fetch(dev, chunk_bytes=4096, out=out)
    assert got2 is out
    np.testing.assert_array_equal(out, host)

    # host arrays pass through without counting
    transfer.fetched_bytes = 0
    np.testing.assert_array_equal(transfer.fetch(host), host)
    assert transfer.fetched_bytes == 0

    ids = np.asarray([4999, 0, 17], np.int32)
    np.testing.assert_array_equal(transfer.gather_rows(dev, ids), host[ids])
    np.testing.assert_array_equal(transfer.gather_rows(host, ids), host[ids])

    mask = jnp.asarray(np.arange(5000) % 7 == 0)
    got_ids, cnt = transfer.mask_ids(mask)
    assert cnt == int(np.asarray(mask).sum())
    np.testing.assert_array_equal(np.asarray(got_ids),
                                  np.flatnonzero(np.asarray(mask)))


def test_compact_indices_matches_scatter_reference():
    """The packed-sort compact_indices must be bit-identical to the
    cumsum+scatter form it replaced (round 5: the sort form cut the
    focused-segment compaction from ~200 ms to one ~25-45 ms key-only
    unstable sort at 15M, octree.py compact_indices docstring)."""

    def reference(mask, capacity):
        pos_idx = jnp.cumsum(mask.astype(jnp.int32)) - 1
        tgt = jnp.where(mask & (pos_idx < capacity), pos_idx, capacity)
        count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), capacity)
        src = jnp.arange(mask.shape[0], dtype=jnp.int32)
        idx = jnp.zeros(capacity + 1, jnp.int32).at[tgt].set(
            src, mode="drop")
        return count, idx[:capacity]

    rng = np.random.default_rng(7)
    for n, cap in [(257, 64), (1024, 1024), (100, 256), (4096, 512),
                   (33, 1), (8, 8)]:
        for p in (0.0, 0.03, 0.5, 1.0):
            mask = jnp.asarray(rng.random(n) < p)
            c0, i0 = reference(mask, cap)
            c1, i1 = octree.compact_indices(mask, cap)
            assert int(c0) == int(c1), (n, cap, p)
            np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1),
                                          err_msg=f"{(n, cap, p)}")


def test_knn_grid_reduce_slab_matches_direct():
    """Round-5: above GRID_SRC_MAX rows the fused grid k-NN runs as an
    exact slab decomposition (x-cell slices + one-cell halos, recursing
    along y/z for oversized slices) — the in-map array-size bound of
    ops/neighbors.py.  Slab results must equal the
    single-hash path bit-for-bit when no cell overflows cell_capacity
    (the global grid origin is shared, so quantization is identical)."""
    from treee_tpu.ops import eigen

    def per_row(i, d, nb):
        cov = neighbors.neighbor_covariance_from(nb, nbr_valid=d < 3.0e38)
        return eigen.curvature_from_cov(cov)

    def per_row_ids(i, d, nb):
        # consumes the GLOBAL neighbor ids: pins the slab path's
        # row_ids remap (slab-local indices would change this sum)
        return jnp.sum(jnp.where(d < 3.0e38, i, 0), axis=-1).astype(
            jnp.float32)

    rng = np.random.default_rng(5)
    n = 50_000
    member = jnp.asarray(rng.random(n) < 0.8)
    saved = neighbors.GRID_SRC_MAX
    try:
        for scale in ([60, 20, 20], [0.2, 40, 40]):  # 2nd forces y-recursion
            pos = jnp.asarray(
                rng.random((n, 3), dtype=np.float32)
                * np.asarray(scale, np.float32))
            for pr in (per_row, per_row_ids):
                neighbors.GRID_SRC_MAX = 1 << 30
                direct = np.asarray(
                    neighbors.knn_grid_reduce(pos, member, 0.5, pr, k=15))
                neighbors.GRID_SRC_MAX = 8192
                slab = np.asarray(
                    neighbors.knn_grid_reduce(pos, member, 0.5, pr, k=15,
                                              query_block=4096))
                m = np.asarray(member)
                np.testing.assert_array_equal(
                    direct[m], slab[m], err_msg=f"{scale} {pr.__name__}")
    finally:
        neighbors.GRID_SRC_MAX = saved
