"""Focused-view parity: separator updates from edited classes, class-filtered
exports with real curvature, IncludeMode masks, deleted-point picking, and
frustum-culled LOD (round-2 items from the reference's focused view,
interactive/mod.rs:182-221, 629-660; hull.rs:15-67; camera_3d.rs:20-51)."""

import numpy as np
import jax.numpy as jnp
import pytest

from treee_tpu.cloud import (
    CLASS_CROWN, CLASS_GROUND, CLASS_TRUNK, include_mask,
)
from treee_tpu.config import Config, SegmentationConfig
from treee_tpu.io import las
from treee_tpu.pipeline import Session
from treee_tpu.render import Camera

CFG = Config(
    segmentation=SegmentationConfig(
        grid_size=128, max_bands=16, max_segments=256, max_trees_per_band=32,
    )
)


@pytest.fixture(scope="module")
def session():
    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=11)
    s = Session.from_points(pts, CFG)
    s.segment(0.75)
    return s


def _a_tree_segment(s):
    t = s.table
    counts = np.asarray(t.count)
    present = np.asarray(t.present)
    # largest non-ground-ish segment with some crown points
    cls = np.asarray(s.cloud.classification)
    seg = np.asarray(s.cloud.segment)
    best, best_crown = None, 0
    for sid in np.flatnonzero(present):
        crown = int(((seg == sid) & (cls == CLASS_CROWN)).sum())
        if crown > best_crown:
            best, best_crown = int(sid), crown
    assert best is not None
    return best


def test_include_mask_modes():
    cls = jnp.asarray([CLASS_GROUND, CLASS_TRUNK, CLASS_CROWN])
    assert include_mask(cls, "all").tolist() == [True, True, True]
    assert include_mask(cls, "crown").tolist() == [False, False, True]
    assert include_mask(cls, "trunk").tolist() == [False, True, False]
    assert include_mask(cls, "ground").tolist() == [True, False, False]
    assert include_mask(cls, "tree").tolist() == [False, True, True]
    assert include_mask(cls, "nocrown").tolist() == [True, True, False]
    with pytest.raises(ValueError):
        include_mask(cls, "bogus")


def test_separators_update_from_edited_classes(session):
    """Brushing points to Trunk moves ground_sep to the lowest trunk point
    (SegmentData::changed, mod.rs:199-221) instead of re-deriving it from the
    area profile over the user's edit."""
    s = session
    sid = _a_tree_segment(s)
    seg = np.asarray(s.cloud.segment)
    pos = np.asarray(s.cloud.pos)
    member = (seg == sid) & np.asarray(s.cloud.valid)
    ys = pos[member, 1]
    # reclassify the segment's points below its midline to Trunk
    mid = (ys.min() + ys.max()) / 2.0
    center = pos[member][np.argmin(pos[member, 1])]
    s.reclassify_sphere(center, CLASS_TRUNK, sid, radius=1e9)
    # every member is Trunk now -> ground_sep = segment min y,
    # trunk_height = full y extent, crown cleared
    t = s.table
    assert float(t.ground_sep[sid]) == pytest.approx(float(ys.min()), abs=1e-3)
    assert float(t.trunk_height[sid]) == pytest.approx(
        float(ys.max() - ys.min()), abs=1e-3)
    assert float(t.crown_height[sid]) == 0.0
    # restore for other tests
    s.characteristics()


def test_export_points_ply_real_curvature(session, tmp_path):
    """The focused export writes computed curvature (mod.rs:1069-1107), not
    zeros, and class filters write only that class's points."""
    s = session
    sid = _a_tree_segment(s)
    path = str(tmp_path / "seg.ply")
    n = s.export_points_ply(path, segment_id=sid, include="all")
    text = open(path).read()
    assert f"element vertex {n}" in text
    body = [ln.split() for ln in
            text.split("end_header\n", 1)[1].strip().splitlines()]
    assert len(body) == n
    curve = np.asarray([float(r[5]) for r in body])
    assert (curve > 0).any()  # real k-NN PCA curvature, not zeros

    cls = np.asarray(s.cloud.classification)
    seg = np.asarray(s.cloud.segment)
    n_crown = s.export_points_ply(str(tmp_path / "c.ply"),
                                  segment_id=sid, include="crown")
    expect = int(((seg == sid) & (cls == CLASS_CROWN)
                  & np.asarray(s.cloud.valid)).sum())
    assert n_crown == expect


def test_pick_include_deleted(session):
    """A fully deleted region stays targetable with include_deleted, like the
    reference's show_deleted brush (mod.rs:845-870)."""
    s = session
    pos = np.asarray(s.cloud.pos)
    live = np.asarray(s.cloud.valid)
    target = pos[live][0]
    # aim the camera straight at the target point
    s.camera = Camera.orbital(distance=40.0)
    w, h = s.config.render.width, s.config.render.height
    # brute force: find a pixel whose ray passes near the target
    cam = s.camera
    d = np.asarray(target) - np.asarray(cam.position)
    d = d / np.linalg.norm(d)
    # project direction into pixel coords (inverse of ray_direction)
    import math
    dist = (h / 2.0) / math.tan(cam.fov_y / 2.0)
    local = np.asarray(cam.transform[:3, :3]).T @ d
    scale = -dist / local[2]
    px = local[0] * scale + w / 2.0
    py = -(local[1] * scale) + h / 2.0
    sid0, _, found0 = s.pick(px, py)
    assert found0
    s.delete_sphere(target, radius=3.0)
    _, _, found_del = s.pick(px, py)
    seg2, _, found_incl = s.pick(px, py, include_deleted=True)
    assert found_incl  # visible-with-show-deleted region is targetable
    s.draw_sphere(target, sid0, radius=3.0, include_deleted=True)  # restore


def test_frustum_culled_lod(session):
    """node_bounds' consumer: a camera looking away culls every LOD node, so
    the subset compacts to ~nothing (the improvement the reference left dead
    at camera_3d.rs:20-51)."""
    from treee_tpu.ops import octree

    s = session
    tree = octree.build(s.cloud.pos, s.cloud.valid)
    live = s.cloud.valid & (s.cloud.segment != 0)

    toward = Camera.orbital(distance=80.0)
    away = toward.replace(
        transform=toward.transform.at[:3, :3].set(
            jnp.asarray([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
        ).at[2, 3].set(300.0)
    )
    m_in = octree.lod_mask(tree, 6, live=live,
                           frustum=toward.frustum_planes(16 / 9))
    m_out = octree.lod_mask(tree, 6, live=live,
                            frustum=away.frustum_planes(16 / 9))
    assert int(m_in.sum()) > 0
    assert int(m_out.sum()) == 0

    # Session path: snug capacity collapses to the 4096 floor and renders
    s.build_lod(level=6, camera=away)
    assert s._lod[0].shape[0] == 4096
    img = s.render(camera=away, use_lod=True)
    assert img.ndim == 3
    s.build_lod(level=6)  # restore the uncried subset for other tests


def test_lod_snug_capacity(session):
    """build_lod pads to a snug granular capacity (frame cost scales with
    padded rows; pow2 padding wastes up to 2x at multi-million-row
    adaptive subsets)."""
    from treee_tpu.ops import octree

    s = session
    s.build_lod(level=6)
    pos_c, idx, count = s._lod
    n = int(count)
    cap = pos_c.shape[0]
    assert cap >= n
    assert cap == octree.snug_capacity(n)
    # helper invariants: covers the target, <=~6% waste above the granule
    for m in (1, 4096, 52_000, 6_137_306):
        c = octree.snug_capacity(m, headroom=1.0)
        assert c >= m
        assert c % 4096 == 0
        assert c <= max(4096, int(m * 1.0711) + (1 << max(12, m.bit_length() - 4)))
    assert octree.snug_capacity(6_137_306, headroom=1.0) == 12 * (1 << 19)


def test_full_table_recomputes_xz_bounds():
    """segment() stores the fast table (full_bbox=False: zero x/z placeholder
    extents); full_table() must hand back REAL per-segment boxes before any
    consumer (export_info, segment_coords) reads them."""
    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=11)
    s = Session.from_points(pts, CFG)
    s.segment(0.75)
    fast = s.table
    present = np.flatnonzero(np.asarray(fast.present))
    # fast path: x/z columns are placeholders (y extent is real)
    assert np.allclose(np.asarray(fast.lo)[present][:, [0, 2]], 0.0)
    assert np.allclose(np.asarray(fast.hi)[present][:, [0, 2]], 0.0)

    t = s.full_table()
    pos = np.asarray(s.cloud.pos)
    seg = np.asarray(s.cloud.segment)
    valid = np.asarray(s.cloud.valid)
    checked = 0
    for sid in present[:4]:
        m = valid & (seg == sid)
        if not m.any():
            continue
        lo = np.asarray(t.lo[sid])
        hi = np.asarray(t.hi[sid])
        np.testing.assert_allclose(lo, pos[m].min(axis=0), atol=1e-3)
        np.testing.assert_allclose(hi, pos[m].max(axis=0), atol=1e-3)
        checked += 1
    assert checked > 0
    # a second call is cached (no recompute path flips the flag back)
    assert s.full_table() is t


def test_adaptive_counts_match_mask_sums(session):
    """adaptive_counts' ladder counts are EXACTLY adaptive_mask(tau).sum()
    per tau — the two implementations share the ring/first-live semantics
    (solve_adaptive_tau bisects this curve)."""
    from treee_tpu.ops import octree

    s = session
    cam = Camera.orbital(distance=60.0)
    rcfg = s.config.render
    live = np.asarray(s.cloud.valid) & (np.asarray(s.cloud.segment) != 0)
    live = jnp.asarray(live)
    tree = octree.build(s.cloud.pos, s.cloud.valid)
    planes = cam.frustum_planes(rcfg.width / rcfg.height)
    px_scale = float(cam.projection_matrix(
        rcfg.width / rcfg.height)[1, 1]) * (rcfg.height / 2.0)
    taus = (0.75, 1.5, 3.0, 6.0)
    counts = np.asarray(octree.adaptive_counts(
        tree, cam.position, px_scale, taus, live=live, frustum=planes))
    for k, tau in enumerate(taus):
        ref = int(np.asarray(octree.adaptive_mask(
            tree, cam.position, px_scale, tau_px=tau, live=live,
            frustum=planes)).sum())
        assert counts[k] == ref, (tau, counts[k], ref)
    # monotone non-increasing in tau
    assert all(counts[i] >= counts[i + 1] for i in range(len(taus) - 1))


def test_solve_adaptive_tau_budget(session):
    from treee_tpu.ops import octree

    s = session
    cam = Camera.orbital(distance=60.0)
    rcfg = s.config.render
    live = s.cloud.valid & (s.cloud.segment != 0)
    tree = octree.build(s.cloud.pos, s.cloud.valid)
    planes = cam.frustum_planes(rcfg.width / rcfg.height)
    px_scale = float(cam.projection_matrix(
        rcfg.width / rcfg.height)[1, 1]) * (rcfg.height / 2.0)
    counts = np.asarray(octree.adaptive_counts(
        tree, cam.position, px_scale, Session.TAU_LADDER,
        live=live, frustum=planes))
    # a budget between two ladder counts picks the smallest tau that fits
    mid = len(counts) // 2
    budget = int(counts[mid])
    tau = s.solve_adaptive_tau(budget_rows=budget, camera=cam)
    want = Session.TAU_LADDER[int(np.nonzero(counts <= budget)[0][0])]
    assert tau == want
    # huge budget -> finest tau; zero budget -> coarsest fallback
    assert s.solve_adaptive_tau(budget_rows=10**9, camera=cam) == \
        Session.TAU_LADDER[0]
    assert s.solve_adaptive_tau(budget_rows=0, camera=cam) == \
        Session.TAU_LADDER[-1]


def test_solve_adaptive_tau_match_floor(session):
    s = session
    cam = Camera.orbital(distance=60.0)
    tau = s.solve_adaptive_tau(match_floor=0.95, camera=cam)
    assert tau in Session.TAU_LADDER
    # verify the promise by rendering at the chosen tau
    full = s.render(camera=cam, use_lod=False)
    s.build_lod(camera=cam, adaptive_tau_px=tau)
    img = s.render(camera=cam, use_lod=True)
    match = float((img == full).all(axis=-1).mean())
    assert match >= 0.95
    s._lod = None


def test_repl_adaptive_auto(session):
    import io as _io

    from treee_tpu.repl import Repl

    out = _io.StringIO()
    r = Repl(session, out=out)
    r.handle("lod adaptive auto rows 100000")
    assert "auto tau" in out.getvalue()
    assert r.use_lod and r._adaptive_tau in Session.TAU_LADDER
    r.handle("lod adaptive auto bogus 1")
    assert "error:" in out.getvalue()
    session._lod = None


def test_focus_compaction_cache_invalidates_on_edit():
    """The cached member-compaction for the brute-force k-NN (round-5:
    replaces a [tile, N] 61 GB distance slab) must refresh after edits —
    a stale index buffer would compute curvature over points that left
    the segment."""
    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=13)
    s = Session.from_points(pts, CFG)
    s.segment(0.75)
    sid = _a_tree_segment(s)
    c1 = np.asarray(s.curvature(sid))
    member = np.asarray(s.cloud.valid & (s.cloud.segment == sid))
    assert (np.abs(c1[member]) > 0).any()
    # cache hit on the second call: same object is reused
    idx_cached = s._focus_idx_cache[sid][0]
    _ = s.curvature(sid)
    assert s._focus_idx_cache[sid][0] is idx_cached

    # delete the whole segment: curvature must drop to all-zero (a stale
    # compaction would still index the old member rows)
    pos_np = np.asarray(s.cloud.pos)
    center = pos_np[member].mean(axis=0)
    s.delete_sphere(center, radius=1e6)
    assert sid not in s._focus_idx_cache  # edit cleared the cache
    c2 = np.asarray(s.curvature(sid))
    assert not (np.abs(c2) > 0).any()


def test_focus_prop_cache_reuses_knn(session):
    """Round-5: the brute-path curvature/normals SUB results are cached per
    (kind, segment, k) so a focused `display curve`/`shaded` frame doesn't
    pay the ~150 ms k-NN recompute per camera move; the full-N output is
    rebuilt per call from the cached subset (bit-identical)."""
    s = session
    sid = _a_tree_segment(s)
    c1 = np.asarray(s.curvature(sid))
    key = ("curve", sid, s.config.characteristics.neighbors)
    assert key in s._focus_prop_cache
    sub_cached = s._focus_prop_cache[key]
    c2 = np.asarray(s.curvature(sid))
    assert s._focus_prop_cache[key] is sub_cached  # k-NN not recomputed
    np.testing.assert_array_equal(c1, c2)
    n1 = np.asarray(s.normals(sid))
    assert ("normals", sid, s.config.characteristics.neighbors) \
        in s._focus_prop_cache
    np.testing.assert_array_equal(n1, np.asarray(s.normals(sid)))


def test_render_focus_subset_matches_full_render():
    """Round-5: the brute-path focused frame renders the index-compacted
    subset instead of the member-masked full cloud (splat cost scales with
    the padded row count).  The scatter-min z-buffer is order- and
    padding-independent, so the image must be IDENTICAL to the full-N
    masked render — pinned by routing the same scene through the grid
    path (brute_force_max=0 forces every segment to the full-cloud
    render)."""
    import dataclasses as dc

    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=17)
    s_sub = Session.from_points(pts, CFG)
    s_sub.segment(0.75)
    cfg_grid = dc.replace(
        CFG, neighbors=dc.replace(CFG.neighbors, brute_force_max=0))
    s_full = Session.from_points(pts, cfg_grid)
    s_full.segment(0.75)
    sid = _a_tree_segment(s_sub)
    # curve/shaded are excluded: the grid path uses a different k-NN
    # engine.  expansion/height ARE pinned: segment_properties on the
    # subset is bit-identical for member rows (support maxima and the
    # table-derived quantization are order-independent).
    for display in ("classification", "hag", "height", "expansion"):
        img_sub = s_sub.render_focus(sid, display=display)
        img_full = s_full.render_focus(sid, display=display)
        np.testing.assert_array_equal(img_sub, img_full, err_msg=display)
    # overlays on the subset point set must match the full-cloud overlays
    img_sub = s_sub.render_focus(sid, show_hull=True, show_axis=True,
                                 show_rbv=True)
    img_full = s_full.render_focus(sid, show_hull=True, show_axis=True,
                                   show_rbv=True)
    mismatch = float(np.mean(np.any(img_sub != img_full, axis=-1)))
    assert mismatch < 0.005, mismatch  # mean-based axis fit: float-order


def test_focus_count_cache_and_eviction():
    """Round-5 review fixes: (a) while _counts_stale the member count
    syncs once per segment and is then host-cached — a focused frame
    after a brush stroke must not block on a device fetch per camera
    move; (b) the focused-view caches are bounded (device-HBM arrays
    would otherwise accumulate per segment browsed)."""
    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=19)
    s = Session.from_points(pts, CFG)
    s.segment(0.75)
    sid = _a_tree_segment(s)
    # trigger staleness the way a brush stroke does
    s.delete_sphere(np.array([1e6, 1e6, 1e6], np.float32), radius=0.1)
    assert s._counts_stale and s._focus_cnt_cache == {}
    # count the full-N mask builds: the stale-count sync is the only
    # thing that should build one on the brute-path frame, and only ONCE
    calls = []
    orig = s._member_mask

    def counting(sid2):
        calls.append(sid2)
        return orig(sid2)

    s._member_mask = counting
    _ = s.render_focus(sid, display="classification")
    assert sid in s._focus_cnt_cache  # synced once...
    first_calls = len(calls)
    assert first_calls >= 1
    _ = s.render_focus(sid, display="classification")
    # ...and the second frame neither re-syncs the count nor rebuilds the
    # mask (warm cnt + compaction caches; membership is subset-gathered)
    assert len(calls) == first_calls
    s._member_mask = orig

    # eviction bound: fake-browse many segments; a get() via _lru_get
    # refreshes recency, so the hit entry survives the next eviction
    from treee_tpu.pipeline import _evict_oldest, _lru_get
    d = {i: i for i in range(100)}
    _evict_oldest(d, 8)
    assert len(d) == 8 and list(d) == list(range(92, 100))
    assert _lru_get(d, 92) == 92
    d[100] = 100
    _evict_oldest(d, 8)
    assert 92 in d and 93 not in d  # LRU: the hit entry outlived FIFO order


def test_render_focus_expansion_first_frame_matches_steady():
    """Round-5 review (repro-confirmed): render_focus(display="expansion")
    on a session whose table isn't derived yet must settle
    characteristics() BEFORE gathering classification — characteristics()
    replaces cloud.classification, and a post-gather settle rendered the
    FIRST frame from the stale array (first frame != second frame)."""
    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=23)
    s = Session.from_points(pts, CFG)
    s.segment(0.75)
    sid = _a_tree_segment(s)
    # the open()/merge-like state: points + segments live, table not yet
    # derived for this cloud state
    s.table = None
    s._counts_np = None
    i1 = s.render_focus(sid, display="expansion")
    i2 = s.render_focus(sid, display="expansion")
    np.testing.assert_array_equal(i1, i2)


def test_focus_grid_path_caches_result():
    """Round-5 review: the grid-path (huge-segment) curvature/normals
    results must be cached per selection — the slab k-NN costs minutes
    at scan scale, and a focused curve/shaded frame would otherwise pay
    it per camera move."""
    import dataclasses as dc

    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=29)
    cfg_grid = dc.replace(
        CFG, neighbors=dc.replace(CFG.neighbors, brute_force_max=0))
    s = Session.from_points(pts, cfg_grid)
    s.segment(0.75)
    sid = _a_tree_segment(s)
    c1 = np.asarray(s.curvature(sid))
    key = ("curve", sid, s.config.characteristics.neighbors)
    assert key in s._focus_grid_cache
    cached = s._focus_grid_cache[key]
    c2 = np.asarray(s.curvature(sid))
    assert s._focus_grid_cache[key] is cached  # not recomputed
    np.testing.assert_array_equal(c1, c2)
    _ = np.asarray(s.normals(sid))
    assert ("normals", sid, s.config.characteristics.neighbors) \
        in s._focus_grid_cache
    # edits clear it
    member = np.asarray(s.cloud.valid & (s.cloud.segment == sid))
    s.delete_sphere(np.asarray(s.cloud.pos)[member].mean(axis=0),
                    radius=0.5)
    assert s._focus_grid_cache == {}
