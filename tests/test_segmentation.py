"""Segmentation parity-by-invariant tests (SURVEY.md §4 item 3).

The reference segmenter is order-dependent and randomly keyed
(segmenting.rs:425,516-521), so tests assert invariants rather than exact ids:
every point assigned, deterministic re-run (a deliberate improvement), well-
separated trees get distinct coherent ids, distance knob merges/splits.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from treee_tpu.config import SegmentationConfig
from treee_tpu.io import las
from treee_tpu.segmentation import segment_points

CFG = SegmentationConfig(
    grid_size=128, max_bands=16, max_segments=128, max_trees_per_band=32,
    cc_iters=16,
)


def _two_trees(gap: float, n: int = 3000, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = las.synthetic_tree(rng, np.array([0.0, 0.0, 0.0]), n_points=n,
                           crown_radius=1.5, trunk_height=3.0, crown_height=4.0)
    b = las.synthetic_tree(rng, np.array([gap, 0.0, 0.0]), n_points=n,
                           crown_radius=1.5, trunk_height=3.0, crown_height=4.0)
    return np.concatenate([a, b])


def _majority_frac(seg, lo, hi):
    ids = seg[lo:hi]
    ids = ids[ids > 0]
    if len(ids) == 0:
        return 0, 0.0
    maj = np.bincount(ids).argmax()
    return maj, (ids == maj).mean()


def test_every_point_assigned():
    pts = _two_trees(gap=6.0)
    res = segment_points(jnp.asarray(pts), jnp.ones(len(pts), bool), 0.75, CFG)
    seg = np.asarray(res.segment)
    assert (seg > 0).all()


def test_separated_trees_distinct_ids():
    pts = _two_trees(gap=6.0)
    n = len(pts) // 2
    res = segment_points(jnp.asarray(pts), jnp.ones(len(pts), bool), 0.75, CFG)
    seg = np.asarray(res.segment)
    id_a, frac_a = _majority_frac(seg, 0, n)
    id_b, frac_b = _majority_frac(seg, n, len(pts))
    assert frac_a > 0.95 and frac_b > 0.95
    assert id_a != id_b


def test_distance_knob_merges():
    # crowns 3 apart edge-to-edge ~0: with huge d the two trees merge
    pts = _two_trees(gap=3.5)
    n = len(pts) // 2
    res = segment_points(jnp.asarray(pts), jnp.ones(len(pts), bool), 2.0, CFG)
    seg = np.asarray(res.segment)
    id_a, _ = _majority_frac(seg, 0, n)
    id_b, _ = _majority_frac(seg, n, len(pts))
    assert id_a == id_b


def test_deterministic():
    pts = _two_trees(gap=6.0, seed=2)
    v = jnp.ones(len(pts), bool)
    s1 = np.asarray(segment_points(jnp.asarray(pts), v, 0.75, CFG).segment)
    s2 = np.asarray(segment_points(jnp.asarray(pts), v, 0.75, CFG).segment)
    np.testing.assert_array_equal(s1, s2)


def test_permutation_equivalence():
    # segment structure must not depend on point order (the reference's does —
    # shuffled input, segmenting.rs:425; ours fixes that deficiency)
    pts = _two_trees(gap=6.0, seed=3)
    v = jnp.ones(len(pts), bool)
    perm = np.random.default_rng(0).permutation(len(pts))
    s1 = np.asarray(segment_points(jnp.asarray(pts), v, 0.75, CFG).segment)
    s2p = np.asarray(segment_points(jnp.asarray(pts[perm]), v, 0.75, CFG).segment)
    s2 = np.empty_like(s2p)
    s2[perm] = s2p
    # same-segment relation preserved for almost all pairs (scatter-add float
    # order can flip boundary points)
    sample = np.random.default_rng(1).integers(0, len(pts), size=(4000, 2))
    same1 = s1[sample[:, 0]] == s1[sample[:, 1]]
    same2 = s2[sample[:, 0]] == s2[sample[:, 1]]
    assert (same1 == same2).mean() > 0.99


def test_invalid_points_get_zero():
    pts = _two_trees(gap=6.0)
    valid = np.ones(len(pts), bool)
    valid[::7] = False
    res = segment_points(jnp.asarray(pts), jnp.asarray(valid), 0.75, CFG)
    seg = np.asarray(res.segment)
    assert (seg[~valid] == 0).all()
    assert (seg[valid] > 0).all()


def test_empty_input():
    res = segment_points(jnp.zeros((64, 3)), jnp.zeros(64, bool), 0.75, CFG)
    assert (np.asarray(res.segment) == 0).all()
    assert int(res.n_segments) == 0


def test_tracking_coherent_down_the_trunk():
    # a single tall tree: trunk and crown points should share one id
    rng = np.random.default_rng(4)
    pts = las.synthetic_tree(rng, np.zeros(3), trunk_height=6.0,
                             crown_height=5.0, n_points=6000)
    res = segment_points(jnp.asarray(pts), jnp.ones(len(pts), bool), 0.75, CFG)
    seg = np.asarray(res.segment)
    ids = seg[seg > 0]
    maj = np.bincount(ids).argmax()
    assert (ids == maj).mean() > 0.97


def test_realistic_stress_scene_invariants():
    """The clustered/overlapping/density-banded stress scene (the offline
    stand-in for a real ALS tile, SURVEY.md §4.3 parity-by-invariant):
    segmentation still finds roughly one segment per tree, assigns every
    live point, and keeps outliers from spawning phantom trees."""
    import numpy as np
    import jax.numpy as jnp

    from treee_tpu.config import Config, SegmentationConfig
    from treee_tpu.io import las
    from treee_tpu.segmentation import segment_points

    cfg = SegmentationConfig(
        grid_size=160, max_bands=24, max_segments=256, max_trees_per_band=48,
    )
    n_trees = 18
    pts = las.synthetic_forest_realistic(
        n_trees=n_trees, extent=50.0, mean_points_per_tree=3000,
        ground_points=20000, seed=4,
    )
    res = segment_points(jnp.asarray(pts), jnp.ones(len(pts), bool), 0.75, cfg)
    seg = np.asarray(res.segment)
    n_seg = int(res.n_segments)
    # every point got an assignment decision (0 = unassigned is allowed for
    # ground/noise, but the majority of canopy points are labeled)
    assert (seg >= 0).all()
    high = pts[:, 1] > 3.0
    assert (seg[high] > 0).mean() > 0.8
    # tree count is in a sane band: clusters may merge overlapping crowns,
    # so allow down to half and up to 2.5x (density cliffs can split)
    assert n_trees // 2 <= n_seg <= int(n_trees * 2.5) + 8
    # determinism: same input -> identical labels
    seg2 = np.asarray(
        segment_points(jnp.asarray(pts), jnp.ones(len(pts), bool), 0.75,
                       cfg).segment
    )
    np.testing.assert_array_equal(seg, seg2)


def test_bruteforce_voronoi_matches_and_is_optimal():
    """The exact occupied-cell Voronoi (use_bruteforce_voronoi) must (a) give
    the same end-to-end segmentation as the JFA on a generic scene, and (b) be
    distance-optimal at every occupied cell (the JFA may propagate a
    non-optimal seed; brute force never does)."""
    import dataclasses

    import jax

    from treee_tpu import segmentation as sg

    pts = las.synthetic_forest(n_trees=6, points_per_tree=1500,
                               ground_points=2000, seed=11)
    pos = jnp.asarray(pts)
    valid = jnp.ones(len(pts), bool)
    cfg_bf = dataclasses.replace(CFG, use_bruteforce_voronoi=True)
    res_jfa = segment_points(pos, valid, 0.75, CFG)
    res_bf = segment_points(pos, valid, 0.75, cfg_bf)
    np.testing.assert_array_equal(np.asarray(res_jfa.segment),
                                  np.asarray(res_bf.segment))
    assert int(res_jfa.n_segments) == int(res_bf.n_segments)

    # optimality: recompute both slot grids and compare winner distances at
    # occupied cells
    import functools

    @functools.partial(jax.jit, static_argnames=("use_bf",))
    def grids(pos, valid, use_bf):
        d = jnp.float32(0.75)
        lo, hi = sg.scene_bounds(pos, valid)
        s = sg.cell_size(lo, hi, d, CFG)
        top = sg.band_anchor(
            sg.anchor_histogram(pos, valid, lo[1], hi[1]), lo[1], hi[1], CFG)
        band, cx, cz = sg.point_cells(pos, valid, lo, hi, s, CFG, top=top)
        cnt = sg.moment_grids(pos, valid, band, cx, cz, CFG)
        cfg = cfg_bf if use_bf else CFG
        slot_grids, _, tracked, active = sg.band_scan(cnt, lo, s, d, cfg)
        g = CFG.grid_size
        cell_center = jnp.stack([
            lo[0] + (jax.lax.broadcasted_iota(jnp.float32, (g, g), 0) + 0.5) * s,
            lo[2] + (jax.lax.broadcasted_iota(jnp.float32, (g, g), 1) + 0.5) * s,
        ], axis=-1)
        return cnt, slot_grids, tracked, active, cell_center

    # NOTE: use_bf is a Python bool through cfg (static), call twice
    cnt, sg_jfa, tracked, active, cc = grids(pos, valid, False)
    _, sg_bf, _, _, _ = grids(pos, valid, True)
    cnt = np.asarray(cnt)
    sg_jfa, sg_bf = np.asarray(sg_jfa), np.asarray(sg_bf)
    tracked, active, cc = np.asarray(tracked), np.asarray(active), np.asarray(cc)

    occ = np.argwhere(cnt > 0)
    assert len(occ) > 0

    def winner_dist(slotgrid, b, ix, iz):
        slot = slotgrid[b, ix, iz]
        if slot < 0 or not active[b, slot]:
            return np.inf
        d = tracked[b, slot] - cc[ix, iz]
        return float(d @ d)

    for b, ix, iz in occ[:: max(1, len(occ) // 512)]:
        d_bf = winner_dist(sg_bf, b, ix, iz)
        d_jfa = winner_dist(sg_jfa, b, ix, iz)
        assert d_bf <= d_jfa + 1e-5, (b, ix, iz, d_bf, d_jfa)


def test_sorted_extract_matches_topk():
    """The sort-based cluster selection (SegmentationConfig.use_sorted_extract,
    the default — replaces a ~90 ms batched top_k at bench scale) is
    bit-identical to the top_k path: same biggest-first order, same
    lowest-index tie-break, same accumulation-target candidate set.
    Covers a normal forest, a count-tie truncation regime (9 equal clusters,
    4 slots), and an empty cloud."""
    import dataclasses

    cfg_t = dataclasses.replace(CFG, use_sorted_extract=False)
    pts = las.synthetic_forest(n_trees=7, points_per_tree=1200,
                               ground_points=1800, seed=21)
    pos, v = jnp.asarray(pts), jnp.ones(len(pts), bool)
    r_s = segment_points(pos, v, 0.75, CFG)
    r_t = segment_points(pos, v, 0.75, cfg_t)
    assert int(r_s.n_segments) == int(r_t.n_segments)
    np.testing.assert_array_equal(np.asarray(r_s.segment),
                                  np.asarray(r_t.segment))
    np.testing.assert_array_equal(np.asarray(r_s.tracked_pos),
                                  np.asarray(r_t.tracked_pos))

    cfg2 = SegmentationConfig(grid_size=64, max_bands=4, max_segments=32,
                              max_trees_per_band=4, cc_iters=10)
    cfg2t = dataclasses.replace(cfg2, use_sorted_extract=False)
    rng = np.random.default_rng(7)
    clusters = [rng.normal(0, 0.5, (200, 3)).astype(np.float32)
                + np.array([(i % 3) * 15.0, 5.0, (i // 3) * 15.0], np.float32)
                for i in range(9)]
    pos2 = jnp.asarray(np.concatenate(clusters))
    v2 = jnp.ones(pos2.shape[0], bool)
    r_s = segment_points(pos2, v2, 0.75, cfg2)
    r_t = segment_points(pos2, v2, 0.75, cfg2t)
    np.testing.assert_array_equal(np.asarray(r_s.segment),
                                  np.asarray(r_t.segment))

    r_s = segment_points(jnp.zeros((64, 3)), jnp.zeros(64, bool), 0.75, cfg2)
    r_t = segment_points(jnp.zeros((64, 3)), jnp.zeros(64, bool), 0.75, cfg2t)
    np.testing.assert_array_equal(np.asarray(r_s.segment),
                                  np.asarray(r_t.segment))


def test_jump_flood_packed_matches_unpacked():
    """Lattice-aligned seeds (multiples of s/64) quantize exactly, so the
    packed-plane JFA is bit-identical to the 4-plane one; random seeds agree
    on >=99% of cells (quantization moves positions by <~1 cm)."""
    import jax

    from treee_tpu import segmentation as sg

    g = 64
    s = jnp.float32(0.75)
    lo = jnp.zeros(3, jnp.float32)
    qs = 0.75 / 64.0  # == 3/256, exactly representable

    def centers():
        return jnp.stack(
            [
                (jax.lax.broadcasted_iota(jnp.float32, (g, g), 0) + 0.5) * s,
                (jax.lax.broadcasted_iota(jnp.float32, (g, g), 1) + 0.5) * s,
            ],
            axis=-1,
        )

    rng = np.random.default_rng(5)
    for aligned in (True, False):
        slot_grid = np.full((g, g), -1, np.int32)
        pos_grid = np.zeros((g, g, 2), np.float32)
        cells = rng.choice(g * g, 25, replace=False)
        for si, c in enumerate(cells):
            gx, gz = divmod(int(c), g)
            px, pz = (gx + rng.uniform()) * 0.75, (gz + rng.uniform()) * 0.75
            if aligned:
                px, pz = round(px / qs) * qs, round(pz / qs) * qs
            slot_grid[gx, gz] = si
            pos_grid[gx, gz] = (px, pz)
        ref = np.asarray(sg._jump_flood(jnp.asarray(slot_grid)[None],
                                        jnp.asarray(pos_grid)[None],
                                        centers()))[0]
        out = np.asarray(sg._jump_flood_packed(
            jnp.asarray(slot_grid)[None], jnp.asarray(pos_grid)[None],
            centers(), lo, s))[0]
        if aligned:
            np.testing.assert_array_equal(out, ref)
        else:
            assert (out == ref).mean() > 0.99


def test_segment_points_packed_jfa_flag():
    """segment_points with use_packed_jfa reproduces the default ids on a
    small synthetic forest (seeds well separated: no quantization ties)."""
    import dataclasses

    from treee_tpu import segmentation as sg

    pts = las.synthetic_forest(n_trees=6, points_per_tree=400,
                               ground_points=400, seed=3)
    pos = jnp.asarray(pts)
    valid = jnp.ones(pos.shape[0], bool)
    # bruteforce Voronoi (the default) would shadow both JFA paths
    cfg0 = SegmentationConfig(grid_size=128, max_bands=32,
                              cc_occupied_cap=1 << 14,
                              use_bruteforce_voronoi=False,
                              use_packed_jfa=False)
    cfg1 = dataclasses.replace(cfg0, use_packed_jfa=True)
    r0 = sg.segment_points(pos, valid, 0.75, cfg0)
    r1 = sg.segment_points(pos, valid, 0.75, cfg1)
    assert (np.asarray(r0.segment) == np.asarray(r1.segment)).mean() > 0.999
    assert int(r0.n_segments) == int(r1.n_segments)


def _blob_grid(b, g, n_blobs, seed, walk=60):
    """Occupancy grids with connected blobs (random walks from seed cells)."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((b, g, g), bool)
    for bi in range(b):
        for _ in range(n_blobs):
            y, x = rng.integers(4, g - 4, 2)
            for _ in range(walk):
                occ[bi, y, x] = True
                dy, dx = rng.integers(-1, 2, 2)
                y = int(np.clip(y + dy, 0, g - 1))
                x = int(np.clip(x + dx, 0, g - 1))
    return occ


def _snake_grid(g):
    """One band holding a single serpentine component: the longest label
    path a g x g grid allows, the hardest case for label propagation."""
    occ = np.zeros((1, g, g), bool)
    for r in range(0, g, 2):
        occ[0, r, :] = True
        if r + 1 < g:
            occ[0, r + 1, g - 1 if (r // 2) % 2 == 0 else 0] = True
    return occ


def _cc_oracle(occ):
    """Run-to-fixpoint labels by flood fill: every occupied cell gets the
    smallest flat in-band index of its 8-connected component."""
    b, g, _ = occ.shape
    out = np.full(occ.shape, 0x7FFFFFFF, np.int64)
    for bi in range(b):
        seen = np.zeros((g, g), bool)
        for y0, x0 in zip(*np.nonzero(occ[bi])):
            if seen[y0, x0]:
                continue
            comp, stack = [], [(y0, x0)]
            seen[y0, x0] = True
            while stack:
                y, x = stack.pop()
                comp.append((y, x))
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        yy, xx = y + dy, x + dx
                        if (0 <= yy < g and 0 <= xx < g and occ[bi, yy, xx]
                                and not seen[yy, xx]):
                            seen[yy, xx] = True
                            stack.append((yy, xx))
            label = min(y * g + x for y, x in comp)
            for y, x in comp:
                out[bi, y, x] = label
    return out


@pytest.mark.parametrize("case", ["blobs", "blobs_small_cap", "snake"])
def test_connected_components_reach_fixpoint(case):
    """The XLA CC (reduce_window sweeps + compact pointer jumps) converges
    to the flood-fill oracle, including cells past the compaction cap."""
    from treee_tpu import segmentation as sg

    if case == "snake":
        occ, cap = _snake_grid(24), 1 << 12
    else:
        occ = _blob_grid(b=3, g=48, n_blobs=5, seed=11)
        cap = 64 if case == "blobs_small_cap" else 1 << 12
    labels, _, _ = sg._connected_components(jnp.asarray(occ), iters=4000,
                                            occ_cap=cap)
    np.testing.assert_array_equal(np.asarray(labels), _cc_oracle(occ))


def _match_band_oracle(tp, act, n_alloc, cents, cmask, radius, rounds):
    """Plain-loop mutual-nearest matching + free-slot allocation."""
    tp, act = tp.copy(), act.copy()
    t_cap, c_cap = len(tp), len(cents)
    taken = ~cmask
    for _ in range(rounds):
        diff = tp[:, None, :] - cents[None, :, :]
        d = np.sqrt((diff * diff).sum(-1)).astype(np.float32)
        d[~(act[:, None] & ~taken[None, :])] = np.float32(3.0e38)
        new_tp = tp.copy()
        for t in range(t_cap):
            c = int(np.argmin(d[t]))
            if (act[t] and d[t, c] <= radius
                    and int(np.argmin(d[:, c])) == t):
                new_tp[t] = cents[c]
                taken[c] = True
        tp = new_tp
    free = [t for t in range(t_cap) if not act[t]]
    for c in range(c_cap):
        if cmask[c] and not taken[c] and free:
            t = free.pop(0)
            tp[t] = cents[c]
            act[t] = True
            n_alloc += 1
    return tp, act, n_alloc


@pytest.mark.parametrize("seed", [13, 21])
def test_match_scan_matches_loop_oracle(seed):
    """band_scan's lax.scan of _match_band == a plain loop, band by band."""
    import jax

    from treee_tpu import segmentation as sg

    rng = np.random.default_rng(seed)
    b, c_cap, t_cap, rounds = 6, 32, 48, 4
    cents = rng.uniform(0, 50, (b, c_cap, 2)).astype(np.float32)
    cmask = rng.random((b, c_cap)) < 0.4
    # some clusters recur across bands (should match), some are new
    cents[1:] = np.where(rng.random((b - 1, c_cap, 1)) < 0.5,
                         cents[:1] + rng.normal(0, 0.3, (b - 1, c_cap, 2)),
                         cents[1:]).astype(np.float32)
    radius = np.float32(1.5)

    def band_step(carry, xs):
        tracked_pos, active, n_alloc = carry
        c, m = xs
        tracked_pos, active, n_alloc = sg._match_band(
            tracked_pos, active, n_alloc, c, m, radius, rounds)
        return (tracked_pos, active, n_alloc), (tracked_pos, active)

    init = (jnp.zeros((t_cap, 2), jnp.float32), jnp.zeros(t_cap, bool),
            jnp.int32(0))
    (_, _, n_alloc), (tp_b, act_b) = jax.lax.scan(
        band_step, init, (jnp.asarray(cents), jnp.asarray(cmask)))

    tp = np.zeros((t_cap, 2), np.float32)
    act = np.zeros(t_cap, bool)
    n = 0
    for bi in range(b):
        tp, act, n = _match_band_oracle(tp, act, n, cents[bi], cmask[bi],
                                        radius, rounds)
        np.testing.assert_array_equal(np.asarray(act_b[bi]), act)
        np.testing.assert_array_equal(np.asarray(tp_b[bi]), tp)
    assert int(n_alloc) == n


def test_cluster_centroids_are_exact_weighted_means():
    """_extract_clusters' fixed-point centroid sums equal the float64
    count-weighted mean of the member cell centres (no accumulation-order
    error), so the ids cannot depend on the scatter's order."""
    from treee_tpu import segmentation as sg

    occ = _blob_grid(b=2, g=40, n_blobs=4, seed=3)
    rng = np.random.default_rng(4)
    cnt = np.where(occ, rng.integers(1, 5000, occ.shape), 0).astype(np.int32)
    lo = jnp.asarray([-7.25, 0.0, 3.5], jnp.float32)
    s = jnp.float32(0.75)
    labels, occ_idx, occ_valid = sg._connected_components(
        jnp.asarray(occ), iters=4000, occ_cap=1 << 12)
    cents, mask = sg._extract_clusters(
        labels, jnp.asarray(cnt), lo, s, 16, 1, occ_idx, occ_valid)
    lab = _cc_oracle(occ)
    got = {}
    for bi in range(occ.shape[0]):
        for ci in np.nonzero(np.asarray(mask[bi]))[0]:
            got[(bi, tuple(np.asarray(cents[bi, ci])))] = True
    g = occ.shape[1]
    want = set()
    for bi in range(occ.shape[0]):
        for label in np.unique(lab[bi][occ[bi]]):
            m = (lab[bi] == label) & occ[bi]
            w = cnt[bi][m].astype(np.float64)
            ys, xs = np.nonzero(m)
            cx = -7.25 + ((ys + 0.5) * w).sum() / w.sum() * 0.75
            cz = 3.5 + ((xs + 0.5) * w).sum() / w.sum() * 0.75
            want.add((bi, cx, cz))
    assert len(got) == len(want)
    for bi, cx, cz in want:
        near = [k for k in got if k[0] == bi
                and abs(k[1][0] - cx) < 2e-5 and abs(k[1][1] - cz) < 2e-5]
        assert near, (bi, cx, cz)
