"""Golden tests for per-segment characteristics (SURVEY.md §4 item 1)."""

import math

import numpy as np
import jax.numpy as jnp
from scipy.spatial import ConvexHull

from treee_tpu import characteristics as ch
from treee_tpu.cloud import CLASS_CROWN, CLASS_GROUND, CLASS_TRUNK
from treee_tpu.config import CharacteristicsConfig
from treee_tpu.io import las

CFG = CharacteristicsConfig(max_slices=160)


def test_slice_areas_vs_scipy_hull():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(500, 2)).astype(np.float32)
    bucket = np.zeros(500, np.int32)
    area = np.asarray(
        ch.slice_areas(jnp.asarray(pts), jnp.asarray(bucket),
                       jnp.ones(500, bool), 4, 16)
    )[0]
    ref = ConvexHull(pts).volume  # 2-D "volume" is the area
    # circumscribed half-plane polygon: bounded above hull area by the K-gon factor
    assert 0.98 * ref <= area <= ref * 1.06


def test_slice_areas_disk():
    # dense unit disk: K=16 inscribed polygon area ~ 0.974 * pi
    rng = np.random.default_rng(1)
    th = rng.uniform(0, 2 * np.pi, 4000)
    r = np.sqrt(rng.uniform(0, 1, 4000))
    pts = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    area = np.asarray(
        ch.slice_areas(jnp.asarray(pts), jnp.zeros(4000, jnp.int32),
                       jnp.ones(4000, bool), 1, 16)
    )[0]
    assert abs(area - math.pi) / math.pi < 0.05


def test_empty_bucket_zero_area():
    pts = np.zeros((4, 2), np.float32)
    area = np.asarray(
        ch.slice_areas(jnp.asarray(pts), jnp.zeros(4, jnp.int32),
                       jnp.zeros(4, bool), 3, 16)
    )
    np.testing.assert_allclose(area, 0.0)


def _lone_tree(trunk_h=4.0, crown_h=6.0, crown_r=2.5, n=30000):
    rng = np.random.default_rng(2)
    pts = las.synthetic_tree(rng, np.zeros(3), trunk_height=trunk_h,
                             crown_height=crown_h, crown_radius=crown_r,
                             n_points=n)
    seg = np.ones(len(pts), np.int32)
    return pts, seg


def test_crown_separator_single_tree():
    pts, seg = _lone_tree()
    table, cls = ch.compute_segments(
        jnp.asarray(pts), jnp.asarray(seg), jnp.ones(len(pts), bool), 4, CFG
    )
    assert bool(table.present[1])
    # crown ellipsoid (center y=7, semi-height 3, r 2.5) crosses area pi at
    # r(y)=1 -> y ~ 4.25; the crown separator should land near the trunk top
    cs = float(table.crown_sep[1])
    assert 3.8 <= cs <= 5.0
    # no ground plane -> ground separator stays at the bottom
    assert float(table.ground_sep[1]) <= 0.3
    assert abs(float(table.trunk_height[1]) - (cs - float(table.ground_sep[1]))) < 1e-4
    assert abs(float(table.crown_height[1]) - (float(table.hi[1, 1]) - cs)) < 1e-4


def test_classification_fractions():
    pts, seg = _lone_tree()
    _, cls = ch.compute_segments(
        jnp.asarray(pts), jnp.asarray(seg), jnp.ones(len(pts), bool), 4, CFG
    )
    cls = np.asarray(cls)
    # 1/5 of points are trunk (below ~4), rest crown; separator ~4.25 so trunk
    # fraction is near 0.2 plus a thin crown shell
    trunk_frac = (cls == CLASS_TRUNK).mean()
    crown_frac = (cls == CLASS_CROWN).mean()
    assert 0.1 < trunk_frac < 0.4
    assert crown_frac > 0.55


def test_ground_separator_with_plane():
    rng = np.random.default_rng(3)
    tree = las.synthetic_tree(rng, np.zeros(3), n_points=20000)
    ground = np.stack([
        rng.uniform(-8, 8, 20000),
        rng.normal(0.0, 0.04, 20000),
        rng.uniform(-8, 8, 20000),
    ], 1).astype(np.float32)
    pts = np.concatenate([tree, ground])
    seg = np.ones(len(pts), np.int32)
    table, cls = ch.compute_segments(
        jnp.asarray(pts), jnp.asarray(seg), jnp.ones(len(pts), bool), 4, CFG
    )
    gs = float(table.ground_sep[1])
    assert 0.05 <= gs <= 1.0  # ground layer detected just above the plane
    cls = np.asarray(cls)
    # the plane points classify as ground
    assert (cls[len(tree):] == CLASS_GROUND).mean() > 0.9


def test_properties_ranges():
    pts, seg = _lone_tree()
    v = jnp.ones(len(pts), bool)
    table, cls = ch.compute_segments(jnp.asarray(pts), jnp.asarray(seg), v, 4, CFG)
    exp, hgt = ch.segment_properties(
        jnp.asarray(pts), jnp.asarray(seg), v, cls, table, 4, CFG
    )
    exp, hgt = np.asarray(exp), np.asarray(hgt)
    assert hgt.min() >= 0.0 and hgt.max() <= 1.0 + 1e-5
    assert exp.max() <= 1.5  # slice diameter never wildly exceeds crown diameter
    crown = np.asarray(cls) == CLASS_CROWN
    # widest crown slice has expansion ~1
    assert exp[crown].max() > 0.9


def test_curvature_endpoints():
    # ellipsoid shell -> locally planar -> low curvature; solid blob -> high
    rng = np.random.default_rng(5)
    u = rng.normal(size=(2000, 3)); u /= np.linalg.norm(u, axis=1, keepdims=True)
    shell = (u * 3.0).astype(np.float32)
    blob = rng.normal(size=(2000, 3)).astype(np.float32) * 0.5
    m = jnp.ones(2000, bool)
    c_shell = np.asarray(ch.segment_curvature(jnp.asarray(shell), m, k=15))
    c_blob = np.asarray(ch.segment_curvature(jnp.asarray(blob), m, k=15))
    assert c_shell.mean() < 0.3
    assert c_blob.mean() > c_shell.mean()


def test_segmented_cummax_vs_oracle():
    # runs spanning multiple 256-blocks, n not a block multiple, 1-D and 2-D
    rng = np.random.default_rng(7)
    n = 3011
    keys = np.sort(rng.integers(0, 9, n)).astype(np.int32)  # ~335/run, blocks=256
    v1 = rng.normal(size=n).astype(np.float32)
    v2 = rng.normal(size=(n, 5)).astype(np.float32)

    def oracle(k, v):
        out = v.copy()
        for i in range(1, len(k)):
            if k[i] == k[i - 1]:
                out[i] = np.maximum(out[i], out[i - 1])
        return out

    got1 = np.asarray(ch._segmented_cummax(jnp.asarray(keys), jnp.asarray(v1)))
    np.testing.assert_allclose(got1, oracle(keys, v1))
    got2 = np.asarray(ch._segmented_cummax(jnp.asarray(keys), jnp.asarray(v2)))
    np.testing.assert_allclose(got2, oracle(keys, v2))
    # short input takes the single-block path
    got3 = np.asarray(
        ch._segmented_cummax(jnp.asarray(keys[:100]), jnp.asarray(v1[:100]))
    )
    np.testing.assert_allclose(got3, oracle(keys[:100], v1[:100]))


def test_segment_curvature_grid_close_to_bruteforce():
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(3000, 3)).astype(np.float32) * 2.0
    m = jnp.ones(3000, bool)
    c_bf = np.asarray(ch.segment_curvature(jnp.asarray(pts), m, k=15))
    c_gr = np.asarray(
        ch.segment_curvature(jnp.asarray(pts), m, k=15, use_grid=True,
                             cell_size=0.8)
    )
    # grid k-NN is approximate (27-cell candidates); curvature stays close
    assert np.abs(c_bf - c_gr).mean() < 0.05


def test_run_end_index_strided_matches_flat():
    """The two-level (coarse + windowed-bisection) run-end search must be
    bit-identical to the flat scan_unrolled searchsorted, including absent
    buckets, leading/trailing runs, and the all-dead tail."""
    rng = np.random.default_rng(3)
    stride = 16
    n_groups = 32
    n_buckets = n_groups * stride
    sizes = rng.integers(0, 200, n_groups)
    sizes[5] = 0  # absent group
    key = np.concatenate([
        np.sort(rng.integers(0, stride, sz)) + g * stride
        for g, sz in enumerate(sizes)
    ] + [np.full(137, n_buckets)]).astype(np.int32)  # dead tail past range
    ks = jnp.asarray(key)
    idx_f, hit_f = ch._run_end_index(ks, n_buckets)
    idx_s, hit_s = ch._run_end_index(ks, n_buckets, stride=stride)
    np.testing.assert_array_equal(np.asarray(idx_f), np.asarray(idx_s))
    np.testing.assert_array_equal(np.asarray(hit_f), np.asarray(hit_s))
    # empty input
    idx_e, hit_e = ch._run_end_index(jnp.zeros(0, jnp.int32) + 99, 8, stride=4)
    assert not bool(jnp.any(hit_e))


def test_score_chunk_widths_bit_identical():
    """Column chunking (incl. the chunk=2 width) must not change any table
    output bit."""
    import dataclasses
    import jax

    pts, seg = _lone_tree()
    args = (jnp.asarray(pts), jnp.asarray(seg), jnp.ones(len(pts), bool), 4)
    ref_t, ref_c = ch.compute_segments(*args, CFG, full_bbox=True)
    for chunk in (2, 4, 5):
        cfg = dataclasses.replace(CFG, score_chunk=chunk)
        t, c = ch.compute_segments(*args, cfg, full_bbox=True)
        np.testing.assert_array_equal(np.asarray(ref_c), np.asarray(c))
        for a, b in zip(
            jax.tree_util.tree_leaves(ref_t), jax.tree_util.tree_leaves(t)
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_upper_half_separators_no_sign_overflow():
    """Separators quantizing into the upper half of the scene's y range
    (qg >= 32768) used to wrap the packed int32 negative; the arithmetic
    >> then sign-extended gs to ~ground_sep - yext, zeroing CLASS_GROUND
    for every elevated segment.  Same for segment_properties' min-y field."""
    pts, seg = _lone_tree()
    n = len(pts)
    shifted = pts + np.float32([0.0, 200.0, 0.0])
    # reference: the tree alone (its own y range -> lower-half quantization)
    t_ref, cls_ref = ch.compute_segments(
        jnp.asarray(shifted), jnp.asarray(seg), jnp.ones(n, bool), 4, CFG)
    # a far-below dummy segment stretches yext so the tree's separators land
    # in the UPPER half of the quantization range
    low = np.float32([[0.0, 0.0, 0.0], [1.0, 0.0, 1.0], [2.0, 0.0, 2.0]])
    allp = np.concatenate([shifted, low])
    seg_all = np.concatenate([seg, np.full(3, 2, np.int32)])
    valid = jnp.ones(n + 3, bool)
    t_all, cls_all = ch.compute_segments(
        jnp.asarray(allp), jnp.asarray(seg_all), valid, 4, CFG)
    # separators themselves agree (table values are un-quantized)
    assert abs(float(t_all.ground_sep[1]) - float(t_ref.ground_sep[1])) < 1e-3
    assert abs(float(t_all.crown_sep[1]) - float(t_ref.crown_sep[1])) < 1e-3
    # per-point classification agrees except points within quantization
    # distance (<= yext/65535 per scene) of a separator
    agree = float(np.mean(np.asarray(cls_all)[:n] == np.asarray(cls_ref)))
    assert agree > 0.995, agree

    # properties: per-point height must track the segment's own min-y, not a
    # sign-wrapped one (which pinned height to 1.0 for the whole segment)
    exp_a, hgt_a = ch.segment_properties(
        jnp.asarray(allp), jnp.asarray(seg_all), valid,
        cls_all, t_all, 4, CFG)
    h = np.asarray(hgt_a)[:n]
    assert h.min() < 0.2 and h.max() > 0.8  # spans the tree, not pinned


def test_segment_normals_recover_plane():
    """Points jittered on a tilted plane: k-NN covariance normals must agree
    with the true plane normal (and be unit, y-up); non-members get +y."""
    from treee_tpu.characteristics import segment_normals

    rng = np.random.default_rng(13)
    n = 1500
    true_n = np.array([0.3, 0.9, 0.2])
    true_n /= np.linalg.norm(true_n)
    u = np.cross(true_n, [1.0, 0.0, 0.0])
    u /= np.linalg.norm(u)
    w = np.cross(true_n, u)
    ab = rng.uniform(-6, 6, (n, 2))
    pts = (ab[:, :1] * u + ab[:, 1:] * w
           + rng.normal(0, 0.01, (n, 1)) * true_n).astype(np.float32)
    member = np.ones(n, bool)
    member[-50:] = False
    nrm = np.asarray(segment_normals(jnp.asarray(pts), jnp.asarray(member),
                                     k=15))
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0, atol=1e-5)
    dots = np.abs(nrm[member] @ true_n)
    assert np.quantile(dots, 0.05) > 0.99  # interior normals nail the plane
    np.testing.assert_allclose(nrm[~member], [[0.0, 1.0, 0.0]] * 50, atol=0)
