"""Splat rasterizer + eye-dome golden tests (framebuffer-level checks,
SURVEY.md §4 item 2)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from treee_tpu.config import RenderConfig
from treee_tpu.io import las
from treee_tpu.render import Camera, palettes, splat

CFG = RenderConfig(width=128, height=96, point_size=0.5)


def _cam(distance=10.0):
    return Camera.orbital(distance=distance)


def test_single_point_center():
    pos = jnp.array([[0.0, 0.0, 0.0]])
    prop = jnp.array([0.5])
    img, z01, hit = splat.render_points(
        pos, prop, jnp.ones(1, bool), _cam(), palettes.get("turbo"), CFG
    )
    hit = np.asarray(hit)
    h, w = CFG.height, CFG.width
    assert hit[h // 2, w // 2]
    # color at the center comes from the palette's 0.5 bin
    expected = np.asarray(palettes.get("turbo"))[128]
    np.testing.assert_allclose(np.asarray(img)[h // 2, w // 2], expected, atol=1e-5)
    # background elsewhere
    np.testing.assert_allclose(np.asarray(img)[0, 0], CFG.background, atol=1e-5)
    assert float(np.asarray(z01)[h // 2, w // 2]) < 1.0


def test_depth_order():
    # two points on the view ray: nearer one (larger z, camera at z=10) wins
    pos = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]])
    prop = jnp.array([0.1, 0.9])
    img, _, _ = splat.render_points(
        pos, prop, jnp.ones(2, bool), _cam(), palettes.get("turbo"), CFG
    )
    center = np.asarray(img)[CFG.height // 2, CFG.width // 2]
    near_color = np.asarray(palettes.get("turbo"))[int(0.9 * 256)]
    np.testing.assert_allclose(center, near_color, atol=1e-5)


def test_property_range_filter():
    pos = jnp.array([[0.0, 0.0, 0.0]])
    cfg = dataclasses.replace(CFG, prop_min=int(0.6 * 0xFFFFFFFF))
    _, _, hit = splat.render_points(
        pos, jnp.array([0.5]), jnp.ones(1, bool), _cam(), palettes.get("turbo"), cfg
    )
    assert not np.asarray(hit).any()


def test_mask_filter():
    pos = jnp.array([[0.0, 0.0, 0.0]])
    _, _, hit = splat.render_points(
        pos, jnp.array([0.5]), jnp.zeros(1, bool), _cam(), palettes.get("turbo"), CFG
    )
    assert not np.asarray(hit).any()


def test_behind_camera_culled():
    pos = jnp.array([[0.0, 0.0, 20.0]])  # behind the camera at z=10
    _, _, hit = splat.render_points(
        pos, jnp.array([0.5]), jnp.ones(1, bool), _cam(), palettes.get("turbo"), CFG
    )
    assert not np.asarray(hit).any()


def test_splat_radius_grows_with_proximity():
    far_hit = splat.render_points(
        jnp.array([[0.0, 0.0, -40.0]]), jnp.array([0.5]), jnp.ones(1, bool),
        _cam(), palettes.get("turbo"), CFG,
    )[2]
    near_hit = splat.render_points(
        jnp.array([[0.0, 0.0, 6.0]]), jnp.array([0.5]), jnp.ones(1, bool),
        _cam(), palettes.get("turbo"), CFG,
    )[2]
    far_px = np.asarray(far_hit).sum()
    near_px = np.asarray(near_hit).sum()
    assert near_px > far_px >= 1


def test_eye_dome_darkens_silhouette():
    # one splat over background: its rim pixels neighbor depth-1.0 background
    pos = jnp.array([[0.0, 0.0, 0.0]])
    color, z01, _ = splat.render_points(
        pos, jnp.array([0.5]), jnp.ones(1, bool), _cam(), palettes.get("white"), CFG
    )
    out = np.asarray(splat.eye_dome(color, z01, CFG))
    h, w = CFG.height, CFG.width
    center = out[h // 2, w // 2]
    ids = np.asarray(z01) < 1.0
    rim = ids & ~np.roll(ids, 1, axis=1)
    assert rim.any()
    ry, rx = np.argwhere(rim)[0]
    assert out[ry, rx].sum() < center.sum()
    # background pixels untouched
    np.testing.assert_allclose(out[0, 0], CFG.background, atol=1e-5)


def test_forest_frame_coverage():
    pts = las.synthetic_forest(n_trees=4, points_per_tree=3000, ground_points=3000)
    prop = splat.prop_from_segment(jnp.arange(len(pts)) % 7 + 1)
    cam = Camera.orbital(distance=60.0)
    img = splat.render_frame(
        jnp.asarray(pts), prop, jnp.ones(len(pts), bool), cam,
        palettes.get("turbo"), CFG,
    )
    img = np.asarray(img)
    assert img.shape == (CFG.height, CFG.width, 3)
    bg = np.asarray(CFG.background)
    coverage = (np.abs(img - bg).sum(-1) > 0.05).mean()
    assert 0.02 < coverage < 0.9


def test_palettes_valid():
    for name in ("turbo", "warm", "white"):
        p = np.asarray(palettes.get(name))
        assert p.shape == (256, 3)
        assert p.min() >= 0.0 and p.max() <= 1.0
    t = np.asarray(palettes.get("turbo"))
    assert t[25, 2] > t[25, 0]  # turbo is blue early on
    assert t[-1, 0] > t[-1, 2]  # and red at the end


def test_no_edge_wrap_bleed():
    """Dilation must not wrap: a fat splat at the right screen edge paints
    nothing onto the left edge (jnp.roll is cyclic; the wrapped band is
    rejected)."""
    w, h = CFG.width, CFG.height
    cam = _cam(5.0)
    # a close point whose center lands in the last column, mid-height
    d = np.asarray(cam.ray_direction(w - 0.5, h / 2.0, w, h))
    p = np.asarray(cam.position) + d * 1.0
    big = dataclasses.replace(CFG, point_size=2.0)  # huge splat radius
    img, _, hit = splat.render_points(
        jnp.asarray(p[None, :], jnp.float32), jnp.array([0.5]),
        jnp.ones(1, bool), cam, palettes.get("turbo"), big,
    )
    hit = np.asarray(hit)
    assert hit[:, -1].any()              # the splat itself rendered
    assert not hit[:, : big.max_splat_radius].any()  # nothing wrapped left


def test_far_depth_high_palette_not_background():
    """zq clamp: a point whose f32 z01 rounds to 1.0 with palette index 255
    must not pack to the IBIG background sentinel."""
    w, h = CFG.width, CFG.height
    far_cfg = dataclasses.replace(CFG, far=100.0, point_size=0.0)
    cam = _cam(2.0)
    d = np.asarray(cam.ray_direction(w / 2.0, h / 2.0, w, h))
    p = np.asarray(cam.position) + d * (far_cfg.far - 1e-4)
    img, z01, hit = splat.render_points(
        jnp.asarray(p[None, :], jnp.float32), jnp.array([1.0]),
        jnp.ones(1, bool), cam, palettes.get("turbo"), far_cfg,
    )
    assert np.asarray(hit).any()


def _dilate_oracle(kimg, radius, cfg, f_proj):
    """Plain-numpy splat dilation (resolve_keys semantics): ``radius``
    passes over the 8 neighbours in a fixed order, a neighbour's key wins a
    pixel when it is nearer and the pixel lies inside its splat circle."""
    h, w = kimg.shape
    ibig = 0x7FFFFFFF
    p22 = cfg.far / (cfg.near - cfg.far)
    p23 = cfg.near * cfg.far / (cfg.near - cfg.far)
    z = (kimg >> 8).astype(np.float32) * np.float32(1.0 / ((1 << 23) - 1))
    d = np.float32(p23) / np.minimum(z + np.float32(p22), np.float32(-1e-9))
    rad = np.maximum(np.float32(cfg.point_size * f_proj * (h / 2.0))
                     / np.maximum(d, np.float32(1e-6)), np.float32(0.71))
    k = kimg.copy()
    rd = np.where(kimg != ibig, rad, 0).astype(np.float32)
    sdx = np.zeros((h, w), np.float32)
    sdy = np.zeros((h, w), np.float32)
    for _ in range(radius):
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1),
                       (-1, -1), (-1, 1), (1, -1), (1, 1)):
            nk, nrd = k.copy(), rd.copy()
            nsx, nsy = sdx.copy(), sdy.copy()
            for y in range(h):
                for x in range(w):
                    sy, sx = y - dy, x - dx
                    if not (0 <= sy < h and 0 <= sx < w):
                        continue
                    cdx, cdy = sdx[sy, sx] + dx, sdy[sy, sx] + dy
                    if (k[sy, sx] != ibig and k[sy, sx] < k[y, x]
                            and cdx * cdx + cdy * cdy
                            <= rd[sy, sx] * rd[sy, sx]):
                        nk[y, x], nrd[y, x] = k[sy, sx], rd[sy, sx]
                        nsx[y, x], nsy[y, x] = cdx, cdy
            k, rd, sdx, sdy = nk, nrd, nsx, nsy
    return k


@pytest.mark.parametrize("radius", [1, 3])
def test_dilation_matches_numpy_loop(radius):
    """The XLA image-space dilation in resolve_keys equals a pixel loop."""
    cfg = dataclasses.replace(RenderConfig(width=40, height=30),
                              max_splat_radius=radius, point_size=0.3)
    cam = Camera.orbital(distance=20.0)
    rng = np.random.default_rng(radius)
    pos = (rng.normal(size=(300, 3)) * 4.0).astype(np.float32)
    prop = rng.random(300).astype(np.float32)
    kimg = splat.rasterize_keys(jnp.asarray(pos), jnp.asarray(prop),
                                jnp.ones(300, bool), cam, cfg)
    f_proj = float(cam.projection_matrix(cfg.width / cfg.height)[1, 1])
    want = _dilate_oracle(np.asarray(kimg), radius, cfg, f_proj)
    # radius 0 shades the oracle's keys without dilating them again
    cfg0 = dataclasses.replace(cfg, max_splat_radius=0)
    pal = palettes.get("turbo")
    got_c, got_z, _ = splat.resolve_keys(kimg, cam, pal, cfg)
    want_c, want_z, _ = splat.resolve_keys(jnp.asarray(want), cam, pal, cfg0)
    np.testing.assert_array_equal(np.asarray(got_z), np.asarray(want_z))
    np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want_c))


def _eye_dome_oracle(color, z01, cfg):
    """Plain-numpy eye-dome lighting (eye_dome.wgsl:37-67 semantics)."""
    s = max(1.0 - cfg.eye_dome_strength, 0.1) ** 6
    n, f = cfg.near, cfg.far
    lin = np.where(z01 >= 1.0, 1.0, (2.0 * n) / (f + n - z01 * (f - n)))
    h, w = z01.shape
    out = np.empty_like(color)
    for y in range(h):
        for x in range(w):
            m = lin[y, x]
            for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                yy, xx = min(max(yy, 0), h - 1), min(max(xx, 0), w - 1)
                m = max(m, lin[yy, xx])
            m = min(m, lin[y, x] + s)
            a = (m - lin[y, x]) / s if z01[y, x] < 1.0 else 0.0
            out[y, x] = color[y, x] * (1 - a) + np.asarray(
                cfg.eye_dome_color) * a
    return out


@pytest.mark.parametrize("strength", [0.7, 0.3])
def test_eye_dome_matches_numpy_loop(strength):
    rng = np.random.default_rng(2)
    h, w = 24, 32
    z01 = rng.uniform(0.9, 1.0, (h, w)).astype(np.float32)
    z01[rng.uniform(size=(h, w)) < 0.3] = 1.0  # background holes
    color = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    cfg = RenderConfig(width=w, height=h, eye_dome_strength=strength,
                       eye_dome_color=(0.1, 0.2, 0.3))
    got = np.asarray(splat.eye_dome(jnp.asarray(color), jnp.asarray(z01), cfg))
    want = _eye_dome_oracle(color.astype(np.float64), z01.astype(np.float64),
                            cfg)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
