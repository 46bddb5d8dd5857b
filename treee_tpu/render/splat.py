"""Point-splat rasterizer + eye-dome lighting, fully on device.

Capability parity with the reference render pipeline:

- splats: one circle per point, billboarded in view space with a world-size
  ``scale`` and colored through a 1-D palette, with a property range filter
  (render/src/point_cloud.rs + point_cloud.wgsl:37-80).
- eye-dome lighting: a post-process that darkens pixels whose 4-neighbor
  linearized depth exceeds their own, alpha-blended over the scene
  (render/src/eye_dome.rs + eye_dome.wgsl:37-67).

The reference rasterizes by GPU instancing (3 vertices x N instances, fragment
circle-discard).  This design is scatter-based: project all points with one
matmul, z-test by scatter-min into a flat depth buffer, resolve winners by a
depth-equality scatter of point ids, then shade per pixel — every stage a
vectorized XLA op.  The splat footprint is a static (2R+1)^2 offset unroll with
a per-point circle test, matching the fragment shader's ``x*x+y*y >= 1 discard``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from . import palettes
from .camera import Camera

IBIG = jnp.int32(0x7FFFFFFF)
FBIG = jnp.float32(3.0e38)


def prop_from_segment(segment: jax.Array) -> jax.Array:
    """Hash segment ids into well-spread [0,1) palette coordinates.

    Stands in for the reference's random u32 ids feeding the lookup texture
    (segmenting.rs:516-521 + point_cloud.wgsl:78): ours are sequential, so a
    Fibonacci hash decorrelates adjacent ids' colors.
    """
    h = (segment.astype(jnp.uint32) * jnp.uint32(2654435761)) >> 8
    return h.astype(jnp.float32) / jnp.float32(1 << 24)


def _project(pos: jax.Array, cam: Camera, width: int, height: int):
    """Project to (pixel_x, pixel_y, view_depth, z01, radius_px_factor)."""
    view = cam.view_matrix()
    # camera-relative position is a large-magnitude cancellation for
    # georeferenced (UTM-scale) coordinates: keep the rotation at full f32
    # (an f32 product feeding a subtraction needs HIGHEST: the GPU would
    # otherwise run it in TF32)
    vp = jnp.dot(pos, view[:3, :3].T,
                 precision=jax.lax.Precision.HIGHEST) + view[:3, 3]
    depth = -vp[:, 2]
    proj = cam.projection_matrix(width / height)
    w = jnp.maximum(depth, 1e-6)
    ndc_x = proj[0, 0] * vp[:, 0] / w
    ndc_y = proj[1, 1] * vp[:, 1] / w
    z01 = (proj[2, 2] * vp[:, 2] + proj[2, 3]) / w
    fx = (ndc_x * 0.5 + 0.5) * width
    fy = (1.0 - (ndc_y * 0.5 + 0.5)) * height
    return fx, fy, depth, z01, proj[1, 1]


def rasterize_keys(
    pos: jax.Array,
    prop: jax.Array,
    mask: jax.Array,
    cam: Camera,
    cfg: RenderConfig = RenderConfig(),
) -> jax.Array:
    """Splat visibility pass -> packed key image i32[H,W].

    The key packs (quantized depth << 8 | palette index), so scatter-min IS
    the z-test.  Min is associative, which makes multi-device compositing
    exact: each shard rasterizes its own points and a ``pmin`` over the mesh
    equals the single-device image bit-for-bit (parallel/sharding.py).
    """
    w, h = cfg.width, cfg.height
    n = pos.shape[0]
    fx, fy, depth, z01, f_proj = _project(pos, cam, w, h)

    pmin = cfg.prop_min / float(0xFFFFFFFF)
    pmax = cfg.prop_max / float(0xFFFFFFFF)
    # NOTE: a point renders only if its CENTER pixel is on-screen (the pix
    # where-clause below) — partial splats whose center is off-screen are an
    # accepted approximation vs the reference's clipped instanced quads
    vis = (
        mask
        & (depth > cfg.near)
        & (depth < cfg.far)
        & (prop >= pmin)
        & (prop <= pmax)
    )

    ix0 = jnp.floor(fx).astype(jnp.int32)
    iy0 = jnp.floor(fy).astype(jnp.int32)
    n_pix = w * h
    r = cfg.max_splat_radius

    # ONE colliding-scatter pass: the z-test key packs quantized depth (23
    # bits, matching a 24-bit depth buffer's precision class) with the 8-bit
    # palette index, so a single scatter-min resolves both visibility and
    # color.  (A per-footprint scatter is 49x the updates; a separate id pass
    # doubles them — both dominated the frame at 15M points.)  Splats then grow
    # in IMAGE space: R min-depth dilation passes over the 8-neighborhood with
    # the circle test (point_cloud.wgsl:73 semantics), radius derived from the
    # winner's depth — pure [H,W] vector ops.
    depth_bits = 23
    # clamp to 2^23 - 2: zq = 2^23 - 1 with palette 255 would pack to
    # 0x7FFFFFFF = IBIG, making a farthest-depth point read as background
    zq = jnp.minimum(
        (jnp.clip(z01, 0.0, 1.0) * ((1 << depth_bits) - 1)).astype(jnp.int32),
        (1 << depth_bits) - 2,
    )
    pal8 = jnp.clip((prop * 256.0).astype(jnp.int32), 0, 255)
    key = (zq << 8) | pal8
    pix = jnp.where(
        vis & (ix0 >= 0) & (ix0 < w) & (iy0 >= 0) & (iy0 < h),
        iy0 * w + ix0,
        n_pix,
    )
    buf = jnp.full(n_pix + 1, IBIG, jnp.int32).at[pix].min(
        jnp.where(vis, key, IBIG), mode="drop"
    )
    return buf[:n_pix].reshape(h, w)


def resolve_keys(
    kimg: jax.Array,
    cam: Camera,
    palette: jax.Array,
    cfg: RenderConfig = RenderConfig(),
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Shade a packed key image: splat dilation, palette, background.

    Returns (color f32[H,W,3], depth01 f32[H,W], hit bool[H,W]).
    """
    w, h = cfg.width, cfg.height
    depth_bits = 23
    r = cfg.max_splat_radius
    f_proj = cam.projection_matrix(w / h)[1, 1]
    hit = kimg != IBIG
    zscale = jnp.float32(1.0 / ((1 << depth_bits) - 1))

    def unpack_z01(k):
        return (k >> 8).astype(jnp.float32) * zscale

    def radius_from_key(k):
        # invert z01 -> view depth: z01 = -p22 + p23/d  =>  d = p23/(z01 + p22)
        p22 = cfg.far / (cfg.near - cfg.far)
        p23 = cfg.near * cfg.far / (cfg.near - cfg.far)
        d = p23 / jnp.minimum(unpack_z01(k) + p22, -1e-9)
        return jnp.maximum(
            cfg.point_size * f_proj * (h / 2.0) / jnp.maximum(d, 1e-6), 0.71
        )

    if r > 0:
        rimg = jnp.where(hit, radius_from_key(kimg), 0.0)
        zero = jnp.zeros((h, w), jnp.float32)
        row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

        def dilate(state, _):
            k, rd, sdx, sdy = state
            for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1),
                           (-1, -1), (-1, 1), (1, -1), (1, 1)):
                ck = jnp.roll(k, (dy, dx), (0, 1))
                crd = jnp.roll(rd, (dy, dx), (0, 1))
                cdx = jnp.roll(sdx, (dy, dx), (0, 1)) + dx
                cdy = jnp.roll(sdy, (dy, dx), (0, 1)) + dy
                inside = cdx * cdx + cdy * cdy <= crd * crd
                # roll wraps: reject destinations whose source row/col came
                # from the opposite screen edge (mirror-bleed otherwise)
                src_ok = (
                    (row - dy >= 0) & (row - dy < h)
                    & (col - dx >= 0) & (col - dx < w)
                )
                better = (ck != IBIG) & inside & (ck < k) & src_ok
                k = jnp.where(better, ck, k)
                rd = jnp.where(better, crd, rd)
                sdx = jnp.where(better, cdx, sdx)
                sdy = jnp.where(better, cdy, sdy)
            return (k, rd, sdx, sdy), None

        (kimg, _, _, _), _ = jax.lax.scan(
            dilate, (kimg, rimg, zero, zero), None, length=r
        )
        hit = kimg != IBIG

    color = palette[jnp.clip(kimg & 255, 0, palette.shape[0] - 1)]
    bg = jnp.asarray(cfg.background, jnp.float32)
    color = jnp.where(hit[..., None], color, bg)
    z01_px = jnp.where(hit, unpack_z01(kimg), 1.0)
    return color, z01_px, hit


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_points(
    pos: jax.Array,
    prop: jax.Array,
    mask: jax.Array,
    cam: Camera,
    palette: jax.Array,
    cfg: RenderConfig = RenderConfig(),
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Rasterize splats; returns (color f32[H,W,3], depth01 f32[H,W], hit bool[H,W]).

    ``prop`` is the normalized [0,1] point property; points outside
    [prop_min, prop_max]/2^32 are filtered like the vertex-stage range test
    (point_cloud.wgsl:44-49).  Point identity does not survive rasterization
    (the z-key packs depth+palette index); picking goes through the exact ray
    path (interactive.pick) like the reference (mod.rs:680-710).
    """
    return resolve_keys(rasterize_keys(pos, prop, mask, cam, cfg),
                        cam, palette, cfg)


def eye_dome(
    color: jax.Array,
    z01: jax.Array,
    cfg: RenderConfig = RenderConfig(),
) -> jax.Array:
    """Eye-dome lighting post-process (eye_dome.wgsl:37-67 semantics).

    Linearize depth, take the max over the 4-neighborhood (edge-clamped like
    the reference sampler), clamp the excess by ``strength`` and alpha-blend
    the silhouette color.
    """
    s = max(1.0 - cfg.eye_dome_strength, 0.1) ** 6  # eye_dome.rs:226-229
    n, f = cfg.near, cfg.far

    def linearize(d):
        return jnp.where(d >= 1.0, 1.0, (2.0 * n) / (f + n - d * (f - n)))

    lin = linearize(z01)
    pad = jnp.pad(lin, 1, mode="edge")
    m = jnp.maximum(
        jnp.maximum(pad[:-2, 1:-1], pad[2:, 1:-1]),
        jnp.maximum(pad[1:-1, :-2], pad[1:-1, 2:]),
    )
    m = jnp.maximum(m, lin)
    m = jnp.minimum(m, lin + s)
    alpha = jnp.where(z01 < 1.0, (m - lin) / s, 0.0)
    ed = jnp.asarray(cfg.eye_dome_color, jnp.float32)
    return color * (1.0 - alpha[..., None]) + ed * alpha[..., None]


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_frame(
    pos: jax.Array,
    prop: jax.Array,
    mask: jax.Array,
    cam: Camera,
    palette: jax.Array,
    cfg: RenderConfig = RenderConfig(),
) -> jax.Array:
    """Full frame: splat pass + eye-dome post-process -> f32[H,W,3]."""
    color, z01, _ = render_points(pos, prop, mask, cam, palette, cfg)
    return eye_dome(color, z01, cfg)


def to_u8(img: jax.Array) -> jax.Array:
    return jnp.clip(img * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
