"""Line overlays: hull wireframes, RBV cages, trunk axes.

The reference draws these as a LineList pipeline with black fragments over the
splat pass (render/src/lines.rs + lines.wgsl; hull/RBV/axis geometry from
interactive/hull.rs:780-841 and trunk_axis.rs:24-43).  The equivalent here
samples each segment densely, projects the samples with the same camera, depth-
tests them against the splat pass's z-buffer (with a small bias so lines win
ties against their own surface) and paints the hit pixels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from .camera import Camera
from .splat import _project


@functools.partial(jax.jit, static_argnames=("samples",))
def sample_lines(endpoints: jax.Array, samples: int = 32) -> jax.Array:
    """f32[L,2,3] segment endpoints -> f32[L*samples,3] sample points."""
    t = jnp.linspace(0.0, 1.0, samples)[None, :, None]
    a = endpoints[:, 0:1, :]
    b = endpoints[:, 1:2, :]
    return (a + (b - a) * t).reshape(-1, 3)


@functools.partial(jax.jit, static_argnames=("cfg", "samples"))
def overlay(
    color: jax.Array,       # f32[H,W,3] splat-pass output
    z01: jax.Array,         # f32[H,W] splat-pass depth
    endpoints: jax.Array,   # f32[L,2,3]
    cam: Camera,
    cfg: RenderConfig = RenderConfig(),
    line_color: tuple[float, float, float] = (0.0, 0.0, 0.0),
    samples: int = 32,
    depth_bias: float = 2e-4,
) -> jax.Array:
    """Paint depth-tested line samples over a rendered frame."""
    w, h = cfg.width, cfg.height
    pts = sample_lines(endpoints, samples)
    fx, fy, depth, z01_s, _ = _project(pts, cam, w, h)
    ix = jnp.floor(fx).astype(jnp.int32)
    iy = jnp.floor(fy).astype(jnp.int32)
    ok = (
        (depth > cfg.near) & (depth < cfg.far)
        & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    )
    pix = jnp.where(ok, iy * w + ix, w * h)
    visible = ok & (z01_s <= z01.reshape(-1)[jnp.clip(pix, 0, w * h - 1)] + depth_bias)
    tgt = jnp.where(visible, pix, w * h)
    painted = (
        jnp.zeros(w * h + 1, bool).at[tgt].set(True, mode="drop")[: w * h]
    ).reshape(h, w)
    lc = jnp.asarray(line_color, jnp.float32)
    return jnp.where(painted[..., None], lc, color)
