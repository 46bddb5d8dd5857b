"""Morton (Z-order) encoding for the linear octree.

The reference has no spatial index at all (SURVEY.md §0: octree/LOD absent; its only
spatial partitioning is 1 m height slices, treee/src/loading.rs:98-101).  The
array backbone is a Morton-coded linear octree: quantize positions to a cubic
grid, interleave bits into one sortable key, and ``jax.lax.sort`` does the rest.

Keys are 30-bit (10 bits per axis, 1024^3 cells) stored in int32: sorts are
fastest on 32-bit keys, and 10 octree levels is ample for LOD/culling on forest
scans (sub-10cm cells on a 100 m tile).

Bit spreading uses the standard magic-number dilation; see e.g. the linear-octree
literature (PAPERS.md: "Efficient Neighbourhood Search in 3D Point Clouds Through
Space-Filling Curves and Linear Octrees").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MORTON_BITS = 10          # bits per axis
MORTON_SIZE = 1 << MORTON_BITS


def _spread3(x: jax.Array) -> jax.Array:
    """Dilate the low 10 bits of ``x`` so they occupy every 3rd bit."""
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact3(x: jax.Array) -> jax.Array:
    """Inverse of :func:`_spread3`."""
    x = x.astype(jnp.uint32) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def quantize(pos: jax.Array, lo: jax.Array, hi: jax.Array) -> jax.Array:
    """Map f32[N,3] positions into integer grid coords u32[N,3] in [0, 1024)."""
    extent = jnp.maximum(jnp.max(hi - lo), 1e-6)
    scaled = (pos - lo) / extent * (MORTON_SIZE - 1)
    return jnp.clip(scaled, 0, MORTON_SIZE - 1).astype(jnp.uint32)


def encode(cell: jax.Array) -> jax.Array:
    """Interleave u32[N,3] grid coords into int32[N] Morton keys (x,y,z order)."""
    key = (
        _spread3(cell[..., 0])
        | (_spread3(cell[..., 1]) << 1)
        | (_spread3(cell[..., 2]) << 2)
    )
    return key.astype(jnp.int32)  # < 2^30, sign-safe


def decode(key: jax.Array) -> jax.Array:
    """Recover u32[N,3] grid coords from int32[N] Morton keys."""
    k = key.astype(jnp.uint32)
    return jnp.stack(
        [_compact3(k), _compact3(k >> 1), _compact3(k >> 2)], axis=-1
    )


def encode_positions(pos: jax.Array, lo: jax.Array, hi: jax.Array) -> jax.Array:
    """f32[N,3] positions -> int32[N] Morton keys over the [lo, hi] bounding cube."""
    return encode(quantize(pos, lo, hi))


def sort_by_key(keys: jax.Array, *values: jax.Array) -> tuple[jax.Array, ...]:
    """Stable-sort ``values`` by Morton ``keys``."""
    return jax.lax.sort((keys,) + values, dimension=0, num_keys=1)
