"""Terrain and canopy rasters: DTM, DSM, CHM (beyond the reference).

The reference app computes per-segment forestry traits
(treee/src/interactive/hull.rs:926-995) but has no area-wide raster
products; these are the standard deliverables next to them: a digital
terrain model (DTM) from ground-classified returns, a digital surface
model (DSM) from all live returns, and their difference, the canopy
height model (CHM).

Array design: one f32 scatter-min and one scatter-max over a flat [H*W]
height grid (the same full-N scatter primitive the splat rasterizer
uses, render/splat.py), then a jump-flood nearest-seed fill for ground
holes — pure rolls/selects over the small grid, the same image-space
idiom as the splat dilation.  Absolute seed coordinates make the roll
wrap-around harmless (a wrapped candidate loses the distance test).  Grid
dims are padded up to multiples of 128 so nearby extents share compiled
shapes; callers slice the live window.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3.0e38)
NODATA = -9999.0


def grid_dims(lo, hi, cell: float, cap: int = 4096, pad: int = 128):
    """Host-side raster sizing: ((rows, cols), padded (rows, cols), cell).

    ``cell`` grows to fit a ``cap``-cell axis when the scene is larger
    (same policy as segmentation.cell_size's static-grid growth); padded
    dims are multiples of ``pad`` for lane-aligned device layouts.
    """
    ex = float(hi[0]) - float(lo[0])
    ez = float(hi[2]) - float(lo[2])
    cell = float(cell)
    need = max(ex, ez) / max(cap - 1, 1)
    if need > cell:
        cell = need
    cols = max(1, int(math.floor(ex / cell)) + 1)
    rows = max(1, int(math.floor(ez / cell)) + 1)
    pad_r = (rows + pad - 1) // pad * pad
    pad_c = (cols + pad - 1) // pad * pad
    return (rows, cols), (pad_r, pad_c), cell


@functools.partial(jax.jit, static_argnames=("shape", "live_dims"))
def height_grids(pos, ground, live, lo_x, lo_z, inv_cell, shape,
                 live_dims=None):
    """(dtm, dsm) f32[H, W]: scatter-min ground y / scatter-max live y.

    Empty cells hold +/-_BIG sentinels.  Masked points route to the one
    extra tail slot instead of a predicated scatter (the moment_grids
    idiom, segmentation.py:599) — cheaper than mode="drop" row masking.
    ``live_dims`` (rows, cols) bounds the index clip so f32 rounding at the
    max-extent boundary can't push the extreme point into a padded cell
    that callers slice off.
    """
    h, w = shape
    lr, lc = live_dims if live_dims is not None else (h, w)
    ix = jnp.clip(((pos[:, 0] - lo_x) * inv_cell).astype(jnp.int32), 0, lc - 1)
    iz = jnp.clip(((pos[:, 2] - lo_z) * inv_cell).astype(jnp.int32), 0, lr - 1)
    flat = iz * w + ix
    tail = h * w
    dtm = (
        jnp.full(tail + 1, _BIG, jnp.float32)
        .at[jnp.where(ground, flat, tail)]
        .min(pos[:, 1])[:tail]
    )
    dsm = (
        jnp.full(tail + 1, -_BIG, jnp.float32)
        .at[jnp.where(live, flat, tail)]
        .max(pos[:, 1])[:tail]
    )
    return dtm.reshape(h, w), dsm.reshape(h, w)


@jax.jit
def jfa_fill(grid, have):
    """Fill cells where ``have`` is False with the nearest seeded value.

    Standard jump-flood over the [H, W] grid: state is (value, seed row,
    seed col); each pass compares the 8 neighbors at the current jump and
    keeps the seed nearest in absolute cell coordinates, so wrapped rolls
    self-reject.  log2(max dim) + 2 passes — unrolled Python loop, static.
    """
    h, w = grid.shape
    rows = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sr = jnp.where(have, rows, -_BIG)
    sc = jnp.where(have, cols, -_BIG)
    val = jnp.where(have, grid, 0.0)

    def dist2(r, c):
        return (r - rows) ** 2 + (c - cols) ** 2

    steps = []
    s = max(1, (1 << (max(h, w) - 1).bit_length()) // 2)  # next_pow2(dim)/2
    while s >= 1:
        steps.append(s)
        s //= 2
    steps += [2, 1]  # JFA+2: mops up the rare misroutes of plain JFA
    best = dist2(sr, sc)
    for s in steps:
        for dr in (-s, 0, s):
            for dc in (-s, 0, s):
                if dr == 0 and dc == 0:
                    continue
                nr = jnp.roll(sr, (dr, dc), (0, 1))
                nc = jnp.roll(sc, (dr, dc), (0, 1))
                nv = jnp.roll(val, (dr, dc), (0, 1))
                nd = dist2(nr, nc)
                take = nd < best
                sr = jnp.where(take, nr, sr)
                sc = jnp.where(take, nc, sc)
                val = jnp.where(take, nv, val)
                best = jnp.where(take, nd, best)
    return val, jnp.isfinite(best) & (best < _BIG)


def compute_rasters(pos, classification, live, lo, hi, cell: float,
                    cap: int = 4096, y_offset: float = 0.0):
    """DTM / DSM / CHM over live points; returns (dict of f32[rows, cols]
    numpy arrays with NODATA holes, (rows, cols), cell).

    - ``dtm``: min ground-return height per cell, holes filled from the
      nearest ground cell (jump flood); NODATA only when the scene has no
      ground returns at all.  ``y_offset`` (the load-time recentering)
      shifts DTM/DSM to absolute map elevations.
    - ``dsm``: max live-return height per cell; NODATA where no returns.
    - ``chm``: max(dsm - dtm, 0) where the DSM exists; NODATA elsewhere.
    """
    from .cloud import CLASS_GROUND

    (rows, cols), (ph, pw), cell = grid_dims(lo, hi, cell, cap=cap)
    ground = live & (classification == CLASS_GROUND)
    dtm_raw, dsm_raw = height_grids(
        pos, ground, live,
        jnp.float32(lo[0]), jnp.float32(lo[2]), jnp.float32(1.0 / cell),
        (ph, pw), (rows, cols),
    )
    return (
        finalize_rasters(dtm_raw, dsm_raw, rows, cols, y_offset=y_offset),
        (rows, cols), cell,
    )


@functools.partial(jax.jit, static_argnames=("shape", "live_dims"))
def height_above_ground(pos, classification, live, lo_x, lo_z, inv_cell,
                        shape, live_dims):
    """Per-point height above the hole-filled DTM, f32[N] >= 0.

    The normalized-height forestry view over the WHOLE forest: the DTM is
    rasterized from ground-classified returns (height_grids + jfa_fill,
    exactly the --export-dtm product) and every live point gathers its
    cell's ground elevation.  The reference's height property is per-segment
    only (calculations.rs:323-326); this is the area-wide equivalent used by
    the ``display hag`` mode.  Non-live points (and scenes with no ground
    returns at all) read 0.
    """
    from .cloud import CLASS_GROUND

    h, w = shape
    lr, lc = live_dims
    ground = live & (classification == CLASS_GROUND)
    dtm_raw, _ = height_grids(
        pos, ground, live, lo_x, lo_z, inv_cell, shape, live_dims
    )
    dtm, ok = jfa_fill(dtm_raw, dtm_raw < _BIG)
    ix = jnp.clip(((pos[:, 0] - lo_x) * inv_cell).astype(jnp.int32), 0, lc - 1)
    iz = jnp.clip(((pos[:, 2] - lo_z) * inv_cell).astype(jnp.int32), 0, lr - 1)
    flat = iz * w + ix
    dtm_pt = dtm.reshape(-1)[flat]
    ok_pt = ok.reshape(-1)[flat]
    hag = jnp.maximum(pos[:, 1] - dtm_pt, 0.0)
    return jnp.where(live & ok_pt, hag, 0.0)


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def _finalize_device(dtm_raw, dsm_raw, rows, cols, y_offset):
    """Fill + NODATA select + live-window slice, all on device."""
    dtm_filled, filled_ok = jfa_fill(dtm_raw, dtm_raw < _BIG)
    have_s = dsm_raw > -_BIG
    chm = jnp.maximum(dsm_raw - dtm_filled, 0.0)
    win = lambda a: a[:rows, :cols]
    return (
        win(jnp.where(filled_ok, dtm_filled + y_offset, NODATA)),
        win(jnp.where(have_s, dsm_raw + y_offset, NODATA)),
        win(jnp.where(have_s & filled_ok, chm, NODATA)),
    )


def _fetch_chunked(dev2d, rows: int, cols: int) -> np.ndarray:
    """Device -> host in ~8 MB row blocks into a preallocated store."""
    out = np.empty((rows, cols), np.float32)
    step = max(1, (8 << 20) // max(cols * 4, 1))
    for r0 in range(0, rows, step):
        out[r0:r0 + step] = np.asarray(dev2d[r0:r0 + step])
    return out


def finalize_rasters(dtm_raw, dsm_raw, rows: int, cols: int,
                     y_offset: float = 0.0):
    """Sentinel grids -> hole-filled / NODATA rasters dict (shared by the
    single-device path above and parallel.sharding.sharded_rasters, whose
    pmin/pmax-composited grids are bit-identical inputs).

    ``y_offset`` restores the load-time recentering (world_offset[1]) on
    the absolute-elevation products DTM/DSM so .asc values are true map
    elevations; CHM is a difference and takes no offset.
    """
    dtm, dsm, chm = _finalize_device(
        dtm_raw, dsm_raw, rows, cols, jnp.float32(y_offset)
    )
    return {
        "dtm": _fetch_chunked(dtm, rows, cols),
        "dsm": _fetch_chunked(dsm, rows, cols),
        "chm": _fetch_chunked(chm, rows, cols),
    }
