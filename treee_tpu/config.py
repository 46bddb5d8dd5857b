"""Configuration for the treee-tpu framework.

The reference (antonWetzel/treee) has no config system: every tunable is an egui
widget or a hardcoded constant (see SURVEY.md §5 "Config / flag system").  Here the
same knobs are first-class dataclasses with the reference's defaults:

- segmentation max distance 0.75 m, slider 0.1-2.0  (treee/src/segmenting.rs:16,82)
- characteristics slice width 0.1 m                 (treee/src/calculations.rs:17)
- curvature neighbor count k=31                     (treee/src/calculations.rs:279)
- camera 45 deg FOV, near 0.1, far 10000            (treee/src/camera.rs:7,24-25)
- point size 0.1, slider 0.01-1.0                   (treee/src/program.rs:156,109)
- eye-dome strength 0.7, color black                (treee/src/program.rs:160)
- background color (0.3, 0.5, 0.7)                  (treee/src/program.rs:200)
- ground search height 1.0 m, min-area scale 1.5,
  min crown diameter 2.0 m                          (treee/src/calculations.rs:204-206)
- brush radius default 0.5, slider 0.1-10           (treee/src/interactive/mod.rs:259,455-463)

Capacity fields are new: compiled XLA programs need static shapes, so every variable-size
collection in the reference (per-segment Vecs, per-slice trees, chunk lists) becomes
a padded array whose capacity is fixed at trace time.
"""

from __future__ import annotations

import dataclasses
import math


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Tree segmentation parameters.

    The reference segments by building per-1m-height-slice convex "tree" polygons
    merged under ``max_distance`` and tracking centroids top-down
    (treee/src/segmenting.rs:110-235).  The array redesign keeps the same observable
    knobs but runs grid connected-components per band + centroid tracking via
    ``lax.scan`` + nearest-centroid (Voronoi-equivalent) point assignment.
    """

    max_distance: float = 0.75          # segmenting.rs:16 DEFAULT_MAX_DISTANCE
    band_height: float = 1.0            # loading.rs:98-101 1m y-slices
    # filter: reference drops trees with polygon area < d^2/4 (segmenting.rs:472)
    min_area_factor: float = 0.25
    # matching radius: centroids match to the band above within 2*d (segmenting.rs:499)
    match_radius_factor: float = 2.0
    # cluster filter: the reference drops degenerate (near-zero-area) polygons;
    # our proxy drops clusters with fewer than min_points points
    min_points: int = 4
    # --- static capacities (new; fixed compiled shapes) ---
    max_bands: int = 64                 # max height bands (64 m of canopy)
    max_trees_per_band: int = 256       # max new clusters per band
    max_segments: int = 2048            # max tracked segments in a scene
    # CC occupancy grid resolution per axis: cells stay at max_distance until
    # the scene exceeds (grid_size-1)*d across (~287 m at d=0.75), then grow;
    # CC/extract work scales with grid_size**2 (384**2 is 44% less than 512**2)
    grid_size: int = 384
    cc_iters: int = 24                  # label-propagation sweeps (with jumping)
    # compacted occupied-cell capacity for CC pointer jumps + cluster
    # aggregation; 512k covers ~3.5 fully dense bands (forest scans occupy a
    # few 100k cells) — overflowing cells still converge via the sweeps
    cc_occupied_cap: int = 1 << 19
    match_rounds: int = 4               # mutual-nearest matching rounds per band
    # packed-plane JFA: seed positions ride one 2x15-bit fixed-point i32
    # plane (s/64 lattice) instead of two f32 planes — ~2x less rolled HBM
    # traffic per direction at ~1 cm position quantization.  Fallback when
    # the brute-force Voronoi is disabled; requires grid_size <= 512.
    use_packed_jfa: bool = True
    # EXACT brute-force banded Voronoi at occupied cells only (one-hot matmul
    # row-select of each band's tracked table, chunked running min): the
    # flood fill sweeps ~9 steps x 8 rolled directions over the full
    # [B,G,G] plane stack, but winners are only read at the ~300k occupied
    # cells.  Work is N-independent (scales with cc_occupied_cap x
    # max_segments).  Takes precedence over the JFA variants when set, and
    # needs none of the seed-grid scatters the JFA does.
    use_bruteforce_voronoi: bool = True
    voronoi_chunk: int = 256            # tracked slots per running-min chunk
    # sort-based cluster selection in _extract_clusters: lex-sort the
    # compacted accumulation-target candidates by (band, -count) instead of
    # a batched top_k over the full [B, G*G] grid.  Bit-identical selection
    # (stable sort reproduces top_k's biggest-first order and lowest-index
    # tie-break; regression-tested).
    use_sorted_extract: bool = True


@dataclasses.dataclass(frozen=True)
class CharacteristicsConfig:
    """Per-segment characteristics parameters (treee/src/calculations.rs)."""

    slice_width: float = 0.1            # calculations.rs:17 SLICE_WIDTH
    ground_max_search_height: float = 1.0   # calculations.rs:204
    ground_min_area_scale: float = 1.5      # calculations.rs:205
    min_crown_diameter: float = 2.0         # calculations.rs:206
    neighbors: int = 31                 # calculations.rs:279 neighbor count for curvature
    min_area_floor: float = 0.5         # calculations.rs:227 `.max(0.5)`
    # --- static capacities ---
    max_slices: int = 384               # 38.4 m of tree at 0.1 m slices
    # support directions for 2-D hull area: the [N,K] scatter is the hot pass
    # of the characteristics phase; K=8 circumscribes a disk within +5.5%,
    # comfortably inside the separator thresholds' 1.5x margins
    hull_directions: int = 8
    # column-chunk the [N,K] segmented support scans to cap peak HBM at very
    # large N (identical results; same total elements).  0/>=K = unchunked,
    # the default: a chunk split costs extra passes and a second bucket
    # extraction.
    score_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Grid-hash k-NN parameters (replaces the k-nearest KD-tree crate)."""

    k: int = 31
    # candidate cap per neighboring cell; 27 cells * cap = candidate pool
    cell_capacity: int = 16
    # brute-force threshold: segments smaller than this use exact tiled
    # brute force; larger ones take the grid-hash engine.  Brute force
    # grows quadratically with the member count, the grid engine linearly
    # with a much larger constant; the crossover on the GPU is not measured
    brute_force_max: int = 131072
    query_tile: int = 1024              # queries per brute-force tile


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Splat renderer parameters (render/src/*.wgsl semantics)."""

    width: int = 1280
    height: int = 720
    fov_y: float = 45.0 * math.tau / 360.0  # camera.rs:7
    near: float = 0.1                   # camera.rs:24
    far: float = 10_000.0               # camera.rs:25
    point_size: float = 0.1             # program.rs:156 (view-space splat radius)
    background: tuple[float, float, float] = (0.3, 0.5, 0.7)  # program.rs:200
    eye_dome_strength: float = 0.7      # program.rs:160
    eye_dome_color: tuple[float, float, float] = (0.0, 0.0, 0.0)  # eye_dome.rs:93
    palette: str = "turbo"              # program.rs:174
    # max splat footprint half-extent in pixels (static unroll bound)
    max_splat_radius: int = 3
    # points per rasterization tile (bounds the [tile, footprint] scatter operand)
    raster_tile: int = 1 << 20
    # property range filter (point_cloud.wgsl:44-49); u32 range semantics
    prop_min: int = 0
    prop_max: int = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class InteractiveConfig:
    """Interactive editing parameters (treee/src/interactive/mod.rs)."""

    draw_radius: float = 0.5            # mod.rs:259
    # default proj string (UTM zone 32, Europe) mod.rs:53
    source_location: str = "+proj=utm\n+ellps=GRS80\n+zone=32"


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level framework configuration."""

    segmentation: SegmentationConfig = dataclasses.field(default_factory=SegmentationConfig)
    characteristics: CharacteristicsConfig = dataclasses.field(default_factory=CharacteristicsConfig)
    neighbors: NeighborConfig = dataclasses.field(default_factory=NeighborConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    interactive: InteractiveConfig = dataclasses.field(default_factory=InteractiveConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = Config()
