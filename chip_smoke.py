#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU, through the user entry points.

    python3 chip_smoke.py            # one card: the phases below
    python3 chip_smoke.py --multi    # four cards: mesh-mode Session only

Phases (one card), each printing its own line; any failure exits non-zero:

1. device  -- JAX must see a GPU (no CPU fallback); the card's name and power
              limit come from ``nvidia-smi`` in a child process.
2. ingest  -- a 15M-point synthetic forest from ``--seed`` is written with the
              repo's LAZ encoder (the native codec is built from ``native/``)
              and opened with ``Session.from_las``.
3. segment -- ``Session.segment(0.75)`` at the default capacities: cold and
              warm time, segment count, peak device memory, and a second and
              third run that must reproduce segment ids and classes bit for bit.
4. views   -- full render, LOD build + render, adaptive render at tau = 2 px,
              curvature + focused render of the largest segment, one brush
              stroke + render, inventory, ``.npz`` save/open round trip.
5. parity  -- ``full_pipeline`` on a 1M-point scene on the GPU and on the CPU.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, ".smoke")

POINTS = 15_000_000
PARITY_POINTS = 1_000_000
MULTI_POINTS = 40_000_000
POINTS_PER_TREE = 12_000
GROUND_FRAC = 0.25
MAX_DISTANCE = 0.75
# segment-table floats, GPU vs CPU: both sides sum the same f32 values in
# different orders, so they agree to a few ulp of the scene extent
TABLE_RTOL = 1e-5
TABLE_ATOL = 1e-3   # metres
SEGMENT_AGREEMENT = 0.9999
# mesh vs one-card inventory: DBH to the mesh test's rtol, on all but a few
# trees (see run_multi)
DBH_RTOL = 1e-4
DBH_TREE_SHARE = 0.995


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require_gpu(jax_module):
    """The visible devices, or SystemExit when the first one is not a GPU."""
    devices = jax_module.devices()
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found {platform!r}")
    return devices


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def forest(n_points: int, seed: int) -> np.ndarray:
    """The benchmark scene: 12,000 points per tree at 7 m spacing, 25% ground."""
    from treee_tpu.io import las

    n_trees = max(1, int(n_points * (1 - GROUND_FRAC)) // POINTS_PER_TREE)
    return las.synthetic_forest(
        n_trees=n_trees, spacing=7.0, points_per_tree=POINTS_PER_TREE,
        ground_points=n_points - n_trees * POINTS_PER_TREE, seed=seed)


def timed(fn):
    """(result, seconds); ``fn`` must end in a host value or block itself."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def twice(phase: str, what: str, fn):
    """Run ``fn`` twice, print cold (compile included) and warm seconds;
    return both results."""
    first, cold = timed(fn)
    out, warm = timed(fn)
    log(phase, f"{what}: cold {cold:.3f} s, warm {warm:.4f} s")
    return first, out


def cold_warm(phase: str, what: str, fn):
    """:func:`twice`, returning the second result."""
    return twice(phase, what, fn)[1]


def same_table(a: dict, b: dict) -> bool:
    """Two inventory tables hold the same bits in every column."""
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def check_frame(img, cfg, what: str) -> None:
    img = np.asarray(img)
    want = (cfg.render.height, cfg.render.width, 3)
    if img.shape != want or img.dtype != np.uint8:
        raise AssertionError(f"{what}: frame {img.shape} {img.dtype}, "
                             f"want {want} uint8")
    bg = np.round(np.asarray(cfg.render.background) * 255).astype(np.uint8)
    drawn = float((img != bg).any(axis=-1).mean())
    if drawn < 0.01:
        raise AssertionError(f"{what}: only {drawn:.4f} of pixels drawn")


def phase_segment(s, cfg):
    import jax

    res, cold = timed(lambda: s.segment(MAX_DISTANCE))
    seg0 = np.asarray(s.cloud.segment)
    cls0 = np.asarray(s.cloud.classification)
    warm = []
    for _ in range(2):
        _, t = timed(lambda: (s.segment(MAX_DISTANCE), s.cloud.segment,
                              s.cloud.classification))
        warm.append(t)
        if not (np.array_equal(np.asarray(s.cloud.segment), seg0)
                and np.array_equal(np.asarray(s.cloud.classification),
                                   cls0)):
            raise AssertionError("segment() is not deterministic: ids or "
                                 "classes differ between runs")
    n_seg = int(res.n_segments)
    if n_seg <= 0:
        raise AssertionError("segmentation allocated no segments")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", -1)
    log("segment", f"cold {cold:.3f} s (compile included), warm "
        f"{min(warm):.4f} s (runs {', '.join(f'{t:.4f}' for t in warm)}), "
        f"{n_seg} segments, peak device memory {peak / 2**30:.2f} GiB")
    log("segment", "determinism: 3 runs, segment and classification "
        "arrays bit-identical")
    return seg0


def phase_views(s, cfg, tmp: str) -> None:
    import jax.numpy as jnp

    check_frame(cold_warm("views", "full render", s.render), cfg, "render")

    def lod():
        s.build_lod()
        return s.render(use_lod=True)
    check_frame(cold_warm("views", "build_lod + LOD render", lod), cfg, "lod")

    def adaptive():
        s.build_lod(camera=s.camera, adaptive_tau_px=2.0)
        return s.render(use_lod=True)
    check_frame(cold_warm("views", "adaptive render (tau 2 px)", adaptive),
                cfg, "adaptive")

    counts = np.asarray(s.table.count).copy()
    counts[0] = 0
    sid = int(np.argmax(counts))
    def curvature():
        # the Session caches a segment's curvature; drop it so the warm run
        # recomputes (k-NN + covariance + eigenvalues) instead of reading it
        s._focus_prop_cache.clear()
        return s.curvature(sid)
    curve = cold_warm("views", f"curvature of segment {sid} "
                      f"({int(counts[sid]):,} points)", curvature)
    curve = np.asarray(curve)
    if not np.isfinite(curve).all():
        raise AssertionError("curvature has non-finite values")
    check_frame(cold_warm("views", "render_focus(display='curve')",
                          lambda: s.render_focus(sid, display="curve")),
                cfg, "focus")

    pos = np.asarray(s.cloud.pos)[np.asarray(s.cloud.valid)]
    centers = iter([pos.mean(axis=0), pos.mean(axis=0) + 9.0])

    def stroke():
        s.delete_sphere(jnp.asarray(next(centers), jnp.float32), 2.0)
        return s.render()
    check_frame(cold_warm("views", "delete_sphere + render", stroke), cfg,
                "edit")

    inv0, inv = twice("views", "inventory", s.inventory)
    if len(inv["segment"]) == 0:
        raise AssertionError("inventory is empty")
    if not np.isfinite(inv["diameter_breast_height"]).all():
        raise AssertionError("inventory has non-finite DBH")
    log("views", f"inventory: {len(inv['segment'])} trees; two runs "
        f"bit-identical: {same_table(inv0, inv)}")

    from treee_tpu.pipeline import Session

    path = os.path.join(tmp, "session.npz")
    t0 = time.perf_counter()
    s.save(path)
    s2 = Session.open(path, s.config)
    dt = time.perf_counter() - t0
    a, b = s.cloud.to_numpy(), s2.cloud.to_numpy()
    for k in ("pos", "segment", "classification"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"save/open round trip changed {k}")
    log("views", f"save/open .npz round trip: {dt:.3f} s, arrays equal")


def phase_parity(seed: int, cfg) -> None:
    import jax
    import jax.numpy as jnp

    from treee_tpu.pipeline import full_pipeline

    pts = forest(PARITY_POINTS, seed)
    out = {}
    for name, dev in (("gpu", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        pos = jax.device_put(jnp.asarray(pts), dev)
        valid = jax.device_put(jnp.ones(len(pts), bool), dev)
        with jax.default_device(dev):
            seg, cls_, table, _ = full_pipeline(pos, valid, MAX_DISTANCE, cfg)
        out[name] = jax.tree_util.tree_map(np.asarray, (seg, cls_, table))
    (sg, cg, tg), (sc, cc, tc) = out["gpu"], out["cpu"]
    agree = float((sg == sc).mean())
    log("parity", f"{len(pts):,} points: segment-id agreement GPU vs CPU "
        f"{agree:.6f} (need >= {SEGMENT_AGREEMENT})")
    if agree < SEGMENT_AGREEMENT:
        raise AssertionError("segment ids disagree between GPU and CPU")
    if not np.array_equal(cg, cc):
        raise AssertionError(
            f"classification differs on {(cg != cc).sum()} points")
    log("parity", "classification identical")
    for field in ("ground_sep", "crown_sep", "trunk_height", "crown_height",
                  "areas"):
        a, b = getattr(tg, field), getattr(tc, field)
        err = float(np.max(np.abs(a - b) / (TABLE_ATOL + TABLE_RTOL
                                            * np.abs(b)), initial=0.0))
        log("parity", f"table.{field}: max |gpu-cpu| / (atol {TABLE_ATOL} + "
            f"rtol {TABLE_RTOL} |cpu|) = {err:.3g}")
        if err > 1.0:
            raise AssertionError(f"table.{field} outside tolerance")
    log("parity", "hand-written kernels on the main path: none (all stages "
        "run as XLA compiles them; f32 products at HIGHEST precision)")


def run_single(args) -> None:
    import jax

    from treee_tpu.config import DEFAULT_CONFIG
    from treee_tpu.io import las
    from treee_tpu.pipeline import Session

    cfg = DEFAULT_CONFIG
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = os.path.join(SCRATCH, f"run{os.getpid()}")
    os.makedirs(tmp)
    try:
        t0 = time.perf_counter()
        pts = forest(args.points, args.seed)
        gen = time.perf_counter() - t0
        path = os.path.join(tmp, "forest.laz")
        t0 = time.perf_counter()
        las.write_laz(path, pts)
        wr = time.perf_counter() - t0
        t0 = time.perf_counter()
        s = Session.from_las(path, cfg)
        jax.block_until_ready(s.cloud.pos)
        rd = time.perf_counter() - t0
        if int(s.cloud.count) != len(pts):
            raise AssertionError("from_las lost points")
        log("ingest", f"{len(pts):,} points: generate {gen:.2f} s, write_laz "
            f"{wr:.2f} s ({os.path.getsize(path) / 2**20:.1f} MiB), "
            f"Session.from_las {rd:.2f} s")
        del pts
        phase_segment(s, cfg)
        phase_views(s, cfg, tmp)
        del s
        phase_parity(args.seed, cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_multi(args) -> None:
    """Mesh-mode Session on four cards against a one-card Session."""
    import jax

    from treee_tpu.config import DEFAULT_CONFIG
    from treee_tpu.parallel import sharding
    from treee_tpu.pipeline import Session

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"chip_smoke --multi needs 4 GPUs, found "
                         f"{len(devices)}")
    cfg = DEFAULT_CONFIG
    pts = forest(args.points, args.seed)
    mesh = sharding.make_mesh(devices[:4])
    t0 = time.perf_counter()
    sm = Session.from_points(pts, cfg, mesh=mesh)
    log("multi", f"{len(pts):,} points on a {mesh.devices.size}-card mesh "
        f"(ingest {time.perf_counter() - t0:.2f} s)")
    del pts
    host = sm.cloud.to_numpy()
    n_cap = sm.cloud.capacity
    with jax.default_device(devices[0]):
        s1 = Session.from_points(host["pos"], cfg, capacity=n_cap)

    res_m = cold_warm("multi", "mesh segment", lambda: sm.segment(
        MAX_DISTANCE))
    res_1 = cold_warm("multi", "one-card segment", lambda: s1.segment(
        MAX_DISTANCE))
    if int(res_m.n_segments) != int(res_1.n_segments):
        raise AssertionError("segment counts differ")
    seg_m, seg_1 = np.asarray(sm.cloud.segment), np.asarray(s1.cloud.segment)
    if not np.array_equal(seg_m, seg_1):
        raise AssertionError(
            f"segment ids differ on {(seg_m != seg_1).sum()} points")
    cls_agree = float((np.asarray(sm.cloud.classification)
                       == np.asarray(s1.cloud.classification)).mean())
    log("multi", f"{int(res_m.n_segments)} segments, ids bit-identical, "
        f"classification agreement {cls_agree:.6f}")
    if cls_agree <= 0.999:
        raise AssertionError("classification agreement below 0.999")

    img_m = cold_warm("multi", "mesh render", sm.render)
    img_1 = cold_warm("multi", "one-card render", s1.render)
    exact = float((img_m == img_1).all(axis=-1).mean())
    log("multi", f"render: {exact:.4f} of pixels identical")
    if exact <= 0.98:
        raise AssertionError("mesh and one-card frames diverge")

    im0, im = twice("multi", "mesh inventory", sm.inventory)
    i10, i1 = twice("multi", "one-card inventory", s1.inventory)
    if not (np.array_equal(im["segment"], i1["segment"])
            and np.array_equal(im["n_points"], i1["n_points"])):
        raise AssertionError("inventory segments or counts differ")
    # the trunk axes come from exact integer sums; the RBV bins each point
    # by its transformed coordinates, which two differently compiled
    # programs may round one ulp apart, and a point crossing a bin edge
    # moves that tree's DBH by more than any float tolerance
    dbh_m, dbh_1 = im["diameter_breast_height"], i1["diameter_breast_height"]
    close = np.isclose(dbh_m, dbh_1, rtol=DBH_RTOL, atol=1e-5)
    log("multi", f"inventory: {len(dbh_m)} trees; DBH within rtol "
        f"{DBH_RTOL} on {close.mean():.6f} of trees (need >= "
        f"{DBH_TREE_SHARE}), max |diff| "
        f"{float(np.abs(dbh_m - dbh_1).max(initial=0.0)):.3g} m; trunk-axis "
        f"origins bit-identical: "
        f"{np.array_equal(im['stem_easting'], i1['stem_easting']) and np.array_equal(im['stem_northing'], i1['stem_northing'])}; "
        f"repeat runs bit-identical: mesh {same_table(im0, im)}, one card "
        f"{same_table(i10, i1)}")
    if close.mean() < DBH_TREE_SHARE:
        raise AssertionError("mesh and one-card DBH disagree")

    px, py = cfg.render.width // 2, cfg.render.height // 2
    pm, p1 = sm.pick(px, py), s1.pick(px, py)
    if pm[0] != p1[0] or pm[2] != p1[2]:
        raise AssertionError(f"pick differs: {pm} vs {p1}")
    np.testing.assert_allclose(pm[1], p1[1], rtol=1e-6)
    log("multi", f"pick at ({px}, {py}): segment {pm[0]}, hit {pm[2]}, "
        "same on both")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=None,
                    help="scene size (default 15M; 40M with --multi)")
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh-mode comparison")
    args = ap.parse_args(argv)
    if args.points is None:
        args.points = MULTI_POINTS if args.multi else POINTS

    import jax

    devices = require_gpu(jax)
    d0 = devices[0]
    log("device", f"{d0.device_kind}, {len(devices)} visible, "
        f"jax {jax.__version__}")
    log("device", f"nvidia-smi: {card_name_and_power()}")

    from treee_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.multi:
        run_multi(args)
    else:
        run_single(args)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
