"""Benchmark: octree build + segmentation + characteristics throughput, and
splat frame time, on a 15M-point synthetic forest scan (BASELINE.md).

Prints ONE JSON line:
  {"metric": ..., "value": Mpts/s, "unit": "Mpts/s", "vs_baseline": ...,
   extras...}

Baseline: the reference publishes no numbers (SURVEY.md §6); the target is
15M points imported+segmented in < 5 s (=> 3 Mpts/s).  ``vs_baseline`` is
measured throughput / 3 Mpts/s.  Every phase must succeed: a failing phase
fails the run.  The JSON line names the device it ran on (platform, kind,
count, and the card's name and power limit from nvidia-smi); the bench
refuses to run without a GPU.

Env knobs: BENCH_POINTS (default 15_000_000), BENCH_FRAMES (default 8).
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RESULT: dict = {}


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit for the card (child process)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    RESULT.update(platform=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()),
                  card=card_name_and_power())

    # persistent compilation cache: reruns load the pipeline executables
    # from disk (shared with the product paths)
    from treee_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp

    from treee_tpu.config import DEFAULT_CONFIG
    from treee_tpu.io import las
    from treee_tpu.ops import octree
    from treee_tpu.pipeline import full_pipeline
    from treee_tpu.render import Camera, palettes, splat

    n_target = int(os.environ.get("BENCH_POINTS", 15_000_000))
    n_frames = int(os.environ.get("BENCH_FRAMES", 8))
    cfg = DEFAULT_CONFIG
    # A/B knobs for the measured alternates (1 = on, 0/unset = config default)
    import dataclasses as _dc

    if os.environ.get("BENCH_PACKED_JFA"):
        cfg = cfg.replace(segmentation=_dc.replace(
            cfg.segmentation,
            use_packed_jfa=os.environ["BENCH_PACKED_JFA"] == "1"))
    if os.environ.get("BENCH_BF_VORONOI"):
        cfg = cfg.replace(segmentation=_dc.replace(
            cfg.segmentation,
            use_bruteforce_voronoi=os.environ["BENCH_BF_VORONOI"] == "1"))
    # --- synthetic forest scan sized to the target (host) ---
    points_per_tree = 12_000
    ground_frac = 0.25
    n_trees = max(1, int(n_target * (1 - ground_frac)) // points_per_tree)
    t0 = time.time()
    pts = las.synthetic_forest(
        n_trees=n_trees,
        spacing=7.0,
        points_per_tree=points_per_tree,
        ground_points=n_target - n_trees * points_per_tree,
        seed=0,
    )
    gen_s = time.time() - t0
    n = len(pts)

    # --- host -> device (import path) ---
    t0 = time.time()
    pos = jnp.asarray(pts)
    valid = jnp.ones(n, bool)
    jax.block_until_ready(pos)
    upload_s = time.time() - t0

    d = jnp.float32(cfg.segmentation.max_distance)

    def build_and_segment(pos, valid, d):
        # keys-only build: bit-identical sorted keys to octree.build(...)
        # .keys (which is all this step ever returned — the order/rank
        # payloads were already DCE'd), minus the stable-sort tax
        keys = octree.build_keys(pos, valid)
        segment, classification, table, _ = full_pipeline(pos, valid, d, cfg)
        return keys, segment, classification, table.trunk_height

    step = jax.jit(build_and_segment)

    print(f"# bench: generated {n:,} pts, compiling pipeline...", file=sys.stderr, flush=True)
    # warmup/compile
    t0 = time.time()
    out = jax.block_until_ready(step(pos, valid, d))
    compile_s = time.time() - t0
    print(f"# bench: pipeline compiled in {compile_s:.0f}s", file=sys.stderr, flush=True)

    # timed runs (dispatch-inclusive; reported as pipeline_dispatch_s)
    runs = []
    for i in range(3):
        t0 = time.time()
        out = jax.block_until_ready(step(pos, valid, d))
        runs.append(time.time() - t0)
        print(f"# bench: run {i} {runs[-1]:.2f}s", file=sys.stderr, flush=True)
    jax.block_until_ready(out)  # every leaf real before downstream consumers

    # device throughput: chain 8 pipeline executions through lax.scan with a
    # single dispatch + sync — the same methodology as the frame sweep
    # below, so per-call dispatch is amortized.  Each iteration's inputs ride the scanned d (valid & (d_i > 0) is
    # bit-identical to valid at runtime but data-dependent at trace time),
    # so XLA's loop-invariant code motion cannot hoist any stage out of the
    # loop — all 8 iterations execute in full.
    @jax.jit
    def pipeline_scan(pos, valid, d_stack):
        def body(acc, d_i):
            v_i = valid & (d_i > 0)
            keys, seg_i, cls_i, th = build_and_segment(pos, v_i, d_i)
            probe = (keys[0] + seg_i[0] + cls_i[0]).astype(jnp.float32)
            return acc + probe + th[0], None

        total, _ = jax.lax.scan(body, jnp.float32(0.0), d_stack)
        return total

    scan_reps = 8
    d_stack = jnp.full(scan_reps, cfg.segmentation.max_distance, jnp.float32)
    jax.block_until_ready(pipeline_scan(pos, valid, d_stack))  # compile
    t0 = time.time()
    jax.block_until_ready(pipeline_scan(pos, valid, d_stack))
    pipe_s = (time.time() - t0) / scan_reps
    print(f"# bench: scan-timed pipeline {pipe_s:.3f}s/run", file=sys.stderr,
          flush=True)
    mpts_per_s = n / pipe_s / 1e6

    target_mpts = 3.0  # 15M in <5s
    RESULT.update(
        metric="Mpts/sec octree build+segmentation; splat frame ms on 15M-point scan",
        value=round(mpts_per_s, 3),
        unit="Mpts/s",
        vs_baseline=round(mpts_per_s / target_mpts, 3),
        points=n,
        pipeline_s=round(pipe_s, 3),
        pipeline_dispatch_s=round(min(runs), 3),
        # dispatch-inclusive throughput (one call per run)
        mpts_per_s_dispatch=round(n / min(runs) / 1e6, 3),
        compile_s=round(compile_s, 1),
        upload_s=round(upload_s, 3),
        gen_s=round(gen_s, 1),
    )

    # --- frame sweep ---
    # One lax.scan over a stack of orbit cameras with a single sync: per-frame
    # dispatch latency isn't what this measures — device frame compute is.
    segment = out[1]
    prop = splat.prop_from_segment(segment)
    palette = palettes.get(cfg.render.palette)
    cam0 = Camera.orbital(distance=120.0)
    cams = [cam0]
    for _ in range(n_frames - 1):
        cams.append(cams[-1].rotate_orbital(40.0, 0.0))
    cam_stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)

    @jax.jit
    def sweep(pos, prop, valid, cam_stack):
        def body(acc, cam):
            img = splat.render_frame(pos, prop, valid, cam, palette, cfg.render)
            return acc + jnp.sum(img), None

        total, _ = jax.lax.scan(body, jnp.float32(0.0), cam_stack)
        return total

    jax.block_until_ready(sweep(pos, prop, valid, cam_stack))  # compile
    print("# bench: frame sweep compiled", file=sys.stderr, flush=True)
    t0 = time.time()
    jax.block_until_ready(sweep(pos, prop, valid, cam_stack))
    frame_ms = (time.time() - t0) / n_frames * 1e3
    RESULT.update(frame_ms=round(frame_ms, 2), fps=round(1000.0 / frame_ms, 1))
    print(f"# bench: full-cloud frame {frame_ms:.0f} ms", file=sys.stderr,
          flush=True)

    # LOD frame sweep: the octree subset the reference lacks (its draw is
    # brute-force, program.rs:309-311).  The subset is INDEX-compacted once,
    # then padded SNUGLY: projection+scatter work scales with the padded row
    # count, not the live one.
    build_lod = jax.jit(
        lambda pos, valid: octree.compact_indices(
            octree.lod_mask(octree.build(pos, valid), level=7) & valid,
            2 << 20,
        )
    )
    count, idx_big = jax.block_until_ready(build_lod(pos, valid))
    lod_n = int(count)
    lod_cap = min(octree.snug_capacity(lod_n), n)
    idx = idx_big[:lod_cap]
    pos_l = pos[idx]
    prop_l = prop[idx]
    mask_l = jnp.arange(lod_cap) < count
    print(f"# bench: lod built ({lod_n} pts, cap {lod_cap})", file=sys.stderr,
          flush=True)
    jax.block_until_ready(sweep(pos_l, prop_l, mask_l, cam_stack))  # compile
    print("# bench: lod sweep compiled", file=sys.stderr, flush=True)
    t0 = time.time()
    jax.block_until_ready(sweep(pos_l, prop_l, mask_l, cam_stack))
    lod_frame_ms = (time.time() - t0) / n_frames * 1e3
    RESULT.update(
        lod_frame_ms=round(lod_frame_ms, 2),
        lod_fps=round(1000.0 / lod_frame_ms, 1),
        lod_points=lod_n,
    )

    # ADAPTIVE frame: full-cloud rendering is bound by the z-scatter over
    # every row, so the fast path renders a screen-error cut
    # (octree.adaptive_mask): per-region octree level chosen so cells
    # project <= tau px at the node's camera distance.  Measured separately
    # from the full-cloud number, with the fraction of pixels identical to
    # the full render as the quality evidence.
    f_proj = cam0.projection_matrix(cfg.render.width / cfg.render.height)[1, 1]
    px_scale = float(f_proj) * (cfg.render.height / 2.0)
    # AUTO-TAU: solve the screen-error cut from a row budget (n/2) over the
    # candidate ladder in ONE dispatch (octree.adaptive_counts) instead of
    # hand-picking tau per scale; the chosen tau is recorded below.
    from treee_tpu.pipeline import Session as _S

    tau_budget = n // 2
    counts_ladder = np.asarray(jax.block_until_ready(jax.jit(
        lambda pos, valid: octree.adaptive_counts(
            octree.build(pos, valid), cam0.position, px_scale, _S.TAU_LADDER,
            live=valid,
        )
    )(pos, valid)))
    fits = np.nonzero(counts_ladder <= tau_budget)[0]
    tau = _S.TAU_LADDER[int(fits[0])] if len(fits) else _S.TAU_LADDER[-1]
    print(f"# bench: auto tau = {tau} px (budget {tau_budget:,} rows)",
          file=sys.stderr, flush=True)
    count_a, idx_a_big = jax.block_until_ready(jax.jit(
        lambda pos, valid: octree.compact_indices(
            octree.adaptive_mask(
                octree.build(pos, valid), cam0.position, px_scale,
                tau_px=tau,
            ) & valid,
            pos.shape[0],
        )
    )(pos, valid))
    ad_n = int(count_a)
    # render-only snapshot subset: no edit headroom, minimal padded rows
    # (frame cost scales with PADDED rows; snug_capacity keeps waste <~6%)
    ad_cap = min(octree.snug_capacity(ad_n, headroom=1.0), n)
    idx_a = idx_a_big[:ad_cap]
    pos_a, prop_a = pos[idx_a], prop[idx_a]
    mask_a = jnp.arange(ad_cap) < count_a
    print(f"# bench: adaptive subset {ad_n} pts (cap {ad_cap})",
          file=sys.stderr, flush=True)
    jax.block_until_ready(sweep(pos_a, prop_a, mask_a, cam_stack))  # compile
    t0 = time.time()
    jax.block_until_ready(sweep(pos_a, prop_a, mask_a, cam_stack))
    ad_ms = (time.time() - t0) / n_frames * 1e3

    frame_full = jax.jit(
        lambda p, pr, v: splat.to_u8(
            splat.render_frame(p, pr, v, cam0, palettes.get(cfg.render.palette),
                               cfg.render))
    )
    img_f = np.asarray(frame_full(pos, prop, valid))
    img_a = np.asarray(frame_full(pos_a, prop_a, mask_a))
    match = float((img_f == img_a).all(axis=-1).mean())
    RESULT.update(
        adaptive_frame_ms=round(ad_ms, 2),
        adaptive_fps=round(1000.0 / ad_ms, 1),
        adaptive_points=ad_n,
        adaptive_pixel_match=round(match, 4),
        adaptive_tau=tau,
    )
    print(f"# bench: adaptive frame {ad_ms:.1f} ms, {match:.1%} pixels == full",
          file=sys.stderr, flush=True)

    # NEAR-LOSSLESS screen-error cut at tau=1 px: the sub-pixel cells keep
    # full detail, so the image is ~indistinguishable from the full render
    # (pixel match ~1.0) at a fraction of the rows; rebuilt per camera move
    # in Session.build_lod(adaptive_tau_px=...).
    count_s, idx_s_big = jax.block_until_ready(jax.jit(
        lambda pos, valid: octree.compact_indices(
            octree.adaptive_mask(
                octree.build(pos, valid), cam0.position, px_scale,
                tau_px=1.0,
            ) & valid,
            pos.shape[0],
        )
    )(pos, valid))
    sc_n = int(count_s)
    sc_cap = min(octree.snug_capacity(sc_n, headroom=1.0), n)
    idx_s = idx_s_big[:sc_cap]
    pos_s, prop_s = pos[idx_s], prop[idx_s]
    mask_s = jnp.arange(sc_cap) < count_s
    print(f"# bench: screen-adaptive subset {sc_n} pts (cap {sc_cap})",
          file=sys.stderr, flush=True)
    jax.block_until_ready(sweep(pos_s, prop_s, mask_s, cam_stack))  # compile
    t0 = time.time()
    jax.block_until_ready(sweep(pos_s, prop_s, mask_s, cam_stack))
    sc_ms = (time.time() - t0) / n_frames * 1e3
    img_s = np.asarray(frame_full(pos_s, prop_s, mask_s))
    match_s = float((img_f == img_s).all(axis=-1).mean())
    RESULT.update(
        screen_adaptive_frame_ms=round(sc_ms, 2),
        screen_adaptive_fps=round(1000.0 / sc_ms, 1),
        screen_adaptive_points=sc_n,
        screen_adaptive_pixel_match=round(match_s, 4),
    )
    print(f"# bench: screen-adaptive frame {sc_ms:.1f} ms, "
          f"{match_s:.1%} pixels == full", file=sys.stderr, flush=True)

    # --- whole-forest inventory: trunk axis + split RBV + all trait fields
    # for EVERY segment in one batched pass (Session.inventory's device
    # core).  The reference computes traits one focused tree at a time; the
    # cost here is a fixed number of [N] gathers/scatters, tree-count-free.
    from treee_tpu import rbv as rbv_mod
    from treee_tpu import trunk_axis as ta_mod
    from treee_tpu.cloud import CLASS_TRUNK
    from treee_tpu.pipeline import _segment_class_counts

    S = cfg.segmentation.max_segments + 1

    @jax.jit
    def inventory_pass(pos, segment, classification, valid):
        live = valid & (segment > 0) & (segment < S)
        axes = ta_mod.batched_average_direction(
            pos, live & (classification == CLASS_TRUNK), segment, S)
        tfs = ta_mod.batched_axis_transform(axes)
        crown, trunk = rbv_mod.batched_split_rbv(
            pos, classification, live, segment, S, tfs)
        tr = rbv_mod.batched_traits(crown, trunk)
        counts = _segment_class_counts(segment, classification, live, S)
        return tr.diameter_breast_height, tr.crown_volume, counts

    jax.block_until_ready(inventory_pass(pos, segment, out[2], valid))  # compile
    t0 = time.time()
    dbh, _, counts = jax.block_until_ready(
        inventory_pass(pos, segment, out[2], valid))
    inv_s = time.time() - t0
    n_trees = int((np.asarray(counts).sum(axis=1) > 0).sum())
    RESULT.update(inventory_s=round(inv_s, 3), inventory_trees=n_trees)
    print(f"# bench: whole-forest inventory {inv_s:.2f}s "
          f"({n_trees} trees)", file=sys.stderr, flush=True)

    # --- focused-view analytics: the per-tree surface — curvature k-NN
    # recompute + the focus frame — measured on the LARGEST segment of the
    # bench scene, scan-amortized like every other frame metric.  Reference
    # analogue: the View-phase recompute is interactive there
    # (calculations.rs:269-376).
    from treee_tpu import characteristics as ch_mod

    tot = np.asarray(counts).sum(axis=1).astype(np.int64)
    tot[0] = 0
    sid = int(np.argmax(tot))
    seg_n = int(tot[sid])
    use_grid = seg_n > cfg.neighbors.brute_force_max
    k_nn = cfg.characteristics.neighbors
    member = valid & (segment == sid)

    reps_c = 2
    cap_sub = min(octree.snug_capacity(max(seg_n, 1), headroom=1.0), n)

    if use_grid:
        # grid path runs eagerly: knn_grid_reduce's host-side slab/block
        # dispatch cannot execute under jit
        jax.block_until_ready(ch_mod.segment_curvature(pos, member, k=k_nn,
                                      use_grid=True))  # warm-up
        t0 = time.time()
        jax.block_until_ready(ch_mod.segment_curvature(pos, member, k=k_nn, use_grid=True))
        curvature_ms = (time.time() - t0) * 1e3
    else:
        @jax.jit
        def curvature_scan(pos, member, d_stack):
            def body(acc, d_i):
                # Session.curvature's brute path: compact the member rows
                # first (a [tile, N] distance slab against full capacity
                # would not fit), k-NN among members, scatter back — the
                # full interactive cost
                m_i = member & (d_i > 0)  # defeat LICM
                count, idx = octree.compact_indices(m_i, cap_sub)
                sub_valid = jnp.arange(cap_sub, dtype=jnp.int32) < count
                sub = ch_mod.segment_curvature(
                    jnp.take(pos, idx, axis=0), sub_valid, k=k_nn,
                    use_grid=False)
                idx_p = jnp.where(sub_valid, idx, n)
                cv = jnp.zeros(n, sub.dtype).at[idx_p].set(sub, mode="drop")
                return acc + cv[0] + cv[-1], None

            total, _ = jax.lax.scan(body, jnp.float32(0.0), d_stack)
            return total

        d_stack_c = jnp.ones(reps_c, jnp.float32)
        jax.block_until_ready(curvature_scan(pos, member, d_stack_c))  # compile
        t0 = time.time()
        jax.block_until_ready(curvature_scan(pos, member, d_stack_c))
        curvature_ms = (time.time() - t0) / reps_c * 1e3
    RESULT.update(
        curvature_ms=round(curvature_ms, 1),
        curvature_points=seg_n,
        curvature_grid=bool(use_grid),
    )
    print(f"# bench: curvature {curvature_ms:.0f} ms "
          f"({seg_n:,} pts, grid={use_grid})", file=sys.stderr, flush=True)

    # focus frame: the classification-colored splat + eye-dome
    # (Session.render_focus's device core).  The brute-path focused frame
    # renders the cached index-compacted subset (splat cost scales with the
    # PADDED row count); the per-frame cost HERE includes the subset gathers
    # through the cached indices (what Session pays per frame).  Grid-path
    # (huge) segments render the masked full cloud.
    cls_prop = jnp.take(
        jnp.asarray([1 / 8, 3 / 8, 6 / 8], jnp.float32), out[2])

    @jax.jit
    def focus_sweep(pos, prop, member, cam_stack):
        if not use_grid:
            count_f, idx_f = octree.compact_indices(member, cap_sub)
            sub_valid_f = jnp.arange(cap_sub, dtype=jnp.int32) < count_f

        def body(acc, xs):
            cam, d_i = xs
            if use_grid:
                color, z01, _ = splat.render_points(
                    pos, prop, member, cam, palette, cfg.render)
            else:
                # idx_i depends on the scanned d_i so the three subset
                # gathers stay INSIDE the loop (LICM would otherwise hoist
                # them and under-report the per-frame cost Session pays;
                # == idx_f at runtime)
                idx_i = jnp.where(d_i > 0, idx_f, 0)
                color, z01, _ = splat.render_points(
                    jnp.take(pos, idx_i, axis=0),
                    jnp.take(prop, idx_i),
                    sub_valid_f & jnp.take(member, idx_i),
                    cam, palette, cfg.render)
            img = splat.eye_dome(color, z01, cfg.render)
            return acc + jnp.sum(img), None

        total, _ = jax.lax.scan(
            body, jnp.float32(0.0),
            (cam_stack, jnp.ones(n_frames, jnp.int32)))
        return total

    jax.block_until_ready(focus_sweep(pos, cls_prop, member, cam_stack))  # compile
    t0 = time.time()
    jax.block_until_ready(focus_sweep(pos, cls_prop, member, cam_stack))
    focus_ms = (time.time() - t0) / n_frames * 1e3
    RESULT.update(focus_frame_ms=round(focus_ms, 2))
    print(f"# bench: focus frame {focus_ms:.1f} ms", file=sys.stderr,
          flush=True)
    del member, cls_prop

    # --- interactive edit latency (BASELINE config 3: incremental octree/LOD
    # update).  The reference re-uploads the whole edited segment to the GPU
    # per brush stroke (interactive/mod.rs:182-221); here the edit is a pure
    # jitted transition on the SoA arrays and the next frame re-reads
    # segment/valid through the CACHED LOD indices with subset-sized gathers
    # — no full-N compaction, no octree re-sort (positions never move).
    from treee_tpu import interactive as edit_mod
    from treee_tpu.cloud import PointCloud

    cloud = PointCloud(
        pos=pos, segment=segment, classification=out[2], valid=valid
    )

    # one jitted scan over 8 strokes with a single sync, like the frame sweep
    centers = jnp.stack(
        [jnp.asarray([0.0, 5.0, 0.0], jnp.float32) + i for i in range(8)]
    )

    @jax.jit
    def scan_edits(cloud, centers, cam):
        def body(c, center):
            c2 = edit_mod.remove_points(c, center, 2.0, 0)
            seg_c = c2.segment[idx]
            mask_c = c2.valid[idx] & (seg_c != 0) & mask_l
            prop_c = splat.prop_from_segment(seg_c)
            img = splat.render_frame(pos_l, prop_c, mask_c, cam, palette,
                                     cfg.render)
            return c2, jnp.sum(img)

        c2, sums = jax.lax.scan(body, cloud, centers)
        return jnp.sum(sums)

    jax.block_until_ready(scan_edits(cloud, centers, cam0))  # compile
    t0 = time.time()
    jax.block_until_ready(scan_edits(cloud, centers, cam0))
    edit_ms = (time.time() - t0) / 8 * 1e3
    RESULT.update(edit_frame_ms=round(edit_ms, 2))
    print(f"# bench: edit+lod-frame {edit_ms:.1f} ms/stroke", file=sys.stderr,
          flush=True)
    center = centers[0]

    # full-cloud edit + re-render: ~= edit + full frame by construction.
    # Free every big subset the earlier metrics materialized first (they are
    # done being measured); the per-call loop below DONATES the cloud so
    # the edit mutates in place instead of allocating a second copy.
    del idx_big, idx_a_big, idx_s_big, pos_a, prop_a, pos_s, prop_s
    del idx_a, idx_s, mask_a, mask_s, img_f, img_a, img_s
    import gc

    gc.collect()

    @jax.jit
    def scan_edit_full(cloud, centers3, cam):
        def body(c, center):
            c2 = edit_mod.remove_points(c, center, 2.0, 0)
            prop = splat.prop_from_segment(c2.segment)
            mask = c2.valid & (c2.segment != 0)
            img = splat.render_frame(c2.pos, prop, mask, cam, palette,
                                     cfg.render)
            return c2, jnp.sum(img)

        _, sums = jax.lax.scan(body, cloud, centers3)
        return jnp.sum(sums)

    centers3 = centers[:3] + jnp.float32(0.25)
    jax.block_until_ready(scan_edit_full(cloud, centers3, cam0))  # compile
    t0 = time.time()
    jax.block_until_ready(scan_edit_full(cloud, centers3, cam0))
    RESULT.update(edit_full_frame_ms=round((time.time() - t0) / 3 * 1e3, 2))

    # per-call chained loop (dispatch-inclusive).  Donation consumes
    # `cloud` — this must stay the LAST metric.
    @functools.partial(jax.jit, donate_argnums=0)
    def edit_and_full_frame(cloud, center, cam):
        c2 = edit_mod.remove_points(cloud, center, 2.0, 0)
        prop = splat.prop_from_segment(c2.segment)
        mask = c2.valid & (c2.segment != 0)
        img = splat.render_frame(c2.pos, prop, mask, cam, palette,
                                 cfg.render)
        return c2, jnp.sum(img)

    cloud2, _ = jax.block_until_ready(edit_and_full_frame(cloud, center, cam0))
    reps = 3
    t0 = time.time()
    for i in range(reps):
        cloud2, chk = edit_and_full_frame(cloud2, center + jnp.float32(i),
                                          cam0)
    jax.block_until_ready(chk)
    RESULT.update(
        edit_full_frame_dispatch_ms=round((time.time() - t0) / reps * 1e3, 2)
    )
    print(json.dumps(RESULT))


if __name__ == "__main__":
    main()
