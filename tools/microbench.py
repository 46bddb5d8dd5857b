"""Micro-benchmarks of the scatter/gather/sort primitives on the GPU.

Measures the per-primitive costs that decide the characteristics/rasterizer
design: colliding vs sorted vs unique scatters, small-table vs big-table
gathers, lexicographic sorts, shifted-doubling segmented scan passes, and
searchsorted.  Each time is the best of three runs bounded by
``block_until_ready``; the first line names the device and the card's power
limit.

Run:  python tools/microbench.py            (needs a GPU)
Env:  MB_POINTS (default 15_000_000)
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"microbench needs a GPU; JAX found {dev.platform!r}")
    from treee_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp

    n = int(os.environ.get("MB_POINTS", 15_000_000))
    s_cap = 2049
    ms = 384
    n_buckets = s_cap * ms
    n_pix = 1280 * 720
    k = 8

    rng = np.random.default_rng(0)
    # ~940 segments of ~150 slices occupied, like the bench forest
    seg_np = rng.integers(1, 941, n).astype(np.int32)
    y_np = rng.random(n).astype(np.float32) * 15.0
    bucket_np = seg_np * ms + (y_np / 15.0 * 150).astype(np.int32)
    pix_np = rng.integers(0, n_pix, n).astype(np.int32)

    seg = jnp.asarray(seg_np)
    bucket = jnp.asarray(bucket_np)
    bucket_sorted = jnp.asarray(np.sort(bucket_np))
    pix = jnp.asarray(pix_np)
    pix_sorted = jnp.asarray(np.sort(pix_np))
    y = jnp.asarray(y_np)
    scores = jnp.asarray(rng.random((n, k)).astype(np.float32))
    val = y

    def bench(name, fn, *args, reps=3):
        f = jax.jit(fn)
        t0 = time.time()
        jax.block_until_ready(f(*args))
        compile_s = time.time() - t0
        ts = []
        for _ in range(reps):
            t0 = time.time()
            jax.block_until_ready(f(*args))
            ts.append(time.time() - t0)
        print(f"{name:55s} {min(ts)*1e3:9.1f} ms   (compile {compile_s:.0f}s)",
              flush=True)
        return min(ts)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"# microbench n={n:,} on {dev.device_kind} ({card})", flush=True)

    # --- scatters ---
    bench("scatter-add N -> [S] colliding",
          lambda t, v: jnp.zeros(s_cap, jnp.int32).at[t].add(1, mode="drop"),
          seg, val)
    bench("scatter-max N -> [S] colliding f32",
          lambda t, v: jnp.full(s_cap, -3e38).at[t].max(v, mode="drop"),
          seg, val)
    bench("scatter-max [N,K] -> [B,K] colliding (current areas)",
          lambda t, sc: jnp.full((n_buckets, k), -3e38).at[t].max(sc, mode="drop"),
          bucket, scores)
    bench("scatter-max [N,K] sorted idx + hint",
          lambda t, sc: jnp.full((n_buckets, k), -3e38).at[t].max(
              sc, mode="drop", indices_are_sorted=True),
          bucket_sorted, scores)
    bench("scatter-min N -> [pix] colliding (raster z)",
          lambda t, v: jnp.full(n_pix, 0x7FFFFFFF, jnp.int32).at[t].min(
              v.astype(jnp.int32), mode="drop"),
          pix, val)
    bench("scatter-min N -> [pix] sorted idx + hint",
          lambda t, v: jnp.full(n_pix, 0x7FFFFFFF, jnp.int32).at[t].min(
              v.astype(jnp.int32), mode="drop", indices_are_sorted=True),
          pix_sorted, val)

    # unique scatter: one update per distinct pixel (mask others to dump slot)
    def unique_scatter(t, v):
        isfirst = jnp.concatenate([jnp.ones(1, bool), t[1:] != t[:-1]])
        tgt = jnp.where(isfirst, t, n_pix)
        return jnp.full(n_pix + 1, 0x7FFFFFFF, jnp.int32).at[tgt].min(
            v.astype(jnp.int32), mode="drop",
            indices_are_sorted=True, unique_indices=False)

    bench("scatter-min N -> [pix] sorted, first-of-run only", unique_scatter,
          pix_sorted, val)

    # --- gathers ---
    small_tab = jnp.asarray(rng.random(s_cap).astype(np.float32))
    big_tab = jnp.asarray(rng.random(n).astype(np.float32))
    bench("gather N lookups from small [2k] table",
          lambda t, tab: tab[t], seg, small_tab)
    bench("gather N lookups from big [N] table",
          lambda idx, tab: tab[idx],
          jnp.asarray(rng.integers(0, n, n).astype(np.int32)), big_tab)
    bench("take_along_axis [N,K] rows from [B,K]",
          lambda t, tab: tab[t],
          bucket, jnp.zeros((n_buckets, k), jnp.float32))

    # --- sorts ---
    bench("sort N f32 single key", lambda x: jnp.sort(x), y)
    bench("sort N i32 key + 1 payload",
          lambda kk, v: jax.lax.sort((kk, v), num_keys=1), bucket, y)
    bench("sort N lexicographic 2 keys + 3 payloads",
          lambda a, b, p1, p2, p3: jax.lax.sort((a, b, p1, p2, p3), num_keys=2),
          seg, y, y, y, y)

    # --- shifted-doubling passes ---
    def seg_cummax_1d(b, v):
        # within-run forward cummax by doubling; runs contiguous in sorted b
        for sh in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
            ok = b == jnp.roll(b, sh)
            cand = jnp.roll(v, sh)
            v = jnp.maximum(v, jnp.where(ok & (jnp.arange(n) >= sh), cand, -3e38))
        return v

    bench("segmented cummax [N] 10 doubling passes", seg_cummax_1d,
          bucket_sorted, val)

    def seg_cummax_2d(b, sc):
        for sh in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
            ok = (b == jnp.roll(b, sh)) & (jnp.arange(n) >= sh)
            cand = jnp.roll(sc, sh, axis=0)
            sc = jnp.maximum(sc, jnp.where(ok[:, None], cand, -3e38))
        return sc

    bench("segmented cummax [N,K] 10 doubling passes", seg_cummax_2d,
          bucket_sorted, scores)

    # --- searchsorted bucket table from sorted array ---
    qs = jnp.arange(n_buckets, dtype=jnp.int32)
    bench("searchsorted 787k queries into N sorted",
          lambda a, q: jnp.searchsorted(a, q, side="right"),
          bucket_sorted, qs)

    # run-end scatter: ~160k live updates but N-row operand, masked to dump
    def runend_scatter(b, sc):
        is_end = jnp.concatenate([b[:-1] != b[1:], jnp.ones(1, bool)])
        tgt = jnp.where(is_end, b, n_buckets)
        return jnp.full((n_buckets + 1, k), -3e38).at[tgt].max(
            sc, mode="drop", indices_are_sorted=True)

    bench("scatter-max [N,K] run-ends-only (masked to dump)", runend_scatter,
          bucket_sorted, scores)


if __name__ == "__main__":
    main()
