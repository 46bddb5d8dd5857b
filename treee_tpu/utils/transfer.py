"""Chunked device→host fetches (the <32 MB rule made a library).

One big `np.asarray(device_array)` on this host faults a fresh mmap'd
buffer at ~10 MB/s once the device client is live (a 59 MB u16 fetch
measured 9.3 s fresh vs 1.7 s chunked); slicing the fetch into
sub-mmap-threshold chunks lets glibc recycle the per-chunk temporaries
through the malloc arena at full speed.  Every product path that pulls
more than a few MB off the device should go through :func:`fetch`.

``fetched_bytes`` counts device→host traffic for tests asserting a path
moves O(selected) bytes, not O(N) (round-5 VERDICT task 3).
"""

from __future__ import annotations

import numpy as np

# running device->host byte counter (tests reset and read it)
fetched_bytes: int = 0

_CHUNK = 1 << 24  # 16 MB


def _is_device(x) -> bool:
    import jax

    return isinstance(x, jax.Array) and not isinstance(x, np.ndarray)


def fetch(arr, chunk_bytes: int = _CHUNK, out: np.ndarray | None = None):
    """Device→host copy of ``arr`` in ≤``chunk_bytes`` row slices.

    Host numpy inputs pass through unchanged (zero copy).  ``out`` reuses a
    preallocated host buffer (shape/dtype must match).
    """
    global fetched_bytes
    if not _is_device(arr):
        return np.asarray(arr) if out is None else np.copyto(out, arr) or out

    shape = tuple(arr.shape)
    dtype = np.dtype(arr.dtype)
    nbytes = int(dtype.itemsize * np.prod(shape, dtype=np.int64))
    fetched_bytes += nbytes
    if not shape or nbytes <= chunk_bytes:
        res = np.asarray(arr)
        if out is not None:
            np.copyto(out, res)
            return out
        return res

    n = shape[0]
    row_bytes = max(1, nbytes // max(n, 1))
    rows = max(1, chunk_bytes // row_bytes)
    if out is None:
        out = np.empty(shape, dtype)
    for a in range(0, n, rows):
        b = min(a + rows, n)
        out[a:b] = np.asarray(arr[a:b])
    return out


def gather_rows(arr, ids) -> np.ndarray:
    """Host copy of ``arr[ids]`` with the gather ON DEVICE: moves
    O(len(ids)) bytes to the host, never the full array."""
    import jax
    import jax.numpy as jnp

    if not _is_device(arr):
        return np.asarray(arr)[np.asarray(ids)]
    return fetch(jnp.take(arr, jnp.asarray(ids, jnp.int32), axis=0))


def mask_ids(mask, count: int | None = None):
    """Device indices of the True rows of a device bool mask (i32[count]).

    ``count`` (host int) avoids re-reducing when the caller already has it.
    Returns (ids_device, count).
    """
    import jax.numpy as jnp

    if count is None:
        count = int(jnp.sum(mask))
    ids = jnp.nonzero(mask, size=count, fill_value=0)[0].astype(jnp.int32)
    return ids, count
