"""Out-of-band fuzz campaign for the native LASzip codec.

The in-suite fuzz (tests/test_laz.py::test_corruption_fuzz_no_uncaught_errors)
runs a deterministic few hundred mutations IN-PROCESS, so a segfault in the
C++ decoder would kill pytest before it could report.  This harness runs much
larger batches inside forked children: a crash (SIGSEGV/SIGABRT/...) kills
only the child, and the parent bisects the batch down to the single crashing
case and prints a repro line.

Mutation strategies (beyond the in-suite flips/fills):
  - truncation at every sampled offset (header, VLR, chunk body, chunk table)
  - random multi-byte garbage splices
  - duplicated / deleted byte ranges (framing desync)
  - length/offset field sweeps near power-of-two boundaries
  - cross-format byte transplants (format-6 bytes under a format-1 header)

Every mutated buffer must either decode (garbage points are fine — arithmetic
coding has no integrity check, matching the reference's laz crate) or raise
the clean taxonomy (CorruptFile/UnsupportedFormat/ValueError/MemoryError).
Anything else — crash, hang, struct.error, IndexError — is a finding.

Usage:
    JAX_PLATFORMS=cpu python tools/fuzz_laz.py \
        [--cases 200000] [--seed 0] [--formats 0,1,...,10]

Exit code 0 = no findings.  Findings are printed as repro lines:
    FINDING fmt=6 seed=12345 kind=trunc detail=... exc=SIGSEGV
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from treee_tpu.io import las  # noqa: E402
from treee_tpu.utils.errors import CorruptFile, UnsupportedFormat  # noqa: E402

CLEAN = (CorruptFile, UnsupportedFormat, ValueError, MemoryError)

# per-case wall clamp: a mutated chunk table must never wedge the decoder
CASE_TIMEOUT_S = 20


LAS_SEED = 99  # pseudo-format key for the uncompressed .las path


def build_seeds(formats) -> dict[int, bytes]:
    """One small valid .laz per format (multi-chunk so the table paths run),
    plus an uncompressed .las seed (native las_decode.cpp path)."""
    out = {}
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 30, (9_000, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        for fmt in formats:
            path = os.path.join(td, f"s{fmt}.laz")
            las.write_laz(path, pos, chunk_size=2_500, point_format=fmt)
            out[fmt] = open(path, "rb").read()
        path = os.path.join(td, "s.las")
        las.write_las(path, pos)
        out[LAS_SEED] = open(path, "rb").read()
    return out


def mutate(data: bytes, rng: np.random.Generator) -> tuple[bytes, str]:
    """One mutated buffer + a short description of what was done."""
    n = len(data)
    buf = bytearray(data)
    kind = rng.integers(0, 7)
    if kind == 0:  # 1-8 random byte flips
        k = int(rng.integers(1, 9))
        offs = rng.integers(0, n, k)
        for off in offs:
            buf[int(off)] ^= int(rng.integers(1, 256))
        return bytes(buf), f"flip{k}@{int(offs[0])}"
    if kind == 1:  # truncate
        cut = int(rng.integers(0, n))
        return bytes(buf[:cut]), f"trunc@{cut}"
    if kind == 2:  # garbage splice (overwrite, keeps length)
        off = int(rng.integers(0, n))
        k = int(rng.integers(1, 65))
        blob = rng.integers(0, 256, min(k, n - off), dtype=np.uint8)
        buf[off:off + len(blob)] = blob.tobytes()
        return bytes(buf), f"splice{k}@{off}"
    if kind == 3:  # duplicate a range (framing desync, grows the file)
        off = int(rng.integers(0, n))
        k = int(rng.integers(1, 257))
        piece = buf[off:off + k]
        at = int(rng.integers(0, n))
        return bytes(buf[:at] + piece + buf[at:]), f"dup{k}@{off}->{at}"
    if kind == 4:  # delete a range
        off = int(rng.integers(0, n))
        k = int(rng.integers(1, 257))
        return bytes(buf[:off] + buf[off + k:]), f"del{k}@{off}"
    if kind == 5:  # 4/8-byte field sweep with boundary values
        off = int(rng.integers(0, max(1, n - 8)))
        width = 8 if rng.integers(0, 2) else 4
        val = int(rng.choice(np.array(
            [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**24, 2**16 - 1,
             2**63 - 1 if width == 8 else 2**32 - 1], dtype=np.uint64)))
        buf[off:off + width] = int(val).to_bytes(width, "little")
        return bytes(buf), f"field{width}={val}@{off}"
    # kind == 6: zero the chunk-table tail region
    off = int(rng.integers(max(0, n - 128), n))
    for i in range(off, n):
        buf[i] = 0
    return bytes(buf), f"zerotail@{off}"


def transplant(a: bytes, b: bytes, rng: np.random.Generator) -> tuple[bytes, str]:
    """Header of a, body bytes of b spliced in past the header block."""
    cut = int(rng.integers(227, min(500, len(a), len(b))))
    return a[:cut] + b[cut:], f"transplant@{cut}"


def run_case(data: bytes) -> None:
    """Raises on any non-CLEAN outcome; the child's loop owns the taxonomy."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        las.load(data)


def run_batch_forked(cases: list[tuple[bytes, str]]) -> tuple[bool, int, str]:
    """Run cases in a forked child.  Returns (ok, idx_of_failure, message).

    The child writes progress (index) into a pipe so the parent can bisect a
    crash to the exact case.
    """
    rfd, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:  # child
        os.close(rfd)
        status = 0
        msg = b"done"
        try:
            for i, (data, _) in enumerate(cases):
                os.write(wfd, i.to_bytes(4, "little"))
                signal.alarm(CASE_TIMEOUT_S)
                try:
                    run_case(data)
                except CLEAN:
                    pass
                except BaseException as exc:  # noqa: BLE001 - report anything
                    status = 3
                    msg = f"exc={type(exc).__name__}: {exc}".encode()[:500]
                    break
                finally:
                    signal.alarm(0)
        finally:
            os.write(wfd, (0xFFFFFFFF).to_bytes(4, "little"))
            os.write(wfd, msg)
            os.close(wfd)
            os._exit(status)
    # parent
    os.close(wfd)
    raw = b""
    while True:
        piece = os.read(rfd, 65536)
        if not piece:
            break
        raw += piece
    os.close(rfd)
    _, wstatus = os.waitpid(pid, 0)
    idx = -1
    tail = b""
    k = 0
    while k + 4 <= len(raw):
        v = int.from_bytes(raw[k:k + 4], "little")
        k += 4
        if v == 0xFFFFFFFF:
            tail = raw[k:]
            break
        idx = v
    if os.WIFSIGNALED(wstatus):
        sig = os.WTERMSIG(wstatus)
        return False, idx, f"signal={signal.Signals(sig).name}"
    rc = os.WEXITSTATUS(wstatus)
    if rc == 3:
        return False, idx, tail.decode(errors="replace")
    if rc != 0:
        return False, idx, f"exit={rc}"
    return True, -1, ""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=500)
    ap.add_argument("--formats", default="0,1,2,3,4,5,6,7,8,9,10")
    args = ap.parse_args()

    formats = [int(s) for s in args.formats.split(",")]
    seeds = build_seeds(formats)
    fmt_list = list(seeds)
    findings = 0
    t0 = time.time()
    done = 0
    batch_no = 0
    while done < args.cases:
        batch_no += 1
        rng = np.random.default_rng((args.seed, batch_no))
        cases = []
        for _ in range(min(args.batch, args.cases - done)):
            fmt = fmt_list[int(rng.integers(0, len(fmt_list)))]
            if len(fmt_list) > 1 and rng.integers(0, 20) == 0:
                other = fmt_list[int(rng.integers(0, len(fmt_list)))]
                data, desc = transplant(seeds[fmt], seeds[other], rng)
                desc = f"{desc}<-fmt{other}"
            else:
                data, desc = mutate(seeds[fmt], rng)
            cases.append((data, f"fmt={fmt} {desc}"))
        ok, idx, msg = run_batch_forked(cases)
        if not ok:
            findings += 1
            desc = cases[idx][1] if 0 <= idx < len(cases) else "?"
            print(f"FINDING batch={batch_no} seed={args.seed} case={idx} "
                  f"{desc} -> {msg}", flush=True)
            # persist the repro buffer
            if 0 <= idx < len(cases):
                rp = f"/tmp/laz_fuzz_repro_{batch_no}_{idx}.laz"
                open(rp, "wb").write(cases[idx][0])
                print(f"  repro written: {rp}", flush=True)
            # resume after the failing case; a child that died before its
            # first progress write (idx < 0) forfeits the whole batch —
            # slicing from idx+1 == 0 would re-run it forever
            rest = cases[idx + 1:] if idx >= 0 else []
            while rest:
                ok2, idx2, msg2 = run_batch_forked(rest)
                if ok2:
                    break
                findings += 1
                d2 = rest[idx2][1] if 0 <= idx2 < len(rest) else "?"
                print(f"FINDING (cont) {d2} -> {msg2}", flush=True)
                rest = rest[idx2 + 1:] if idx2 >= 0 else []
        done += len(cases)
        if batch_no % 10 == 0:
            rate = done / max(1e-9, time.time() - t0)
            print(f"[{done}/{args.cases}] {rate:.0f} cases/s "
                  f"findings={findings}", flush=True)
    print(f"DONE cases={done} findings={findings} "
          f"elapsed={time.time() - t0:.0f}s", flush=True)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
