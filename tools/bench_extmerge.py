#!/usr/bin/env python3
"""Benchmark the native k-way suffix merge at >=100M positions (BASELINE.md).

Round-3 verdict ask #2: the host merge must not dominate the 10M-read
external-memory run.  This measures the round-4 merge (word-wise comparators
+ splitter-partitioned threads, native/extmerge.cpp) against the round-3
implementation (byte-wise, single-threaded), compiled from git history into
/tmp for an honest baseline, on identical chunk orders from the real device.

Usage: python tools/bench_extmerge.py FASTQ [--chunks 16] [--threads 0]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

R3_REV = "0f08f73"  # last round-3 commit (byte-wise single-thread merge)


def build_r3_lib(repo: str) -> str:
    src = subprocess.run(
        ["git", "-C", repo, "show", f"{R3_REV}:native/extmerge.cpp"],
        check=True, capture_output=True,
    ).stdout
    cpp = "/tmp/extmerge_r3.cpp"
    so = "/tmp/libextmerge_r3.so"
    with open(cpp, "wb") as f:
        f.write(src)
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
         "-o", so, cpp],
        check=True,
    )
    return so


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fastq")
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--skip-r3", action="store_true")
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from bfqzip_tpu.io.fastq import read_fastq
    from bfqzip_tpu.ops.suffix import build_ebwt
    from bfqzip_tpu.utils import native
    from bfqzip_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    batch = read_fastq(args.fastq, with_headers=False)
    N, W = batch.seqs.shape
    wp = W + 1
    k = np.arange(wp)[None, :]
    text = np.where(
        k < batch.lengths[:, None],
        np.pad(batch.seqs, ((0, 0), (0, 1))).astype(np.uint8) + 1,
        0,
    ).reshape(-1)
    qtext = np.pad(batch.quals, ((0, 0), (0, 1))).reshape(-1)

    bounds = np.linspace(0, N, args.chunks + 1).astype(int)
    sa_chunks, lcp_chunks = [], []
    t0 = time.time()
    for c in range(args.chunks):
        lo, hi = bounds[c], bounds[c + 1]
        dev = build_ebwt(
            jnp.asarray(batch.seqs[lo:hi]),
            jnp.asarray(batch.quals[lo:hi]),
            jnp.asarray(batch.lengths[lo:hi]),
        )
        sa_chunks.append(
            (np.asarray(dev.sa)[: int(dev.n)].astype(np.int64) + lo * wp).astype(np.int32)
        )
        lcp_chunks.append(
            np.asarray(jnp.minimum(dev.lcp, 255).astype(jnp.uint8))[: int(dev.n)]
        )
        del dev
        print(f"chunk {c + 1}/{args.chunks} sorted ({time.time() - t0:.1f}s)",
              file=sys.stderr)
    total = sum(len(s) for s in sa_chunks)

    results = {}
    # round-4 LCP loser tree, threaded (the production configuration)
    t = time.time()
    r4 = native.ext_merge(text, qtext, sa_chunks, threads=args.threads,
                          lcp_chunks=lcp_chunks)
    results["r4_lcptree_threaded_s"] = round(time.time() - t, 2)
    # LCP tree, single thread
    t = time.time()
    r4l1 = native.ext_merge(text, qtext, sa_chunks, threads=1,
                            lcp_chunks=lcp_chunks)
    results["r4_lcptree_1thread_s"] = round(time.time() - t, 2)
    # word-compare merge without chunk LCPs (threaded / single)
    t = time.time()
    r4w = native.ext_merge(text, qtext, sa_chunks, threads=args.threads)
    results["r4_wordcmp_threaded_s"] = round(time.time() - t, 2)
    t = time.time()
    r4s = native.ext_merge(text, qtext, sa_chunks, threads=1)
    results["r4_wordcmp_1thread_s"] = round(time.time() - t, 2)
    for other in (r4l1, r4w, r4s):
        for a, b in zip(r4, other):
            assert np.array_equal(a, b), "merge variants disagree"

    if not args.skip_r3:
        so = build_r3_lib(repo)
        lib = ctypes.CDLL(so)
        i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
        lib.ext_merge.restype = i64
        lib.ext_merge.argtypes = [vp, vp, i64, vp, vp, i32, vp, vp, vp, vp, vp]
        sa_all = np.ascontiguousarray(np.concatenate(sa_chunks), np.int32)
        offs = np.zeros(len(sa_chunks) + 1, np.int64)
        np.cumsum([len(c) for c in sa_chunks], out=offs[1:])

        def p(a):
            return a.ctypes.data_as(vp)

        outs = [np.empty(total, np.uint8) for _ in range(4)] + [np.empty(total, np.int32)]
        t = time.time()
        rc = lib.ext_merge(p(text), p(qtext), i64(text.size), p(sa_all), p(offs),
                           i32(len(sa_chunks)), *[p(o) for o in outs])
        results["r3_baseline_s"] = round(time.time() - t, 2)
        assert rc == total, f"r3 merge rc={rc}"
        for a, b in zip(r4, outs):
            assert np.array_equal(a, b), "round-4 merge differs from round-3"
        results["speedup_vs_r3"] = round(
            results["r3_baseline_s"] / results["r4_lcptree_threaded_s"], 2
        )

    print(json.dumps({
        "metric": "extmerge_positions_per_sec",
        "value": round(total / results["r4_lcptree_threaded_s"], 1),
        "unit": "positions/s",
        "positions": total,
        "chunks": args.chunks,
        **results,
    }))


if __name__ == "__main__":
    main()
