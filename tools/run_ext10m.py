#!/usr/bin/env python3
"""Drive the out-of-core pipeline at scale on the device (BASELINE.md).

Measures the config the reference serves with eGap's --mem budget
(BFQzip_ext.py:172-177): N reads through chunked device sorts + native k-way
merge + streaming smoothing, with bounded device memory AND (spill mode,
default) bounded host memory — every O(n) host array is an np.memmap with
finished ranges evicted (io/spill.py).  Prints one JSON line with wall time,
throughput, per-stage attribution, peak host RSS and output checks.
"""

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fastq")
    ap.add_argument("--mem-gb", type=float, default=4.0)
    ap.add_argument("--out", default=None, help="optional smoothed FASTQ path")
    ap.add_argument("--no-spill", action="store_true",
                    help="force the in-RAM host path (the pre-r5 behavior)")
    args = ap.parse_args()

    import logging

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import numpy as np

    from bfqzip_tpu.external import smooth_fastq_external
    from bfqzip_tpu.io.fastq import read_fastq
    from bfqzip_tpu.io.spill import Spill, read_fastq_spill
    from bfqzip_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    spill = not args.no_spill
    t0 = time.time()
    if spill:
        sp = Spill()
        batch = read_fastq_spill(args.fastq, sp, with_headers=False)
    else:
        sp = False
        batch = read_fastq(args.fastq, with_headers=False)
    t_parse = time.time() - t0
    rss_parse = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    assert batch.num_reads > 0, "parser returned no reads"
    total_bases = int(batch.lengths.sum())

    rep = {}
    t1 = time.time()
    out, stats = smooth_fastq_external(
        batch, mem_bytes=int(args.mem_gb * (1 << 30)),
        spill=sp if spill else False, out_path=args.out, report=rep,
    )
    t_pipe = time.time() - t1

    # sanity: same shapes/lengths, bases changed only where the smoother says
    assert out.seqs.shape[0] == batch.seqs.shape[0]
    assert np.array_equal(out.lengths, batch.lengths)
    w = batch.seqs.shape[1]
    changed = 0
    slab = 1 << 20
    for lo in range(0, batch.num_reads, slab):
        hi = min(lo + slab, batch.num_reads)
        changed += int((np.asarray(out.seqs[lo:hi])[:, :w]
                        != np.asarray(batch.seqs[lo:hi])).sum())

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(
        json.dumps(
            {
                "metric": "extmem_bases_per_sec",
                "value": round(total_bases / t_pipe, 1),
                "unit": "bases/s",
                "spill": spill,
                "reads": int(batch.num_reads),
                "total_bases": total_bases,
                "parse_s": round(t_parse, 1),
                "parse_peak_rss_gb": round(rss_parse, 2),
                "pipeline_s": round(t_pipe, 1),
                "stage_attribution": rep,
                "peak_host_rss_gb": round(peak_rss_gb, 2),
                "bases_changed": changed,
                "stats": {k: int(v) for k, v in stats.items()},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
