"""Multi-host (multi-process) sequence-sharded pipeline.

Spawns 2 REAL processes (jax.distributed over localhost, 4 virtual CPU
devices each = 8 global) — each feeds half the reads and must receive its
half of the byte-identical single-process output: the cross-host case that a
single-process run cannot cover.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bfqzip_tpu import SmoothConfig
from bfqzip_tpu.engine import smooth_fastq
from bfqzip_tpu.io.fastq import ReadBatch, read_fastq

from conftest import golden_path

_WORKER = r"""
import os, sys
import numpy as np
import jax
pid = int(sys.argv[1]); nprocs = int(sys.argv[2]); port = sys.argv[3]; outdir = sys.argv[4]
jax.distributed.initialize(f"localhost:{port}", num_processes=nprocs, process_id=pid)
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.environ["BFQ_REPO"])
sys.path.insert(0, os.path.join(os.environ["BFQ_REPO"], "tests"))
from bfqzip_tpu import SmoothConfig
from bfqzip_tpu.io.fastq import ReadBatch, read_fastq
from bfqzip_tpu.parallel import multihost
from conftest import golden_path

batch = read_fastq(golden_path("example.in.fastq"))
# pad globally to a multiple of the 8 global devices, then take my half
pad = (-batch.num_reads) % jax.device_count()
seqs = np.concatenate([batch.seqs, np.zeros((pad, batch.max_len), np.uint8)])
quals = np.concatenate([batch.quals, np.zeros((pad, batch.max_len), np.uint8)])
lengths = np.concatenate([batch.lengths, np.zeros(pad, np.int32)])
n = seqs.shape[0]
half = n // nprocs
lo, hi = pid * half, (pid + 1) * half
local = ReadBatch(seqs=seqs[lo:hi], quals=quals[lo:hi], lengths=lengths[lo:hi])
out, stats = multihost.smooth_fastq_sharded_multihost(local, SmoothConfig())
np.savez(os.path.join(outdir, f"out_{pid}.npz"),
         seqs=out.seqs, quals=out.quals, lengths=out.lengths,
         **{f"stat_{k}": v for k, v in stats.items()})
print("worker", pid, "done", flush=True)
"""


@pytest.mark.skipif(sys.platform != "linux", reason="multi-process test")
def test_two_process_pipeline_matches_single(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        BFQ_REPO=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]

    batch = read_fastq(golden_path("example.in.fastq"))
    want, want_stats = smooth_fastq(batch, SmoothConfig())
    got = [np.load(tmp_path / f"out_{pid}.npz") for pid in (0, 1)]
    seqs = np.concatenate([g["seqs"] for g in got])[: batch.num_reads]
    quals = np.concatenate([g["quals"] for g in got])[: batch.num_reads]
    lengths = np.concatenate([g["lengths"] for g in got])[: batch.num_reads]
    w = int(want.lengths.max())
    assert np.array_equal(lengths, want.lengths)
    assert np.array_equal(seqs[:, :w], want.seqs[:, :w])
    assert np.array_equal(quals[:, :w], want.quals[:, :w])
    for k, v in want_stats.items():
        assert int(got[0][f"stat_{k}"]) == v, k
