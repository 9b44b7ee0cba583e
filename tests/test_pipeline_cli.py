"""End-to-end pipeline + CLI tests (CPU backend)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bfqzip_tpu.config import PipelineConfig, SmoothConfig
from bfqzip_tpu.ops import rans
from bfqzip_tpu.pipeline import decompress_stream, run_pipeline

from conftest import golden_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def workdir(tmp_path):
    src = golden_path("example.in.fastq")
    dst = tmp_path / "reads.fastq"
    shutil.copyfile(src, dst)
    return tmp_path


def test_pipeline_m3_matches_golden(workdir):
    base = str(workdir / "out")
    res = run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=3), out_base=base)
    # .fq must equal the reference golden with headers
    golden = open(golden_path("example.m2b0h.fq"), "rb").read()
    assert open(base + ".fq", "rb").read() == golden
    assert set(res.streams) == {base + ".fq.dna", base + ".fq.qs", base + ".h"}
    # native rANS outputs round-trip
    for stream in res.streams:
        out = decompress_stream(stream + ".rans", stream + ".rt")
        assert open(out, "rb").read() == open(stream, "rb").read()
    assert res.stats["num_clust"] == 387


def test_pipeline_artifact_cache(workdir):
    base = str(workdir / "out")
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=1), out_base=base)
    bwt_mtime = os.path.getmtime(base + ".bwt")
    # second run must reuse the cached EBWT artifacts
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=1), out_base=base)
    assert os.path.getmtime(base + ".bwt") == bwt_mtime
    # rebuild forces reconstruction
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=1, rebuild=True), out_base=base)
    assert os.path.getmtime(base + ".bwt") >= bwt_mtime


def test_pipeline_cache_invalidated_on_input_change(workdir):
    """A changed input FASTQ must NOT reuse stale stage-1 artifacts (the
    reference shares this flaw, BFQzip.py:93-104; meta.json carries a content
    fingerprint here)."""
    base = str(workdir / "out")
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=1), out_base=base)
    bwt_mtime = os.path.getmtime(base + ".bwt")
    fq1 = open(base + ".fq", "rb").read()
    # swap in a different input under the same basename
    shutil.copyfile(golden_path("synth_var.in.fastq"), workdir / "reads.fastq")
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=1), out_base=base)
    assert os.path.getmtime(base + ".bwt") != bwt_mtime, "stale artifacts reused"
    assert open(base + ".fq", "rb").read() != fq1


def test_pipeline_mesh_mode_matches_single_chip(workdir):
    """--mesh D routes steps 1-3 through the sequence-sharded global pipeline
    (one EBWT over D devices) and must reproduce the single-chip output."""
    base1 = str(workdir / "single")
    base2 = str(workdir / "meshed")
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=2), out_base=base1)
    run_pipeline(
        [str(workdir / "reads.fastq")], PipelineConfig(mode=2), out_base=base2,
        mesh_shards=4,
    )
    assert open(base2 + ".fq", "rb").read() == open(base1 + ".fq", "rb").read()
    assert open(base2 + ".fq.dna.rans", "rb").read() == open(base1 + ".fq.dna.rans", "rb").read()


def test_pipeline_ext_mem_matches_in_core(workdir):
    """--ext-mem routes steps 1-3 through the out-of-core engine and must
    reproduce the in-core output (BFQzip_ext.py vs BFQzip.py parity)."""
    base1 = str(workdir / "incore")
    base2 = str(workdir / "extmem")
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=2), out_base=base1)
    run_pipeline(
        [str(workdir / "reads.fastq")], PipelineConfig(mode=2), out_base=base2,
        ext_mem_mb=64,
    )
    assert open(base2 + ".fq", "rb").read() == open(base1 + ".fq", "rb").read()


def test_pipeline_ppmd_bsc_backends_invoked(workdir, monkeypatch):
    """The 7z-PPMd / bsc passthrough backends (BFQzip.py:253-275) invoke the
    external binaries with the reference's exact CLI shape — exercised here
    with stub executables since the real binaries are not in this image."""
    from bfqzip_tpu import pipeline as pl

    stub7z = workdir / "7z"
    stub7z.write_text("#!/bin/sh\n# args: a -mm=PPMd OUT IN\ncp \"$4\" \"$3\"\n")
    stubbsc = workdir / "bsc"
    stubbsc.write_text("#!/bin/sh\n# args: e IN OUT -T\ncp \"$2\" \"$3\"\n")
    for s in (stub7z, stubbsc):
        s.chmod(0o755)
    monkeypatch.setattr(pl, "ZIP7", str(stub7z))
    monkeypatch.setattr(pl, "BSC", str(stubbsc))

    base = str(workdir / "multi")
    res = run_pipeline(
        [str(workdir / "reads.fastq")],
        PipelineConfig(mode=2, codecs=("rans", "ppmd", "bsc")),
        out_base=base,
    )
    assert set(res.outputs) == {"rans", "ppmd", "bsc"}
    for codec, ext in (("ppmd", ".7z"), ("bsc", ".bsc")):
        assert res.outputs[codec] == [base + ".fq.dna" + ext, base + ".fq.qs" + ext]
        for f in res.outputs[codec]:
            assert os.path.getsize(f) > 0
    assert "ppmd_ratio" in res.report and "bsc_ratio" in res.report


def test_pipeline_artifacts_feed_reference_format(workdir):
    """The .bwt artifact uses the reference's ASCII alphabet."""
    base = str(workdir / "out")
    run_pipeline([str(workdir / "reads.fastq")], PipelineConfig(mode=0), out_base=base)
    bwt = open(base + ".bwt", "rb").read()
    assert set(bwt) <= set(b"ACGTN#")
    meta = json.load(open(base + ".meta.json"))
    assert meta["n"] == len(bwt) == 10200


def test_pipeline_block_mode(workdir):
    """Block-mode output must EQUAL running the engine on each block
    separately and concatenating in order (BFQzip_parallel.py:137-152)."""
    from bfqzip_tpu.engine import smooth_fastq
    from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq

    base = str(workdir / "out_blocks")
    run_pipeline(
        [str(workdir / "reads.fastq")], PipelineConfig(mode=1), out_base=base, blocks=4
    )
    fq = open(base + ".fq", "rb").read()

    batch = read_fastq(str(workdir / "reads.fastq"))
    parts = []
    for b in range(4):
        lo, hi = 25 * b, 25 * (b + 1)
        sub = ReadBatch(seqs=batch.seqs[lo:hi], quals=batch.quals[lo:hi],
                        lengths=batch.lengths[lo:hi])
        out, _ = smooth_fastq(sub)
        parts.append(format_fastq(out))
    assert fq == b"".join(parts)


def test_pipeline_block_mode_paired(workdir):
    """Paired block mode interleaves each block's mate-2 share into the block
    (split_fastq_2 semantics, BFQzip_parallel.py:325-360) and re-splits the
    merged output into _1/_2 at the recorded boundary."""
    from bfqzip_tpu.engine import smooth_fastq
    from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq

    # mate files: halves of the example
    batch = read_fastq(str(workdir / "reads.fastq"))
    half = 50
    for name, lo, hi in (("r1.fastq", 0, half), ("r2.fastq", half, 100)):
        sub = ReadBatch(seqs=batch.seqs[lo:hi], quals=batch.quals[lo:hi],
                        lengths=batch.lengths[lo:hi],
                        headers=batch.headers[lo:hi] if batch.headers else None)
        with open(workdir / name, "wb") as f:
            f.write(format_fastq(sub, headers=sub.headers))

    base = str(workdir / "paired_blocks")
    run_pipeline(
        [str(workdir / "r1.fastq"), str(workdir / "r2.fastq")],
        PipelineConfig(mode=1), out_base=base, blocks=2,
    )
    # expected: block b holds f1[25b:25b+25] + f2[25b:25b+25]
    parts = {1: [], 2: []}
    for b in range(2):
        idx = np.concatenate([np.arange(25 * b, 25 * b + 25),
                              50 + np.arange(25 * b, 25 * b + 25)])
        sub = ReadBatch(seqs=batch.seqs[idx], quals=batch.quals[idx],
                        lengths=batch.lengths[idx])
        out, _ = smooth_fastq(sub)
        parts[1].append(ReadBatch(seqs=out.seqs[:25], quals=out.quals[:25],
                                  lengths=out.lengths[:25]))
        parts[2].append(ReadBatch(seqs=out.seqs[25:], quals=out.quals[25:],
                                  lengths=out.lengths[25:]))

    for m in (1, 2):
        want = b"".join(format_fastq(p) for p in parts[m])
        got = open(f"{base}_{m}.fq", "rb").read()
        assert got == want, f"mate {m} mismatch"


def test_pipeline_block_mode_uneven(workdir):
    base = str(workdir / "out_blocks3")
    run_pipeline(
        [str(workdir / "reads.fastq")], PipelineConfig(mode=0), out_base=base, blocks=3
    )
    fq = open(base + ".fq", "rb").read()
    assert fq.count(b"\n") == 400  # all 100 reads survive uneven blocks


def test_pipeline_original(workdir):
    base = str(workdir / "orig")
    run_pipeline(
        [str(workdir / "reads.fastq")], PipelineConfig(mode=1, original=True), out_base=base
    )
    assert open(base + ".fq", "rb").read() == open(workdir / "reads.fastq", "rb").read()


def test_cli_end_to_end(workdir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    base = str(workdir / "cli_out")
    r = subprocess.run(
        [sys.executable, "-m", "bfqzip_tpu", str(workdir / "reads.fastq"),
         "-o", base, "--m3", "-v", "1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=500,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    golden = open(golden_path("example.m2b0h.fq"), "rb").read()
    assert open(base + ".fq", "rb").read() == golden
    assert os.path.exists(base + ".fq.dna.rans")
    # decompress path
    r2 = subprocess.run(
        [sys.executable, "-m", "bfqzip_tpu", "--decompress", base + ".fq.dna.rans"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r2.returncode == 0, r2.stderr[-2000:]


def test_cli_bad_args():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "bfqzip_tpu", "a.fastq", "b.fastq"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )
    assert r.returncode == 2
    assert "paired" in r.stderr


def test_reorder_modes(workdir):
    from bfqzip_tpu.io.fastq import read_fastq
    from bfqzip_tpu.utils.reorder import reorder_batch

    batch = read_fastq(str(workdir / "reads.fastq"))
    for mode in (1, 2):
        out = reorder_batch(batch, mode=mode)
        assert sorted(map(bytes, out.seqs)) == sorted(map(bytes, batch.seqs))


def test_reorder_paired_keeps_mates_aligned(workdir):
    """--reorder in paired mode must apply ONE permutation to both mate files
    (randomFASTQ.py:52-102): after the paired re-split, record i of _1.fq is
    still the mate of record i of _2.fq.  Tracked via headers."""
    from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq

    batch = read_fastq(str(workdir / "reads.fastq"))
    half = 50
    for name, lo, hi, tag in (("r1.fastq", 0, half, b"a"), ("r2.fastq", half, 100, b"b")):
        sub = ReadBatch(seqs=batch.seqs[lo:hi], quals=batch.quals[lo:hi],
                        lengths=batch.lengths[lo:hi],
                        headers=[b"@" + tag + b"_%d" % i for i in range(hi - lo)])
        with open(workdir / name, "wb") as f:
            f.write(format_fastq(sub, headers=sub.headers))

    for mode in (1, 2):
        base = str(workdir / f"paired_reorder{mode}")
        run_pipeline(
            [str(workdir / "r1.fastq"), str(workdir / "r2.fastq")],
            PipelineConfig(mode=3), out_base=base, reorder=mode,
        )
        h1 = open(base + "_1.fq", "rb").read().split(b"\n")[0::4]
        h2 = open(base + "_2.fq", "rb").read().split(b"\n")[0::4]
        h1 = [h for h in h1 if h]
        h2 = [h for h in h2 if h]
        assert len(h1) == len(h2) == half
        if mode == 1:
            assert h1 != [b"@a_%d" % i for i in range(half)], "reorder was a no-op"
        for a, b in zip(h1, h2):
            assert a.split(b"_")[1] == b.split(b"_")[1], f"mates scrambled: {a} vs {b}"


def test_checkfastq(workdir):
    from bfqzip_tpu.utils.checkfastq import check_fastq

    assert check_fastq(str(workdir / "reads.fastq"))
    bad = workdir / "bad.fastq"
    bad.write_bytes(b"@r\nACGT\n+\nIII\n")
    assert not check_fastq(str(bad))
    assert not check_fastq(str(workdir / "reads.txt"))


def test_restore_fastq_roundtrip(tmp_path):
    """--restore reassembles the smoothed FASTQ from mode-3 stream archives;
    the result must equal the pipeline's own .fq byte-for-byte (a capability
    the reference leaves to manual stream pasting, BFQzip.py:253-275)."""
    from bfqzip_tpu import cli
    from bfqzip_tpu.pipeline import restore_fastq

    src = golden_path("example.in.fastq")
    base = str(tmp_path / "r")
    rc = cli.main([src, "-o", base, "-3", "--headers", "--cpu"])
    assert rc == 0
    out = restore_fastq(base)
    assert open(out, "rb").read() == open(base + ".fq", "rb").read()

    # mode-2 archives (no header stream) restore with bare '@' headers
    base2 = str(tmp_path / "r2")
    rc = cli.main([src, "-o", base2, "-2", "--cpu"])
    assert rc == 0
    out2 = restore_fastq(base2)
    body = open(out2, "rb").read()
    assert body.startswith(b"@\n")
    assert body == open(base2 + ".fq", "rb").read()


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_restore_fastq_paired_roundtrip(tmp_path, mode):
    """Paired archives restore to the _1/_2 FASTQ pair the reference's
    parallel driver emits (BFQzip_parallel.py:153-178): mode-1 decodes the
    per-file archives, merged mode-2/3 archives are split at the recorded
    mate boundary (BASE.paired.meta.json)."""
    from bfqzip_tpu import cli
    from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq
    from bfqzip_tpu.pipeline import restore_fastq

    batch = read_fastq(golden_path("example.in.fastq"))
    half = 50
    mates = []
    for name, lo, hi in (("r1.fastq", 0, half), ("r2.fastq", half, 100)):
        sub = ReadBatch(seqs=batch.seqs[lo:hi], quals=batch.quals[lo:hi],
                        lengths=batch.lengths[lo:hi],
                        headers=batch.headers[lo:hi] if batch.headers else None)
        p = tmp_path / name
        with open(p, "wb") as f:
            f.write(format_fastq(sub, headers=sub.headers))
        mates.append(str(p))

    base = str(tmp_path / f"pr{mode}")
    flags = [f"-{mode}", "--cpu", "--paired"] + (["--headers"] if mode == 3 else [])
    rc = cli.main(mates + ["-o", base] + flags)
    assert rc == 0
    out = restore_fastq(base)
    assert isinstance(out, tuple) and len(out) == 2
    for got_path, want_path in zip(out, (base + "_1.fq", base + "_2.fq")):
        got = open(got_path, "rb").read()
        want = open(want_path, "rb").read()
        if mode in (2, 3):
            # merged mode-2/3 archives drop the original headers unless the
            # header stream exists; compare the reassembled record bodies
            want_lines = want.split(b"\n")
            got_lines = got.split(b"\n")
            assert got_lines[1::4] == want_lines[1::4], "DNA lines differ"
            assert got_lines[3::4] == want_lines[3::4], "QS lines differ"
            if mode == 3:
                assert got_lines[0::4] == want_lines[0::4], "headers differ"
        else:
            assert got == want, f"mate file {want_path} mismatch"
