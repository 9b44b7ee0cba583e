"""Auxiliary subsystem tests: paired mode, profiling, logging."""

import os
import shutil

import numpy as np
import pytest

from bfqzip_tpu.config import PipelineConfig
from bfqzip_tpu.pipeline import run_pipeline
from bfqzip_tpu.utils.profiling import PhaseProfiler, device_memory_stats

from conftest import golden_path


def test_paired_pipeline(tmp_path):
    shutil.copyfile(golden_path("example.in.fastq"), tmp_path / "r_1.fastq")
    shutil.copyfile(golden_path("example_r1.in.fastq"), tmp_path / "r_2.fastq")
    base = str(tmp_path / "out")
    res = run_pipeline(
        [str(tmp_path / "r_1.fastq"), str(tmp_path / "r_2.fastq")],
        PipelineConfig(mode=1),
        out_base=base,
    )
    assert os.path.exists(base + "_1.fq") and os.path.exists(base + "_2.fq")
    fq1 = open(base + "_1.fq", "rb").read()
    fq2 = open(base + "_2.fq", "rb").read()
    assert fq1.count(b"\n") == 400 and fq2.count(b"\n") == 400
    assert set(res.streams) == {base + "_1.fq", base + "_2.fq"}


def test_phase_profiler():
    prof = PhaseProfiler()
    with prof.phase("warmup"):
        import jax.numpy as jnp

        jnp.arange(10).sum()
    assert prof.records[0]["phase"] == "warmup"
    assert prof.records[0]["seconds"] >= 0
    assert "warmup" in prof.report()
    # CPU backend has no memory stats; the call must still be safe
    device_memory_stats()


def test_pipeline_phase_telemetry(tmp_path):
    """Every pipeline step records wall + host-RSS delta (+ device memory on
    accelerators) into the .log and PipelineResult.report — the reference's
    per-phase malloc_count_peak_curr prints (bfq_int.cpp:976-1001)."""
    shutil.copyfile(golden_path("example.in.fastq"), tmp_path / "r.fastq")
    base = str(tmp_path / "t")
    res = run_pipeline([str(tmp_path / "r.fastq")], PipelineConfig(mode=2), out_base=base)
    phases = res.report["phases"]
    names = [p["phase"] for p in phases]
    assert any("step1" in n for n in names)
    assert any("step3" in n for n in names)
    assert any("step5" in n for n in names)
    for p in phases:
        assert p["seconds"] >= 0
        assert "host_rss_delta_mb" in p and "host_rss_peak_mb" in p
    log = open(base + ".log").read()
    assert "host_rss_delta=" in log


def test_debug_dump(tmp_path):
    shutil.copyfile(golden_path("example.in.fastq"), tmp_path / "r.fastq")
    base = str(tmp_path / "dbg")
    run_pipeline([str(tmp_path / "r.fastq")], PipelineConfig(mode=0), out_base=base,
                 debug_dump=True)
    tsv = open(base + ".debug.tsv").read().splitlines()
    assert tsv[0].startswith("pos\t")
    assert len(tsv) == 10201
    log = open(base + ".log").read()
    assert "QS distribution before" in log
    assert "cluster-size histogram" in log


def test_gzip_input(tmp_path):
    import gzip

    from bfqzip_tpu.io.fastq import read_fastq

    raw = open(golden_path("example.in.fastq"), "rb").read()
    gz = tmp_path / "r.fastq.gz"
    gz.write_bytes(gzip.compress(raw))
    batch = read_fastq(str(gz))
    assert batch.num_reads == 100


def test_step_logger_names_the_device(tmp_path):
    from bfqzip_tpu.utils.logging import StepLogger

    log = StepLogger(str(tmp_path / "run.log"))
    log.devices()
    log.close()
    text = (tmp_path / "run.log").read_text()
    assert "device: platform=cpu kind=cpu count=" in text
