#!/usr/bin/env python3
"""Smoke test of bfqzip_tpu on NVIDIA GPUs, through the entry points a user calls.

    python chip_smoke.py               # one card: phases a-e below
    python chip_smoke.py --four        # four cards: the multi-device phases only
    python chip_smoke.py --reads 20000 # a quicker run of the one-card phases

One card:
  a  device check: JAX runs on a GPU (a silent CPU fallback fails), and the
     card's name and power limit from nvidia-smi;
  e  native library: built from native/*.cpp; the BQZC coder is present, so
     step 5 is not the pure-Python fallback;
  b  golden parity: engine.smooth_fastq on every tests/golden configuration
     (M=0..3, -B, headers), byte-equal to the reference binary's output;
  d  `--ext-mem --mem 2048` through the CLI on --reads/2 reads, byte-equal to
     the in-core CLI output on the same file;
  c  the CLI `--m3` on --reads (default 2,000,000) realistic 101 bp reads,
     then `--restore`: the restored DNA and quality lines equal the smoothed
     OUT.fq and the headers equal the input's.

Four cards (--four): `--mesh 4` byte-equal to engine.smooth_fastq on device
0, and `-t 4` byte-equal to the sequential per-block path, with each card's
peak memory.

Everything runs in this one process (a second JAX process could not get the
card's memory).  Every phase prints its wall time, compile time and peak
device memory; any failure exits non-zero.  The last line of a passing run
is one JSON object naming the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def require_gpu(devices, count: int = 1):
    """The smoke test only counts on a GPU: JAX falls back to the CPU when its
    CUDA plugin does not load, and that must not pass."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        fail(f"JAX found no GPU (platform {plat})")
    if len(devices) < count:
        fail(f"need {count} GPUs, JAX sees {len(devices)}")


class CompileClock:
    """Sums the trace, lowering and XLA compile durations JAX reports."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event: str, duration: float, **_):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


@contextlib.contextmanager
def phase(name: str, clock: CompileClock, all_devices: bool = False):
    import jax

    from bfqzip_tpu.utils.profiling import device_memory_stats

    print(f"=== phase {name}", flush=True)
    t0, c0 = time.perf_counter(), clock.seconds
    yield
    line = (f"phase {name}: wall {time.perf_counter() - t0:.3f} s, "
            f"compile {clock.seconds - c0:.3f} s")
    mem = device_memory_stats()
    if mem:
        line += (f", peak_bytes_in_use {mem['peak_bytes_in_use']}"
                 f" bytes_limit {mem['bytes_limit']}")
    print(line, flush=True)
    if all_devices:
        for d in jax.devices():
            st = d.memory_stats() or {}
            print(f"  device {d.id}: peak_bytes_in_use {st.get('peak_bytes_in_use')}"
                  f" bytes_limit {st.get('bytes_limit')}", flush=True)


def make_fastq(n_reads: int, seed: int, width: int = 101) -> str:
    """Illumina-like reads with coverage (~34x) from tools/make_realistic.py."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_realistic import make, write_fastq

    path = os.path.join(WORK, f"reads_{n_reads}.fastq")
    t0 = time.perf_counter()
    seq, qs = make(n_reads, width, max(n_reads * width / 34e6, 0.05), seed, 0.005, 0.001)
    write_fastq(path, seq, qs)
    print(f"generated {path}: {n_reads} x {width} bp in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return path


def cli(*argv: str) -> None:
    from bfqzip_tpu import cli as bfq_cli

    print("$ python -m bfqzip_tpu " + " ".join(argv), flush=True)
    rc = bfq_cli.main(list(argv))
    if rc != 0:
        fail(f"CLI exited {rc}: {' '.join(argv)}")


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def first_difference(got: bytes, want: bytes) -> str:
    g, w = got.split(b"\n"), want.split(b"\n")
    for i, (a, b) in enumerate(zip(g, w)):
        if a != b:
            cols = [j for j in range(min(len(a), len(b))) if a[j] != b[j]][:8]
            return (f"line {i + 1}: columns {cols}, got {a[:120]!r}, want {b[:120]!r}")
    return f"line counts differ: {len(g)} vs {len(w)}"


def phase_golden() -> None:
    from bfqzip_tpu.config import SmoothConfig
    from bfqzip_tpu.engine import smooth_fastq
    from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, pad_batch, read_fastq
    from bfqzip_tpu.ops.suffix import MAX_FLAT_WORDS, PACK6

    gdir = os.path.join(REPO, "tests", "golden")
    with open(os.path.join(gdir, "manifest.json")) as f:
        manifest = json.load(f)
    inputs = {ent["dataset"]: read_fastq(os.path.join(gdir, f"{ent['dataset']}.in.fastq"))
              for ent in manifest.values()}
    # pad the datasets of the flat suffix sort to one shape with rows that add
    # nothing to the EBWT, so each smoothing configuration compiles twice
    # (flat, doubling), not once per dataset
    flat_max = PACK6 * MAX_FLAT_WORDS - 1
    flat = [b for b in inputs.values() if b.max_len <= flat_max]
    shape = (max(b.num_reads for b in flat), max(b.max_len for b in flat))
    bad = []
    for key in sorted(manifest):
        ent = manifest[key]
        batch = inputs[ent["dataset"]]
        run = pad_batch(batch, shape) if batch.max_len <= flat_max else batch
        cfg = SmoothConfig(mode=ent["mode"], binning=bool(ent["binning"]))
        out, _ = smooth_fastq(run, cfg)
        n = batch.num_reads
        out = ReadBatch(seqs=out.seqs[:n], quals=out.quals[:n], lengths=out.lengths[:n],
                        headers=batch.headers)
        got = format_fastq(out) if ent["headers"] else format_fastq(out, headers=None)
        want = read(os.path.join(gdir, key + ".fq"))
        if got != want:
            bad.append(f"{key}: {first_difference(got, want)}")
    print(f"golden configurations: {len(manifest)}, mismatched: {len(bad)}", flush=True)
    if bad:
        fail("golden parity: " + "; ".join(bad))


def phase_ext_mem(n_reads: int, seed: int) -> None:
    fq = make_fastq(n_reads, seed)
    ext, core = os.path.join(WORK, "ext"), os.path.join(WORK, "core")
    cli(fq, "-o", ext, "-0", "--ext-mem", "--mem", "2048")
    cli(fq, "-o", core, "-0")
    got, want = read(ext + ".fq"), read(core + ".fq")
    if got != want:
        fail(f"--ext-mem output differs from in-core: {first_difference(got, want)}")
    print(f"--ext-mem OUT.fq == in-core OUT.fq ({len(got)} bytes)", flush=True)


def phase_cli_m3(n_reads: int, seed: int) -> None:
    fq = make_fastq(n_reads, seed)
    base = os.path.join(WORK, "m3")
    cli(fq, "-o", base, "--m3", "-v", "1")
    archive = [base + s for s in (".fq.dna.rans", ".fq.qs.rans", ".h.rans")]
    missing = [p for p in archive if not os.path.exists(p)]
    if missing:
        fail(f"archive streams missing: {missing}")
    restored = base + ".restored.fastq"
    cli(base, "--restore", "-o", restored)
    smoothed = read(base + ".fq").split(b"\n")
    back = read(restored).split(b"\n")
    orig = read(fq).split(b"\n")
    if len(back) != len(smoothed) or len(back) != len(orig):
        fail(f"line counts: restored {len(back)}, smoothed {len(smoothed)}, input {len(orig)}")
    if back[1::4] != smoothed[1::4]:
        fail("restored DNA lines differ from the smoothed OUT.fq")
    if back[3::4] != smoothed[3::4]:
        fail("restored quality lines differ from the smoothed OUT.fq")
    if back[0::4] != orig[0::4]:
        fail("restored headers differ from the input's")
    if smoothed[1::4] == orig[1::4] and smoothed[3::4] == orig[3::4]:
        fail("smoothing changed nothing")
    size = sum(os.path.getsize(p) for p in archive)
    print(f"restore round trip ok: {len(back) // 4} records; archive {size} bytes, "
          f"ratio {size / os.path.getsize(fq):.4f}", flush=True)


def phase_mesh(fq: str) -> None:
    from bfqzip_tpu.config import SmoothConfig
    from bfqzip_tpu.engine import smooth_fastq
    from bfqzip_tpu.io.fastq import format_fastq, read_fastq

    base = os.path.join(WORK, "mesh4")
    cli(fq, "-o", base, "-0", "--mesh", "4")
    ref, _ = smooth_fastq(read_fastq(fq), SmoothConfig())  # device 0
    got, want = read(base + ".fq"), format_fastq(ref, headers=None)
    if got != want:
        fail(f"--mesh 4 differs from the single-device engine: {first_difference(got, want)}")
    print(f"--mesh 4 OUT.fq == single-device engine ({len(got)} bytes)", flush=True)


def phase_blocks(fq: str) -> None:
    from bfqzip_tpu import pipeline
    from bfqzip_tpu.config import SmoothConfig
    from bfqzip_tpu.io.fastq import format_fastq, read_fastq
    from bfqzip_tpu.utils.logging import StepLogger

    base = os.path.join(WORK, "t4")
    cli(fq, "-o", base, "-0", "-t", "4")
    batch = read_fastq(fq)
    _, bounds = pipeline._block_permutation(batch.num_reads, 4, None)
    log = StepLogger(os.path.join(WORK, "t4_sequential.log"))
    ref = pipeline._blocks_sequential(batch, bounds, SmoothConfig(), log)
    log.close()
    got, want = read(base + ".fq"), format_fastq(ref, headers=None)
    if got != want:
        fail(f"-t 4 differs from the sequential block path: {first_difference(got, want)}")
    print(f"-t 4 OUT.fq == sequential per-block path ({len(got)} bytes)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="run the four-card phases only")
    ap.add_argument("--reads", type=int, default=2_000_000,
                    help="reads of the CLI run (default 2,000,000); --ext-mem takes half")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "bfqzip_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    os.environ.setdefault("JAX_ENABLE_X64", "1")  # M=1 parity, as the CLI sets it

    import jax

    sys.path.insert(0, REPO)
    from bfqzip_tpu.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    count = 4 if args.four else 1

    with phase("a: device", clock):
        require_gpu(jax.devices(), count)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
        for line in smi:
            print(f"card: {line}", flush=True)
        devs = jax.devices()[:count]
        print(f"jax: platform {devs[0].platform}, kind {devs[0].device_kind}, "
              f"count {len(devs)}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    if args.four:
        fq = make_fastq(args.reads, args.seed)
        with phase("four: --mesh 4", clock, all_devices=True):
            phase_mesh(fq)
        with phase("four: -t 4", clock, all_devices=True):
            phase_blocks(fq)
    else:
        with phase("e: native library", clock):
            subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True)
            from bfqzip_tpu.utils import native

            if not (native.available() and native.cm_available()):
                fail("native library or its BQZC coder did not load")
        with phase("b: golden parity", clock):
            phase_golden()
        with phase(f"d: --ext-mem on {args.reads // 2} reads", clock):
            phase_ext_mem(args.reads // 2, args.seed + 1)
        with phase(f"c: CLI --m3 on {args.reads} reads + --restore", clock):
            phase_cli_m3(args.reads, args.seed)
    shutil.rmtree(WORK, ignore_errors=True)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
