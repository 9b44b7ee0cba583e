"""End-to-end pipeline orchestration with durable, resumable stage artifacts.

The reference drives five subprocess stages through files on disk
(BFQzip.py:91-145) and caches the expensive EBWT build (BFQzip.py:93-104).
This module keeps that resumability contract — every stage boundary is a
durable artifact, `rebuild` forces stage 1 — but the stages are library calls
into the jitted device engine instead of process boundaries:

  step 1  EBWT + QS permutation (+ LCP)  -> OUT.bwt, OUT.bwt.qs, OUT.lcp, OUT.meta.json
  step 2  headers                        -> OUT.h            (BFQzip.py:192-203)
  step 3  smooth + invert                -> OUT.fq           (BFQzip.py:206-228)
  step 4  stream split (modes 2/3)       -> OUT.fq.dna, OUT.fq.qs  (BFQzip.py:231-251)
  step 5  entropy coding                 -> <stream>.rans (native rANS) and,
          when the external binaries exist, <stream>.7z / <stream>.bsc
          (BFQzip.py:253-275)

Artifact formats are reference-compatible where they overlap: .bwt is ASCII
{A,C,G,T,N,#}, .bwt.qs the permuted quality bytes — both consumable by the
reference's own bfq_int.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np

from bfqzip_tpu import alphabet
from bfqzip_tpu.config import PipelineConfig
from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq
from bfqzip_tpu.ops import rans
from bfqzip_tpu.utils.logging import StepLogger

ZIP7 = shutil.which("7z")
BSC = shutil.which("bsc")


@dataclasses.dataclass
class PipelineResult:
    streams: List[str]
    outputs: Dict[str, List[str]]  # codec -> files
    stats: Dict[str, int]
    report: Dict[str, object]  # sizes/ratios + per-phase wall/memory records


def _meta_path(base):
    return base + ".meta.json"


def _fingerprint(batch: ReadBatch) -> str:
    """Identity of the stage-1 input: the exact read content.

    The reference's cache keys on file *names* only (BFQzip.py:93-104), which
    silently reuses stale artifacts when the input changes; here the cache is
    only valid when the content hash recorded in meta.json matches.
    """
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(batch.seqs).tobytes())
    h.update(np.ascontiguousarray(batch.quals).tobytes())
    h.update(np.ascontiguousarray(batch.lengths).tobytes())
    return h.hexdigest()


def _artifacts_exist(base: str, fingerprint: Optional[str] = None) -> bool:
    if not all(
        os.path.exists(base + ext) for ext in (".bwt", ".bwt.qs", ".lcp", ".meta.json")
    ):
        return False
    if fingerprint is None:
        return True
    try:
        with open(_meta_path(base)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    return meta.get("fingerprint") == fingerprint


def step1_build(batch: ReadBatch, base: str, log: StepLogger) -> None:
    """EBWT + QS + LCP artifacts (replaces gsufsort/eGap, BFQzip.py:178-189)."""
    import jax.numpy as jnp

    from bfqzip_tpu.ops.suffix import build_ebwt

    with log.step("step1: EBWT+QS+LCP construction"):
        from bfqzip_tpu.io.fastq import pad_batch

        run = pad_batch(batch)  # compile-shape bucket; dummy rows are EBWT-inert
        dev = build_ebwt(
            jnp.asarray(run.seqs), jnp.asarray(run.quals), jnp.asarray(run.lengths)
        )
        n = int(dev.n)
        bwt = np.asarray(dev.bwt)[:n]
        qs = np.asarray(dev.qs)[:n]
        lcp = np.asarray(dev.lcp)[:n]
    with open(base + ".bwt", "wb") as f:
        f.write(alphabet.decode(bwt).tobytes())
    with open(base + ".bwt.qs", "wb") as f:
        f.write(qs.tobytes())
    with open(base + ".lcp", "wb") as f:
        f.write(lcp.astype("<u2").tobytes())
    with open(_meta_path(base), "w") as f:
        json.dump(
            {
                "n": n,
                "n_reads": batch.num_reads,
                "max_len": batch.max_len,
                "fingerprint": _fingerprint(batch),
            },
            f,
        )


def step3_smooth(base: str, cfg: PipelineConfig, log: StepLogger, debug_dump: bool = False):
    """Cluster smoothing + inversion from the stage-1 artifacts."""
    import jax.numpy as jnp

    from bfqzip_tpu.engine import smooth_arrays_step

    with open(_meta_path(base)) as f:
        meta = json.load(f)
    n, n_reads, width = meta["n"], meta["n_reads"], meta["max_len"]
    bwt = alphabet.encode(np.fromfile(base + ".bwt", np.uint8))
    qs = np.fromfile(base + ".bwt.qs", np.uint8)
    lcp = np.fromfile(base + ".lcp", "<u2").astype(np.int32)

    n_pad = ((n + 1023) // 1024) * 1024
    pad = n_pad - n
    bwt_p = np.pad(bwt, (0, pad), constant_values=alphabet.SIGMA)
    qs_p = np.pad(qs, (0, pad))
    lcp_p = np.pad(lcp, (0, pad))

    with log.step("step3: cluster smoothing + inversion"):
        inv, bwt_sub, qs_new, stats = smooth_arrays_step(
            jnp.asarray(bwt_p), jnp.asarray(qs_p), jnp.asarray(lcp_p),
            np.int32(n), n_reads, width, cfg.smooth,
        )
        out = ReadBatch(
            seqs=np.asarray(inv.seqs),
            quals=np.asarray(inv.quals),
            lengths=np.asarray(inv.lengths).astype(np.int32),
        )

    if debug_dump:
        # reference -D/-V inspection outputs (bfq_int.cpp:829-862,1022-1053)
        from bfqzip_tpu.utils import debug as dbg

        bwt_sub_h = np.asarray(bwt_sub)[:n]
        qs_new_h = np.asarray(qs_new)[:n]
        with open(base + ".debug.tsv", "w") as f:
            dbg.position_dump(bwt[:n], bwt_sub_h, qs[:n], qs_new_h, lcp[:n], cfg.smooth, f)
        nonterm = bwt[:n] != 0
        log.info("QS distribution before: " + str(dbg.qs_distribution(qs[:n], nonterm)))
        log.info("QS distribution after:  " + str(dbg.qs_distribution(qs_new_h, nonterm)))
        hist = dbg.cluster_size_histogram(lcp[:n], cfg.smooth)
        log.info("cluster-size histogram:\n" + dbg.format_histogram(hist))

    return out, {k: int(v) for k, v in stats.items()}


def _rans_one(path: str) -> str:
    data = open(path, "rb").read()
    if path.endswith(".h"):
        # tokenising header model (models/headers.py)
        from bfqzip_tpu.models.headers import encode_headers

        blob = encode_headers(data.split(b"\n")[:-1])
    else:
        # BQZC's match models capture the inter-read repeat
        # structure directly in the raw stream, so the
        # EBWT-domain BQZE transform (models/dna_ebwt.py) is no
        # longer tried here — it measured larger AND costs a
        # second suffix sort (BASELINE.md, compression table).
        # Quality streams get the positional context model: in-read
        # position (reset at each newline) strongly conditions q
        pos_reset = ord("\n") if path.endswith(".qs") else -1
        blob = rans.encode_blob_best(data, pos_reset=pos_reset)
    out = path + ".rans"
    with open(out, "wb") as f:
        f.write(blob)
    return out


def step5_compress(streams: List[str], codecs, log: StepLogger) -> Dict[str, List[str]]:
    """Entropy-code every stream with each backend (BFQzip.py:253-275).

    The in-tree coder runs the streams CONCURRENTLY (the native encode
    releases the GIL), mirroring the reference's threaded compressor fan-out
    (BFQzip_parallel.py:204-233).  BFQ_CM_PROFILE=fast|max selects the BQZC
    speed/ratio point (the bsc-vs-PPMd axis): max (default) keeps every
    model with per-block benefit gating, fast trades ~23% DNA size for
    ~3.5x faster encode — both stay under the xz -9 yardstick
    (BASELINE.md)."""
    from concurrent.futures import ThreadPoolExecutor

    outputs: Dict[str, List[str]] = {}
    for codec in codecs:
        outs = []
        if codec == "rans" and streams:
            with log.step("step5: rans " + " ".join(os.path.basename(p) for p in streams)):
                with ThreadPoolExecutor(max_workers=min(len(streams), 8)) as tp:
                    outs.extend(tp.map(_rans_one, streams))
            outputs[codec] = outs
            continue
        for path in streams:
            if codec == "ppmd" and ZIP7:
                out = path + ".7z"
                if os.path.exists(out):
                    os.remove(out)
                with log.step(f"step5: 7z PPMd {os.path.basename(path)}"):
                    log.run([ZIP7, "a", "-mm=PPMd", out, path])
            elif codec == "bsc" and BSC:
                out = path + ".bsc"
                with log.step(f"step5: bsc {os.path.basename(path)}"):
                    log.run([BSC, "e", path, out, "-T"])
            else:
                continue  # backend unavailable
            outs.append(out)
        if outs:
            outputs[codec] = outs
    return outputs


def _pair_paths(out_path: str):
    """BASE.fastq -> (BASE_1.fastq, BASE_2.fastq), extension preserved."""
    root, ext = os.path.splitext(out_path)
    return root + "_1" + ext, root + "_2" + ext


def _split_pair(data: bytes, n1: int):
    """Split a merged FASTQ body (file-1 records then file-2 records) at the
    recorded mate boundary — the inverse of the paired merge
    (BFQzip_parallel.py:153-178 re-splits block outputs the same way)."""
    cut = 0
    for _ in range(4 * n1):
        nl = data.find(b"\n", cut)
        if nl < 0:
            raise ValueError(f"merged archive has fewer than {n1} file-1 records")
        cut = nl + 1
    return data[:cut], data[cut:]


def restore_fastq(base: str, out_path: Optional[str] = None):
    """Reassemble a FASTQ from compressed stream containers.

    The reference stops at per-stream archives and leaves reassembly to the
    user (BFQzip.py:253-275 writes OUT.fq/.fq.dna/.fq.qs/.h archives only);
    this puts the 4-line records back together: mode-1 archives (BASE.fq.rans)
    decode directly, mode-2/3 archives interleave BASE.fq.dna.rans +
    BASE.fq.qs.rans with BASE.h.rans headers when present ('@' otherwise).

    Paired archives (BASE.paired.meta.json present) restore to a _1/_2 FASTQ
    pair — the shape the reference's parallel driver emits
    (BFQzip_parallel.py:153-178): mode-1 pairs decode the per-file
    BASE_1.fq.rans/BASE_2.fq.rans archives, merged mode-2/3 archives are
    split at the recorded mate boundary.  Returns the single output path, or
    the (path_1, path_2) tuple for paired archives.
    """
    out_path = out_path or base + ".restored.fastq"
    paired_n1 = None
    meta_p = _meta_path(base + ".paired")
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            paired_n1 = int(json.load(f)["reads_file1"])

    # paired mode 1: one archive per mate file
    if paired_n1 is not None and os.path.exists(base + "_1.fq.rans"):
        p1, p2 = _pair_paths(out_path)
        for path, arc in ((p1, base + "_1.fq.rans"), (p2, base + "_2.fq.rans")):
            if not os.path.exists(arc):
                raise FileNotFoundError(f"paired archive missing: {arc}")
            with open(path, "wb") as f:
                f.write(_decode_blob_file(arc))
        return p1, p2

    one = base + ".fq.rans"
    if os.path.exists(one):
        data = _decode_blob_file(one)
        if paired_n1 is not None:  # merged archive of a paired run
            half1, half2 = _split_pair(data, paired_n1)
            p1, p2 = _pair_paths(out_path)
            with open(p1, "wb") as f:
                f.write(half1)
            with open(p2, "wb") as f:
                f.write(half2)
            return p1, p2
        with open(out_path, "wb") as f:
            f.write(data)
        return out_path
    dna_p, qs_p, h_p = base + ".fq.dna.rans", base + ".fq.qs.rans", base + ".h.rans"
    if not (os.path.exists(dna_p) and os.path.exists(qs_p)):
        raise FileNotFoundError(f"no stream archives found at {base}(.fq|.fq.dna|.fq.qs).rans")
    dna = _decode_blob_file(dna_p).split(b"\n")
    qs = _decode_blob_file(qs_p).split(b"\n")
    if dna and dna[-1] == b"":
        dna.pop()
    if qs and qs[-1] == b"":
        qs.pop()
    if len(dna) != len(qs):
        raise ValueError(f"stream record mismatch: {len(dna)} DNA vs {len(qs)} QS lines")
    if os.path.exists(h_p):
        headers = _decode_blob_file(h_p).split(b"\n")
        if headers and headers[-1] == b"":
            headers.pop()
        if len(headers) != len(dna):
            raise ValueError(f"{len(headers)} headers for {len(dna)} records")
    else:
        headers = None
    with open(out_path, "wb") as f:
        parts = []
        for i, (d, q) in enumerate(zip(dna, qs)):
            parts.append(headers[i] if headers else b"@")
            parts.append(b"\n")
            parts.append(d)
            parts.append(b"\n+\n")
            parts.append(q)
            parts.append(b"\n")
            if len(parts) > 1 << 16:
                f.write(b"".join(parts))
                parts = []
        f.write(b"".join(parts))
    if paired_n1 is not None:
        with open(out_path, "rb") as f:
            body = f.read()
        half1, half2 = _split_pair(body, paired_n1)
        p1, p2 = _pair_paths(out_path)
        with open(p1, "wb") as f:
            f.write(half1)
        with open(p2, "wb") as f:
            f.write(half2)
        os.remove(out_path)
        return p1, p2
    return out_path


def _decode_blob_file(path: str) -> bytes:
    tmp = decompress_stream(path, path + ".dec.tmp")
    with open(tmp, "rb") as f:
        data = f.read()
    os.remove(tmp)
    return data


def decompress_stream(path: str, out_path: Optional[str] = None) -> str:
    """Decode any bfqzip container back to the original stream bytes."""
    from bfqzip_tpu.utils import native

    blob = open(path, "rb").read()
    if blob[:4] == b"BQZH":
        from bfqzip_tpu.models.headers import decode_headers

        payload = b"\n".join(decode_headers(blob)) + b"\n"
    elif blob[:4] == b"BQZE":
        from bfqzip_tpu.models.dna_ebwt import decode_dna_stream

        payload = decode_dna_stream(blob)
    elif blob[:4] == b"BQZC":
        payload = native.cm_decode(blob).tobytes()
    elif native.available():
        payload = native.rans_decode(blob).tobytes()
    else:
        payload = rans.decode(blob).tobytes()
    out_path = out_path or (path[:-5] if path.endswith(".rans") else path + ".out")
    with open(out_path, "wb") as f:
        f.write(payload)
    return out_path


def run_pipeline(
    inputs: List[str],
    cfg: PipelineConfig,
    out_base: Optional[str] = None,
    check: bool = False,
    reorder: int = 0,
    blocks: int = 0,
    mesh_shards: int = 0,
    ext_mem_mb: int = 0,
    logfile: Optional[str] = None,
    debug_dump: bool = False,
) -> PipelineResult:
    """The full compression pipeline (reference BFQzip.py:31-174 surface)."""
    base = out_base or inputs[0]
    log = StepLogger(logfile or base + ".log")
    log.command_line()
    log.devices()

    # ---- input / validation (checkFASTQ.py semantics via the parser) ----
    _spill = None
    with log.step("read FASTQ"):
        if ext_mem_mb and len(inputs) == 1 and not cfg.original:
            # out-of-core runs parse in record-aligned slabs straight into
            # spill-backed arrays (io/spill.py) so the input never needs
            # 2x file size of host RAM
            from bfqzip_tpu.io.spill import Spill, read_fastq_spill

            _spill = Spill()
            batches = [read_fastq_spill(inputs[0], _spill, with_headers=True)]
        else:
            batches = [read_fastq(p) for p in inputs]
    if check:
        for b in batches:
            b.validate()
        log.info("checkFASTQ: valid")

    paired_split = batches[0].num_reads if len(batches) > 1 else None

    # ---- optional reorder (BFQzip.py:277-292 / randomFASTQ.py) ----
    # Paired mode follows the reference contract (randomFASTQ.py:52-102): ONE
    # permutation, computed on file 1, applied to BOTH mate files before the
    # concat — so record i of _1.fq stays mated with record i of _2.fq after
    # the paired re-split in _finish_pipeline.
    if reorder:
        from bfqzip_tpu.utils.reorder import reorder_batch

        with log.step(f"reorder mode {reorder}"):
            if len(batches) > 1:
                b1, b2 = reorder_batch(batches[0], mode=reorder, mate=batches[1])
                batches = [b1, b2]
            else:
                batches = [reorder_batch(batches[0], mode=reorder)]

    batch = batches[0] if len(batches) == 1 else _concat(batches)

    # ---- out-of-core mode (BFQzip_ext.py surface): chunked device sorts +
    # native host merge + streaming smoothing under a device-memory budget ----
    if ext_mem_mb and not cfg.original:
        from bfqzip_tpu.external import smooth_fastq_external

        with log.step(f"steps1-3: external memory, budget {ext_mem_mb} MB"):
            smoothed, stats = smooth_fastq_external(
                batch, cfg.smooth, mem_bytes=ext_mem_mb << 20, spill=_spill,
            )
        headers_on = cfg.headers or cfg.mode == 3
        if headers_on and batch.headers is not None:
            with open(base + ".h", "wb") as f:
                f.write(b"\n".join(batch.headers) + b"\n")
        hdrs = batch.headers if headers_on else None
        with open(base + ".fq", "wb") as f:
            f.write(format_fastq(smoothed, headers=hdrs))
        return _finish_pipeline(inputs, cfg, base, log, stats, paired_split)

    # ---- sequence-sharded mode: ONE global EBWT over the mesh, smoothed and
    # inverted in a single collective kernel (no per-block ratio cost; see
    # parallel/global_pipeline.py).  Steps 1-3 fuse; artifacts are skipped. ----
    if mesh_shards and mesh_shards > 1 and not cfg.original:
        import jax

        jax.config.update("jax_enable_x64", True)  # i64 sort keys
        from bfqzip_tpu.parallel import make_mesh, smooth_fastq_sharded

        mesh = make_mesh((1, mesh_shards))
        with log.step(f"steps1-3: sequence-sharded over {mesh_shards} devices"):
            smoothed, stats = smooth_fastq_sharded(batch, cfg.smooth, mesh)
        headers_on = cfg.headers or cfg.mode == 3
        if headers_on and batch.headers is not None:
            with open(base + ".h", "wb") as f:
                f.write(b"\n".join(batch.headers) + b"\n")
        hdrs = batch.headers if headers_on else None
        with open(base + ".fq", "wb") as f:
            f.write(format_fastq(smoothed, headers=hdrs))
        return _finish_pipeline(inputs, cfg, base, log, stats, paired_split)

    # ---- step 1 with artifact caching (BFQzip.py:93-104), content-keyed ----
    if cfg.rebuild or not _artifacts_exist(base, _fingerprint(batch)):
        if blocks and blocks > 1:
            _blockwise_step1_3(batch, base, cfg, blocks, log, paired_split=paired_split)
            smoothed, stats = _load_fq(base), {}
        else:
            step1_build(batch, base, log)
            smoothed = None
    else:
        log.info("step1: artifacts cached, skipping (use rebuild to force)")
        smoothed = None

    # ---- step 2: headers (BFQzip.py:192-203) ----
    headers_on = cfg.headers or cfg.mode == 3
    if headers_on and batch.headers is not None:
        with open(base + ".h", "wb") as f:
            f.write(b"\n".join(batch.headers) + b"\n")

    # ---- step 3 (+4) ----
    stats: Dict[str, int] = {}
    if cfg.original:
        with log.step("step3: --original (copy input)"):
            shutil.copyfile(inputs[0], base + ".fq")
    elif smoothed is None:
        smoothed, stats = step3_smooth(base, cfg, log, debug_dump=debug_dump)
        hdrs = batch.headers if headers_on else None
        with open(base + ".fq", "wb") as f:
            f.write(format_fastq(smoothed, headers=hdrs))

    return _finish_pipeline(inputs, cfg, base, log, stats, paired_split)


def _finish_pipeline(inputs, cfg, base, log, stats, paired_split) -> PipelineResult:
    """Steps 4-5 + report, shared by the artifact and sharded paths."""
    # paired mode: re-split the merged output at the recorded mate boundary
    # into _1/_2 files (BFQzip_parallel.py:153-172) and compress those
    if paired_split is not None and not cfg.original:
        with log.step("paired re-split"):
            fq = open(base + ".fq", "rb").read()
            lines = fq.split(b"\n")
            cut = 4 * paired_split
            with open(base + "_1.fq", "wb") as f:
                f.write(b"\n".join(lines[:cut]) + b"\n")
            with open(base + "_2.fq", "wb") as f:
                f.write(b"\n".join(lines[cut:]).rstrip(b"\n") + b"\n")

    streams = []
    if cfg.mode == 1:
        streams = [base + ".fq"] if paired_split is None else [base + "_1.fq", base + "_2.fq"]
    elif cfg.mode in (2, 3):
        with log.step("step4: stream split"):
            fq = open(base + ".fq", "rb").read()
            lines = fq.split(b"\n")
            with open(base + ".fq.dna", "wb") as f:
                f.write(b"\n".join(lines[1::4]) + b"\n")
            with open(base + ".fq.qs", "wb") as f:
                f.write(b"\n".join(lines[3::4]) + b"\n")
        streams = [base + ".fq.dna", base + ".fq.qs"]
        if cfg.mode == 3:
            streams.append(base + ".h")

    # ---- step 5 ----
    outputs: Dict[str, List[str]] = {}
    if cfg.mode != 0 and streams:
        outputs = step5_compress(streams, cfg.codecs, log)

    # ---- report (BFQzip.py:147-172) ----
    insize = sum(os.path.getsize(p) for p in inputs)
    report = {"original_mb": insize / 2**20}
    for codec, files in outputs.items():
        outsize = sum(os.path.getsize(f) for f in files)
        report[f"{codec}_mb"] = outsize / 2**20
        report[f"{codec}_ratio"] = outsize / insize
        log.info(f"{codec}: {outsize/2**20:.2f} MB, ratio {outsize/insize:.3f}")

    if paired_split is not None:
        with open(_meta_path(base + ".paired"), "w") as f:
            json.dump({"reads_file1": paired_split}, f)

    # per-phase wall + memory telemetry (the reference prints the peak heap
    # after every phase, bfq_int.cpp:976-1001; here it also rides the result)
    report["phases"] = list(log.phases)
    log.close()
    return PipelineResult(streams=streams, outputs=outputs, stats=stats, report=report)


def _concat(batches: List[ReadBatch]) -> ReadBatch:
    """Paired-end mode: append mate reads after file-1 reads
    (BFQzip_parallel.py:325-360)."""
    width = max(b.max_len for b in batches)
    seqs = np.concatenate([np.pad(b.seqs, ((0, 0), (0, width - b.max_len))) for b in batches])
    quals = np.concatenate([np.pad(b.quals, ((0, 0), (0, width - b.max_len))) for b in batches])
    lengths = np.concatenate([b.lengths for b in batches])
    headers = None
    if all(b.headers is not None for b in batches):
        headers = [h for b in batches for h in b.headers]
    return ReadBatch(seqs=seqs, quals=quals, lengths=lengths, headers=headers)


def _block_permutation(n: int, blocks: int, paired_split: Optional[int]):
    """Read order for block mode.  Unpaired: contiguous ~equal blocks
    (BFQzip_parallel.py:288-323).  Paired: each block holds its share of
    file-1 reads followed by the matching file-2 reads
    (split_fastq_2, BFQzip_parallel.py:325-360), so mates land in the SAME
    block's EBWT.  Returns (perm, block index bounds in permuted order)."""
    if paired_split is None:
        size = (n + blocks - 1) // blocks
        bounds = [(b * size, min((b + 1) * size, n)) for b in range(blocks)]
        return np.arange(n), bounds
    n1 = paired_split
    n2 = n - n1
    s1 = (n1 + blocks - 1) // blocks
    s2 = (n2 + blocks - 1) // blocks
    idx, bounds, off = [], [], 0
    for b in range(blocks):
        lo1, hi1 = b * s1, min((b + 1) * s1, n1)
        lo2, hi2 = b * s2, min((b + 1) * s2, n2)
        idx.append(np.arange(lo1, hi1))
        idx.append(n1 + np.arange(lo2, hi2))
        take = (hi1 - lo1) + (hi2 - lo2)
        bounds.append((off, off + take))
        off += take
    return np.concatenate(idx), bounds


def _blockwise_step1_3(batch, base, cfg, blocks, log, paired_split=None):
    """Block mode: independent EBWT per ~equal read block, outputs merged in
    block order (BFQzip_parallel.py:288-323,137-152).  When the visible
    device count covers the block count, every block runs concurrently as one
    shard_map step (parallel/block.py — the reference's thread fan-out,
    BFQzip_parallel.py:104-119); otherwise blocks run sequentially through
    the engine under one cached compilation."""
    import jax

    n = batch.num_reads
    perm, bounds = _block_permutation(n, blocks, paired_split)
    work = ReadBatch(
        seqs=batch.seqs[perm], quals=batch.quals[perm],
        lengths=batch.lengths[perm],
    )

    equal_blocks = len({hi - lo for lo, hi in bounds}) == 1
    if blocks > 1 and len(jax.devices()) >= blocks and equal_blocks:
        from bfqzip_tpu.parallel import block_smooth_fastq, make_mesh

        with log.step(f"blocks 1-{blocks}: mesh-parallel EBWT+smooth+invert"):
            merged_w, _ = block_smooth_fastq(
                work, cfg.smooth, make_mesh((blocks, 1)), axes=("data",)
            )
    else:
        merged_w = _blocks_sequential(work, bounds, cfg.smooth, log)

    # back to input order: file-1 reads then file-2 reads (the paired
    # re-split in _finish_pipeline cuts at paired_split)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    merged = ReadBatch(
        seqs=merged_w.seqs[inv], quals=merged_w.quals[inv],
        lengths=merged_w.lengths[inv], headers=batch.headers,
    )
    hdrs = batch.headers if (cfg.headers or cfg.mode == 3) else None
    with open(base + ".fq", "wb") as f:
        f.write(format_fastq(merged, headers=hdrs))


def _blocks_sequential(work: ReadBatch, bounds, smooth_cfg, log) -> ReadBatch:
    """Smooth each read block [lo, hi) of `work` on its own, one after the
    other on the default device, and concatenate the outputs in block order."""
    from bfqzip_tpu.engine import smooth_fastq

    size = max(hi - lo for lo, hi in bounds)
    parts = []
    for b, (lo, hi) in enumerate(bounds):
        take = hi - lo
        # pad every block to the common shape so a single jit compilation
        # serves all blocks (dummy 1-base reads, lowest quality)
        seqs_b = np.zeros((size, work.max_len), np.uint8)
        quals_b = np.zeros((size, work.max_len), np.uint8)
        lens_b = np.ones(size, np.int32)
        seqs_b[:take] = work.seqs[lo:hi]
        quals_b[:take] = work.quals[lo:hi]
        lens_b[:take] = work.lengths[lo:hi]
        if take < size:
            seqs_b[take:, 0] = 1
            quals_b[take:, 0] = 33
        sub = ReadBatch(seqs=seqs_b, quals=quals_b, lengths=lens_b)
        with log.step(f"block {b+1}/{len(bounds)}: EBWT+smooth+invert ({take} reads)"):
            out, _ = smooth_fastq(sub, smooth_cfg)
        parts.append(ReadBatch(seqs=out.seqs[:take], quals=out.quals[:take],
                               lengths=out.lengths[:take]))
    width = max(p.max_len for p in parts)
    return ReadBatch(
        seqs=np.concatenate([np.pad(p.seqs, ((0, 0), (0, width - p.max_len))) for p in parts]),
        quals=np.concatenate([np.pad(p.quals, ((0, 0), (0, width - p.max_len))) for p in parts]),
        lengths=np.concatenate([p.lengths for p in parts]),
    )


def _load_fq(base: str) -> ReadBatch:
    return read_fastq(base + ".fq")
