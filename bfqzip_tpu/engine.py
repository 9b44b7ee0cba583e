"""Single-device end-to-end engine: FASTQ batch -> smoothed FASTQ batch.

This is the jitted composition of the compute path (build_ebwt -> smooth ->
lf -> invert), the device equivalent of one `bfq_int` invocation
(reference BFQzip.py:206-228).  Shapes are static in (N, L); the pipeline is
recompiled per shape bucket and cached by jax.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bfqzip_tpu import alphabet
from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.io.fastq import ReadBatch
from bfqzip_tpu.ops.invert import InvertOut, invert, invert_via_sa
from bfqzip_tpu.ops.rank import lf_array
from bfqzip_tpu.ops.smooth import smooth
from bfqzip_tpu.ops.suffix import build_ebwt


@functools.partial(jax.jit, static_argnames=("cfg",))
def smooth_step(seqs: jax.Array, quals: jax.Array, lengths: jax.Array, cfg: SmoothConfig):
    """The full device-side pipeline on a padded [N, L] read batch."""
    n_reads, width = seqs.shape
    ebwt = build_ebwt(seqs, quals, lengths)
    # bwt[LF[j]] is the text symbol at SA[j]-2 (dna_bwt_n.hpp:78-101 becomes
    # pointer arithmetic on the kept SA); the flat builder carries it through
    # the sort as a payload, the doubling builder needs one gather
    if ebwt.pre is not None:
        pre = ebwt.pre
    else:
        n_pad = ebwt.bwt.shape[0]
        tprev2 = ebwt.text[(ebwt.sa - 2) % n_pad]
        pre = jnp.where(tprev2 == 0, jnp.uint8(alphabet.TERM), tprev2 - 1)
    out = smooth(ebwt, cfg, pre=pre)
    inv = invert_via_sa(
        ebwt.sa, ebwt.bwt, out.bwt_sub, out.qs, ebwt.n, n_reads, width, binning=cfg.binning
    )
    return inv, out.stats


@functools.partial(jax.jit, static_argnames=("n_reads", "width", "cfg"))
def smooth_arrays_step(bwt, qs, lcp, n, n_reads: int, width: int, cfg: SmoothConfig):
    """Steps 3-5 of the core from precomputed EBWT artifacts (the cached-step1
    path, reference BFQzip.py:93-104: bfq_int consuming OUT.bwt/OUT.bwt.qs)."""
    from bfqzip_tpu.ops.suffix import EbwtDevice

    n = jnp.asarray(n, jnp.int32)
    ebwt = EbwtDevice(bwt=bwt, qs=qs, lcp=lcp, sa=jnp.zeros_like(lcp), text=jnp.zeros_like(bwt), n=n)
    out = smooth(ebwt, cfg)
    valid = jnp.arange(bwt.shape[0], dtype=jnp.int32) < n
    lf = lf_array(bwt, valid)
    inv = invert(bwt, out.bwt_sub, out.qs, lf, n_reads, width, binning=cfg.binning)
    return inv, out.bwt_sub, out.qs, out.stats


def smooth_fastq(
    batch: ReadBatch, cfg: SmoothConfig | None = None, bucket: bool = True
) -> Tuple[ReadBatch, dict]:
    """Host wrapper: numpy ReadBatch in, smoothed numpy ReadBatch out.

    With bucket=True (default) the batch is padded to a compile-shape bucket
    (io.fastq.pad_batch: dummy length -1 rows, inert in the EBWT) so arbitrary
    dataset sizes hit the persistent compilation cache, and the output is
    trimmed back to the original read count.
    """
    from bfqzip_tpu.io.fastq import pad_batch

    cfg = cfg or SmoothConfig()
    run = pad_batch(batch) if bucket else batch
    inv, stats = smooth_step(
        jnp.asarray(run.seqs), jnp.asarray(run.quals), jnp.asarray(run.lengths), cfg
    )
    n0 = batch.num_reads
    out = ReadBatch(
        seqs=np.asarray(inv.seqs)[:n0],
        quals=np.asarray(inv.quals)[:n0],
        lengths=np.asarray(inv.lengths)[:n0].astype(np.int32),
        headers=batch.headers,
    )
    return out, {k: int(v) for k, v in stats.items()}
