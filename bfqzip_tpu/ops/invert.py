"""EBWT inversion: reconstruct all reads by a lock-step backward LF walk.

Replaces the reference's per-read pointer-chasing loop (bfq_int.cpp:748-819)
and the file-seeking BCR decoder (decode.cpp:499-686): all N reads advance one
LF step per iteration, which turns the reconstruction into L batched gathers —
the dense analog of decodeBCRmultipleReverse's pair queues, with the "cyc"
column files + out-of-core transpose (decode.cpp:409-496) collapsing into a
single [L, N] -> [N, L] transpose and per-row flip.

The per-step payload (substituted base, smoothed quality, end-of-read flag)
is packed into one i32 word next to the LF pointer, so each of the L
sequential steps issues exactly two gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bfqzip_tpu import alphabet


class InvertOut(NamedTuple):
    seqs: jax.Array  # [N, L] u8 codes, zero-padded
    quals: jax.Array  # [N, L] u8 raw ASCII, zero-padded
    lengths: jax.Array  # [N] i32


def illumina_bin_jax(qs: jax.Array) -> jax.Array:
    """Illumina 8-level binning on raw ASCII qualities (bfq_int.cpp:307-319)."""
    q = qs.astype(jnp.int32) - 33
    out = q
    for lo, v in ((2, 6), (10, 15), (20, 22), (25, 27), (30, 33), (35, 37), (40, 40)):
        out = jnp.where(q >= lo, v, out)
    return (out + 33).astype(jnp.uint8)


def invert_via_sa(
    sa: jax.Array,
    bwt: jax.Array,
    bwt_sub: jax.Array,
    qs: jax.Array,
    n: jax.Array,
    n_reads: int,
    width: int,
    binning: bool = False,
) -> InvertOut:
    """Reconstruction without LF walking: this framework keeps the suffix
    array, and each non-terminator BWT position i holds the (possibly
    corrected) read character at text position SA[i]-1 — so the smoothed
    FASTQ is ONE permutation of (base, quality) back to read coordinates,
    replacing the reference's n sequential LF steps (bfq_int.cpp:775-791)
    entirely.  (SA-1) mod n_pad is a bijection over text slots, so the
    permutation is applied as one 2-operand key/value sort (whether a
    scatter is cheaper on the GPU is ROADMAP A3's question).  The
    LF-walk variant below remains for resuming from on-disk artifacts,
    which carry no SA."""
    if binning:
        qs = illumina_bin_jax(qs)
    n_pad = bwt.shape[0]
    wp = n_pad // n_reads  # width + 1
    idx = jnp.arange(n_pad, dtype=jnp.int32)
    is_char = (bwt != alphabet.TERM) & (bwt != jnp.uint8(alphabet.SIGMA)) & (idx < n)
    target = (sa - 1) % n_pad  # dense: every text slot receives exactly one entry
    packed = jnp.where(is_char, (qs.astype(jnp.int32) << 8) | bwt_sub.astype(jnp.int32), 0)
    # the key is a permutation (all distinct), so the unstable comparator is
    # safe
    _, grid_flat = jax.lax.sort((target, packed), num_keys=1, is_stable=False)
    grid = grid_flat.reshape(n_reads, wp)
    seqs = (grid[:, :width] & 0xFF).astype(jnp.uint8)
    quals = ((grid[:, :width] >> 8) & 0xFF).astype(jnp.uint8)
    lengths = jnp.sum((seqs != 0).astype(jnp.int32), axis=1, dtype=jnp.int32)
    return InvertOut(seqs=seqs, quals=quals, lengths=lengths)


def invert(
    bwt: jax.Array,
    bwt_sub: jax.Array,
    qs: jax.Array,
    lf: jax.Array,
    n_reads: int,
    width: int,
    binning: bool = False,
) -> InvertOut:
    """Walk LF from BWT positions 0..N-1 (the terminator suffixes in read
    order, bfq_int.cpp:775-791), collecting substituted bases and smoothed
    qualities right-to-left, then reverse each row to read order.
    """
    if binning:
        qs = illumina_bin_jax(qs)

    # payload word: [16:24]=quality  [8:16]=substituted base  [0]=not-TERM
    payload = (
        (qs.astype(jnp.int32) << 16)
        | (bwt_sub.astype(jnp.int32) << 8)
        | (bwt != alphabet.TERM).astype(jnp.int32)
    )

    # the `* 0 + arange` keeps the scan carry's sharding type aligned with the
    # data arrays when this runs inside shard_map (varying-axes propagation)
    pos0 = lf[:n_reads] * 0 + jnp.arange(n_reads, dtype=jnp.int32)

    def step(pos, _):
        w = payload[pos]
        active = (w & 1) == 1
        b = jnp.where(active, ((w >> 8) & 0xFF).astype(jnp.uint8), 0)
        q = jnp.where(active, ((w >> 16) & 0xFF).astype(jnp.uint8), 0)
        nxt = jnp.where(active, lf[pos], pos)
        return nxt, (b, q, active)

    _, (bcols, qcols, act) = jax.lax.scan(step, pos0, None, length=width)
    lengths = jnp.sum(act.astype(jnp.int32), axis=0, dtype=jnp.int32)  # [N]

    # emitted column t holds read char at index len-1-t; reverse via gather
    t_idx = lengths[None, :] - 1 - jnp.arange(width, dtype=jnp.int32)[:, None]  # [L, N]
    ok = t_idx >= 0
    t_clamped = jnp.maximum(t_idx, 0)
    seqs = jnp.where(ok, jnp.take_along_axis(bcols, t_clamped, axis=0), 0).T
    quals = jnp.where(ok, jnp.take_along_axis(qcols, t_clamped, axis=0), 0).T
    return InvertOut(seqs=seqs, quals=quals, lengths=lengths)
