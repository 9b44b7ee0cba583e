"""EBWT + quality-permutation + LCP construction as a JAX sort pipeline.

Replaces the reference's external gsufsort / eGap step-1 tools (invoked at
reference BFQzip.py:184 and BFQzip_ext.py:177).  The construction is a packed
prefix-doubling suffix sort over the read collection; the LCP of adjacent
sorted suffixes is recovered by binary lifting over the doubling ranks — both
pure array programs that map onto XLA's sort/gather and shard over meshes.

Layout
------
Reads are presented as padded arrays [N, L]; position g = r*(L+1) + k denotes
suffix k of read r (k == len_r is the read's terminator suffix).  Suffix order
follows gsufsort's convention (built with TERMINATOR=0 DNA=1 at reference
Makefile:18): per-read terminators are pairwise distinct, smaller than every
base, ordered by read index.  Padding positions (k > len_r) are given keys
that sort strictly after all real suffixes, so the n real suffixes occupy
SA[0:n] and every shape stays static under jit; n = sum(len)+N is only ever
used as a mask.

Sort — flat path (reads up to ~300bp, the production case)
----
The flat path issues no random gathers or scatters: the ENTIRE suffix window (L+1 symbols) is packed into
ceil((L+1)/PACK6) base-6 u32 key words (PACK6 = 12 digits per word,
6^12 < 2^32; terminator/padding -> digit 0 < bases 1..5; symbols after the
terminator zeroed) and suffix order is ONE variadic XLA sort.  Prefix-equal
suffixes of different reads must order by read index (gsufsort's
distinct-terminator convention): the suffix position rides as the final
sort key (equal window content implies position order = read order), making
the key set a total order so the faster UNSTABLE comparator applies;
padding rows get a forced max first word so they sort after all real
suffixes, in deterministic position order.
Everything downstream needs only *data at SA order*, so it is carried through
the sort as payloads instead of gathered afterwards: the suffix position
(-> SA), and one packed word holding the two preceding text symbols (-> BWT,
and bwt[LF] for the smoother's SNP rule) plus the preceding quality (-> qs).

LCP — flat path
---
lcp(SA[i-1], SA[i]) is the count of leading equal 3-bit groups between
CONSECUTIVE sorted key rows, gated at the first zero group (= terminator) —
pure elementwise work on the sort outputs, zero gathers.

Sort/LCP — doubling path (long reads)
----
For reads too long to pack the whole window (wp > PACK*MAX_FLAT_WORDS), the
flat sort degrades (too many key words), so a prefix-doubling path remains:
round 0 sorts PACK_WORDS packed words, then each round is one variadic sort
doubling the span 30 -> 60 -> 120 -> ... with dense re-ranking; the LCP is
recovered by binary lifting over the saved per-round ranks plus a packed-key
remainder count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bfqzip_tpu import alphabet

PACK = 10  # symbols per packed word (3 bits each, 30 bits used; doubling path)
PACK_WORDS = 3  # words in the doubling-path round-0 key: span = PACK * PACK_WORDS
SPAN0 = PACK * PACK_WORDS
_EXT = SPAN0 + PACK  # row extension so every packed word is in-row
PACK6 = 12  # flat-path symbols per packed u32 word (base-6 digits: 6^12 < 2^32)
MAX_FLAT_WORDS = 27  # flat path covers reads up to PACK6*MAX_FLAT_WORDS-2 bp


class EbwtDevice(NamedTuple):
    """Step-1 artifacts on device; valid data occupies [0, n) of each array."""

    bwt: jax.Array  # [n_pad] u8 codes; PAD_CODE past n
    qs: jax.Array  # [n_pad] u8 raw ASCII quality bytes (filler at TERM positions)
    lcp: jax.Array  # [n_pad] i32 (lcp[0] == 0; garbage past n)
    sa: jax.Array  # [n_pad] i32 positions into the padded text
    text: jax.Array  # [n_pad] u8: 1+code per base, 0 at terminator/padding slots
    n: jax.Array  # scalar i32: number of real BWT positions
    pre: jax.Array | None = None  # [n_pad] u8: bwt[LF[i]] (symbol at SA[i]-2)


PAD_CODE = jnp.uint8(alphabet.SIGMA)  # sentinel code for padding region


def _window_codes(seqs: jax.Array, lengths: jax.Array) -> jax.Array:
    """[N, wp+_EXT] u8 symbol rows: 1+code for bases, zeros from the
    terminator on (zeros make prefix comparisons stop at the terminator)."""
    n_reads, width = seqs.shape
    wp = width + 1
    k = jnp.arange(wp + _EXT, dtype=jnp.int32)[None, :]
    lens = lengths[:, None].astype(jnp.int32)
    base = jnp.pad(seqs, ((0, 0), (0, 1 + _EXT))).astype(jnp.uint8) + 1
    return jnp.where(k < lens, base, jnp.uint8(0))


def _pack_word(wcodes: jax.Array, wp: int, word: int) -> jax.Array:
    """[N, wp] i32 key packing symbols [10*word, 10*word+10) of each window."""
    o = PACK * word
    acc = jnp.zeros(wcodes.shape[:-1] + (wp,), jnp.int32)
    for t in range(PACK):
        acc = acc | (wcodes[:, o + t : o + t + wp].astype(jnp.int32) << (3 * (PACK - 1 - t)))
    return acc


def _dense_rank(eq_prev: jax.Array, sa: jax.Array) -> jax.Array:
    """Scatter dense ranks (cumsum of 'key changed') back to position order."""
    n_pad = sa.shape[0]
    changed = jnp.concatenate([jnp.zeros((1,), jnp.int32), (~eq_prev[1:]).astype(jnp.int32)])
    dense = jnp.cumsum(changed, dtype=jnp.int32)
    return jnp.zeros((n_pad,), jnp.int32).at[sa].set(dense, mode="drop", unique_indices=True)


def _spans(wp: int):
    spans = [SPAN0]
    while spans[-1] < wp:
        spans.append(spans[-1] * 2)
    return spans  # doubling rounds sort spans[1:]; ranks kept for spans[:-1]


@functools.partial(jax.jit, static_argnames=())
def build_ebwt(seqs: jax.Array, quals: jax.Array, lengths: jax.Array) -> EbwtDevice:
    """Compute ebwt(S), qs(S) and lcp(S) for a padded read batch.

    Returns fixed-shape arrays of size N*(L+1) whose first n entries are the
    real EBWT/QS/LCP (n = sum(lengths) + N); the rest is inert padding
    (PAD_CODE bases, zero quality).  Dispatches on read width: one flat
    whole-window sort for short reads, prefix doubling beyond that.
    """
    if seqs.shape[1] + 1 <= PACK6 * MAX_FLAT_WORDS:
        return _build_ebwt_flat(seqs, quals, lengths)
    return _build_ebwt_doubling(seqs, quals, lengths)


def _build_ebwt_flat(seqs: jax.Array, quals: jax.Array, lengths: jax.Array) -> EbwtDevice:
    """One variadic sort over whole-window packed keys; no random gathers.

    Key layout per suffix g = r*(L+1) + k (see module docstring): W base-6
    u32 words covering symbols k..k+wp-1 (12 symbols per word, two words
    fewer than a 3-bit packing at 101bp; sort cost grows with the number of
    operands and keys).  Equal window content implies equal
    distance to the terminator, so among fully tied suffixes position order
    equals read order (the distinct-terminator convention); the suffix
    position (doubling as the SA) rides as the FINAL key, which makes the
    key set a total order and lets the unstable comparator realise that
    order.  The
    payload word carries the two preceding text symbols + preceding
    quality, so BWT/QS/pre come out of the sort directly.
    """
    n_reads, width = seqs.shape
    wp = width + 1
    n_pad = n_reads * wp
    idx0 = jnp.arange(n_pad, dtype=jnp.int32)
    lens = lengths.astype(jnp.int32)
    # rows with length -1 are shape-bucketing dummies: no terminator, no
    # suffixes, zero contribution to the EBWT (io.fastq.pad_batch)
    real_read = lens >= 0
    n = (jnp.sum(jnp.maximum(lens, 0), dtype=jnp.int32)
         + jnp.sum(real_read.astype(jnp.int32), dtype=jnp.int32)).astype(jnp.int32)

    n_words = -(-wp // PACK6)

    # symbol windows (digits 0..5: terminator/pad 0 < bases 1..5), extended so
    # every packed word reads in-row
    ext = PACK6 * n_words
    k = jnp.arange(wp + ext, dtype=jnp.int32)[None, :]
    base6 = jnp.pad(seqs, ((0, 0), (0, 1 + ext))).astype(jnp.uint8)
    wcodes = jnp.where(k < lens[:, None], base6, jnp.uint8(0))

    def pack6(word):
        o = PACK6 * word
        acc = jnp.zeros((n_reads, wp), jnp.uint32)
        for t in range(PACK6):
            acc = acc * jnp.uint32(6) + wcodes[:, o + t : o + t + wp].astype(jnp.uint32)
        return acc.reshape(-1)

    words = [pack6(w) for w in range(n_words)]

    kk = jnp.arange(wp, dtype=jnp.int32)[None, :]
    is_pad = (kk > lens[:, None]).reshape(-1)
    # padding rows: first word forced above every real key (real words are
    # < 6^12 < 0xF0000000); stability (below) keeps them in position order
    words[0] = jnp.where(is_pad, jnp.uint32(0xF0000000), words[0])

    # payload: packed (prev symbol, prev quality, prev^2 symbol)
    text_codes = jnp.where(
        (kk < lens[:, None]), jnp.pad(seqs, ((0, 0), (0, 1))).astype(jnp.uint8) + 1, jnp.uint8(0)
    )
    tflat = text_codes.reshape(-1)
    qtext = jnp.pad(quals, ((0, 0), (0, 1))).reshape(-1)
    p1 = jnp.roll(tflat, 1).astype(jnp.int32)
    aux = p1 | (jnp.roll(qtext, 1).astype(jnp.int32) << 3) | (jnp.roll(tflat, 2).astype(jnp.int32) << 11)

    # idx0 rides as the FINAL KEY, making the key set a total order: for
    # fully equal windows (content implies equal distance-to-terminator)
    # position order g = r*wp + k IS read-index order — gsufsort's
    # distinct-terminator convention — and equal padding rows order by
    # position deterministically.  With a total order the comparator may be
    # UNSTABLE, with byte-identical outputs.
    sorted_ops = jax.lax.sort((*words, idx0, aux), num_keys=n_words + 1, is_stable=False)
    skeys, sa, saux = sorted_ops[:n_words], sorted_ops[-2], sorted_ops[-1]

    # ---- BWT / permuted qualities / smoother predecessors from the payload ----
    cprev = (saux & 7).astype(jnp.uint8)
    is_term = cprev == 0
    bwt = jnp.where(is_term, jnp.uint8(alphabet.TERM), cprev - 1)
    qs = jnp.where(is_term, jnp.uint8(alphabet.TERM_CHAR), ((saux >> 3) & 0xFF).astype(jnp.uint8))
    c2 = ((saux >> 11) & 7).astype(jnp.uint8)
    pre = jnp.where(c2 == 0, jnp.uint8(alphabet.TERM), c2 - 1)

    valid = idx0 < n
    bwt = jnp.where(valid, bwt, PAD_CODE)
    qs = jnp.where(valid, qs, jnp.uint8(0))

    # ---- LCP: leading equal nonzero base-6 digits of consecutive sorted rows ----
    lcp = jnp.zeros((n_pad,), jnp.int32)
    eq = jnp.ones((n_pad,), bool)
    nz = jnp.ones((n_pad,), bool)  # no terminator digit seen yet
    for w in range(n_words):
        bw = skeys[w]
        aw = jnp.concatenate([jnp.zeros((1,), jnp.uint32), bw[:-1]])
        for t in range(PACK6):
            div = jnp.uint32(6 ** (PACK6 - 1 - t))
            da = (aw // div) % jnp.uint32(6)
            db = (bw // div) % jnp.uint32(6)
            eq = eq & (da == db)
            nz = nz & (da != 0)
            lcp = lcp + (eq & nz).astype(jnp.int32)
    lcp = jnp.where(valid, lcp, 0).at[0].set(0)

    return EbwtDevice(bwt=bwt, qs=qs, lcp=lcp, sa=sa, text=tflat, n=n, pre=pre)


def _build_ebwt_doubling(seqs: jax.Array, quals: jax.Array, lengths: jax.Array) -> EbwtDevice:
    """Prefix-doubling construction (long reads; see module docstring)."""
    n_reads, width = seqs.shape
    wp = width + 1
    n_pad = n_reads * wp
    idx0 = jnp.arange(n_pad, dtype=jnp.int32)
    lens = lengths.astype(jnp.int32)
    n = (jnp.sum(jnp.maximum(lens, 0), dtype=jnp.int32)
         + jnp.sum((lens >= 0).astype(jnp.int32), dtype=jnp.int32)).astype(jnp.int32)

    wcodes = _window_codes(seqs, lengths)  # [N, wp+_EXT]
    words = [_pack_word(wcodes, wp, w).reshape(-1) for w in range(PACK_WORDS)]

    k = jnp.arange(wp, dtype=jnp.int32)[None, :]
    rid = jnp.arange(n_reads, dtype=jnp.int32)[:, None]
    is_pad = (k > lens[:, None]).reshape(-1)
    term_near = (lens[:, None] - k >= 0) & (lens[:, None] - k < SPAN0)
    # tie-break: read index when the terminator is inside the packed span
    # (prefix-equal reads order by index); unique large values for padding so
    # it sorts after all real suffixes (its first word is forced to the max).
    tb = jnp.where(term_near, rid + 1, 0)
    g2 = rid * wp + k
    tb = jnp.where(is_pad.reshape(n_reads, wp), n_reads + 1 + g2, tb).reshape(-1)
    w0 = jnp.where(is_pad, jnp.int32(2**30), words[0])

    # round 0: one sort by the 30-symbol packed key + tie-break
    sorted_ops = jax.lax.sort((w0, *words[1:], tb, idx0), num_keys=PACK_WORDS + 1,
                              is_stable=True)
    sa = sorted_ops[-1]
    keys = sorted_ops[:-1]
    eq = jnp.ones((n_pad,), bool)
    for ks in keys:
        eq = eq & jnp.concatenate([jnp.ones((1,), bool), ks[1:] == ks[:-1]])
    rank = _dense_rank(eq, sa)

    spans = _spans(wp)
    ranks = [rank]  # ranks[i] = rank after span spans[i]
    for i, h in enumerate(spans[:-1]):
        rank_ahead = jnp.where(idx0 + h < n_pad, jnp.roll(rank, -h), -1)
        r1, r2, sa = jax.lax.sort((rank, rank_ahead, idx0), num_keys=2)
        if i + 1 < len(spans) - 1:  # the final span's rank is never used
            eq = jnp.concatenate(
                [jnp.ones((1,), bool), (r1[1:] == r1[:-1]) & (r2[1:] == r2[:-1])]
            )
            rank = _dense_rank(eq, sa)
            ranks.append(rank)

    # ---- BWT + permuted qualities ----
    # Symbol cyclically preceding each suffix.  A padding predecessor can only
    # occur when the suffix starts a read, whose true predecessor in the
    # compact text is the previous read's terminator — emit TERM either way.
    text_codes = jnp.where(
        (k < lens[:, None]), jnp.pad(seqs, ((0, 0), (0, 1))).astype(jnp.uint8) + 1, jnp.uint8(0)
    )  # 0 for terminator AND padding slots
    tflat = text_codes.reshape(-1)
    qtext = jnp.pad(quals, ((0, 0), (0, 1))).reshape(-1)
    prev = (sa - 1) % n_pad
    cprev = tflat[prev]
    is_term = cprev == 0
    bwt = jnp.where(is_term, jnp.uint8(alphabet.TERM), cprev - 1)
    qs = jnp.where(is_term, jnp.uint8(alphabet.TERM_CHAR), qtext[prev])

    valid = idx0 < n
    bwt = jnp.where(valid, bwt, PAD_CODE)
    qs = jnp.where(valid, qs, jnp.uint8(0))

    # ---- LCP by binary lifting over the doubling ranks ----
    a = jnp.concatenate([jnp.zeros((1,), jnp.int32), sa[:-1]])
    b = sa
    h = jnp.zeros((n_pad,), jnp.int32)
    for span, r in zip(reversed(spans[:-1]), reversed(ranks)):
        ah, bh = a + h, b + h
        ok = (ah < n_pad) & (bh < n_pad)
        same = r[jnp.minimum(ah, n_pad - 1)] == r[jnp.minimum(bh, n_pad - 1)]
        h = jnp.where(ok & same, h + span, h)

    # remainder < SPAN0 symbols, from the packed keys alone: count leading
    # equal 3-bit groups, gated at the first zero group (= terminator; the
    # gate also neutralises any out-of-row garbage in later words).  a+h and
    # b+h land on base/terminator slots of valid rows (h <= lcp keeps the
    # offset within the read), so the padding-key masking of w0 is never
    # observed here — use the unmasked word array.
    # NB: these gathers are kept strictly 1-D, one per key word.
    rem = jnp.zeros((n_pad,), jnp.int32)
    nz = jnp.ones((n_pad,), bool)  # no zero group seen yet
    eq = jnp.ones((n_pad,), bool)  # all groups equal so far
    for w in range(PACK_WORDS):
        aw = words[0][jnp.minimum(a + h + PACK * w, n_pad - 1)]
        bw = words[0][jnp.minimum(b + h + PACK * w, n_pad - 1)]
        for j in range(1, PACK + 1):
            sh = 3 * (PACK - j)
            eq = eq & ((aw >> sh) == (bw >> sh))
            nz = nz & (((aw >> sh) & 7) != 0)
            rem = rem + (eq & nz).astype(jnp.int32)
    lcp = h + rem
    lcp = jnp.where(valid, lcp, 0).at[0].set(0)

    return EbwtDevice(bwt=bwt, qs=qs, lcp=lcp, sa=sa, text=tflat, n=n)
