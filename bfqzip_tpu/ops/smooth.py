"""Positional clustering + noise reduction + quality smoothing, vectorised.

Replaces the sequential cluster scan and per-cluster loops of the reference
(bfq_int.cpp:376-737) with SEGMENTED SCANS over the whole EBWT.  The round-1
design kept per-cluster arrays addressed by gather/scatter (cluster-id
expansion, end-sampling of prefix sums); this version keeps ALL
per-cluster state in scan form and never materialises a cluster-indexed
array:

  * LCP_threshold / LCP_minima are elementwise predicates on the explicit LCP
    array (the LCP-array form of the suffix-tree traversal, see
    ref_golden.lcp_bitvectors for the equivalence argument);
  * clusters are maximal runs of (threshold & ~minima) extended one position
    left (border=1, bfq_int.cpp:67,416-417); runs shorter than min_cluster-1
    are filtered before anything is counted (bfq_int.cpp:422);
  * per-cluster symbol counts / trusted-base flags / predecessor-pair
    presence are segmented cumsums, restarted at cluster opens — each is two
    native 1-D scans (ops/scan.seg_cumsum_nn), their value at the cluster
    CLOSE position is the cluster total;
  * the per-cluster decision word (one 30-bit pack of every smoothing
    decision) is computed elementwise at close positions and broadcast back
    over the members by one keep-left segmented scan — no cluster-id gather;
  * the SNP-candidate rule for two frequent symbols uses predecessor symbols
    bwt[LF[j]] carried through the suffix sort as payload (ops/suffix.py),
    not per-occurrence pointer chasing (bfq_int.cpp:545-611).

Outputs are the substituted BWT, the smoothed quality permutation, and the
reference's cluster/quality/base counters (bfq_int.cpp:53-65).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bfqzip_tpu import alphabet
from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.ops.rank import lf_array
from bfqzip_tpu.ops.scan import LOCAL_OPS
from bfqzip_tpu.ops.suffix import EbwtDevice

# reference ord order (bfq_int.cpp:106-110): index o -> alphabet code
_ORD_CODES = (alphabet.A, alphabet.C, alphabet.G, alphabet.T, alphabet.N)
_N_ORD = 4  # index of 'N' in ord order — always last, so FreqSymb[0] is never N
# code -> ord (TERM/PAD -> 0, harmless under masks)
_CODE2ORD = (0, 0, 1, 2, 4, 3, 0, 0)

# decision-word bit layout
_B_SINGLE = 0
_B_TWO = 1
_B_SSYM = 2  # 3 bits
_B_F0 = 5  # 3 bits
_B_F1 = 8  # 3 bits
_B_P0 = 11  # 3 bits
_B_P1 = 14  # 3 bits
_B_NEWQS = 17  # 8 bits
_B_HIGH = 25  # 5 bits, ord order


class SmoothOut(NamedTuple):
    bwt_sub: jax.Array  # [n_pad] u8, base-corrected BWT
    qs: jax.Array  # [n_pad] u8, smoothed qualities
    stats: dict  # reference counters, scalar i32


def smooth(ebwt: EbwtDevice, cfg: SmoothConfig, pre=None, ops=None) -> SmoothOut:
    ops = ops or LOCAL_OPS
    bwt, qs, lcp, n = ebwt.bwt, ebwt.qs, ebwt.lcp, ebwt.n
    if pre is None:
        # symbol preceding each BWT position: bwt[LF[j]] (bfq_int.cpp:547)
        # (single-device only: rank is a global cumsum; sharded/streaming
        # callers pass pre = text[(sa-2) % n_pad] carried from the sort)
        valid = ops.iota(bwt.shape[0]) < n
        lf = lf_array(bwt, valid)
        pre = bwt[lf]
    word, close_mark, in_cluster, stats = cluster_words(bwt, qs, lcp, n, cfg, pre, ops)
    # broadcast the close-position word back over the cluster members with a
    # keep-left segmented scan on the reversed array — no cluster-id gather
    w = ops.next_marked(jnp.where(close_mark, word, 0), close_mark, init=0)
    bwt_sub, qs_out, modified, qs_smoothed = apply_words(bwt, qs, pre, w, in_cluster, cfg)
    stats["modified"] = ops.sum(modified.astype(jnp.int32))
    stats["qs_smoothed"] = ops.sum(qs_smoothed.astype(jnp.int32))
    return SmoothOut(bwt_sub=bwt_sub, qs=qs_out, stats=stats)


def cluster_words(bwt, qs, lcp, n, cfg: SmoothConfig, pre, ops) -> tuple:
    """Cluster detection + per-cluster decisions, all in scan form.

    Returns (word, close_mark, in_cluster, stats): `word` is the packed
    30-bit decision word, meaningful at close positions; the caller
    broadcasts it over members (ops.next_marked, the only right-to-left
    long-range dependency) and applies it with apply_words — the split lets
    the streaming external-memory path (bfqzip_tpu/external.py) run this
    part chunk-by-chunk with carries.
    """
    n_pad = bwt.shape[0]
    pos = ops.iota(n_pad)
    valid = pos < n
    m = cfg.min_cluster

    # ---- bitvectors (bfq_int.cpp:183-300 via the LCP array) ----
    thr = (lcp >= cfg.k) & valid
    lcp_prev = ops.shift_prev(lcp, 0)
    lcp_next = ops.shift_next(lcp, 0)
    minima = (lcp < lcp_prev) & (lcp_next >= lcp) & (pos >= 1) & (pos <= n - 2)
    pred = thr & ~minima

    # ---- eligible runs -> clusters [run_start-1, run_end] ----
    pred_prev = ops.shift_prev(pred, False)
    pred_next = ops.shift_next(pred, False)
    rs_mark = pred & ~pred_prev
    # run has length >= m-1 iff pred holds at its first m-1 positions
    ext = pred
    for t in range(1, max(m - 1, 1)):
        ext = ext & ops.shift_next_k(pred, t, False)
    elig_start = rs_mark & ext
    # propagate eligibility across each run (cummax of start positions)
    run_start = ops.cummax(jnp.where(elig_start, pos, -1))
    in_run_elig = pred & (run_start >= 0) & (run_start <= pos)
    # ... but run_start could point at an older eligible run across a gap;
    # cut at the most recent run boundary:
    last_gap = ops.cummax(jnp.where(~pred, pos, -1))
    in_run_elig = in_run_elig & (run_start > last_gap)

    open_mark = ~pred & ops.shift_next(in_run_elig, False)
    in_cluster = in_run_elig | open_mark
    close_mark = in_run_elig & ~pred_next

    nonterm_pos = (bwt != alphabet.TERM) & (bwt != jnp.uint8(alphabet.SIGMA))
    qt = cfg.quality_threshold + 33

    # ---- per-cluster totals: ONE batched segmented cumsum for the 5 symbol
    # counts + ONE segmented OR for the 21 presence bits (packed into a
    # single word: 0-4 trusted-base presence per ord symbol, 5-20 the
    # (symbol s, predecessor d) pairs of the SNP rule), read at closes ----
    mask_i = in_cluster
    acgt = (alphabet.A, alphabet.C, alphabet.G, alphabet.T)
    X = jnp.stack(
        [mask_i & (bwt == code) for code in _ORD_CODES], axis=0
    ).astype(jnp.int32)  # [5, n]
    S = ops.seg_cumsum(X, open_mark)
    c_freq = [S[o] for o in range(5)]

    pmask = jnp.zeros((n_pad,), jnp.int32)
    for o, code in enumerate(_ORD_CODES):
        pmask = pmask | (((bwt == code) & (qs >= qt)).astype(jnp.int32) << o)
    for si, s in enumerate(acgt):
        for d_i, d in enumerate(acgt):
            pmask = pmask | (((bwt == s) & (pre == d)).astype(jnp.int32) << (5 + 4 * si + d_i))
    ors = ops.seg_cumor(jnp.where(mask_i, pmask, 0), open_mark)
    c_high = [(ors >> o) & 1 for o in range(5)]
    c_u = [[(ors >> (5 + 4 * si + d)) & 1 for d in range(4)] for si in range(4)]

    c_basenum = c_freq[0] + c_freq[1] + c_freq[2] + c_freq[3] + c_freq[4]
    safe_basenum = jnp.maximum(c_basenum, 1)

    # every eligible run has size >= m by construction (runs shorter than m-1
    # are filtered before numbering), so the reference's size check at
    # bfq_int.cpp:422 is a tautology here

    # ---- replacement quality newqs (bfq_int.cpp:307-373,462-473) ----
    if cfg.mode == 2:
        c_newqs = jnp.full((n_pad,), cfg.default_qs, jnp.int32)
    elif cfg.mode == 0:
        c_newqs = ops.seg_cummax(
            jnp.where(mask_i & nonterm_pos, qs.astype(jnp.int32), 0), open_mark
        )
    elif cfg.mode == 3:
        # segment-local i32 sums (no global cumsum: avoids overflow at scale)
        qsum = ops.seg_cumsum(
            jnp.where(mask_i & nonterm_pos, qs.astype(jnp.int32), 0), open_mark
        )
        c_newqs = qsum // safe_basenum
    else:  # mode 1: mean error in the reference's double precision when x64
        # is on (tests/CLI); f32 fallback can differ +-1 on half-boundaries.
        if not jax.config.jax_enable_x64:
            import warnings

            warnings.warn(
                "SmoothConfig(mode=1) without jax_enable_x64: mean-error "
                "quality replacement runs in float32 and can differ +-1 from "
                "the reference's double precision (bfq_int.cpp:357-373). "
                "Set JAX_ENABLE_X64=1 (the CLI default) for exact parity.",
                RuntimeWarning,
                stacklevel=2,
            )
        ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        err = jnp.where(
            nonterm_pos & mask_i,
            jnp.power(ftype(10.0), -(qs.astype(ftype) - 33.0) / 10.0),
            ftype(0.0),
        )
        c_esum = ops.seg_scan(err, open_mark, jnp.add, ftype(0.0))
        avg = c_esum / safe_basenum.astype(ftype)
        # C round(): half away from zero (the argument is always positive here)
        c_newqs = (
            jnp.floor(
                -10.0
                * jnp.log10(jnp.maximum(avg, ftype(1e-300 if ftype == jnp.float64 else 1e-30)))
                + 0.5
            ).astype(jnp.int32)
            + 33
        )

    # ---- frequent symbols (integer percentage, bfq_int.cpp:487-497) ----
    c_isfreq = [
        ((100 * f) // safe_basenum >= cfg.freq_threshold) & (f > 0) for f in c_freq
    ]
    c_nfreq = sum(f.astype(jnp.int32) for f in c_isfreq)
    # first/second frequent symbol in ord order A,C,G,T,N
    c_f0 = jnp.full((n_pad,), 5, jnp.int32)
    c_f1 = jnp.full((n_pad,), -1, jnp.int32)
    for o in range(4, -1, -1):
        c_f0 = jnp.where(c_isfreq[o], o, c_f0)
    for o in range(5):
        c_f1 = jnp.where(c_isfreq[o], o, c_f1)
    codes_arr = list(_ORD_CODES) + [0]  # index 5 -> harmless 0
    c_f0_code = jnp.zeros((n_pad,), jnp.int32)
    c_f1_code = jnp.zeros((n_pad,), jnp.int32)
    for o in range(5):
        c_f0_code = jnp.where(c_f0 == o, codes_arr[o], c_f0_code)
        c_f1_code = jnp.where(jnp.maximum(c_f1, 0) == o, codes_arr[o], c_f1_code)

    c_has_bases = c_basenum > 0

    # single-symbol smoothing applies when:
    #   nf==1 and symbol != N                    (bfq_int.cpp:512-519)
    #   nf==2, base_num >= m, one of them is N   (bfq_int.cpp:528-537)
    c_single1 = c_has_bases & (c_nfreq == 1) & (c_f0 != _N_ORD)
    c_single2 = c_has_bases & (c_nfreq == 2) & (c_basenum >= m) & (c_f1 == _N_ORD)
    c_single = c_single1 | c_single2
    c_two = c_has_bases & (c_nfreq == 2) & (c_basenum >= m) & (c_f1 != _N_ORD)

    # ---- two-frequent-symbol rule: unique distinct predecessors ----
    # presence row of each frequent symbol (codes A=1,C=2,G=3,T=5 -> row 0..3)
    def sel_row(fc):
        rows = []
        for d in range(4):
            r = jnp.zeros((n_pad,), jnp.int32)
            for si, s in enumerate(acgt):
                r = jnp.where(fc == s, (c_u[si][d] > 0).astype(jnp.int32), r)
            rows.append(r)
        return rows

    u0 = sel_row(c_f0_code)
    u1 = sel_row(c_f1_code)
    c_u0sum = u0[0] + u0[1] + u0[2] + u0[3]
    c_u1sum = u1[0] + u1[1] + u1[2] + u1[3]
    pred_codes = (alphabet.A, alphabet.C, alphabet.G, alphabet.T)
    c_p0 = jnp.zeros((n_pad,), jnp.int32)
    c_p1 = jnp.zeros((n_pad,), jnp.int32)
    for d in range(3, -1, -1):
        c_p0 = jnp.where(u0[d] > 0, pred_codes[d], c_p0)
        c_p1 = jnp.where(u1[d] > 0, pred_codes[d], c_p1)
    c_p0 = jnp.where(c_u0sum == 1, c_p0, 0)
    c_p1 = jnp.where(c_u1sum == 1, c_p1, 0)
    c_two_ok = c_two & (c_u0sum == 1) & (c_u1sum == 1) & (c_p0 != c_p1)

    # ---- pack per-cluster decisions into one word at the close position ----
    high_bits = jnp.zeros((n_pad,), jnp.int32)
    for o in range(5):
        high_bits = high_bits | ((c_high[o] > 0).astype(jnp.int32) << (_B_HIGH + o))
    word = (
        c_single.astype(jnp.int32) << _B_SINGLE
        | c_two_ok.astype(jnp.int32) << _B_TWO
        | c_f0_code << _B_SSYM  # ssym == FreqSymb[0] for both single cases
        | c_f0_code << _B_F0
        | c_f1_code << _B_F1
        | c_p0 << _B_P0
        | c_p1 << _B_P1
        | jnp.clip(c_newqs, 0, 255) << _B_NEWQS
        | high_bits
    )
    # ---- counters (bfq_int.cpp:53-65,1004-1020), summed at close marks ----
    c_nnn = sum((f > 0).astype(jnp.int32) for f in c_freq)
    c_disc = c_has_bases & (
        (c_nfreq == 0)
        | ((c_nfreq == 1) & (c_f0 == _N_ORD))
        | ((c_nfreq == 2) & (c_basenum < m))
    )

    def ccount(mask):
        return ops.sum((mask & close_mark).astype(jnp.int32))

    stats = {
        "num_clust": ccount(jnp.ones((n_pad,), bool)),
        "num_clust_discarded": ccount(c_disc),
        "num_clust_amb_discarded": ccount(c_two & ~c_two_ok),
        "num_clust_mod": ccount(c_single2 | c_two_ok),
        "num_clust_alleq": ccount(c_has_bases & (c_nnn == 1)),
        "bases_inside": ops.sum(jnp.where(close_mark, c_basenum, 0)).astype(jnp.int32),
    }
    return word, close_mark, in_cluster, stats


def apply_words(bwt, qs, pre, w, in_cluster, cfg: SmoothConfig) -> tuple:
    """Apply broadcast decision words w to every cluster member (elementwise).

    Returns (bwt_sub, qs_out, modified_mask, smoothed_mask)."""
    n_pad = bwt.shape[0]
    qt = cfg.quality_threshold + 33
    nonterm_pos = (bwt != alphabet.TERM) & (bwt != jnp.uint8(alphabet.SIGMA))
    apply_mask = in_cluster & nonterm_pos
    cl_single = ((w >> _B_SINGLE) & 1) == 1
    cl_two_ok = ((w >> _B_TWO) & 1) == 1
    cl_ssym = ((w >> _B_SSYM) & 7).astype(jnp.uint8)
    cl_f0 = ((w >> _B_F0) & 7).astype(jnp.uint8)
    cl_f1 = ((w >> _B_F1) & 7).astype(jnp.uint8)
    cl_p0 = ((w >> _B_P0) & 7).astype(jnp.uint8)
    cl_p1 = ((w >> _B_P1) & 7).astype(jnp.uint8)
    cl_newqs = ((w >> _B_NEWQS) & 0xFF).astype(jnp.uint8)
    ord_of = jnp.zeros((n_pad,), jnp.int32)
    for code in range(alphabet.SIGMA + 2):
        ord_of = jnp.where(bwt == code, _CODE2ORD[code], ord_of)
    cl_high_own = (w >> (_B_HIGH + ord_of)) & 1

    # single-symbol case (modBasesSmoothQS, bfq_int.cpp:376-405)
    s_act = apply_mask & cl_single
    s_replace = s_act & (bwt != cl_ssym) & (cl_high_own == 0)
    s_qs_const = s_act & (bwt == cl_ssym)
    s_qs_min = s_act & (bwt != cl_ssym) & (cl_high_own == 1) & (cl_newqs < qs)

    # two-frequent case (bfq_int.cpp:568-611)
    t_act = apply_mask & cl_two_ok
    t_isf = (bwt == cl_f0) | (bwt == cl_f1)
    t_candidate = t_act & ~t_isf & (cl_high_own == 0)
    t_rep0 = t_candidate & (pre == cl_p0)
    t_rep1 = t_candidate & (pre == cl_p1) & ~t_rep0
    t_qs_const = t_act & t_isf
    t_qs_min = t_act & ~t_isf & (cl_high_own == 1) & (cl_newqs < qs)

    bwt_sub = jnp.where(s_replace, cl_ssym, bwt)
    bwt_sub = jnp.where(t_rep0, cl_f0, bwt_sub)
    bwt_sub = jnp.where(t_rep1, cl_f1, bwt_sub)
    smoothed = s_qs_const | s_qs_min | t_qs_const | t_qs_min
    qs_out = jnp.where(smoothed, cl_newqs, qs)
    modified = s_replace | t_rep0 | t_rep1
    return bwt_sub, qs_out, modified, smoothed
