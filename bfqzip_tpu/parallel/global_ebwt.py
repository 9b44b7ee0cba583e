"""Sequence-sharded EBWT construction: ONE global suffix sort across devices.

Block parallelism (parallel/block.py) mirrors the reference's scale-out and
pays its compression-ratio cost (independent EBWTs, reference README.md:107).
This module builds a SINGLE EBWT with the read collection sharded over a mesh
axis — the path with no ratio cost, for collections larger than one chip:

  * the padded position space n_pad = N*(L+1) is sharded contiguously
    (row-aligned: each shard owns whole reads);
  * every prefix-doubling round is a distributed sample sort of
    (rank<<31 | rank_ahead+1) 64-bit keys: local sort -> splitter agreement
    (all_gather) -> fixed-capacity bucket exchange (all_to_all) ->
    local merge;
  * rank_ahead needs only a halo exchange with the next shard (ppermute),
    because position shards are contiguous;
  * dense re-ranking is a local scan + an exclusive shard-offset scan
    (all_gather of counts), then ranks are routed back to their
    position shards by a second bucket exchange — the distributed analog of
    the single-chip scatter;
  * BWT/QS extraction and LCP lifting use a generic routed global gather
    (requests grouped by target shard, two all_to_alls).

This is the device equivalent of upgrading the reference's external-memory pile
partitioning (bfq_ext.cpp:190-348) from 6 static disk piles to D dynamic
device shards.  x64 must be enabled (64-bit sort keys).

Sorted-order outputs (bwt, qs, lcp) come back as fixed-capacity per-shard
buffers plus counts (sample sort balances only approximately); the host-side
wrapper compacts them.  Bucket overflows are reported, never silent — the
wrapper retries with doubled capacity.

The collective toolbox (_make_ctx: bucket exchange, routed gather/scatter,
exact rebalance) and the sort body (_sort_body) are shared with the full
sequence-sharded pipeline in parallel/global_pipeline.py.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from bfqzip_tpu import alphabet
from bfqzip_tpu.ops.suffix import PACK, SPAN0, _EXT, _pack_word, _window_codes

I64_MAX = jnp.int64(jnp.iinfo(jnp.int64).max)


class ShardedEbwt(NamedTuple):
    bwt: np.ndarray  # [n] u8 codes (compacted on host)
    qs: np.ndarray  # [n] u8
    lcp: np.ndarray  # [n] i32
    sa: np.ndarray  # [n] i32 suffix positions in the padded layout
    n: int
    overflow: int  # total bucket overflow across all exchanges (0 == exact)


def _spans10(wp: int):
    spans = [PACK]
    while spans[-1] < wp:
        spans.append(spans[-1] * 2)
    return spans


def pad_reads_to_multiple(seqs, quals, lengths, d):
    """Pad the read count to a multiple of d with zero-length rows (pure
    padding: no terminator, sorts last, trimmed from every output)."""
    n_reads = seqs.shape[0]
    if n_reads % d:
        pad = d - n_reads % d
        seqs = np.concatenate([seqs, np.zeros((pad, seqs.shape[1]), seqs.dtype)])
        quals = np.concatenate([quals, np.zeros((pad, seqs.shape[1]), quals.dtype)])
        lengths = np.concatenate([lengths, np.zeros((pad,), lengths.dtype)])
    return seqs, quals, lengths


def build_ebwt_sharded(seqs, quals, lengths, mesh: Mesh, axis: str = "seq",
                       capacity_factor: float = 2.5) -> ShardedEbwt:
    """Host wrapper: returns the global EBWT of the collection, built with the
    reads sharded over `axis`.  Requires x64 (i64 sort keys).  Read counts not
    divisible by the axis size are padded with zero-length rows.  Sample-sort
    bucket overflow triggers a retry with doubled capacity instead of failing."""
    if not jax.config.jax_enable_x64:
        raise RuntimeError("build_ebwt_sharded requires jax_enable_x64 (64-bit sort keys)")
    d = mesh.shape[axis]
    seqs, quals, lengths = pad_reads_to_multiple(seqs, quals, lengths, d)
    n_reads, width = seqs.shape
    wp = width + 1
    n_pad = n_reads * wp
    m = n_pad // d  # positions per shard

    for attempt in range(3):
        cap_sorted = int(capacity_factor * m) + 64  # sorted-order shard buffers
        fn = _make_kernel(mesh, axis, d, n_reads, width, m, cap_sorted)
        out = fn(jnp.asarray(seqs), jnp.asarray(quals), jnp.asarray(lengths))
        bwt_b, qs_b, lcp_b, sa_b, counts, overflow, n = map(np.asarray, out)
        if int(overflow.sum()) == 0:
            break
        capacity_factor *= 2  # retry with more headroom (last result kept)

    parts = {0: [], 1: [], 2: [], 3: []}
    for i in range(d):
        c = int(counts[i])
        for j, buf in enumerate((bwt_b, qs_b, lcp_b, sa_b)):
            parts[j].append(buf[i * cap_sorted : i * cap_sorted + c])
    bwt, qs, lcp, sa = (np.concatenate(parts[j]) for j in range(4))
    # padding suffixes sort last globally; the real EBWT is the first n entries
    n = int(n)
    bwt, qs, lcp, sa = bwt[:n], qs[:n], lcp.astype(np.int32)[:n], sa.astype(np.int32)[:n]
    lcp[0] = 0
    return ShardedEbwt(bwt=bwt, qs=qs, lcp=lcp, sa=sa,
                       n=n, overflow=int(overflow.sum()))


def _make_ctx(axis: str, d: int, m: int, n_pad: int, cap_sorted: int,
              rebalance_cap: int | None = None):
    """Collective toolbox bound to one mesh axis: everything the distributed
    sort, gather, scatter and rebalance need, as closures over static sizes."""
    cap_x = int(2.5 * (cap_sorted // d)) + 64  # per-pair exchange capacity
    # rebalance drift per (src, tgt) pair is bounded by the sample-sort
    # imbalance (few % of m in practice); overflow is reported, never silent
    cap_off = rebalance_cap if rebalance_cap is not None else m // 4 + 1024
    next_perm = [(i, (i - 1) % d) for i in range(d)]  # receive from next shard
    prev_perm = [(i, (i + 1) % d) for i in range(d)]

    def a2a(x):
        return jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=True)

    def shard_id():
        return jax.lax.axis_index(axis)

    def halo_next(x, h):
        """x[g+h] for local positions (h < m); out-of-range -> -1."""
        nxt = jax.lax.ppermute(x[:h], axis, next_perm)  # first h of next shard
        shifted = jnp.concatenate([x[h:], nxt])
        base = shard_id().astype(jnp.int64) * m
        gidx = base + jnp.arange(m, dtype=jnp.int64)
        return jnp.where(gidx + h < n_pad, shifted, -1)

    def shard_offset(count):
        """Exclusive prefix over shards of a per-shard scalar."""
        all_c = jax.lax.all_gather(count, axis)  # [d]
        me = shard_id()
        return jnp.sum(jnp.where(jnp.arange(d) < me, all_c, 0)), all_c

    def prev_valid_halo(vals, count):
        """Last element of the NEAREST NONEMPTY preceding shard for each
        array in `vals` (scalars), plus a has-predecessor flag.

        A plain ppermute halo reads the immediate neighbour's sentinel when
        that shard received zero elements (extreme splitter skew), silently
        corrupting adjacent-row LCPs and dense ranks; this chains across
        empty shards instead.  has_prev is False on shard 0 and when every
        preceding shard is empty — callers must fall back explicitly."""
        has = jax.lax.all_gather(count > 0, axis)  # [d]
        sid = jnp.arange(d, dtype=jnp.int32)
        me = shard_id().astype(jnp.int32)
        pidx = jnp.max(jnp.where(has & (sid < me), sid, -1))
        rows = []
        for v in vals:
            g = jax.lax.all_gather(v[jnp.maximum(count - 1, 0)], axis)  # [d]
            rows.append(g[jnp.maximum(pidx, 0)])
        return rows, pidx >= 0

    def bucket_exchange(sort_key, payloads, bucket_of, cap):
        """Group local elements by bucket_of (values in [0,d)), exchange.

        Elements must already be sorted by bucket (sort_key sorted ascending
        and bucket_of monotone in it).  Returns (received payloads [d*cap],
        valid mask, overflow count)."""
        mm = sort_key.shape[0]
        buckets = jnp.arange(d, dtype=jnp.int32)
        starts = jnp.searchsorted(bucket_of, buckets, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(bucket_of, buckets, side="right").astype(jnp.int32)
        cnt = ends - starts
        overflow = jnp.sum(jnp.maximum(cnt - cap, 0))
        cols = jnp.arange(cap, dtype=jnp.int32)[None, :]
        src = jnp.minimum(starts[:, None] + cols, mm - 1)
        sel = cols < jnp.minimum(cnt, cap)[:, None]
        recv = []
        for p, sentinel in payloads:
            send = jnp.where(sel, p[src], sentinel)
            recv.append(a2a(send).reshape(-1))
        vmask = a2a(sel).reshape(-1)
        return recv, vmask, overflow

    def dsort(key, pos):
        """Distributed sort by i64 key; returns sorted-order shard buffers
        (key, pos, valid, count, overflow)."""
        k_s, p_s = jax.lax.sort((key, pos), num_keys=1)
        step = max(m // d, 1)
        samples = k_s[jnp.arange(d, dtype=jnp.int32) * step]
        alls = jnp.sort(jax.lax.all_gather(samples, axis).reshape(-1))
        spl = alls[jnp.arange(1, d, dtype=jnp.int64) * d]
        bucket = jnp.searchsorted(spl, k_s, side="right").astype(jnp.int32)
        (rk, rp), vmask, ovf = bucket_exchange(
            k_s, [(k_s, I64_MAX), (p_s, jnp.int32(-1))], bucket, cap_sorted // d + 64
        )
        # local merge; sentinels sort last
        rk = jnp.where(vmask, rk, I64_MAX)
        ks, ps = jax.lax.sort((rk, rp), num_keys=1)
        count = jnp.sum(vmask.astype(jnp.int32))
        # pad/trim to cap_sorted (valid elements beyond it are overflow)
        ovf = ovf + jnp.maximum(count - cap_sorted, 0)
        count = jnp.minimum(count, cap_sorted)
        ks = ks[:cap_sorted] if ks.shape[0] >= cap_sorted else jnp.pad(ks, (0, cap_sorted - ks.shape[0]), constant_values=I64_MAX)
        ps = ps[:cap_sorted] if ps.shape[0] >= cap_sorted else jnp.pad(ps, (0, cap_sorted - ps.shape[0]), constant_values=-1)
        return ks, ps, count, ovf

    def dense_rank_to_positions(ks, ps, count):
        """Dense-rank the sorted-order keys and route ranks back to the
        position-sharded layout.  Returns (rank_l [m], overflow)."""
        valid = jnp.arange(cap_sorted) < count
        (prev_last,), has_prev = prev_valid_halo([ks], count)
        prev_key = jnp.concatenate([prev_last[None], ks[:-1]])
        changed = (ks != prev_key) & valid
        # no valid predecessor anywhere before this shard -> first key is new
        changed = changed.at[0].set((~has_prev & valid[0]) | changed[0])
        local_rank = jnp.cumsum(changed.astype(jnp.int64), dtype=jnp.int64) - 1
        nuniq = jnp.maximum(local_rank[jnp.maximum(count - 1, 0)] + 1, 0)
        nuniq = jnp.where(count > 0, nuniq, 0)
        off, _ = shard_offset(nuniq)
        dense = (local_rank + off).astype(jnp.int64)
        # route (pos, dense) by pos // m; elements must be grouped by target:
        tgt = jnp.where(valid, (ps // m).astype(jnp.int32), d)  # invalid -> last+
        order = jnp.argsort(tgt, stable=True).astype(jnp.int32)
        tgt_s = tgt[order]
        ps_s = ps[order]
        dn_s = dense[order]
        (rpos, rdn), vmask, ovf = bucket_exchange(
            tgt_s, [(ps_s, jnp.int32(-1)), (dn_s, jnp.int64(-1))],
            tgt_s, cap_x,
        )
        base = shard_id().astype(jnp.int64) * m
        slot = jnp.where(vmask & (rpos >= 0), rpos.astype(jnp.int64) - base, m)
        rank_l = jnp.zeros((m,), jnp.int64).at[slot].set(
            jnp.where(vmask, rdn, 0), mode="drop"
        )
        return rank_l, ovf

    def global_gather(val_l, gidx, sentinel):
        """val[gidx] for arbitrary global indices (out-of-range -> sentinel)."""
        mm = gidx.shape[0]
        ok = (gidx >= 0) & (gidx < n_pad)
        tgt = jnp.where(ok, (gidx // m).astype(jnp.int32), d)
        order = jnp.argsort(tgt, stable=True).astype(jnp.int32)
        tgt_s = tgt[order]
        g_s = gidx[order].astype(jnp.int64)
        slot_s = order.astype(jnp.int32)  # original slot to restore later
        (rg, rslot), vmask, ovf = bucket_exchange(
            tgt_s, [(g_s, jnp.int64(-1)), (slot_s, jnp.int32(-1))], tgt_s, cap_x
        )
        base = shard_id().astype(jnp.int64) * m
        lidx = jnp.clip(rg - base, 0, m - 1)
        vals = val_l[lidx]
        # respond: the recv layout [d, cap_x] routes straight back with a2a
        resp_v = a2a(vals.reshape(d, cap_x))
        resp_slot = a2a(rslot.reshape(d, cap_x))
        resp_ok = a2a(vmask.reshape(d, cap_x))
        out = jnp.full((mm,), sentinel, vals.dtype)
        flat_slot = jnp.where(resp_ok.reshape(-1), resp_slot.reshape(-1), mm)
        out = out.at[flat_slot].set(resp_v.reshape(-1), mode="drop")
        return jnp.where(ok, out, sentinel), ovf

    def global_scatter(vals, gidx, init):
        """Route vals[j] to global position gidx[j]; returns this shard's [m]
        received values (init where nothing lands).  Global positions must be
        unique across shards for a deterministic result."""
        tgt = jnp.clip((gidx // m).astype(jnp.int32), 0, d - 1)
        order = jnp.argsort(tgt, stable=True).astype(jnp.int32)
        (rg, rv), vmask, ovf = bucket_exchange(
            tgt[order], [(gidx[order].astype(jnp.int64), jnp.int64(-1)),
                         (vals[order], init)], tgt[order], cap_x
        )
        base = shard_id().astype(jnp.int64) * m
        slot = jnp.where(vmask & (rg >= 0), rg - base, m)
        out = jnp.full((m,), init, vals.dtype).at[slot].set(rv, mode="drop")
        return out, ovf

    def rebalance(count, payloads):
        """Exact redistribution of the sorted-order shard buffers (valid
        prefix `count` of cap_sorted slots, globally contiguous) to the even
        layout where shard s holds global sorted ranks [s*m, (s+1)*m).

        The diagonal (elements already on their target shard) is placed
        locally; only the drift (|count - m| scale) rides a bucket exchange.
        Returns ([m] array per payload, overflow)."""
        me = shard_id()
        off, _ = shard_offset(count)
        slot_valid = jnp.arange(cap_sorted) < count
        grank = off.astype(jnp.int64) + jnp.arange(cap_sorted, dtype=jnp.int64)
        tgt = jnp.where(slot_valid, (grank // m).astype(jnp.int32), d)
        onme = slot_valid & (tgt == me)
        lslot = jnp.where(onme, grank - me.astype(jnp.int64) * m, m)
        outs = []
        ovf_total = jnp.zeros((), jnp.int32)
        # off-diagonal elements, grouped by target (grank is monotone, so the
        # masked-out diagonal keeps the residue grouped after argsort)
        tgt_off = jnp.where(slot_valid & ~onme, tgt, d)
        order = jnp.argsort(tgt_off, stable=True).astype(jnp.int32)
        (rg,), vmask, ovf = bucket_exchange(
            tgt_off[order], [(grank[order], jnp.int64(-1))], tgt_off[order], cap_off
        )
        ovf_total += ovf.astype(jnp.int32)
        rslot = jnp.where(vmask & (rg >= 0), rg - me.astype(jnp.int64) * m, m)
        for p, init in payloads:
            out = jnp.full((m,), init, p.dtype).at[lslot].set(p, mode="drop")
            (rv,), vm2, _ = bucket_exchange(
                tgt_off[order], [(p[order], init)], tgt_off[order], cap_off
            )
            out = out.at[jnp.where(vm2, rslot, m)].set(rv, mode="drop")
            outs.append(out)
        return outs, ovf_total

    return SimpleNamespace(
        axis_name=axis, d=d, m=m, n_pad=n_pad, cap_sorted=cap_sorted, cap_x=cap_x,
        a2a=a2a, shard_id=shard_id, halo_next=halo_next,
        shard_offset=shard_offset, bucket_exchange=bucket_exchange,
        dsort=dsort, dense_rank_to_positions=dense_rank_to_positions,
        global_gather=global_gather, global_scatter=global_scatter,
        rebalance=rebalance, prev_valid_halo=prev_valid_halo,
    )


PACK6_64 = 24  # base-6 digits per i64 key word (6^24 < 2^62)
MAX_FLAT_WORDS64 = 5  # flat path covers windows up to 120 symbols


def _sort_body(ctx, n_reads, width, seqs_l, quals_l, lens_l):
    """Dispatch: whole-window flat sort for production read lengths, prefix
    doubling beyond the 5-word pack budget (mirrors ops/suffix.build_ebwt)."""
    if width + 1 <= PACK6_64 * MAX_FLAT_WORDS64:
        return _sort_body_flat(ctx, n_reads, width, seqs_l, quals_l, lens_l)
    return _sort_body_doubling(ctx, n_reads, width, seqs_l, quals_l, lens_l)


def _sort_body_flat(ctx, n_reads, width, seqs_l, quals_l, lens_l):
    """ONE distributed multiword sample sort of whole-window packed keys.

    The round-2 single-chip lesson (ops/suffix._build_ebwt_flat) ported to the
    mesh: the ENTIRE (wp<=120)-symbol suffix window packs into <=5 base-6 i64
    words, so suffix order is one sample sort — local variadic sort, splitter
    agreement on full key ROWS, one bucket exchange, local merge.  Replaces
    round-0 + 4 doubling rounds (each 2 distributed sorts + rank routing) of
    the doubling path with ONE round and NO rank arrays; BWT/QS and the
    smoother's predecessor symbols ride the exchange as one packed payload
    (no routed gathers), and the LCP is elementwise on adjacent sorted rows
    plus a one-row halo.  Suffix position is the last sort key, so ties
    resolve in global position order == gsufsort's read-index convention.
    """
    m, d, n_pad, cap_sorted = ctx.m, ctx.d, ctx.n_pad, ctx.cap_sorted
    wp = width + 1
    nl = m // wp
    me = ctx.shard_id()
    base = me.astype(jnp.int64) * m
    n_words = -(-wp // PACK6_64)
    overflow = jnp.zeros((), jnp.int32)

    lensl = lens_l.astype(jnp.int32)
    k = jnp.arange(wp, dtype=jnp.int32)[None, :]
    is_pad = ((k > lensl[:, None]) | (lensl[:, None] <= 0)).reshape(-1)

    # ---- whole-window base-6 keys (digits 0..5; 0 = terminator/pad) ----
    ext = PACK6_64 * n_words
    kk = jnp.arange(wp + ext, dtype=jnp.int32)[None, :]
    base6 = jnp.pad(seqs_l, ((0, 0), (0, 1 + ext))).astype(jnp.uint8)
    wcodes = jnp.where(kk < lensl[:, None], base6, jnp.uint8(0))

    def pack24(word):
        o = PACK6_64 * word
        acc = jnp.zeros((nl, wp), jnp.int64)
        for t in range(PACK6_64):
            acc = acc * 6 + wcodes[:, o + t : o + t + wp].astype(jnp.int64)
        return acc.reshape(-1)

    words = [pack24(w) for w in range(n_words)]
    # padding suffixes sort after every real window (real word0 < 6^24)
    words[0] = jnp.where(is_pad, jnp.int64(6**PACK6_64), words[0])

    # ---- payload: (prev symbol, prev quality, prev^2 symbol), with the
    # cross-shard predecessors from a cyclic one/two-element halo ----
    text_l = jnp.where(
        (k < lensl[:, None]),
        jnp.pad(seqs_l, ((0, 0), (0, 1))).astype(jnp.uint8) + 1,
        jnp.uint8(0),
    ).reshape(-1)
    qtext_l = jnp.pad(quals_l, ((0, 0), (0, 1))).reshape(-1)
    from_prev = [(i, (i + 1) % d) for i in range(d)]
    tail2 = jax.lax.ppermute(text_l[m - 2 :], ctx.axis_name, from_prev)
    qtail = jax.lax.ppermute(qtext_l[m - 1 :], ctx.axis_name, from_prev)
    p1 = jnp.concatenate([tail2[1:], text_l[:-1]])
    p2 = jnp.concatenate([tail2, text_l[:-2]])
    q1 = jnp.concatenate([qtail, qtext_l[:-1]])
    aux = (
        p1.astype(jnp.int32)
        | (q1.astype(jnp.int32) << 3)
        | (p2.astype(jnp.int32) << 11)
    )

    pos = (base + jnp.arange(m, dtype=jnp.int64)).astype(jnp.int32)

    # ---- distributed multiword sample sort ----
    # pos is the final key -> total order, so the unstable comparator is
    # safe and faster (same argument as ops/suffix.py's flat sort)
    srt = jax.lax.sort((*words, pos, aux), num_keys=n_words + 1, is_stable=False)
    kw, ps, ax = srt[:n_words], srt[-2], srt[-1]

    step = max(m // d, 1)
    sample_idx = jnp.arange(d, dtype=jnp.int32) * step
    # splitter ROWS (all words + pos jointly sorted, not per-word sorts)
    samples = [jax.lax.all_gather(w[sample_idx], ctx.axis_name).reshape(-1)
               for w in kw + (ps,)]
    samples = jax.lax.sort(tuple(samples), num_keys=n_words + 1)
    spl_idx = jnp.arange(1, d, dtype=jnp.int32) * d
    spl = [s[spl_idx] for s in samples]  # [d-1] per word (+pos)

    bucket = jnp.zeros((m,), jnp.int32)
    for s in range(d - 1):
        gt = jnp.zeros((m,), bool)
        eq = jnp.ones((m,), bool)
        for w in range(n_words):
            gt = gt | (eq & (kw[w] > spl[w][s]))
            eq = eq & (kw[w] == spl[w][s])
        gt = gt | (eq & (ps > spl[n_words][s]))
        bucket = bucket + gt.astype(jnp.int32)

    payloads = [(w, I64_MAX) for w in kw] + [(ps, jnp.int32(-1)), (ax, jnp.int32(0))]
    recv, vmask, ovf = ctx.bucket_exchange(bucket, payloads, bucket,
                                           cap_sorted // d + 64)
    overflow += ovf
    rw = [jnp.where(vmask, r, I64_MAX) for r in recv[:n_words]]
    rp = jnp.where(vmask, recv[n_words], jnp.iinfo(jnp.int32).max)
    ra = recv[n_words + 1]
    # ties exist only among invalid lanes (all-sentinel keys), whose relative
    # order is never observed past `count` — unstable is safe
    srt = jax.lax.sort((*rw, rp, ra), num_keys=n_words + 1, is_stable=False)
    kws, sa, axs = srt[:n_words], srt[-2], srt[-1]
    count = jnp.sum(vmask.astype(jnp.int32))
    overflow += jnp.maximum(count - cap_sorted, 0)
    count = jnp.minimum(count, cap_sorted)

    def fit(x, sentinel):
        if x.shape[0] >= cap_sorted:
            return x[:cap_sorted]
        return jnp.pad(x, (0, cap_sorted - x.shape[0]), constant_values=sentinel)

    kws = [fit(w, I64_MAX) for w in kws]
    sa = fit(sa, jnp.int32(-1))
    axs = fit(axs, jnp.int32(0))
    slot_valid = jnp.arange(cap_sorted) < count

    # ---- BWT / QS / predecessor from the payload ----
    cprev = (axs & 7).astype(jnp.uint8)
    is_term = cprev == 0
    bwt_s = jnp.where(is_term, jnp.uint8(alphabet.TERM), cprev - 1)
    qs_s = jnp.where(is_term, jnp.uint8(alphabet.TERM_CHAR),
                     ((axs >> 3) & 0xFF).astype(jnp.uint8))
    c2 = ((axs >> 11) & 7).astype(jnp.uint8)
    pre_s = jnp.where(c2 == 0, jnp.uint8(alphabet.TERM), c2 - 1)
    bwt_s = jnp.where(slot_valid, bwt_s, jnp.uint8(alphabet.SIGMA))
    qs_s = jnp.where(slot_valid, qs_s, jnp.uint8(0))

    # ---- LCP: leading equal nonzero digits of adjacent sorted rows ----
    # halo = last row of the nearest NONEMPTY preceding shard (a direct
    # neighbour halo would read the I64_MAX pad sentinel across empty shards)
    prev_rows, has_prev = ctx.prev_valid_halo(kws, count)
    lcp_s = jnp.zeros((cap_sorted,), jnp.int32)
    eq = jnp.ones((cap_sorted,), bool)
    nz = jnp.ones((cap_sorted,), bool)
    for w in range(n_words):
        bw = kws[w]
        aw = jnp.concatenate([prev_rows[w][None], bw[:-1]])
        for t in range(PACK6_64):
            div = jnp.int64(6 ** (PACK6_64 - 1 - t))
            da = (aw // div) % 6
            db = (bw // div) % 6
            eq = eq & (da == db)
            nz = nz & (da != 0)
            lcp_s = lcp_s + (eq & nz).astype(jnp.int32)
    lcp_s = jnp.where(slot_valid, lcp_s, 0)
    lcp_s = jnp.where(~has_prev & (jnp.arange(cap_sorted) == 0), 0, lcp_s)

    axis = ctx.axis_name
    n_valid_reads = jax.lax.psum(jnp.sum((lensl > 0).astype(jnp.int64)), axis)
    n = jax.lax.psum(jnp.sum(jnp.maximum(lensl, 0), dtype=jnp.int64), axis) + n_valid_reads
    overflow = jax.lax.psum(overflow, axis)
    return SimpleNamespace(
        bwt=bwt_s, qs=qs_s, lcp=lcp_s, sa=sa, count=count,
        text=text_l, qtext=qtext_l, n=n, overflow=overflow, pre=pre_s,
    )


def _sort_body_doubling(ctx, n_reads, width, seqs_l, quals_l, lens_l):
    """Distributed EBWT sort body (runs inside shard_map): returns per-shard
    sorted-order buffers (bwt, qs, lcp, sa) + count, plus the local text/qs
    arrays in position layout, the total length n, and the overflow count."""
    m, d, n_pad, cap_sorted = ctx.m, ctx.d, ctx.n_pad, ctx.cap_sorted
    wp = width + 1
    nl = m // wp  # reads per shard
    spans = _spans10(wp)
    me = ctx.shard_id()
    rid0 = me.astype(jnp.int32) * nl
    base = me.astype(jnp.int64) * m
    overflow = jnp.zeros((), jnp.int32)

    wcodes = _window_codes(seqs_l, lens_l)  # [nl, wp+_EXT]
    w0 = _pack_word(wcodes, wp, 0).reshape(-1)  # span-10 word, local
    lensl = lens_l.astype(jnp.int32)
    k = jnp.arange(wp, dtype=jnp.int32)[None, :]
    rid = rid0 + jnp.arange(nl, dtype=jnp.int32)[:, None]
    # zero-length rows are divisibility padding: every position is pad
    is_pad2 = (k > lensl[:, None]) | (lensl[:, None] <= 0)
    term_near = (lensl[:, None] - k >= 0) & (lensl[:, None] - k < PACK)
    tb2 = jnp.where(term_near, rid + 1, 0).astype(jnp.int64)
    g_local = base + jnp.arange(m, dtype=jnp.int64)
    tb = jnp.where(is_pad2, n_reads + 1 + g_local.reshape(nl, wp), tb2).reshape(-1)
    w0m = jnp.where(is_pad2.reshape(-1), jnp.int64(2**30), w0.astype(jnp.int64))
    key = (w0m << 32) | tb  # span-10 + read-index tie-break

    pos = g_local.astype(jnp.int32)
    ks, ps, count, ovf = ctx.dsort(key, pos)
    overflow += ovf
    rank_l, ovf = ctx.dense_rank_to_positions(ks, ps, count)
    overflow += ovf

    ranks = [rank_l]
    for i, h in enumerate(spans[:-1]):
        ra = ctx.halo_next(rank_l, h)
        key = (rank_l << 31) | (ra + 2)
        ks, ps, count, ovf = ctx.dsort(key, pos)
        overflow += ovf
        if i + 1 < len(spans) - 1:
            rank_l, ovf = ctx.dense_rank_to_positions(ks, ps, count)
            overflow += ovf
            ranks.append(rank_l)

    # ---- BWT / QS in sorted order (per-shard buffers + count) ----
    text_l = jnp.where(
        (k < lensl[:, None]),
        jnp.pad(seqs_l, ((0, 0), (0, 1))).astype(jnp.uint8) + 1,
        jnp.uint8(0),
    ).reshape(-1)
    qtext_l = jnp.pad(quals_l, ((0, 0), (0, 1))).reshape(-1)
    sa = ps  # sorted-order suffix positions (valid under count)
    slot_valid = jnp.arange(cap_sorted) < count
    # invalid slots must not generate gather traffic (ps == -1 would wrap
    # to n_pad-2 and flood the last shard's buckets)
    prev = jnp.where(slot_valid, (sa.astype(jnp.int64) - 1) % n_pad, jnp.int64(-1))
    cprev, ovf = ctx.global_gather(text_l, prev, jnp.uint8(0))
    overflow += ovf
    qprev, ovf = ctx.global_gather(qtext_l, prev, jnp.uint8(0))
    overflow += ovf
    is_term = cprev == 0
    bwt_s = jnp.where(is_term, jnp.uint8(alphabet.TERM), cprev - 1)
    qs_s = jnp.where(is_term, jnp.uint8(alphabet.TERM_CHAR), qprev)

    # ---- LCP in sorted order ----
    # halo from the nearest NONEMPTY preceding shard (empty shards pad sa
    # with -1; comparing against that would zero a genuinely nonzero LCP)
    (prev_sa,), has_prev = ctx.prev_valid_halo([sa], count)
    far = jnp.int64(-(2**40))  # keeps a+h negative for any offset h
    a = jnp.where(slot_valid, jnp.concatenate([prev_sa[None], sa[:-1]]).astype(jnp.int64), far)
    # position 0 of the globally-first nonempty shard has no predecessor
    a = jnp.where((jnp.arange(cap_sorted) == 0) & ~has_prev, far, a)
    b = jnp.where(slot_valid, sa.astype(jnp.int64), far)
    h = jnp.zeros((cap_sorted,), jnp.int64)
    for span, r in zip(reversed(spans[:-1]), reversed(ranks)):
        va, ovf = ctx.global_gather(r, a + h, jnp.int64(-1)); overflow += ovf
        vb, ovf = ctx.global_gather(r, b + h, jnp.int64(-2)); overflow += ovf
        same = (va == vb) & (va >= 0)
        h = jnp.where(same, h + span, h)
    # remainder < PACK from the packed words
    pa, ovf = ctx.global_gather(w0.astype(jnp.int64), a + h, jnp.int64(-1)); overflow += ovf
    pb, ovf = ctx.global_gather(w0.astype(jnp.int64), b + h, jnp.int64(-2)); overflow += ovf
    rem = jnp.zeros((cap_sorted,), jnp.int64)
    nz = jnp.ones((cap_sorted,), bool)
    eq = jnp.ones((cap_sorted,), bool)
    for j in range(1, PACK + 1):
        sh = 3 * (PACK - j)
        eq = eq & ((pa >> sh) == (pb >> sh))
        nz = nz & (((pa >> sh) & 7) != 0)
        rem = rem + (eq & nz).astype(jnp.int64)
    lcp_s = (h + rem).astype(jnp.int32)
    lcp_s = jnp.where(~has_prev & (jnp.arange(cap_sorted) == 0), 0, lcp_s)

    axis = ctx.axis_name
    n_valid_reads = jax.lax.psum(jnp.sum((lensl > 0).astype(jnp.int64)), axis)
    n = jax.lax.psum(jnp.sum(lensl, dtype=jnp.int64), axis) + n_valid_reads
    overflow = jax.lax.psum(overflow, axis)
    return SimpleNamespace(
        bwt=bwt_s, qs=qs_s, lcp=lcp_s, sa=sa, count=count,
        text=text_l, qtext=qtext_l, n=n, overflow=overflow,
    )


def _make_kernel(mesh, axis, d, n_reads, width, m, cap_sorted):
    wp = width + 1
    n_pad = n_reads * wp
    ctx = _make_ctx(axis, d, m, n_pad, cap_sorted)
    spec = P(axis)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec, spec, spec, spec, P()),
    )
    def kernel(seqs_l, quals_l, lens_l):
        r = _sort_body(ctx, n_reads, width, seqs_l, quals_l, lens_l)
        return (
            r.bwt[None],
            r.qs[None],
            r.lcp[None],
            r.sa[None],
            r.count[None],
            r.overflow[None],
            r.n,
        )

    jitted = jax.jit(kernel)

    def run(seqs_j, quals_j, lens_j):
        b, q, l, sa_, c, o, n = jitted(seqs_j, quals_j, lens_j)
        return (b.reshape(-1), q.reshape(-1), l.reshape(-1), sa_.reshape(-1),
                c.reshape(-1), o.reshape(-1), n)

    return run
