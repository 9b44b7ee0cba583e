// External-memory stage-1 merge: k-way interleave of per-chunk suffix orders.
//
// The out-of-core pipeline (bfqzip_tpu/external.py) sorts each read chunk's
// suffixes on the device (bounded device memory) and merges the chunk orders here on the
// host — the role eGap's disk-based merge plays for the reference
// (BFQzip_ext.py:172-177; eGap --em --mem).  The merge never materialises
// suffix keys: the comparator walks the text directly (0 = terminator/pad
// sorts below every base, content ties break by read index = position,
// matching ops/suffix.py's distinct-terminator convention), so the only
// device->host transfer is each chunk's suffix-position array.
//
// Parallel strategy (the OMP pattern of the reference's analogous phase,
// src_ext_mem/decode.cpp:561-643): sample suffixes from every chunk, sort
// the sample, pick T-1 splitter suffixes, locate each splitter in every
// chunk with a partition_point binary search — that partitions the OUTPUT
// into T contiguous ranges merged independently on threads.  The T-1
// boundary LCPs (each thread starts blind to its predecessor's last suffix)
// are fixed up serially afterwards.  Comparisons are word-wise: 8 text
// bytes per step with bit tricks for the first mismatch / terminator.
//
// Outputs per merged position: BWT symbol (text[g-1], 0 -> TERM), permuted
// quality, 1-byte LCP against the previous merged suffix (capped at 255 —
// the reference's eGap --lbytes 1 convention, BFQzip_ext.py:29-32), the
// smoothing predecessor text[g-2], and the suffix position itself.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kTermCode = 0;   // alphabet.TERM
constexpr uint8_t kTermChar = '#'; // alphabet.TERM_CHAR

inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

// 0x80 in every byte of v that is 0x00 (classic SWAR zero-byte detector)
inline uint64_t zero_bytes(uint64_t v) {
    return (v - 0x0101010101010101ull) & ~v & 0x8080808080808080ull;
}

// suffix comparator on the padded text; 0 stops a row (terminator/pad).
// Every row ends with at least one 0 inside the array (k = wp-1 is always
// pad), so the byte tail loop cannot run off the end; the word loop is
// additionally bounds-guarded for its 8-byte loads.
inline bool suffix_less(const uint8_t* text, int64_t n_pad, int64_t a, int64_t b) {
    if (a == b) return false;
    const uint8_t* pa = text + a;
    const uint8_t* pb = text + b;
    int64_t lim = n_pad - (a > b ? a : b);  // bytes both sides can load
    int64_t i = 0;
    while (i + 8 <= lim) {
        uint64_t va = load64(pa + i), vb = load64(pb + i);
        uint64_t diff = va ^ vb;
        uint64_t term = zero_bytes(va);
        if (!(diff | term)) { i += 8; continue; }
        // first interesting byte: a mismatch or a's terminator, whichever
        // comes first (little-endian: lowest set bit = earliest byte)
        int dj = diff ? __builtin_ctzll(diff) >> 3 : 8;
        int zj = term ? __builtin_ctzll(term) >> 3 : 8;
        int j = dj < zj ? dj : zj;
        uint8_t ca = pa[i + j], cb = pb[i + j];
        if (ca != cb) return ca < cb;
        // equal terminators: same in-read offset -> position order
        return a < b;
    }
    pa += i; pb += i;
    while (*pa != 0 && *pa == *pb) { pa++; pb++; }
    if (*pa != *pb) return *pa < *pb;
    return a < b;
}

inline uint8_t lcp255(const uint8_t* text, int64_t n_pad, int64_t a, int64_t b) {
    const uint8_t* pa = text + a;
    const uint8_t* pb = text + b;
    int64_t lim = n_pad - (a > b ? a : b);
    if (lim > 255 + 8) lim = 255 + 8;
    int64_t i = 0;
    while (i + 8 <= lim && i < 255) {
        uint64_t va = load64(pa + i), vb = load64(pb + i);
        uint64_t stop = (va ^ vb) | zero_bytes(va);
        if (!stop) { i += 8; continue; }
        i += __builtin_ctzll(stop) >> 3;
        return (uint8_t)(i < 255 ? i : 255);
    }
    while (i < 255 && pa[i] != 0 && pa[i] == pb[i]) i++;
    return (uint8_t)i;
}

// TIdx = int32_t for workloads under 2^31 positions, int64_t beyond (the
// reference's dataTypeNChar=ulong analog, parameters.h:60-106: 50M x 101bp
// reads already exceed int32 global positions).
template <typename TIdx>
struct Cursor {
    const TIdx* p;
    const TIdx* end;
    const uint8_t* lcp;  // intra-chunk LCP of *p vs its chunk predecessor
                         // (255-capped lower bound); null when unavailable
};

// Order + mutual LCP of suffixes a < b starting from a known common prefix
// `from` (a valid lower bound of lcp(a,b)).  Returns (a<b) and writes the
// 255-capped mutual lcp.
inline bool suffix_less_from(const uint8_t* text, int64_t n_pad, int64_t a,
                             int64_t b, int from, int* out_lcp) {
    if (a == b) { *out_lcp = 255; return false; }
    const uint8_t* pa = text + a + from;
    const uint8_t* pb = text + b + from;
    int64_t lim = n_pad - (a > b ? a : b) - from;
    int64_t i = 0;
    while (i + 8 <= lim) {
        uint64_t va = load64(pa + i), vb = load64(pb + i);
        uint64_t diff = va ^ vb;
        uint64_t term = zero_bytes(va);
        if (!(diff | term)) { i += 8; continue; }
        int dj = diff ? __builtin_ctzll(diff) >> 3 : 8;
        int zj = term ? __builtin_ctzll(term) >> 3 : 8;
        int j = dj < zj ? dj : zj;
        int64_t l = from + i + j;
        *out_lcp = l > 255 ? 255 : (int)l;
        uint8_t ca = pa[i + j], cb = pb[i + j];
        if (ca != cb) return ca < cb;
        return a < b;  // equal terminators: position order
    }
    // byte tail (in-bounds: every row ends in a 0 before the array end)
    while (pa[i] != 0 && pa[i] == pb[i]) i++;
    int64_t l = from + i;
    *out_lcp = l > 255 ? 255 : (int)l;
    if (pa[i] != pb[i]) return pa[i] < pb[i];
    return a < b;
}

int merge_threads() {
    if (const char* e = std::getenv("BFQ_EXT_THREADS")) {
        int v = std::atoi(e);
        if (v > 0) return v;
    }
    unsigned hc = std::thread::hardware_concurrency();
    return hc ? (int)hc : 2;
}

// Emit-progress publication: a consumer (the streaming smoother,
// bfqzip_tpu/external.py) polls these 8-byte aligned cursors while the
// merge threads run, so later pipeline stages can start on the merged
// prefix before the merge finishes.  Release stores pair with the
// consumer's acquire loads; the granularity keeps the store off the hot
// path (one publish per kProgStep emits).
constexpr int64_t kProgStep = 1 << 18;

inline void publish(int64_t* slot, int64_t value) {
    if (slot) __atomic_store_n(slot, value, __ATOMIC_RELEASE);
}

// Loser-tree merge of one output range; returns 0 or a negative error code.
// prev_g < 0 leaves lcp_out[0] = 0 for the caller's boundary fix-up.
// prog (nullable) receives the absolute output cursor abs_base + i.
template <typename TIdx>
int merge_range(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                std::vector<Cursor<TIdx>>& cur, int64_t total,
                uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                uint8_t* pre_out, TIdx* sa_out,
                int64_t* prog = nullptr, int64_t abs_base = 0) {
    int32_t n_chunks = (int32_t)cur.size();
    // internal nodes hold the LOSER chunk id, `winner` the overall minimum.
    // k is small (<= a few hundred), so the tree lives in L1; each emit
    // costs ceil(log2 k) suffix comparisons.
    int k = 1;
    while (k < n_chunks) k <<= 1;
    std::vector<int32_t> node((size_t)k, -1);  // internal loser slots
    auto head_less = [&](int32_t a, int32_t b) {
        // exhausted cursors sort last
        bool ea = cur[a].p == cur[a].end, eb = cur[b].p == cur[b].end;
        if (ea || eb) return !ea;
        return suffix_less(text, n_pad, *cur[a].p, *cur[b].p);
    };
    // initial winner via pairwise tournament
    int32_t winner = -1;
    {
        std::vector<int32_t> level((size_t)k, -1);
        for (int32_t c = 0; c < n_chunks; c++) level[c] = c;
        int width = k;
        int base = k;  // node indices [1, k) as a heap; fill bottom-up
        while (width > 1) {
            width >>= 1;
            base -= width;
            for (int i = 0; i < width; i++) {
                int32_t a = level[2 * i], b = level[2 * i + 1];
                int32_t w, l;
                if (b < 0 || (a >= 0 && head_less(a, b))) { w = a; l = b; }
                else { w = b; l = a; }
                node[base + i] = l;
                level[i] = w;
            }
        }
        winner = level[0];
    }

    int64_t prev_g = -1;
    for (int64_t i = 0; i < total; i++) {
        if (winner < 0 || cur[winner].p == cur[winner].end) return -3;
        int64_t g = *cur[winner].p++;
        if (cur[winner].p != cur[winner].end) {
            // the advancing chunk's next suffix is a likely near-term emit:
            // warm its output text lines while the tree replay runs
            int64_t ng = *cur[winner].p;
            __builtin_prefetch(text + (ng ? ng - 1 : 0));
            __builtin_prefetch(qtext + (ng ? ng - 1 : 0));
        }
        if (g <= 0 || g >= n_pad) {
            // g == 0 would need text[-1]; the padded layout always starts a
            // read at 0 whose preceding slot wraps — handle explicitly
            if (g != 0) return -4;
        }
        int64_t gp = g == 0 ? n_pad - 1 : g - 1;
        int64_t gp2 = g <= 1 ? n_pad - (2 - g) : g - 2;
        uint8_t cprev = text[gp];
        bwt_out[i] = cprev == 0 ? kTermCode : (uint8_t)(cprev - 1);
        qs_out[i] = cprev == 0 ? kTermChar : qtext[gp];
        uint8_t c2 = text[gp2];
        pre_out[i] = c2 == 0 ? kTermCode : (uint8_t)(c2 - 1);
        lcp_out[i] = prev_g < 0 ? 0 : lcp255(text, n_pad, prev_g, g);
        sa_out[i] = (TIdx)g;
        prev_g = g;
        if (prog && (i == 0 || ((i + 1) & (kProgStep - 1)) == 0))
            publish(prog, abs_base + i + 1);

        // replay the loser tree along winner's leaf-to-root path
        int32_t w = winner;
        for (int idx = (k + w) >> 1; idx >= 1; idx >>= 1) {
            int32_t l = node[idx];
            if (l >= 0 && !head_less(w, l)) {
                node[idx] = w;
                w = l;
            }
        }
        winner = w;
    }
    // NB: the final cursor (abs_base + total) is published by the CALLER —
    // a range's completion may first require its successor's boundary LCP
    // to be fixed (see the worker epilogue in ext_merge_impl)
    return 0;
}

// LCP-augmented loser tree (the Ng/Kakehi string-merge scheme): each node
// stores (loser, 255-capped lcp(loser head, the winner that defeated it)).
// A replay walks only the emitted winner's root path, where every stored
// lcp is relative to that same winner, so ordering is decided by comparing
// two integers — the text is walked only on exact ties, starting at the
// tied offset.  The carried lcp of the element reaching the root IS the
// next output LCP, so the per-emit lcp255 walk disappears too.  Intra-chunk
// LCPs (cur[].lcp, from the device chunk sorts) seed the carry when a
// cursor advances past its just-emitted predecessor.
template <typename TIdx>
int merge_range_lcp(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                    std::vector<Cursor<TIdx>>& cur, int64_t total,
                    uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                    uint8_t* pre_out, TIdx* sa_out,
                    int64_t* prog = nullptr, int64_t abs_base = 0) {
    int32_t n_chunks = (int32_t)cur.size();
    int k = 1;
    while (k < n_chunks) k <<= 1;
    std::vector<int32_t> node((size_t)k, -1);
    std::vector<int> nlcp((size_t)k, 0);

    int32_t winner = -1;
    int wlcp = 0;
    {
        std::vector<int32_t> level((size_t)k, -1);
        for (int32_t c = 0; c < n_chunks; c++) level[c] = c;
        int width = k;
        int base = k;
        while (width > 1) {
            width >>= 1;
            base -= width;
            for (int i = 0; i < width; i++) {
                int32_t a = level[2 * i], b = level[2 * i + 1];
                int32_t w, l;
                int ml = 0;
                if (b < 0) { w = a; l = b; }
                else if (a < 0) { w = b; l = a; }
                else {
                    bool ea = cur[a].p == cur[a].end, eb = cur[b].p == cur[b].end;
                    bool aw;
                    if (ea || eb) aw = !ea;
                    else aw = suffix_less_from(text, n_pad, *cur[a].p,
                                               *cur[b].p, 0, &ml);
                    if (aw) { w = a; l = b; }
                    else { w = b; l = a; }
                }
                node[base + i] = l;
                nlcp[base + i] = ml;
                level[i] = w;
            }
        }
        winner = level[0];
    }

    for (int64_t i = 0; i < total; i++) {
        if (winner < 0 || cur[winner].p == cur[winner].end) return -3;
        int64_t g = *cur[winner].p++;
        cur[winner].lcp++;
        if (cur[winner].p != cur[winner].end) {
            // the advancing chunk's next suffix is a likely near-term emit:
            // warm its output text lines while the tree replay runs
            int64_t ng = *cur[winner].p;
            __builtin_prefetch(text + (ng ? ng - 1 : 0));
            __builtin_prefetch(qtext + (ng ? ng - 1 : 0));
        }
        if (g <= 0 || g >= n_pad) {
            if (g != 0) return -4;
        }
        int64_t gp = g == 0 ? n_pad - 1 : g - 1;
        int64_t gp2 = g <= 1 ? n_pad - (2 - g) : g - 2;
        uint8_t cprev = text[gp];
        bwt_out[i] = cprev == 0 ? kTermCode : (uint8_t)(cprev - 1);
        qs_out[i] = cprev == 0 ? kTermChar : qtext[gp];
        uint8_t c2 = text[gp2];
        pre_out[i] = c2 == 0 ? kTermCode : (uint8_t)(c2 - 1);
        lcp_out[i] = i == 0 ? 0 : (uint8_t)wlcp;
        sa_out[i] = (TIdx)g;
        if (prog && (i == 0 || ((i + 1) & (kProgStep - 1)) == 0))
            publish(prog, abs_base + i + 1);

        // replay: carried cl = lcp(new head, the suffix just emitted)
        int32_t w = winner;
        bool wex = cur[w].p == cur[w].end;
        int cl = wex ? 0 : (int)*cur[w].lcp;
        for (int idx = (k + w) >> 1; idx >= 1; idx >>= 1) {
            int32_t l = node[idx];
            if (l < 0) continue;
            bool lex = cur[l].p == cur[l].end;
            int ll = nlcp[idx];
            bool w_wins;
            int mutual;
            if (wex || lex) {
                w_wins = !wex;
                mutual = 0;
            } else if (cl != ll) {
                w_wins = cl > ll;
                mutual = cl < ll ? cl : ll;
            } else {
                w_wins = suffix_less_from(text, n_pad, *cur[w].p, *cur[l].p,
                                          cl, &mutual);
            }
            if (w_wins) {
                nlcp[idx] = mutual;  // lcp(l, w) — w is the winner here
            } else {
                node[idx] = w;
                nlcp[idx] = mutual;
                w = l;
                cl = ll;
                wex = lex;
            }
        }
        winner = w;
        wlcp = cl;
    }
    // final cursor published by the caller (see merge_range's note)
    return 0;
}

// Returns total merged length, negative on error.  nthreads <= 0 auto-detects
// (BFQ_EXT_THREADS overrides).  lcp_all (nullable) holds each chunk's
// intra-chunk 255-capped LCP aligned with sa_all; when present the merge
// uses the LCP loser tree (no per-comparison text walks).
// prog (nullable): live progress for a concurrent consumer.  Layout
// (all slots 8-byte, written with release stores):
//   prog[0]          = T, the number of output ranges (0 until the output
//                      partition is fixed — nothing is consumable before)
//   prog[1+3t .. ]   = {range start, range end, absolute cursor} per range
// The merged prefix [0, P) is final where P walks ranges in order and
// stops at the first cursor short of its end.  The caller must size prog
// for the REQUESTED thread count; the used T never exceeds it.
template <typename TIdx>
int64_t ext_merge_impl(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                       const TIdx* sa_all, const uint8_t* lcp_all,
                       const int64_t* offs, int32_t n_chunks,
                       uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                       uint8_t* pre_out, TIdx* sa_out, int nthreads,
                       int64_t* prog = nullptr) {
    if (n_chunks <= 0) return -1;
    for (int32_t c = 0; c < n_chunks; c++)
        if (offs[c + 1] < offs[c]) return -2;
    int64_t total = offs[n_chunks];
    // validate every suffix position once, up front (untrusted input must
    // fail cleanly, not index out of bounds inside the merge threads)
    for (int64_t i = 0; i < total; i++)
        if (sa_all[i] < 0 || sa_all[i] >= n_pad) return -4;

    static const uint8_t kZeroLcp = 0;
    auto make_cursor = [&](int32_t c, int64_t s, int64_t e) -> Cursor<TIdx> {
        return {sa_all + offs[c] + s, sa_all + offs[c] + e,
                lcp_all ? lcp_all + offs[c] + s : &kZeroLcp};
    };
    auto run_range = [&](std::vector<Cursor<TIdx>>& cur, int64_t len, int64_t o,
                         int64_t* pr) {
        return lcp_all
                   ? merge_range_lcp(text, qtext, n_pad, cur, len, bwt_out + o,
                                     qs_out + o, lcp_out + o, pre_out + o,
                                     sa_out + o, pr, o)
                   : merge_range(text, qtext, n_pad, cur, len, bwt_out + o,
                                 qs_out + o, lcp_out + o, pre_out + o,
                                 sa_out + o, pr, o);
    };
    auto open_ranges = [&](const std::vector<int64_t>& starts, int T_used) {
        if (!prog) return;
        for (int t = 0; t < T_used; t++) {
            prog[1 + 3 * t] = starts[t];
            prog[2 + 3 * t] = starts[t + 1];
            publish(&prog[3 + 3 * t], starts[t]);
        }
        publish(&prog[0], (int64_t)T_used);
    };

    if (nthreads <= 0) nthreads = merge_threads();
    int T = nthreads;
    if ((int64_t)T * 4096 > total) T = (int)(total / 4096) ? (int)(total / 4096) : 1;

    if (T <= 1) {
        std::vector<Cursor<TIdx>> cur((size_t)n_chunks);
        for (int32_t c = 0; c < n_chunks; c++)
            cur[c] = make_cursor(c, 0, offs[c + 1] - offs[c]);
        open_ranges({0, total}, 1);
        int rc = run_range(cur, total, 0, prog ? &prog[3] : nullptr);
        if (rc == 0 && prog) publish(&prog[3], total);
        return rc < 0 ? rc : total;
    }

    // ---- splitter selection: sampled quantiles of the merged order ----
    std::vector<int64_t> samples;
    for (int32_t c = 0; c < n_chunks; c++) {
        int64_t len = offs[c + 1] - offs[c];
        if (len == 0) continue;
        int64_t s = std::min<int64_t>(len, 32 * T);
        for (int64_t j = 0; j < s; j++)
            samples.push_back(sa_all[offs[c] + j * len / s]);
    }
    std::sort(samples.begin(), samples.end(), [&](int64_t a, int64_t b) {
        return suffix_less(text, n_pad, a, b);
    });

    // bounds[t][c]: partition point of splitter t in chunk c (t=0 -> 0,
    // t=T -> chunk length); splitters ascend, so bounds are monotone per
    // chunk and the output ranges [out0[t], out0[t+1]) tile exactly.
    std::vector<std::vector<int64_t>> bounds((size_t)T + 1,
                                             std::vector<int64_t>((size_t)n_chunks));
    for (int32_t c = 0; c < n_chunks; c++) {
        bounds[0][c] = 0;
        bounds[T][c] = offs[c + 1] - offs[c];
    }
    for (int t = 1; t < T; t++) {
        int64_t spl = samples[(size_t)t * samples.size() / T];
        for (int32_t c = 0; c < n_chunks; c++) {
            const TIdx* lo = sa_all + offs[c];
            const TIdx* hi = sa_all + offs[c + 1];
            const TIdx* it = std::partition_point(lo, hi, [&](TIdx g) {
                return suffix_less(text, n_pad, g, spl);
            });
            bounds[t][c] = it - lo;
        }
    }

    std::vector<int64_t> out0((size_t)T + 1, 0);
    for (int t = 0; t <= T; t++)
        for (int32_t c = 0; c < n_chunks; c++) out0[t] += bounds[t][c];
    if (out0[T] != total) return -5;  // partition must tile exactly

    open_ranges(out0, T);
    std::vector<int> rcs((size_t)T, 0);
    std::atomic<bool> any_err{false};
    std::vector<std::thread> pool;
    for (int t = 0; t < T; t++) {
        pool.emplace_back([&, t]() {
            int64_t len = out0[t + 1] - out0[t];
            if (len == 0) {
                // nothing to emit and no boundary to fix (the preceding
                // non-empty range owns the fix at this output position)
                if (prog) publish(&prog[3 + 3 * t], out0[t + 1]);
                return;
            }
            std::vector<Cursor<TIdx>> cur((size_t)n_chunks);
            for (int32_t c = 0; c < n_chunks; c++)
                cur[c] = make_cursor(c, bounds[t][c], bounds[t + 1][c]);
            rcs[t] = run_range(cur, len, out0[t],
                               prog ? &prog[3 + 3 * t] : nullptr);
            if (rcs[t] < 0) { any_err.store(true); return; }
            if (!prog) return;
            // epilogue: this range's completion unlocks the NEXT non-empty
            // range for a live consumer — but that range's first LCP slot
            // still holds the provisional 0 written by its own thread.  Fix
            // it here (we know our last emitted suffix = sa_out[end-1]) as
            // soon as its first entry is visible, THEN publish completion.
            int64_t end = out0[t + 1];
            int tn = t + 1;
            while (tn < T && out0[tn + 1] == out0[tn]) tn++;
            if (end > 0 && tn < T) {
                int64_t* next_cur = &prog[3 + 3 * tn];
                while (__atomic_load_n(next_cur, __ATOMIC_ACQUIRE) <= end) {
                    if (any_err.load()) return;
                    std::this_thread::yield();
                }
                lcp_out[end] = lcp255(text, n_pad, sa_out[end - 1], sa_out[end]);
            }
            publish(&prog[3 + 3 * t], end);
        });
    }
    for (auto& th : pool) th.join();
    for (int t = 0; t < T; t++)
        if (rcs[t] < 0) return rcs[t];

    // boundary LCPs: each range's first entry vs the previous merged suffix
    // (idempotent with the worker epilogues of the live-progress path; this
    // serial pass is the only fixer when prog == nullptr)
    for (int t = 1; t < T; t++) {
        int64_t i = out0[t];
        if (i > 0 && i < total && out0[t + 1] > i)
            lcp_out[i] = lcp255(text, n_pad, sa_out[i - 1], sa_out[i]);
    }
    return total;
}

}  // namespace

extern "C" {

int64_t ext_merge_mt2(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                      const int32_t* sa_all, const uint8_t* lcp_all,
                      const int64_t* offs, int32_t n_chunks,
                      uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                      uint8_t* pre_out, int32_t* sa_out, int nthreads) {
    return ext_merge_impl<int32_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads);
}

// 64-bit suffix positions: required beyond 2^31 total positions (>~21M
// 101bp reads; the reference's ext engine likewise sizes char positions as
// ulong, src_ext_mem/parameters.h:86-96).
int64_t ext_merge_mt3(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                      const int64_t* sa_all, const uint8_t* lcp_all,
                      const int64_t* offs, int32_t n_chunks,
                      uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                      uint8_t* pre_out, int64_t* sa_out, int nthreads) {
    return ext_merge_impl<int64_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads);
}

// Live-progress variants: prog is a caller-owned int64 array of size
// 1 + 3*nthreads (nthreads must be EXPLICIT, > 0) that a concurrent
// consumer polls while the merge runs — see ext_merge_impl's layout note.
// The merged prefix [0, P) is final, P = the walk over ranges in order
// stopping at the first cursor short of its range end.
int64_t ext_merge_mt2p(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                       const int32_t* sa_all, const uint8_t* lcp_all,
                       const int64_t* offs, int32_t n_chunks,
                       uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                       uint8_t* pre_out, int32_t* sa_out, int nthreads,
                       int64_t* prog) {
    if (nthreads <= 0 || !prog) return -6;
    return ext_merge_impl<int32_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads, prog);
}

int64_t ext_merge_mt3p(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                       const int64_t* sa_all, const uint8_t* lcp_all,
                       const int64_t* offs, int32_t n_chunks,
                       uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                       uint8_t* pre_out, int64_t* sa_out, int nthreads,
                       int64_t* prog) {
    if (nthreads <= 0 || !prog) return -6;
    return ext_merge_impl<int64_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads, prog);
}

// Compatibility entry points (no intra-chunk LCPs / auto-threaded).
int64_t ext_merge_mt(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                     const int32_t* sa_all, const int64_t* offs, int32_t n_chunks,
                     uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                     uint8_t* pre_out, int32_t* sa_out, int nthreads) {
    return ext_merge_mt2(text, qtext, n_pad, sa_all, nullptr, offs, n_chunks,
                         bwt_out, qs_out, lcp_out, pre_out, sa_out, nthreads);
}

int64_t ext_merge(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                  const int32_t* sa_all, const int64_t* offs, int32_t n_chunks,
                  uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                  uint8_t* pre_out, int32_t* sa_out) {
    return ext_merge_mt2(text, qtext, n_pad, sa_all, nullptr, offs, n_chunks,
                         bwt_out, qs_out, lcp_out, pre_out, sa_out, 0);
}

}  // extern "C"
