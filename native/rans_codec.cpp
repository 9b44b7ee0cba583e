// Native rANS codec — host-side backend producing/consuming the same
// self-describing containers as bfqzip_tpu/ops/rans.py (magic "BQZR", v1).
//
// Role: the fast CPU path for step-5 entropy coding (the reference shells out
// to 7z PPMd / libbsc here, BFQzip.py:253-275).  The JAX implementation is
// the JAX path; both sides interoperate on the container format, so streams
// encoded on device decode on host and vice versa.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 12;
constexpr uint32_t kM = 1u << kPrecision;
constexpr uint32_t kRansL = 1u << 16;
constexpr uint8_t kMagic[4] = {'B', 'Q', 'Z', 'R'};

int num_contexts(int order, int k) {
    int c = 1;
    for (int i = 0; i < order; i++) c *= k;
    return c;
}

// Quantise per-context counts to sum kM; mirrors ops/rans.py::quantize_freqs.
void quantize(std::vector<int64_t>& counts, int c, int k,
              std::vector<uint16_t>& freq) {
    freq.assign((size_t)c * k, 0);
    for (int ci = 0; ci < c; ci++) {
        int64_t* row = counts.data() + (size_t)ci * k;
        int64_t total = 0;
        for (int s = 0; s < k; s++) total += row[s];
        uint16_t* frow = freq.data() + (size_t)ci * k;
        if (total == 0) {
            uint32_t base = kM / k;
            for (int s = 0; s < k; s++) frow[s] = (uint16_t)base;
            frow[0] += (uint16_t)(kM - base * k);
            continue;
        }
        int64_t sum = 0;
        int top = 0;
        for (int s = 0; s < k; s++) {
            int64_t f = (int64_t)((double)row[s] * kM / (double)total);
            if (row[s] > 0 && f == 0) f = 1;
            frow[s] = (uint16_t)f;
            sum += f;
            if (frow[s] > frow[top]) top = s;
        }
        frow[top] = (uint16_t)(frow[top] + (kM - sum));
    }
}

struct Header {
    uint8_t spec_id, k;
    uint64_t n;
    uint32_t lanes, plen;
};

}  // namespace

extern "C" {

// Encode n bytes; returns container size, or negative on error/overflow.
int64_t rans_encode(const uint8_t* data, int64_t n, int spec_order, int lanes,
                    uint8_t* out, int64_t out_cap) {
    if (spec_order < 0 || spec_order > 2 || lanes < 1) return -1;
    // dense alphabet
    int64_t hist256[256] = {0};
    for (int64_t i = 0; i < n; i++) hist256[data[i]]++;
    uint8_t dense[256];
    uint8_t uniq[256];
    int k = 0;
    for (int b = 0; b < 256; b++)
        if (hist256[b] || (n == 0 && b == 0)) {
            dense[b] = (uint8_t)k;
            uniq[k++] = (uint8_t)b;
        }
    if (k == 0) { dense[0] = 0; uniq[0] = 0; k = 1; }

    int64_t chunk = n > 0 ? (n + lanes - 1) / lanes : 1;
    int64_t padded_n = (int64_t)lanes * chunk;
    std::vector<uint8_t> rows((size_t)padded_n);
    for (int64_t i = 0; i < padded_n; i++)
        rows[i] = dense[i < n ? data[i] : (n ? data[n - 1] : 0)];

    int c = num_contexts(spec_order, k);
    // contexts (history zero at each lane-chunk start)
    std::vector<int32_t> ctx((size_t)padded_n, 0);
    if (spec_order >= 1) {
        for (int64_t l = 0; l < lanes; l++) {
            const uint8_t* row = rows.data() + l * chunk;
            int32_t* crow = ctx.data() + l * chunk;
            for (int64_t t = 0; t < chunk; t++) {
                int32_t v = t >= 1 ? row[t - 1] : 0;
                if (spec_order == 2) v += (t >= 2 ? row[t - 2] : 0) * k;
                crow[t] = v;
            }
        }
    }

    std::vector<int64_t> counts((size_t)c * k, 0);
    for (int64_t i = 0; i < padded_n; i++) counts[(size_t)ctx[i] * k + rows[i]]++;
    std::vector<uint16_t> freq;
    quantize(counts, c, k, freq);
    std::vector<uint32_t> cum((size_t)c * (k + 1), 0);
    for (int ci = 0; ci < c; ci++)
        for (int s = 0; s < k; s++)
            cum[(size_t)ci * (k + 1) + s + 1] =
                cum[(size_t)ci * (k + 1) + s] + freq[(size_t)ci * k + s];

    // reverse encode; emission order (t desc, lane desc) then reversed
    std::vector<uint32_t> state((size_t)lanes, kRansL);
    std::vector<uint16_t> emitted;
    emitted.reserve((size_t)padded_n / 2);
    for (int64_t t = chunk - 1; t >= 0; t--) {
        for (int64_t l = lanes - 1; l >= 0; l--) {
            int64_t i = l * chunk + t;
            uint32_t s = rows[i];
            uint32_t f = freq[(size_t)ctx[i] * k + s];
            uint32_t start = cum[(size_t)ctx[i] * (k + 1) + s];
            uint32_t x = state[l];
            if ((x >> (32 - kPrecision)) >= f) {
                emitted.push_back((uint16_t)(x & 0xFFFF));
                x >>= 16;
            }
            state[l] = ((x / f) << kPrecision) + (x % f) + start;
        }
    }

    uint32_t plen = (uint32_t)emitted.size();
    int64_t total = 24 + k + 2 * (int64_t)c * k + 4 * lanes + 2 * (int64_t)plen;
    if (total > out_cap) return -2;
    uint8_t* p = out;
    std::memcpy(p, kMagic, 4); p += 4;
    *p++ = 1; *p++ = (uint8_t)spec_order; *p++ = (uint8_t)(k - 1); *p++ = 0;
    uint64_t n64 = (uint64_t)n;
    std::memcpy(p, &n64, 8); p += 8;
    uint32_t lanes32 = (uint32_t)lanes;
    std::memcpy(p, &lanes32, 4); p += 4;
    std::memcpy(p, &plen, 4); p += 4;
    std::memcpy(p, uniq, (size_t)k); p += k;
    std::memcpy(p, freq.data(), 2 * (size_t)c * k); p += 2 * (size_t)c * k;
    std::memcpy(p, state.data(), 4 * (size_t)lanes); p += 4 * (size_t)lanes;
    for (int64_t i = 0; i < plen; i++) {  // reversed payload
        uint16_t v = emitted[plen - 1 - i];
        std::memcpy(p, &v, 2); p += 2;
    }
    return p - out;
}

// Returns the decoded length, or negative on error.  Pass out==nullptr to
// query the length first.
int64_t rans_decode(const uint8_t* blob, int64_t size, uint8_t* out,
                    int64_t out_cap) {
    if (size < 24 || std::memcmp(blob, kMagic, 4) != 0) return -1;
    uint8_t ver = blob[4], spec_order = blob[5];
    int k = blob[6] + 1;
    if (ver != 1 || spec_order > 2) return -1;
    uint64_t n;
    uint32_t lanes, plen;
    std::memcpy(&n, blob + 8, 8);
    std::memcpy(&lanes, blob + 16, 4);
    std::memcpy(&plen, blob + 20, 4);
    if (out == nullptr) return (int64_t)n;
    if ((int64_t)n > out_cap) return -2;

    // hostile-header hardening: every region length below derives from the
    // untrusted header, so bound it against the actual blob size before any
    // pointer is formed (the cm_decode standard, round-3 verdict ask #5)
    if (lanes < 1 || lanes > (1u << 22)) return -3;
    int64_t c = num_contexts(spec_order, k);
    int64_t need = 24 + (int64_t)k + 2 * c * k + 4 * (int64_t)lanes
                   + 2 * (int64_t)plen;
    if (need > size) return -3;
    const uint8_t* p = blob + 24;
    const uint8_t* uniq = p; p += k;
    const uint16_t* freq = (const uint16_t*)p; p += 2 * (size_t)c * k;
    const uint32_t* states0 = (const uint32_t*)p; p += 4 * (size_t)lanes;
    const uint16_t* payload = (const uint16_t*)p;

    std::vector<uint32_t> cum((size_t)c * (k + 1), 0);
    for (int ci = 0; ci < c; ci++) {
        uint32_t sum = 0;
        for (int s = 0; s < k; s++) {
            uint16_t f = freq[(size_t)ci * k + s];
            cum[(size_t)ci * (k + 1) + s + 1] = cum[(size_t)ci * (k + 1) + s] + f;
            sum += f;
        }
        // each context row must tile the kM slots exactly, or the slot
        // table fill below would write past its row (heap corruption)
        if (sum != kM) return -3;
    }
    std::vector<uint8_t> slot_sym((size_t)c * kM);
    for (int ci = 0; ci < c; ci++) {
        uint8_t* row = slot_sym.data() + (size_t)ci * kM;
        uint32_t pos = 0;
        for (int s = 0; s < k; s++)
            for (uint32_t j = 0; j < freq[(size_t)ci * k + s]; j++) row[pos++] = (uint8_t)s;
    }

    int64_t chunk = n > 0 ? ((int64_t)n + lanes - 1) / lanes : 1;
    std::vector<uint32_t> state(states0, states0 + lanes);
    std::vector<uint8_t> hist((size_t)lanes * 2, 0);
    std::vector<uint8_t> rows((size_t)lanes * chunk);
    uint64_t off = 0;
    for (int64_t t = 0; t < chunk; t++) {
        for (uint32_t l = 0; l < lanes; l++) {
            int32_t ctxv = 0;
            if (spec_order >= 1) ctxv = hist[l * 2];
            if (spec_order == 2) ctxv += hist[l * 2 + 1] * k;
            uint32_t x = state[l];
            uint32_t slot = x & (kM - 1);
            uint8_t s = slot_sym[(size_t)ctxv * kM + slot];
            uint32_t f = freq[(size_t)ctxv * k + s];
            uint32_t start = cum[(size_t)ctxv * (k + 1) + s];
            x = f * (x >> kPrecision) + slot - start;
            if (x < kRansL) {
                if (off >= plen) return -3;
                x = (x << 16) | payload[off++];
            }
            state[l] = x;
            rows[(size_t)l * chunk + t] = s;
            hist[l * 2 + 1] = hist[l * 2];
            hist[l * 2] = s;
        }
    }
    for (int64_t i = 0; i < (int64_t)n; i++) out[i] = uniq[rows[i]];
    return (int64_t)n;
}

}  // extern "C"
