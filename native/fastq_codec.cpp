// Native FASTQ parser / serialiser for the host-side IO path.
//
// The reference's IO is getline loops and `sed` subprocesses
// (reference BFQzip.py:19-21, bfq_int.cpp:800-806).  Multi-GB FASTQ parsing
// is a host-side bottleneck for a device pipeline, so this library turns raw
// FASTQ bytes into the dense arrays the device consumes ([N,L] codes/quals,
// lengths, header offsets) and back, in a single pass each way.  Exposed with
// a C ABI and bound from Python via ctypes (bfqzip_tpu/utils/native.py).

#include <cstdint>
#include <cstring>

extern "C" {

// First pass: count records and the maximum read length.
// Returns 0 on success, negative error codes on malformed input.
//   -1 line structure broken, -2 dna/qs length mismatch, -3 bad header
int fastq_scan(const uint8_t* data, int64_t size, int64_t* n_reads,
               int64_t* max_len) {
    int64_t n = 0, lmax = 0;
    int64_t i = 0;
    while (i < size) {
        // header
        if (data[i] != '@') return -3;
        while (i < size && data[i] != '\n') i++;
        if (i >= size) return -1;
        i++;
        // dna
        int64_t d0 = i;
        while (i < size && data[i] != '\n') i++;
        if (i >= size) return -1;
        int64_t dlen = i - d0;
        i++;
        // plus
        if (i >= size || data[i] != '+') return -1;
        while (i < size && data[i] != '\n') i++;
        if (i >= size) return -1;
        i++;
        // qs
        int64_t q0 = i;
        while (i < size && data[i] != '\n') i++;
        int64_t qlen = i - q0;
        if (i < size) i++;  // tolerate missing final newline
        if (qlen != dlen) return -2;
        if (dlen > lmax) lmax = dlen;
        n++;
    }
    *n_reads = n;
    *max_len = lmax;
    return 0;
}

// Second pass: fill the dense arrays.  seqs/quals are [n_reads, width]
// row-major u8 (zero-padded), lengths [n_reads] i32, header_off/len [n_reads]
// i64 into the input buffer.  code_map maps ASCII byte -> code (255 invalid).
int fastq_fill(const uint8_t* data, int64_t size, const uint8_t* code_map,
               int64_t width, uint8_t* seqs, uint8_t* quals, int32_t* lengths,
               int64_t* header_off, int64_t* header_len) {
    int64_t i = 0, r = 0;
    while (i < size) {
        int64_t h0 = i;
        while (i < size && data[i] != '\n') i++;
        header_off[r] = h0;
        header_len[r] = i - h0;
        i++;
        int64_t d0 = i;
        while (i < size && data[i] != '\n') i++;
        int64_t dlen = i - d0;
        i++;
        while (i < size && data[i] != '\n') i++;
        i++;
        int64_t q0 = i;
        while (i < size && data[i] != '\n') i++;
        if (i < size) i++;
        lengths[r] = (int32_t)dlen;
        uint8_t* srow = seqs + r * width;
        uint8_t* qrow = quals + r * width;
        for (int64_t k = 0; k < dlen; k++) {
            uint8_t c = code_map[data[d0 + k]];
            if (c == 255) return -4;
            srow[k] = c;
        }
        std::memcpy(qrow, data + q0, (size_t)dlen);
        r++;
    }
    return 0;
}

// Serialise arrays back to FASTQ.  headers==nullptr emits bare '@' lines
// (the reference's header-less mode, bfq_int.cpp:758,805).  out must hold
// fastq_format_size() bytes; returns bytes written or negative on error.
int64_t fastq_format(const uint8_t* seqs, const uint8_t* quals,
                     const int32_t* lengths, int64_t n_reads, int64_t width,
                     const uint8_t* decode_map, const uint8_t* headers,
                     const int64_t* header_off, const int64_t* header_len,
                     uint8_t* out) {
    int64_t p = 0;
    for (int64_t r = 0; r < n_reads; r++) {
        if (headers) {
            std::memcpy(out + p, headers + header_off[r], (size_t)header_len[r]);
            p += header_len[r];
        } else {
            out[p++] = '@';
        }
        out[p++] = '\n';
        int64_t L = lengths[r];
        const uint8_t* srow = seqs + r * width;
        for (int64_t k = 0; k < L; k++) out[p++] = decode_map[srow[k]];
        out[p++] = '\n';
        out[p++] = '+';
        out[p++] = '\n';
        std::memcpy(out + p, quals + r * width, (size_t)L);
        p += L;
        out[p++] = '\n';
    }
    return p;
}

}  // extern "C"
