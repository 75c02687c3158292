// Shared sequence parser and copy loops of the CUDA LZ4 block decoders
// (decode128.cu and decode_v3.cu: one warp per block; decode_v4.cu and
// decode_big.cu: one thread block per block).  Semantics: reference src/raw/decompress.rs:59-138, stated in
// the port's plain version (lz4tpu_torch/kernels/decode128.py
// decode_plain):
//
//  * token, LSIC literal length, literals; a block may end after literals,
//    and with exactly ONE byte left that byte is re-read as a token (the
//    u16 offset read fails and consumes nothing);
//  * u16 offset, LSIC match length + 4;
//  * the memory limit is checked only at matches, so literals may run past
//    output_limit by up to the compressed length;
//  * offset 0 is ERR_ZERO_OFFSET; an offset reaching before the prefix is
//    ERR_INVALID_OFFSET; the first failing check of a sequence wins.
//
// Addressing: V[s] is out[s] for s >= 0 and the right-aligned prefix byte
// prefix_end[s] for s < 0.  Byte j of a match with offset o that starts at
// op is V[op - o + (j mod o)]: the canonical byte-at-a-time overlap copy
// resolved in closed form, so every byte of a match reads only bytes that
// were written before the match began and the group copies it in parallel.

#pragma once

#include <cstdint>

namespace lz4t {

constexpr int32_t OK = 0;
constexpr int32_t ERR_UNEXPECTED_END = 1;
constexpr int32_t ERR_MEMORY_LIMIT = 2;
constexpr int32_t ERR_ZERO_OFFSET = 3;
constexpr int32_t ERR_INVALID_OFFSET = 4;

// one parsed sequence; lit_len/match_len are 0 when absent
struct Seq {
    long long next_pos;   // comp position after this sequence
    long long lit_src;    // comp position of the literals
    long long lit_len;
    long long match_len;  // 0: no match (block ends after literals)
    long long offset;
    int status;
};

// Parse the sequence at `pos` given output position `op`.  Reads only
// bytes pos .. n-1 of the compressed stream, each through `comp(p)`: a
// plain pointer for the decoders that parse from device memory, a staged
// window with a fallback for the ones that read ahead into shared memory.
template <class Reader>
__device__ __forceinline__ Seq parse_seq_with(const Reader& comp, long long n, long long pos,
                                              long long op, long long plen, long long limit,
                                              long long out_cap) {
    Seq q;
    q.lit_len = 0;
    q.match_len = 0;
    q.offset = 0;
    q.status = OK;
    int token = comp(pos++);
    long long lit = token >> 4;
    if (lit == 0xF) {
        for (;;) {
            if (pos >= n) {
                q.status = ERR_UNEXPECTED_END;
                return q;
            }
            int more = comp(pos++);
            lit += more;
            if (more != 0xFF) break;
        }
    }
    if (pos + lit > n) {
        q.status = ERR_UNEXPECTED_END;
        return q;
    }
    q.lit_src = pos;
    q.lit_len = lit;
    pos += lit;
    // defensive: the wrappers size out_cap >= limit + comp length, which
    // every valid or invalid stream respects
    if (op + lit > out_cap) {
        q.status = ERR_MEMORY_LIMIT;
        return q;
    }
    if (n - pos < 2) {  // ends after literals (a stray byte re-reads as a token)
        q.next_pos = pos;
        return q;
    }
    long long offset = (long long)comp(pos) | ((long long)comp(pos + 1) << 8);
    pos += 2;
    long long ml = token & 0xF;
    if (ml == 0xF) {
        for (;;) {
            if (pos >= n) {
                q.status = ERR_UNEXPECTED_END;
                return q;
            }
            int more = comp(pos++);
            ml += more;
            if (more != 0xFF) break;
        }
    }
    ml += 4;
    long long mop = op + lit;
    if (mop + ml > limit) {
        q.status = ERR_MEMORY_LIMIT;
        return q;
    }
    if (offset == 0) {
        q.status = ERR_ZERO_OFFSET;
        return q;
    }
    if (offset > mop + plen) {
        q.status = ERR_INVALID_OFFSET;
        return q;
    }
    q.offset = offset;
    q.match_len = ml;
    q.next_pos = pos;
    return q;
}

struct PtrReader {
    const uint8_t* __restrict__ p;
    __device__ __forceinline__ int operator()(long long i) const { return p[i]; }
};

__device__ __forceinline__ Seq parse_seq(const uint8_t* __restrict__ comp, long long n,
                                         long long pos, long long op, long long plen,
                                         long long limit, long long out_cap) {
    return parse_seq_with(PtrReader{comp}, n, pos, op, plen, limit, out_cap);
}

// literals: out[op + j] = comp[src + j], j = tid, tid + nthreads, ...
__device__ __forceinline__ void copy_literals(uint8_t* __restrict__ out,
                                              const uint8_t* __restrict__ comp, long long op,
                                              long long src, long long len, int tid,
                                              int nthreads) {
    for (long long j = tid; j < len; j += nthreads) out[op + j] = comp[src + j];
}

// match: out[op + j] = V[op - offset + (j mod offset)]
__device__ __forceinline__ void copy_match(uint8_t* out, const uint8_t* __restrict__ prefix_end,
                                           long long op, long long offset, long long len, int tid,
                                           int nthreads) {
    const long long base = op - offset;
    if (offset >= len) {
        for (long long j = tid; j < len; j += nthreads) {
            long long s = base + j;
            out[op + j] = s >= 0 ? out[s] : prefix_end[s];
        }
    } else {
        for (long long j = tid; j < len; j += nthreads) {
            long long s = base + j % offset;
            out[op + j] = s >= 0 ? out[s] : prefix_end[s];
        }
    }
}

}  // namespace lz4t
