// Lane LZ4 compressor: one warp per row [window | block], any number of rows
// a launch.
//
// Replaces: lz4tpu/kernels/compress128.py:156 _compress128_kernel (launched
// by _compress128_jit, compress128.py:1072): each row's block (at most
// 32 KiB) is parsed from cur0 behind a window of at most 64 KiB, with a
// packed per-row table pos17 | tag15 << 17, four probes a round, backward
// extension and a token/LSIC emitter; default, window and STRICT modes.
//
// What bounds it on this card: neither bytes nor operations.  A row's parse
// is a chain of dependent steps (a probe reads the slot the one before it
// wrote; a sequence starts where the last one ended), so it runs at one
// thread's instruction and load latency; the bytes (row read once, stream
// written once) would take microseconds at 3.35 TB/s.  Big blocks become
// parallel work because they are cut into rows: 128 rows for a 4 MiB block.
//
// What the design does about it: the row's table (1 << hashlog packed
// entries, 16 KiB at hashlog 12) lives in shared memory, 14 rows resident
// per SM.  The 15-bit tag of a slot answers most probes without touching the
// candidate's bytes, which are the loads most likely to miss the caches.
// Lane 0 searches; the warp primes the table from the window (atomicMax on
// positions, so the last insert wins as in a serial walk, then one pass that
// packs the tags) and copies each sequence's literals, one byte a lane,
// coalesced.  Rows are cut from one flat source by their base offsets: no
// [window | block] copy is made, and a window that must stop short of the
// bytes before it (the head of an independent block) is a larger base.
//
// The TPU kernel's transposed buffers, one-hot table sweeps, input pages and
// staging ring are its layout, not its contract, and have no counterpart;
// its rounds become a loop, in which a probe sees the inserts of the probes
// before it just as its fix-ups arrange.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_HASHLOG = 12;
constexpr int MIN_HASHLOG = 4;
constexpr int PROBES = 4;
constexpr int PROBE_SPAN = 24;
constexpr int SKIP_TRIGGER = 6;
constexpr int MISS0 = 1 << SKIP_TRIGGER;
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr uint32_t POS_MASK = 0x1FFFFu;
constexpr uint32_t TAG_MASK = 0x7FFFu;
constexpr uint32_t SENTINEL = 0x1FFFFu;  // a position no row reaches, tag 0

__device__ __forceinline__ uint32_t read32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

__device__ __forceinline__ uint64_t read64(const uint8_t* p) {
    return (uint64_t)read32(p) | ((uint64_t)read32(p + 4) << 32);
}

// the slot value of position p whose 4-byte word hashes to vm
__device__ __forceinline__ uint32_t packed(int p, uint32_t vm) {
    return (uint32_t)p | (((vm >> 6) & TAG_MASK) << 17);
}

// the reference's 5-byte hash (spec/table.py hash_all_u32): positions with
// fewer than 8 readable bytes hash a zero word
__device__ __forceinline__ uint32_t hash5(const uint8_t* in, int n, int p) {
    uint64_t v = (p + 8 <= n) ? read64(in + p) : 0;
    return (uint32_t)(((v << 24) * 889523592379ULL) >> (64 - MAX_HASHLOG));
}

// longest common prefix of in[a..a+limit) and in[b..), b < a
__device__ __forceinline__ int lcp(const uint8_t* in, int a, int b, int limit) {
    int m = 0;
    while (m + 8 <= limit) {
        uint64_t x = read64(in + a + m) ^ read64(in + b + m);
        if (x) return m + ((__ffsll((long long)x) - 1) >> 3);
        m += 8;
    }
    while (m < limit && in[a + m] == in[b + m]) m++;
    return m;
}

__device__ __forceinline__ int lsic_len(int v) { return v < 0xF ? 0 : (v - 0xF) / 0xFF + 1; }

__device__ __forceinline__ void put_lsic(uint8_t* out, int op, int v) {
    if (v < 0xF) return;
    v -= 0xF;
    while (v >= 0xFF) {
        out[op++] = 0xFF;
        v -= 0xFF;
    }
    out[op] = (uint8_t)v;
}

// The next sequence of a row parsed from `anchor`: match start, length and
// offset, or mlen 0 for the literal tail.  Run by lane 0.
struct Seq {
    int mstart, mlen, moff;
};

// Default and window mode.  A round probes up to PROBES positions spaced by
// the skip schedule, inserts every one of them, and takes the earliest tag
// hit; the forward compare verifies it.
__device__ Seq search_lane(uint32_t* tab, const uint8_t* in, int n, int anchor, int hashlog) {
    const int shift = 32 - hashlog;
    int cur = anchor;
    int miss = MISS0;
    while (cur + 12 <= n) {
        int q = cur, nvalid = 0, hit_q = -1, hit_c = 0;
#pragma unroll
        for (int j = 0; j < PROBES; j++) {
            if (j && (q + 12 > n || q - cur > PROBE_SPAN)) break;
            nvalid++;
            const uint32_t vm = read32(in + q) * HASH_MUL;
            const uint32_t h = vm >> shift;
            const uint32_t cand = tab[h];
            const uint32_t mine = packed(q, vm);
            tab[h] = mine;
            const int cpos = (int)(cand & POS_MASK);
            if (hit_q < 0 && cpos < q && q - cpos <= 0xFFFF && (cand >> 17) == (mine >> 17)) {
                hit_q = q;
                hit_c = cpos;
            }
            q += (miss + j) >> SKIP_TRIGGER;
        }
        if (hit_q < 0) {
            cur = q;  // the first position not probed
            miss += nvalid;
            continue;
        }
        const int len = lcp(in, hit_q, hit_c, n - 5 - hit_q);
        if (len < 4) {  // a tag that lied, or a match too short
            cur = hit_q + 1;
            miss += 1;
            continue;
        }
        // backward extension into the pending literals, down to the anchor
        // and to the row's first byte
        const int max_bt = min(hit_q - anchor, hit_c);
        int bt = 0;
        while (bt < max_bt && in[hit_q - bt - 1] == in[hit_c - bt - 1]) bt++;
        return Seq{hit_q - bt, len + bt, hit_q - hit_c};
    }
    return Seq{n, 0, 0};
}

// STRICT mode: the reference greedy parse (compress/mod.rs:166-238; the
// steps of compress.cu's parse_block with a fresh U32 table, acceleration 1,
// cursor 0).  A row has at most 32 KiB, so every candidate is within 0xFFFF.
__device__ Seq search_strict(uint32_t* tab, const uint8_t* in, int n, int anchor) {
    int cursor = anchor;
    int step_counter = MISS0;
    int step = 1;
    for (;;) {
        if (cursor + step > n - 11) return Seq{n, 0, 0};
        const uint32_t h = hash5(in, n, cursor);
        const uint32_t cand = tab[h];
        const uint32_t mine = packed(cursor, read32(in + cursor) * HASH_MUL);
        tab[h] = mine;
        // equal words have equal tags, so the tag never hides a match the
        // reference would take; position 0 is the one it never tests
        if (cursor != 0 && (cand >> 17) == (mine >> 17)) {
            const int cpos = (int)(cand & POS_MASK);
            const int len = lcp(in, cursor, cpos, n - 5 - cursor);
            if (len >= 4) {
                const int max_bt = min(cursor - anchor, cpos);
                int bt = 0;
                while (bt < max_bt && in[cursor - bt - 1] == in[cpos - bt - 1]) bt++;
                const int back = cursor + len - 2;  // the cursor - 2 re-insert
                tab[hash5(in, n, back)] = packed(back, read32(in + back) * HASH_MUL);
                return Seq{cursor - bt, len + bt, cursor - cpos};
            }
        }
        cursor += step;
        // the step assignment lags one miss: advances go 1, 1, a, a, ...
        if (anchor + 1 != cursor) {
            step = step_counter >> SKIP_TRIGGER;
            step_counter++;
        }
    }
}

template <bool STRICT>
__global__ void __launch_bounds__(THREADS)
compress128_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ base_arr,
                   const int32_t* __restrict__ n_arr, const int32_t* __restrict__ cur0_arr,
                   uint8_t* __restrict__ out, int64_t out_stride, int32_t* __restrict__ out_len,
                   int32_t* __restrict__ tail_pos, int32_t* __restrict__ tail_lit, int hashlog) {
    extern __shared__ uint32_t tab[];
    const int lane = threadIdx.x;
    const int64_t row = blockIdx.x;
    const uint8_t* in = src + base_arr[row];
    const int n = n_arr[row];
    const int cur0 = cur0_arr[row];
    const int slots = 1 << hashlog;
    uint8_t* o = out + row * out_stride;

    if (STRICT) {
        // the reference's zero-filled table: an empty slot is position 0,
        // here with the tag of the word that lies there
        const uint32_t empty = n >= 4 ? packed(0, read32(in) * HASH_MUL) : 0u;
        for (int i = lane; i < slots; i += THREADS) tab[i] = empty;
    } else if (cur0 >= 16) {
        // window priming: every 3rd position from 0 to cur0 - 12, the last
        // insert of a bucket winning; positions first, tags after
        const int shift = 32 - hashlog;
        for (int i = lane; i < slots; i += THREADS) tab[i] = 0u;
        __syncwarp();
        for (int p = 3 * lane; p <= cur0 - 12; p += 3 * THREADS)
            atomicMax(&tab[(read32(in + p) * HASH_MUL) >> shift], (uint32_t)p + 1u);
        __syncwarp();
        for (int i = lane; i < slots; i += THREADS) {
            const uint32_t v = tab[i];
            tab[i] = v ? packed((int)v - 1, read32(in + v - 1) * HASH_MUL) : SENTINEL;
        }
    } else {
        for (int i = lane; i < slots; i += THREADS) tab[i] = SENTINEL;
    }
    __syncwarp();

    int anchor = cur0;
    int op = 0;
    for (;;) {
        Seq s{0, 0, 0};
        if (lane == 0)
            s = STRICT ? search_strict(tab, in, n, anchor) : search_lane(tab, in, n, anchor, hashlog);
        const int mstart = __shfl_sync(FULL, s.mstart, 0);
        const int mlen = __shfl_sync(FULL, s.mlen, 0);
        const int moff = __shfl_sync(FULL, s.moff, 0);
        const bool tail = mlen == 0;
        const int lit = mstart - anchor;
        const int extra = tail ? 0 : mlen - 4;
        const int header = 1 + lsic_len(lit);
        if (lane == 0) {
            o[op] = (uint8_t)(((lit < 0xF ? lit : 0xF) << 4) | (extra < 0xF ? extra : 0xF));
            put_lsic(o, op + 1, lit);
        }
        for (int i = lane; i < lit; i += THREADS) o[op + header + i] = in[anchor + i];
        if (tail) {
            if (lane == 0) {
                out_len[row] = op + header + lit;
                tail_pos[row] = op;
                tail_lit[row] = lit;
            }
            break;
        }
        op += header + lit;
        if (lane == 0) {
            o[op] = (uint8_t)(moff & 0xFF);
            o[op + 1] = (uint8_t)(moff >> 8);
            put_lsic(o, op + 2, extra);
        }
        op += 2 + lsic_len(extra);
        anchor = mstart + mlen;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lz4t_compress128(const void* src, const void* base, const void* n, const void* cur0,
                                void* out, int64_t out_stride, void* out_len, void* tail_pos,
                                void* tail_lit, int nrows, int hashlog, int strict, void* stream) {
    if (nrows <= 0) return 0;
    if (hashlog < MIN_HASHLOG || hashlog > MAX_HASHLOG || (strict && hashlog != MAX_HASHLOG))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t shared = sizeof(uint32_t) << hashlog;
    if (strict)
        compress128_kernel<true><<<nrows, THREADS, shared, s>>>(
            (const uint8_t*)src, (const int64_t*)base, (const int32_t*)n, (const int32_t*)cur0,
            (uint8_t*)out, out_stride, (int32_t*)out_len, (int32_t*)tail_pos, (int32_t*)tail_lit,
            hashlog);
    else
        compress128_kernel<false><<<nrows, THREADS, shared, s>>>(
            (const uint8_t*)src, (const int64_t*)base, (const int32_t*)n, (const int32_t*)cur0,
            (uint8_t*)out, out_stride, (int32_t*)out_len, (int32_t*)tail_pos, (int32_t*)tail_lit,
            hashlog);
    return (int)cudaGetLastError();
}
