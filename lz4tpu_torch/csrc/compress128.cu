// Lane LZ4 compressor: one thread block per row [window | block], any number
// of rows a launch.
//
// Replaces: lz4tpu/kernels/compress128.py:156 _compress128_kernel (launched
// by _compress128_jit, compress128.py:1072): each row's block (at most
// 32 KiB) is parsed from cur0 behind a window of at most 64 KiB, with a
// per-row hash table, backward extension and a token/LSIC emitter; default,
// window and STRICT modes.
//
// What bounds it on this card: neither bytes nor operations.  The bytes
// (row read once, stream written once) would take microseconds at
// 3.35 TB/s; a serial parse is a chain of dependent steps (a probe reads the
// slot the one before it wrote; a sequence starts where the last one ended)
// and runs at one thread's latency.
//
// What the design does about it, in default and window mode: the parse is
// defined so that most of it is off the chain (kernels/compress128.py,
// lane_records_plain and lane_parse_plain, is the same definition).
//   * Candidate pass, eight producer warps.  The row is cut into groups of
//     32 positions, a warp's.  A bucket of the table keeps its WAYS latest
//     positions (packed (pos + 1) << 15 | tag15, 4 << hashlog entries in
//     shared memory, 64 KiB at hashlog 12).  A position's candidates are
//     the bucket's ways as they stood before its group and the latest
//     position of its bucket earlier in its own group (__match_any_sync).
//     The groups take turns only to update the ways (a read, a shuffle and
//     a write each); everything else runs in parallel: the hash from word
//     loads, the in-group ranks, and the forward compare of every candidate
//     whose tag agrees, 32 bytes in one round of aligned loads.  The record
//     of a position is its longest compare and the equal bytes before it
//     (back << 24 | length << 16 | offset), in a double buffer of TILE
//     positions.  The window goes through the same table in one parallel
//     pass before the block's first tile (WAYS rounds of atomicMax, round w
//     taking the latest position below way w - 1).
//   * The walk's jumps, the producers too: from each position, the first
//     record at or after it (a ballot a group), and from each record the
//     best of it and the LAZY - 1 after it (longest less its distance).
//   * The walk, warp 0, one tile behind the producers: from the cursor it
//     reads a jump and a record, so a sequence is two shared-memory loads
//     on the chain whatever the literal run before it.  Only a match longer
//     than CAP or a backward run longer than the record holds is read from
//     the row, 128 bytes a warp step.  It appends a descriptor (anchor,
//     start, length, offset) and moves the cursor to the match's end.
//   * Emission, the producers, one tile behind the walk: a prefix sum over
//     the descriptors' encoded sizes places every token, length run,
//     literal run and offset; a thread a descriptor writes its header and
//     offset, a warp a descriptor copies its literals.
// Three thread blocks are resident per SM (68 KiB of shared memory each).

// STRICT mode (byte parity with the reference greedy parse, on no frame
// path) keeps a serial search in lane 0 of one warp per row.
//
// Rows are cut from one flat source by their base offsets: no [window |
// block] copy is made, and a window that must stop short of the bytes
// before it (the head of an independent block) is a larger base.  The TPU
// kernel's transposed buffers, one-hot table sweeps, input pages and
// staging ring are its layout, not its contract, and have no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_HASHLOG = 12;
constexpr int MIN_HASHLOG = 4;
constexpr int SKIP_TRIGGER = 6;
constexpr int MISS0 = 1 << SKIP_TRIGGER;
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr uint32_t POS_MASK = 0x1FFFFu;
constexpr uint32_t TAG_MASK = 0x7FFFu;

// default and window mode (the constants of kernels/compress128.py)
constexpr int PRODUCERS = 256;            // warps 1-8: the candidate pass and the emission
constexpr int PWARPS = PRODUCERS / 32;
constexpr int THREADS = 32 + PRODUCERS;   // warp 0 walks
constexpr int CTAS_PER_SM = 3;
constexpr int GROUP = 32;                 // positions of a producer warp
constexpr int TILE = GROUP * PWARPS;      // positions a walk step sees at once
constexpr int WAYS = 4;                   // latest positions a bucket keeps
constexpr int CAP = 32;                   // bytes the candidate pass compares
constexpr int LAZY = 4;                   // positions the walk picks a match among
constexpr int DESC_CAP = TILE / 4 + 1;    // a tile's matches start 4 bytes apart, and the tail
constexpr int BACK_SEEN = 7;              // backward bytes a record carries (3 bits)
static_assert(TILE == 256, "kernels/compress128.py TILE");
static_assert(WAYS == 4, "a bucket's ways are one uint4");
constexpr int STRICT_THREADS = 32;

__device__ __forceinline__ uint32_t read32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

__device__ __forceinline__ uint64_t read64(const uint8_t* p) {
    return (uint64_t)read32(p) | ((uint64_t)read32(p + 4) << 32);
}

// the 4 bytes at p from aligned 32-bit loads; the second word is read only
// when p is not aligned, and then it holds byte p + 3, so no load leaves
// the row's words
__device__ __forceinline__ uint32_t word_at(const uint8_t* p) {
    const uintptr_t a = (uintptr_t)p;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    const uint32_t sh = (uint32_t)(a & 3) * 8;
    const uint32_t lo = w[0];
    return sh ? __funnelshift_r(lo, w[1], sh) : lo;
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

// ---------------------------------------------------------------------------
// default and window mode
// ---------------------------------------------------------------------------

// a way's entry: (p + 1) << 15 | tag, 0 for an empty way
__device__ __forceinline__ uint32_t entry(int p, uint32_t vm) {
    return ((uint32_t)(p + 1) << 15) | ((vm >> 6) & TAG_MASK);
}

__device__ __forceinline__ int entry_pos(uint32_t e) { return (int)(e >> 15) - 1; }

// the producers meet (barrier 1; barrier 0 is __syncthreads); the
// non-aligned form, since a warp may arrive diverged
__device__ __forceinline__ void producers_sync() {
    __syncwarp();
    asm volatile("barrier.sync 1, %0;" ::"n"(PRODUCERS) : "memory");
}

// the 32 bytes at a as 8 words, from 9 aligned loads; a load is made only
// if its word holds a byte below `end` (the row's end), so no load leaves
// the row's words, and what lies past `end` reads as zeros
__device__ __forceinline__ void words32(const uint8_t* a, const uint8_t* end, uint32_t (&w)[8]) {
    const uintptr_t base = (uintptr_t)a & ~(uintptr_t)3;
    const uint32_t sh = (uint32_t)((uintptr_t)a & 3) * 8;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(base);
    uint32_t raw[9];
#pragma unroll
    for (int i = 0; i < 9; i++) raw[i] = base + 4 * i < (uintptr_t)end ? src[i] : 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) w[i] = sh ? __funnelshift_r(raw[i], raw[i + 1], sh) : raw[i];
}

// equal leading bytes of two 32-byte strings, at most span (<= 32)
__device__ __forceinline__ int equal_prefix(const uint32_t (&a)[8], const uint32_t (&b)[8],
                                            int span) {
    int m = 32;
#pragma unroll
    for (int i = 7; i >= 0; i--) {
        const uint32_t x = a[i] ^ b[i];
        if (x) m = 4 * i + ((__ffs(x) - 1) >> 3);
    }
    return min(m, span);
}

// A warp's step of an extension: lane l compares the 4 byte pairs
// a[j + i], b[j + i] with j = from + 4 l (forward, dir 1) or a[-1 - j - i],
// b[-1 - j - i] (backward, dir -1), for j + i < limit.  Returns the equal
// bytes from `from` on if a difference or the limit lies in this step, else
// -1 (128 equal bytes: step again).
__device__ __forceinline__ int extension_step(const uint8_t* a, const uint8_t* b, int from,
                                              int limit, int dir, int lane) {
    const int j = from + 4 * lane;
    int k = 4;
#pragma unroll
    for (int i = 3; i >= 0; i--) {
        const int at = dir > 0 ? j + i : -1 - j - i;
        const bool inside = j + i < limit;
        const uint8_t x = inside ? a[at] : 0, y = inside ? b[at] : 1;
        if (x != y) k = i;
    }
    const unsigned stop = __ballot_sync(FULL, k < 4);
    if (!stop) return -1;
    const int first = __ffs(stop) - 1;
    return 4 * first + __shfl_sync(FULL, k, first);
}

struct Desc {
    int anchor, mstart, mlen, offset;  // mlen 0: the literal tail
};

struct LaneShared {
    uint32_t rec[2][TILE];    // records of the tile being walked and the next
    uint16_t jump[2][TILE];   // from each position, the match the walk takes (TILE: none)
    uint8_t pick[TILE];       // from each record, the lazy step to the one taken
    int first_hit[PWARPS];    // a group's first record (TILE: none)
    Desc desc[2][DESC_CAP];   // descriptors of the tile being walked and the last
    int dcount[2];
    int dpos[DESC_CAP];       // where each descriptor's literals go
    int wsum[PWARPS];         // the emission's prefix sum, a total a warp
};

// Producers: the records of the tile at ts into sh.rec[buf], and the walk's
// jumps into sh.jump[buf].  Warp pw takes group pw; the groups update the
// ways in turn.
__device__ void tile_records(uint4* ways, LaneShared& sh, int buf, const uint8_t* in, int n,
                             int cur0, int ts, int shift, int pw, int lane) {
    const int p = ts + GROUP * pw + lane;
    const bool has = p + 4 <= n;
    const uint32_t vm = has ? word_at(in + p) * HASH_MUL : 0u;
    const uint32_t h = vm >> shift;
    const uint32_t tag = (vm >> 6) & TAG_MASK;
    const uint32_t mine = entry(p, vm);
    // this group's positions of each bucket: the one before mine, and how
    // many come after it
    const unsigned same = __match_any_sync(FULL, has ? h : 0x10000u + lane);
    const unsigned below = same & ((1u << lane) - 1);
    const int rank = __popc(same & ~((2u << lane) - 1));  // 0: the group's newest
    const int count = __popc(same);
    uint4 old = make_uint4(0, 0, 0, 0);
    for (int g = 0; g < PWARPS; g++) {
        if (g == pw) {
            if (has) old = ways[h];
            __syncwarp();
            // the newest WAYS of this group, then the older ways shifted
            uint32_t* wv = reinterpret_cast<uint32_t*>(&ways[h]);
            if (has && rank < WAYS) wv[rank] = mine;
            if (has && rank == 0) {
                const uint32_t o[WAYS] = {old.x, old.y, old.z, old.w};
                for (int k = count; k < WAYS; k++) wv[k] = o[k - count];
            }
            __syncwarp();
        }
        producers_sync();
    }
    uint32_t r = 0;
    if (p >= cur0 && p + 12 <= n) {
        // each candidate's 32 bytes in one round of loads, against p's
        const int span = min(CAP, n - 5 - p);
        uint32_t mine32[8], cand32[8];
        words32(in + p, in + n, mine32);
        int best = 0, best_c = 0;
        if (below) {
            const int c = ts + GROUP * pw + 31 - __clz(below);
            words32(in + c, in + n, cand32);
            const int len = equal_prefix(mine32, cand32, span);
            if (len > best) best = len, best_c = c;
        }
        const uint32_t cands[WAYS] = {old.x, old.y, old.z, old.w};
        for (int k = 0; k < WAYS; k++) {
            const uint32_t e = cands[k];
            const int c = entry_pos(e);
            // equal words have equal tags, so the tag hides no match
            if (e && (e & TAG_MASK) == tag && p - c <= 0xFFFF) {
                words32(in + c, in + n, cand32);
                const int len = equal_prefix(mine32, cand32, span);
                if (len > best) best = len, best_c = c;
            }
        }
        if (best >= 4) {
            // the equal bytes before p and its candidate, up to BACK_SEEN,
            // so that the walk loads nothing for a short backward extension
            int back = BACK_SEEN;
#pragma unroll
            for (int i = BACK_SEEN - 1; i >= 0; i--) {
                const bool inside = best_c - 1 - i >= 0;
                if (!inside || in[p - 1 - i] != in[best_c - 1 - i]) back = i;
            }
            r = ((uint32_t)back << 24) | ((uint32_t)best << 16) | (uint32_t)(p - best_c);
        }
    }
    const int i = GROUP * pw + lane;
    uint32_t* rec = sh.rec[buf];
    rec[i] = r;
    // The walk's jumps, off its chain.  From a record at i the walk takes,
    // of i and the LAZY - 1 positions after it, the longest record less its
    // distance (the first such); from any position, the first record at or
    // after it opens the next match.
    const unsigned hits = __ballot_sync(FULL, r != 0);
    if (lane == 0) sh.first_hit[pw] = hits ? GROUP * pw + __ffs(hits) - 1 : TILE;
    producers_sync();
    if (r) {
        int best = -1, step = 0;
        for (int d = 0; d < LAZY && i + d < TILE; d++) {
            const uint32_t rd = rec[i + d];
            const int v = (int)((rd >> 16) & 0xFF) - d;
            if (rd && v > best) best = v, step = d;
        }
        sh.pick[i] = (uint8_t)step;
    }
    const unsigned later = hits & ~((1u << lane) - 1);
    int next = later ? GROUP * pw + __ffs(later) - 1 : TILE;
    for (int g = pw + 1; g < PWARPS && next == TILE; g++) next = sh.first_hit[g];
    producers_sync();
    sh.jump[buf][i] = (uint16_t)(next < TILE ? next + sh.pick[next] : TILE);
}

// Producers: the descriptors d[0 .. count) as LZ4 sequences from output
// position op; returns the position after them.
__device__ int emit(LaneShared& sh, const Desc* d, int count, int op, const uint8_t* in,
                    uint8_t* o, int32_t* out_len, int32_t* tail_pos, int32_t* tail_lit,
                    int64_t row, int pt, int pw, int lane) {
    Desc q{0, 0, 0, 0};
    int size = 0;
    if (pt < count) {
        q = d[pt];
        const int lit = q.mstart - q.anchor;
        size = 1 + lsic_len(lit) + lit + (q.mlen ? 2 + lsic_len(q.mlen - 4) : 0);
    }
    int upto = size;
    for (int k = 1; k < 32; k <<= 1) {
        const int v = __shfl_up_sync(FULL, upto, k);
        if (lane >= k) upto += v;
    }
    if (lane == 31) sh.wsum[pw] = upto;
    producers_sync();
    int before = 0, total = 0;
    for (int k = 0; k < PWARPS; k++) {
        const int v = sh.wsum[k];
        before += k < pw ? v : 0;
        total += v;
    }
    if (pt < count) {
        const int at = op + before + upto - size;
        const int lit = q.mstart - q.anchor;
        const int extra = q.mlen ? q.mlen - 4 : 0;
        o[at] = (uint8_t)(((lit < 0xF ? lit : 0xF) << 4) | (extra < 0xF ? extra : 0xF));
        put_lsic(o, at + 1, lit);
        const int lit_at = at + 1 + lsic_len(lit);
        sh.dpos[pt] = lit_at;
        if (q.mlen) {
            const int mo = lit_at + lit;
            o[mo] = (uint8_t)(q.offset & 0xFF);
            o[mo + 1] = (uint8_t)(q.offset >> 8);
            put_lsic(o, mo + 2, extra);
        } else {
            out_len[row] = at + size;
            tail_pos[row] = at;
            tail_lit[row] = lit;
        }
    }
    producers_sync();
    for (int k = pw; k < count; k += PWARPS) {
        const int src = d[k].anchor, len = d[k].mstart - src, dst = sh.dpos[k];
        for (int j = lane; j < len; j += 32) o[dst + j] = in[src + j];
    }
    return op + total;
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
compress128_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ base_arr,
                   const int32_t* __restrict__ n_arr, const int32_t* __restrict__ cur0_arr,
                   uint8_t* __restrict__ out, int64_t out_stride, int32_t* __restrict__ out_len,
                   int32_t* __restrict__ tail_pos, int32_t* __restrict__ tail_lit, int hashlog) {
    extern __shared__ uint4 ways[];  // 1 << hashlog buckets
    __shared__ LaneShared sh;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int64_t row = blockIdx.x;
    const uint8_t* in = src + base_arr[row];
    const int n = n_arr[row];
    const int cur0 = cur0_arr[row];
    const int buckets = 1 << hashlog;
    const int shift = 32 - hashlog;
    uint8_t* o = out + row * out_stride;
    uint32_t* wv = reinterpret_cast<uint32_t*>(ways);

    for (int i = tid; i < WAYS * buckets; i += THREADS) wv[i] = 0u;
    __syncthreads();
    // the window up to the first tile, every position: way w takes the
    // latest position below way w - 1's
    const int t0 = cur0 / TILE * TILE;
    const int last = min(t0, n - 3);  // positions with a word
    for (int w = 0; w < WAYS; w++) {
        for (int p = tid; p < last; p += THREADS) {
            const uint32_t vm = word_at(in + p) * HASH_MUL;
            const uint32_t h = vm >> shift;
            if (w) {
                const uint32_t above = wv[WAYS * h + w - 1];
                if (!above || p >= entry_pos(above)) continue;
            }
            atomicMax(&wv[WAYS * h + w], entry(p, vm));
        }
        __syncthreads();
    }

    const int tiles = max(1, (n - t0 + TILE - 1) / TILE);
    const int pt = tid - 32, pw = pt >> 5;
    if (tid >= 32) tile_records(ways, sh, 0, in, n, cur0, t0, shift, pw, lane);
    __syncthreads();

    int anchor = cur0, cur = cur0;  // the walk (warp 0)
    int op = 0;                     // the emission (producers)
    for (int k = 0; k < tiles; k++) {
        const int ts = t0 + k * TILE;
        if (tid < 32) {
            const uint32_t* rec = sh.rec[k & 1];
            const uint16_t* jump = sh.jump[k & 1];
            Desc* d = sh.desc[k & 1];
            const int lim = min(ts + TILE, n - 11);
            int count = 0;
            // the chain: a jump and a record a match (every lane alike)
            while (cur < lim) {
                const int q = ts + jump[cur - ts];
                if (q >= lim) {
                    cur = lim;
                    break;
                }
                const uint32_t rq = rec[q - ts];
                int m = (int)((rq >> 16) & 0xFF);
                const int off = (int)(rq & 0xFFFF);
                const int c = q - off;
                if (m == CAP) {
                    // past the cap, 128 bytes a step, to n - 5
                    int got;
                    while ((got = extension_step(in + q, in + c, m, n - 5 - q, 1, lane)) < 0) m += 128;
                    m += got;
                }
                // backward into the pending literals, down to the anchor and
                // the row's first byte: the record holds the first BACK_SEEN
                // bytes, and only a longer run is read, 128 bytes a step
                const int max_bt = min(q - anchor, c);
                int bt = min((int)(rq >> 24), max_bt);
                if (bt == BACK_SEEN && max_bt > BACK_SEEN) {
                    int got;
                    while ((got = extension_step(in + q, in + c, bt, max_bt, -1, lane)) < 0) bt += 128;
                    bt += got;
                }
                if (lane == 0) d[count] = Desc{anchor, q - bt, m + bt, off};
                count++;
                anchor = cur = q + m;
            }
            if (k == tiles - 1) {
                if (lane == 0) d[count] = Desc{anchor, n, 0, 0};
                count++;
            }
            if (lane == 0) sh.dcount[k & 1] = count;
            __syncwarp();
        } else {
            if (k + 1 < tiles)
                tile_records(ways, sh, (k + 1) & 1, in, n, cur0, ts + TILE, shift, pw, lane);
            if (k)
                op = emit(sh, sh.desc[(k - 1) & 1], sh.dcount[(k - 1) & 1], op, in, o, out_len,
                          tail_pos, tail_lit, row, pt, pw, lane);
            __syncwarp();
        }
        __syncthreads();
    }
    if (tid >= 32)
        emit(sh, sh.desc[(tiles - 1) & 1], sh.dcount[(tiles - 1) & 1], op, in, o, out_len, tail_pos,
             tail_lit, row, pt, pw, lane);
}

// ---------------------------------------------------------------------------
// STRICT mode
// ---------------------------------------------------------------------------

// The next sequence of a row parsed from `anchor`: match start, length and
// offset, or mlen 0 for the literal tail.  Run by lane 0.
struct Seq {
    int mstart, mlen, moff;
};

// The reference greedy parse (compress/mod.rs:166-238; the steps of
// compress.cu's parse_block with a fresh U32 table, acceleration 1, cursor
// 0).  A row has at most 32 KiB, so every candidate is within 0xFFFF.
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

// one warp a row: lane 0 searches, the warp copies each sequence's literals
__global__ void __launch_bounds__(STRICT_THREADS)
compress128_strict_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ base_arr,
                          const int32_t* __restrict__ n_arr, uint8_t* __restrict__ out,
                          int64_t out_stride, int32_t* __restrict__ out_len,
                          int32_t* __restrict__ tail_pos, int32_t* __restrict__ tail_lit) {
    extern __shared__ uint32_t tab[];
    const int lane = threadIdx.x;
    const int64_t row = blockIdx.x;
    const uint8_t* in = src + base_arr[row];
    const int n = n_arr[row];
    constexpr int slots = 1 << MAX_HASHLOG;
    uint8_t* o = out + row * out_stride;

    // the reference's zero-filled table: an empty slot is position 0, here
    // with the tag of the word that lies there
    const uint32_t empty = n >= 4 ? packed(0, read32(in) * HASH_MUL) : 0u;
    for (int i = lane; i < slots; i += STRICT_THREADS) tab[i] = empty;
    __syncwarp();

    int anchor = 0;
    int op = 0;
    for (;;) {
        Seq s{0, 0, 0};
        if (lane == 0) s = search_strict(tab, in, n, anchor);
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
        for (int i = lane; i < lit; i += STRICT_THREADS) o[op + header + i] = in[anchor + i];
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

// Returns the CUDA error of the shared-memory request or of the launch (0
// on success).
extern "C" int lz4t_compress128(const void* src, const void* base, const void* n, const void* cur0,
                                void* out, int64_t out_stride, void* out_len, void* tail_pos,
                                void* tail_lit, int nrows, int hashlog, int strict, void* stream) {
    if (nrows <= 0) return 0;
    if (hashlog < MIN_HASHLOG || hashlog > MAX_HASHLOG || (strict && hashlog != MAX_HASHLOG))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (strict) {
        compress128_strict_kernel<<<nrows, STRICT_THREADS, sizeof(uint32_t) << MAX_HASHLOG, s>>>(
            (const uint8_t*)src, (const int64_t*)base, (const int32_t*)n, (uint8_t*)out, out_stride,
            (int32_t*)out_len, (int32_t*)tail_pos, (int32_t*)tail_lit);
        return (int)cudaGetLastError();
    }
    // the shared-memory request for the largest table, once per device
    const int shared = (int)(sizeof(uint4) << hashlog);
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev >= 64 || !ready[dev])) {
        e = cudaFuncSetAttribute(compress128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(sizeof(uint4) << MAX_HASHLOG));
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(compress128_kernel,
                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        if (e == cudaSuccess && dev < 64) ready[dev] = true;
    }
    if (e != cudaSuccess) return (int)e;
    compress128_kernel<<<nrows, THREADS, shared, s>>>(
        (const uint8_t*)src, (const int64_t*)base, (const int32_t*)n, (const int32_t*)cur0,
        (uint8_t*)out, out_stride, (int32_t*)out_len, (int32_t*)tail_pos, (int32_t*)tail_lit,
        hashlog);
    return (int)cudaGetLastError();
}
