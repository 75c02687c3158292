// LZ4 block decoder with the newest output and a read-ahead of the
// compressed stream staged per warp in shared memory; one warp per block,
// any block size.
//
// Replaces: lz4tpu/kernels/decompress_v3.py:135 _decode_v3_kernel (launched
// by _decompress_batch_v3_jit, decompress_v3.py:388), the per-block decoder
// that keeps the newest 2 KiB of output and a 1 KiB read-ahead of the
// compressed stream on chip, serves near matches and literals from there,
// flushes with aligned stores and touches memory only for far matches.
//
// What bounds it on this card: bytes, at best: (comp bytes + output bytes)
// / 3.35 TB/s.  What a block waits on is its token walk, the serial chain of
// every LZ4 decoder; v3's design point is many such chains resident on each
// SM, one a warp, so that their latencies hide each other.
//
// What the design does about it: each warp owns its block and about 17 KiB
// of shared memory, and CTAs hold WARPS warps (one), so a batch spreads over
// all 132 SMs before an SM takes a second block and many warps stay
// resident an SM.
//   * The walk is decode128's and decode_big's (lz4t::parse_batch in
//     decode_common.cuh): 32 sequences at a time in one tight walk, output
//     positions by a prefix sum, the checks of the shared parser off the
//     chain and the first failure by a ballot.  The same warp then copies
//     the batch: first every literal and every match that reads only older
//     output or its own literals, a lane a sequence for those of at most
//     SHORT bytes, then the warp for each longer one; then the matches that
//     read their own batch's output (Batch::dependent): those that read no
//     other such match at once, the rest in stream order.  A sequence longer
//     than SMALL is a batch of its own and moves in pieces of PIECE bytes.
//   * A RING-byte ring holds the newest output: every byte is written there
//     first, a match source still in it is a shared-memory read, and only
//     sources that have left it are read from the [prefix | output] buffers
//     in device memory ("far").  Output leaves the ring FLUSH_AT bytes at a
//     time with aligned 16-byte stores.
//   * The warp's copies move 16 bytes a lane: a piece that lies in the
//     sequence's literals (in the window, or past it in device memory), or in
//     a match of offset 16 or more whose source is whole in the ring, in
//     flushed output or in the prefix, is read as five aligned words joined
//     by funnel shifts and written with one 16-byte store; other pieces go a
//     byte at a time.  Long literal runs and far matches, which big blocks
//     and poorly compressible data are made of, are what this is for.
//   * The compressed stream is read ahead into two windows of CWIN bytes:
//     while the warp copies a batch out of one, the next is loaded into the
//     other with cp.async, so a refill does not stop the walk.  A byte
//     outside the window is read from device memory, so the window is a
//     cache, not a limit.
// Nothing routes here by default; the kernel is measured beside decode128
// and decode_v4 (tools/torch_chip_decode_v4_cost.py chooses WARPS and RING).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int WARPS = 1;
constexpr int RING = 8192;          // newest output per warp, bytes (power of two)
constexpr int RMASK = RING - 1;
constexpr int CWIN = 4096;          // each of the two compressed-stream windows
constexpr int WANT = CWIN - 32;     // staged from a refill's first byte
constexpr int FLUSH_AT = 1024;
constexpr int BATCH_BYTES = 1024;   // a batch ends once it holds this much output
constexpr int SMALL = 1024;         // longer sequences are a batch of their own
constexpr int PIECE = 2048;         // and move in such pieces
constexpr int SHORT = 256;          // a sequence up to this long is copied by one lane
constexpr int SEQ_OVERHEAD = 3 + 2 * (SMALL / 255 + 1);
constexpr int REFILL_MARGIN = BATCH_BYTES + SMALL + SEQ_OVERHEAD * lz4t::BATCH;

// a batch, or a piece of a long sequence, writes ring slots that hold
// neither unflushed output nor its own ring sources
static_assert(FLUSH_AT + 16 + BATCH_BYTES + SMALL <= RING, "ring too small for a batch");
static_assert(FLUSH_AT + 16 + PIECE <= RING, "ring too small for a piece");
static_assert(PIECE > SMALL, "a long sequence is longer than a batch's sequences");
static_assert(REFILL_MARGIN < WANT, "the window must hold the batch being parsed");

using lz4t::Batch;
using lz4t::Entry;
using lz4t::Window;

// ring[fl .. end) -> device memory with 16-byte stores (fl, end multiples of 16)
__device__ __forceinline__ int flush(const uint8_t* ring, uint8_t* o, int fl, int end, int lane) {
    for (int p = fl + 16 * lane; p < end; p += 16 * 32)
        *reinterpret_cast<uint4*>(o + p) = *reinterpret_cast<const uint4*>(ring + (p & RMASK));
    return end;
}

// 16 bytes from five aligned words; `word(k)` is the k-th word from the
// one holding the first byte, `shift` the first byte's offset in it, in bits
template <class Word>
__device__ __forceinline__ uint4 join16(const Word& word, int shift) {
    const unsigned w0 = word(0), w1 = word(1), w2 = word(2), w3 = word(3), w4 = word(4);
    return make_uint4(__funnelshift_r(w0, w1, shift), __funnelshift_r(w1, w2, shift),
                      __funnelshift_r(w2, w3, shift), __funnelshift_r(w3, w4, shift));
}

struct Copy {
    uint8_t* ring;
    const uint8_t* o;     // flushed output
    const uint8_t* pend;  // prefix_end: V[s] for s < 0
    Window w;
    int n;                // the compressed stream's length
    int plen;             // the prefix's
    int fl;               // output below this is flushed to o

    // V[s] for a source below the batch: the ring, or device memory once flushed
    __device__ __forceinline__ uint8_t older(int s, int near) const {
        return s >= near ? ring[s & RMASK] : s >= 0 ? o[s] : pend[s];
    }

    // byte p of entry q (not a dependent match): a literal, or a match byte
    // from older output or from its own literals (through the window: the
    // ring may not hold them yet)
    __device__ __forceinline__ uint8_t byte(const Entry& q, int p, int near) const {
        const int rel = p - q.op;
        if (rel < q.lit_len) return (uint8_t)w(q.lit_src + rel);
        const int mop = q.op + q.lit_len, j = rel - q.lit_len;
        const int s = mop - q.offset + (q.offset >= q.match_len ? j : j % q.offset);
        return s >= q.op ? (uint8_t)w(q.lit_src + (s - q.op)) : older(s, near);
    }

    // the 16 bytes at p of entry q in one piece, when they lie in its
    // literals or in a match of offset >= 16 whose source is whole in the
    // ring, in flushed output or in the prefix; false otherwise
    __device__ __forceinline__ bool wide(const Entry& q, int p, int near, uint4& v) const {
        if (p + 16 <= q.op + q.lit_len) {
            const int s = q.lit_src + (p - q.op);
            if (s >= w.base && s + 16 <= w.end) return join_at(w.c + s, false, v);
            // a long literal run past the window: aligned words of the row
            return s >= 4 && s + 20 <= n && join_at(w.g + s, true, v);
        }
        const int mop = q.op + q.lit_len;
        if (p < mop || q.offset < 16 || p + 16 > mop + q.match_len) return false;
        const int r = (p - mop) % q.offset;
        if (r + 16 > q.offset) return false;  // the source wraps at the offset
        const int s = mop - q.offset + r;
        if (s + 16 > q.op) return false;      // own literals: a byte at a time
        if (s >= near) {
            const unsigned* words = reinterpret_cast<const unsigned*>(ring);
            const int w0 = s >> 2;
            v = join16([&](int k) { return words[(w0 + k) & (RMASK >> 2)]; }, 8 * (s & 3));
            return true;
        }
        if (s >= 0) return s + 20 <= fl && join_at(o + s, false, v);  // written here: no __ldg
        return s + 20 <= 0 && s - 4 >= -plen && join_at(pend + s, true, v);
    }

    // the 16 bytes at b from the five aligned words around them
    __device__ __forceinline__ bool join_at(const uint8_t* b, bool read_only, uint4& v) const {
        const uintptr_t at = (uintptr_t)b;
        const unsigned* base = reinterpret_cast<const unsigned*>(at & ~(uintptr_t)3);
        if (read_only)
            v = join16([&](int k) { return __ldg(base + k); }, 8 * (int)(at & 3));
        else
            v = join16([&](int k) { return base[k]; }, 8 * (int)(at & 3));
        return true;
    }

    // the literals of q by one lane: straight from the window when they lie
    // in it
    __device__ __forceinline__ void lits_by_lane(const Entry& q) const {
        if (q.lit_src + q.lit_len <= w.end) {
            const uint8_t* lits = w.c + q.lit_src;
            for (int j = 0; j < q.lit_len; j++) ring[(q.op + j) & RMASK] = lits[j];
        } else {
            for (int j = 0; j < q.lit_len; j++) ring[(q.op + j) & RMASK] = (uint8_t)w(q.lit_src + j);
        }
    }

    // the match of q by one lane: byte j is V[mop - offset + (j mod offset)],
    // straight from the ring when every source is in it (its own literals
    // included: this lane, or the warp before round two, wrote them)
    __device__ __forceinline__ void match_by_lane(const Entry& q, int near) const {
        const int mop = q.op + q.lit_len, from = mop - q.offset;
        if (from >= near) {
            for (int j = 0, r = 0; j < q.match_len; j++) {  // r = j mod offset
                ring[(mop + j) & RMASK] = ring[(from + r) & RMASK];
                if (++r == q.offset) r = 0;
            }
            return;
        }
        for (int j = 0, r = 0; j < q.match_len; j++) {
            ring[(mop + j) & RMASK] = older(from + r, near);
            if (++r == q.offset) r = 0;
        }
    }

    // output [lo, hi) of q by the warp, lanes over 16-byte pieces of it
    __device__ void by_warp(const Entry& q, int lo, int hi, int near, int lane) const {
        for (int a = (lo & ~15) + 16 * lane; a < hi; a += 16 * 32) {
            uint4 v;
            if (a >= lo && a + 16 <= hi && wide(q, a, near, v)) {
                *reinterpret_cast<uint4*>(ring + (a & RMASK)) = v;
                continue;
            }
            const int last = a + 16 < hi ? a + 16 : hi;
            for (int p = a > lo ? a : lo; p < last; p++) ring[p & RMASK] = byte(q, p, near);
        }
    }

    // the match of q by the warp, a byte a lane
    __device__ void match_by_warp(const Entry& q, int near, int lane) const {
        const int mop = q.op + q.lit_len;
        for (int j = lane; j < q.match_len; j += 32) {
            const int s = mop - q.offset + (q.offset >= q.match_len ? j : j % q.offset);
            ring[(mop + j) & RMASK] = older(s, near);
        }
    }

    // round one: every literal and every match that is not dependent, of
    // entries e[0 .. count) that end at end_op: a lane a sequence for those
    // of at most SHORT bytes, then the warp for each longer one, 16 bytes a
    // lane
    __device__ void round_one(const Entry* e, int count, unsigned dependent, int end_op,
                              int lane) const {
        const int near = max(end_op - RING, 0);  // the prefix is never in the ring
        bool longer = false;
        if (lane < count) {
            const Entry q = e[lane];
            longer = q.lit_len + q.match_len > SHORT;
            if (!longer) {
                lits_by_lane(q);
                if (!((dependent >> lane) & 1)) match_by_lane(q, near);
            }
        }
        for (unsigned left = __ballot_sync(lz4t::FULL_MASK, longer); left; left &= left - 1) {
            const int k = __ffs(left) - 1;
            const Entry q = e[k];
            by_warp(q, q.op, q.op + q.lit_len + ((dependent >> k) & 1 ? 0 : q.match_len), near,
                    lane);
        }
    }

    // round two: the matches that read their own batch's output.  Those
    // that read no other such match (only literals and round one's matches,
    // all written) go at once, a lane each or the warp for a long one; the
    // rest in stream order, each complete before the next begins
    __device__ void round_two(const Entry* e, unsigned dependent, int end_op, int lane) const {
        const int near = max(end_op - RING, 0);  // the prefix is never in the ring
        bool chained = false;
        if ((dependent >> lane) & 1) {
            const Entry q = e[lane];
            const int from = q.op + q.lit_len - q.offset;
            const int upper = from + min(q.match_len, q.offset);
            for (unsigned left = dependent & ((1u << lane) - 1); left; left &= left - 1) {
                const Entry r = e[__ffs(left) - 1];
                const int rm = r.op + r.lit_len;
                if (from < rm + r.match_len && upper > rm) {
                    chained = true;
                    break;
                }
            }
        }
        const unsigned later = __ballot_sync(lz4t::FULL_MASK, chained);
        const unsigned now = dependent & ~later;
        bool longer = false;
        if ((now >> lane) & 1) {
            const Entry q = e[lane];
            longer = q.match_len > SHORT;
            if (!longer) match_by_lane(q, near);
        }
        for (unsigned left = __ballot_sync(lz4t::FULL_MASK, longer); left; left &= left - 1)
            match_by_warp(e[__ffs(left) - 1], near, lane);
        __syncwarp();
        for (unsigned left = later; left; left &= left - 1) {
            match_by_warp(e[__ffs(left) - 1], near, lane);
            __syncwarp();
        }
    }

};

__global__ void __launch_bounds__(WARPS * 32)
decode_v3_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
                 const int32_t* __restrict__ comp_len, const uint8_t* __restrict__ prefix,
                 long long prefix_stride, long long prefix_width,
                 const int32_t* __restrict__ prefix_len, long long limit, uint8_t* out,
                 long long out_stride, int32_t* __restrict__ out_len,
                 int32_t* __restrict__ status, int nblocks) {
    __shared__ __align__(16) uint8_t rings[WARPS][RING];
    __shared__ __align__(16) uint8_t wins[WARPS][2][CWIN];
    __shared__ Batch batches[WARPS];
    __shared__ Entry pieces[WARPS];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * WARPS + warp;
    if (b >= nblocks) return;  // whole warp exits together; no block-wide barrier follows
    Batch& bt = batches[warp];
    Entry& piece = pieces[warp];
    const int n = comp_len[b];
    const int plen = prefix_len[b];
    uint8_t* o = out + b * out_stride;
    Copy cp{rings[warp], o, prefix + b * prefix_stride + prefix_width,
            Window{nullptr, comp + b * comp_stride, 0, 0}, n, plen, 0};
    lz4t::load_window<32>(cp.w, wins[warp][0], n, 0, lane, WANT);
    __syncwarp();

    // a piece of a long sequence, copied as an entry of its own (its
    // sources all lie before it)
    const auto copy_piece = [&](int op, int lit_src, int lit_len, int match_len, int offset) {
        if (lane == 0) piece = Entry{op, lit_src, lit_len, match_len, offset};
        __syncwarp();
        cp.round_one(&piece, 1, 0, op + lit_len + match_len, lane);
        __syncwarp();
    };

    int pos = 0, op = 0, cur = 0;
    int& fl = cp.fl;
    int st = lz4t::OK;
    for (;;) {
        lz4t::parse_batch<BATCH_BYTES, SMALL>(bt, cp.w, n, pos, op, plen, limit, out_stride, lane);
        const int count = bt.count, next_pos = bt.next_pos, end_op = bt.end_op;
        const int flags = bt.flags;
        const unsigned dependent = bt.dependent;
        st = bt.status;
        const bool done = st != lz4t::OK || (flags & lz4t::FLAG_LAST);
        // read ahead into the other window while this batch is copied
        Window next = cp.w;
        const bool refill = !done && cp.w.end < n && next_pos + REFILL_MARGIN > cp.w.end;
        if (refill) lz4t::load_window_async<32>(next, wins[warp][cur ^ 1], n, next_pos, lane, WANT);
        if (op - fl >= FLUSH_AT) {
            fl = flush(cp.ring, o, fl, op & ~15, lane);
            __syncwarp();  // the flushed bytes may be read back below
        }
        if (flags & lz4t::FLAG_LONG) {
            const Entry q = bt.e[0];
            for (int done_bytes = 0; done_bytes < q.lit_len; done_bytes += PIECE) {
                if (op - fl >= FLUSH_AT) {
                    fl = flush(cp.ring, o, fl, op & ~15, lane);
                    __syncwarp();
                }
                const int len = min(PIECE, q.lit_len - done_bytes);
                copy_piece(op, q.lit_src + done_bytes, len, 0, 0);
                op += len;
            }
            // piece j of a match is a match of the same offset at its own
            // start, so each piece reads only bytes written before it began
            for (int done_bytes = 0; done_bytes < q.match_len; done_bytes += PIECE) {
                if (op - fl >= FLUSH_AT) {
                    fl = flush(cp.ring, o, fl, op & ~15, lane);
                    __syncwarp();
                }
                const int len = min(PIECE, q.match_len - done_bytes);
                copy_piece(op, 0, 0, len, q.offset);
                op += len;
            }
        } else if (count) {
            cp.round_one(bt.e, count, dependent, end_op, lane);
            __syncwarp();
            if (dependent) cp.round_two(bt.e, dependent, end_op, lane);
            op = end_op;
        }
        if (done) break;
        if (refill) {
            lz4t::cp_async_wait_all();
            __syncwarp();
            cp.w = next;
            cur ^= 1;
        }
        pos = next_pos;
    }
    // the rest of the ring; bytes past op stay zero, so the tail goes bytewise
    fl = flush(cp.ring, o, fl, op & ~15, lane);
    for (int p = fl + lane; p < op; p += 32) o[p] = cp.ring[p & RMASK];
    if (lane == 0) {
        out_len[b] = op;
        status[b] = st;
    }
}

}  // namespace

// Same arguments as lz4t_decode128; `out` must be 16-byte aligned and
// out_stride a multiple of 16.  Returns cudaGetLastError() after the launch.
extern "C" int lz4t_decode_v3(const void* comp, long long comp_stride, const void* comp_len,
                              const void* prefix, long long prefix_stride, long long prefix_width,
                              const void* prefix_len, long long limit, void* out,
                              long long out_stride, void* out_len, void* status, int nblocks,
                              void* stream) {
    if (nblocks <= 0) return 0;
    const int grid = (nblocks + WARPS - 1) / WARPS;
    decode_v3_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_len, (const uint8_t*)prefix,
        prefix_stride, prefix_width, (const int32_t*)prefix_len, limit, (uint8_t*)out, out_stride,
        (int32_t*)out_len, (int32_t*)status, nblocks);
    return (int)cudaGetLastError();
}
