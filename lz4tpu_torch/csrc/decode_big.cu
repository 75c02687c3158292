// LZ4 block decoder for big blocks (256 KiB - 4 MiB, any size in fact), one
// thread block per LZ4 block, both streams staged through shared memory.
//
// Replaces: lz4tpu/kernels/decodebig.py:136 _decodebig_kernel (launched by
// _decodebig_jit, decodebig.py:1088), the lane decoder that streams up to
// 128 big blocks through bounded on-chip bands of the compressed stream and
// of the output, with a per-lane prefix (dictionary / linked window) seeded
// into the first output band.
//
// What bounds it on this card: bytes, at best: (comp bytes + output bytes)
// / 3.35 TB/s.  What a big block actually waits on is latency: LZ4 is
// byte-serial within a block, so every sequence is a chain of dependent
// reads (token, length bytes, offset, then the match source).  decode_v4.cu
// takes each link of that chain from device memory/L2 and pays two or three
// block-wide barriers per sequence.
//
// What the design does about it (the TPU kernel's idea, on an SM): a match
// never reaches further back than 64 KiB, so everything on the chain fits
// in shared memory, and the chain itself is cut to the parse.
//   * The newest 128 KiB of output is a ring in shared memory, seeded with
//     the prefix's last 64 KiB at the positions before 0.  Literals and
//     matches are written into the ring and matches are served from it;
//     finished ring segments go to device memory 16 KiB at a time with
//     aligned 16-byte stores, off the chain.
//   * The compressed stream is read ahead into a 64 KiB window in shared
//     memory with 16-byte loads; the parser and the literal copies read the
//     window (a byte outside it, e.g. in a length run longer than the
//     window, is read from device memory instead, so the window is a cache,
//     not a limit).
//   * Warp 0 parses ahead (lane 0): while the four copy warps move batch k
//     (up to 16 sequences, about 8 KiB of output), it parses batch k+1 into
//     the other of two queues in shared memory.  One block-wide barrier
//     ends a batch; between the sequences of a batch only the copy warps
//     meet, at a named barrier.  Measured on this card, copying hides
//     entirely behind the parse, which one thread runs at a few hundred
//     cycles per sequence: the common sequence (both lengths in the token,
//     all of it in the window) therefore takes a short path through the
//     parser, and everything else the shared parse_seq.
//   * A match whose source lies in its own sequence's literals reads them
//     from the window, so literals and match are copied in one step.
//   * A sequence longer than 8 KiB (long literal runs of stored-like data,
//     long matches of runs) is a batch of its own and is copied by all
//     threads in pieces of 16 KiB with a flush between pieces; piece j of a
//     match is a match of the same offset at its own start, so the ring
//     never has to hold more than the window plus one piece.  A literal
//     piece is staged through the window, so it too leaves device memory
//     in 16-byte loads.
// One block is resident per SM (192 KiB of shared memory), so a launch of
// up to 132 blocks runs in one wave.  cp.async/TMA read-ahead and a parse
// split over several threads are left for later.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int COPIERS = 128;           // warps 1-4
constexpr int THREADS = 32 + COPIERS;  // warp 0 parses ahead
constexpr int RING = 1 << 17;          // output ring, bytes (power of two)
constexpr int RMASK = RING - 1;
constexpr int CWIN = 1 << 16;          // compressed-stream window, bytes
constexpr int FLUSH_AT = 1 << 14;      // flush when this much is unflushed
constexpr int PIECE = 1 << 14;         // long sequences move in such pieces
constexpr int SMALL = 1 << 13;         // longer sequences take the piece path
constexpr int BATCH = 16;              // sequences parsed ahead per barrier
constexpr int BATCH_BYTES = 1 << 13;   // a batch ends once it holds this much output
constexpr int REFILL_MARGIN = 3 << 13; // window left for the batch being parsed
constexpr int MAX_DISTANCE = 1 << 16;  // offsets are u16
constexpr int SMEM_BYTES = RING + CWIN;

// ring slots written by a step must hold neither unflushed bytes nor bytes
// a match may still read: 64 KiB of history + unflushed + one step < RING
static_assert(BATCH_BYTES + SMALL <= PIECE, "a batch is at most one piece");
static_assert(MAX_DISTANCE + FLUSH_AT + 16 + 2 * PIECE <= RING, "ring too small");
// the window holds the batch being copied and the batch being parsed
static_assert(2 * (BATCH_BYTES + SMALL) + REFILL_MARGIN + 64 * BATCH <= CWIN, "window too small");

struct BigSeq {
    int next_pos, lit_src, lit_len, match_len, offset, status;
};

struct Entry {
    int op, lit_src, lit_len, match_len, offset;
};

constexpr int FLAG_LAST = 1;  // the stream ends with this batch
constexpr int FLAG_LONG = 2;  // one sequence longer than SMALL, alone

struct Batch {
    int count;     // sequences in e[]
    int next_pos;  // compressed position after them
    int end_op;    // output position after them
    int status;    // not OK: the sequence after them failed, decoding ends
    int flags;
    Entry e[BATCH];
};

// the compressed stream: bytes [base, end) staged in shared memory, the
// rest read from device memory.  The window only moves forward and never
// past the oldest byte still to be read (the literals of the batch being
// copied), so no read is below `base` and one comparison decides.
struct Window {
    const uint8_t* c;  // the staged bytes, indexed by stream position
    const uint8_t* g;
    int base, end;
    __device__ __forceinline__ int operator()(long long p) const {
        const int i = (int)p;
        return i < end ? c[i] : g[i];
    }
};

// stage comp[from .. from + want) into the window, all threads; the window
// starts at the 16-byte boundary of device memory at or below `from`
__device__ __forceinline__ void load_window(Window& w, uint8_t* win, int n, int from, int tid,
                                            int want = CWIN - 32) {
    const int skew = (int)((uintptr_t)(w.g + from) & 15);
    const int base = from - skew;  // may be as low as -15
    const int end = min(from + want, n);
    for (int p = base + 16 * tid; p < end; p += 16 * THREADS) {
        uint8_t* d = win + (p - base);
        if (p >= 0 && p + 16 <= n) {
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(w.g + p);
        } else {  // the row's first and last bytes
            for (int i = 0; i < 16; i++)
                if (p + i >= 0 && p + i < n) d[i] = w.g[p + i];
        }
    }
    w.c = win - base;
    w.base = base;
    w.end = end;
}

// ring[fl .. end) -> device memory with 16-byte stores; fl and end are
// multiples of 16, the row is 16-byte aligned
__device__ __forceinline__ int flush(const uint8_t* ring, uint8_t* o, int fl, int end, int tid) {
    for (int p = fl + 16 * tid; p < end; p += 16 * THREADS)
        *reinterpret_cast<uint4*>(o + p) = *reinterpret_cast<const uint4*>(ring + (p & RMASK));
    return end;
}

__device__ __forceinline__ BigSeq parse_at(const Window& w, int n, int pos, int op, int plen,
                                           long long limit, long long out_cap) {
    BigSeq q;
    // the common sequence: both lengths in the token, token to offset inside
    // the window.  The same checks in the same order as parse_seq_with; the
    // window ends at or before n, so the stream cannot end inside.
    if (pos + 18 <= w.end) {
        const uint8_t* c = w.c;
        const int token = c[pos];
        const int lit = token >> 4;
        if (lit != 0xF && (token & 0xF) != 0xF) {
            const int at = pos + 1 + lit;
            const int offset = c[at] | (c[at + 1] << 8);
            const int ml = (token & 0xF) + 4;
            const int mop = op + lit;
            q.next_pos = at + 2;
            q.lit_src = pos + 1;
            q.lit_len = lit;
            q.match_len = ml;
            q.offset = offset;
            q.status = mop > out_cap || mop + ml > limit ? lz4t::ERR_MEMORY_LIMIT
                       : offset == 0                      ? lz4t::ERR_ZERO_OFFSET
                       : offset > mop + plen              ? lz4t::ERR_INVALID_OFFSET
                                                          : lz4t::OK;
            return q;
        }
    }
    const lz4t::Seq s = lz4t::parse_seq_with(w, n, pos, op, plen, limit, out_cap);
    q.next_pos = (int)s.next_pos;
    q.lit_src = (int)s.lit_src;
    q.lit_len = (int)s.lit_len;
    q.match_len = (int)s.match_len;
    q.offset = (int)s.offset;
    q.status = s.status;
    return q;
}

// Lane 0 of warp 0: parse the next batch, from (pos, op).  A batch with no
// sequence has FLAG_LAST or a failing status.
__device__ void parse_batch(Batch& bt, const Window& w, int n, int pos, int op, int plen,
                            long long limit, long long out_cap) {
    const int start_op = op;
    int count = 0, flags = 0, status = lz4t::OK;
    for (;;) {
        if (pos >= n) {
            flags |= FLAG_LAST;
            break;
        }
        const BigSeq q = parse_at(w, n, pos, op, plen, limit, out_cap);
        if (q.status != lz4t::OK) {
            status = q.status;
            break;
        }
        const int len = q.lit_len + q.match_len;
        if (len > SMALL) {
            if (count) break;  // it opens the next batch
            flags |= FLAG_LONG;
        }
        bt.e[count++] = Entry{op, q.lit_src, q.lit_len, q.match_len, q.offset};
        pos = q.next_pos;
        op += len;
        if (len > SMALL || count == BATCH || op - start_op >= BATCH_BYTES ||
            (w.end < n && pos + SMALL + 64 > w.end)) {  // or the window has to move first
            if (pos >= n) flags |= FLAG_LAST;
            break;
        }
    }
    bt.count = count;
    bt.next_pos = pos;
    bt.end_op = op;
    bt.status = status;
    bt.flags = flags;
}

__global__ void __launch_bounds__(THREADS, 1)
decode_big_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
                  const int32_t* __restrict__ comp_len, const uint8_t* __restrict__ prefix,
                  long long prefix_stride, long long prefix_width,
                  const int32_t* __restrict__ prefix_len, long long limit, uint8_t* out,
                  long long out_stride, int32_t* __restrict__ out_len,
                  int32_t* __restrict__ status) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ Batch batch[2];
    uint8_t* ring = smem;
    uint8_t* win = smem + RING;
    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    const int n = comp_len[b];
    const int plen = prefix_len[b];
    const uint8_t* pend = prefix + b * prefix_stride + prefix_width;
    uint8_t* o = out + b * out_stride;
    Window w{win, comp + b * comp_stride, 0, 0};  // empty until load_window

    // the prefix's last 64 KiB sits in the ring just before position 0
    const int seed = min(plen, MAX_DISTANCE);
    for (int j = tid; j < seed; j += THREADS) ring[(-1 - j) & RMASK] = pend[-1 - j];
    load_window(w, win, n, 0, tid);
    __syncthreads();
    if (tid == 0) parse_batch(batch[0], w, n, 0, 0, plen, limit, out_stride);
    __syncthreads();

    int op = 0;  // output position: ring and device memory share it
    int fl = 0;  // output below fl is in device memory
    int cur = 0;
    int st = lz4t::OK;
    for (;;) {
        const Batch& bt = batch[cur];
        const int count = bt.count, next_pos = bt.next_pos, end_op = bt.end_op;
        const int flags = bt.flags;
        st = bt.status;
        const bool done = st != lz4t::OK || (flags & FLAG_LAST);
        if (op - fl >= FLUSH_AT) fl = flush(ring, o, fl, op & ~15, tid);
        if (!(flags & FLAG_LONG) && w.end < n && next_pos + REFILL_MARGIN > w.end) {
            // move the window, keeping this batch's literals in it
            load_window(w, win, n, count ? bt.e[0].lit_src : next_pos, tid);
            __syncthreads();
        }
        if (flags & FLAG_LONG) {
            // every thread copies; each piece ends in a barrier, so a piece
            // reads only ring bytes that are complete.  Literals pass through
            // the window piece by piece: 16-byte loads from device memory,
            // then bytes from shared memory to wherever the ring stands
            const Entry q = bt.e[0];
            int src = q.lit_src;
            for (int rem = q.lit_len; rem > 0;) {
                const int len = min(rem, PIECE);
                load_window(w, win, n, src, tid, len);
                __syncthreads();
                for (int j = tid; j < len; j += THREADS) ring[(op + j) & RMASK] = w.c[src + j];
                op += len;
                src += len;
                rem -= len;
                __syncthreads();
                if (op - fl >= FLUSH_AT) fl = flush(ring, o, fl, op & ~15, tid);
            }
            for (int rem = q.match_len; rem > 0;) {
                const int len = min(rem, PIECE);
                const int base = op - q.offset;
                for (int j = tid; j < len; j += THREADS)
                    ring[(op + j) & RMASK] =
                        ring[(base + (q.offset >= len ? j : j % q.offset)) & RMASK];
                op += len;
                rem -= len;
                __syncthreads();
                if (op - fl >= FLUSH_AT) fl = flush(ring, o, fl, op & ~15, tid);
            }
            if (!done) {
                if (w.end < n && next_pos + REFILL_MARGIN > w.end) {
                    load_window(w, win, n, next_pos, tid);
                    __syncthreads();
                }
                if (tid == 0)
                    parse_batch(batch[cur ^ 1], w, n, next_pos, end_op, plen, limit, out_stride);
            }
        } else if (tid == 0) {
            if (!done) parse_batch(batch[cur ^ 1], w, n, next_pos, end_op, plen, limit, out_stride);
        } else if (tid >= 32) {
            const int t = tid - 32;
            for (int k = 0; k < count; k++) {
                const Entry q = bt.e[k];
                for (int j = t; j < q.lit_len; j += COPIERS)
                    ring[(q.op + j) & RMASK] = (uint8_t)w(q.lit_src + j);
                const int mop = q.op + q.lit_len;
                const int base = mop - q.offset;
                for (int j = t; j < q.match_len; j += COPIERS) {
                    const int s = base + (q.offset >= q.match_len ? j : j % q.offset);
                    // a source inside this sequence's literals may not be in
                    // the ring yet: take it from the compressed stream
                    ring[(mop + j) & RMASK] =
                        s >= q.op ? (uint8_t)w(q.lit_src + (s - q.op)) : ring[s & RMASK];
                }
                // the next sequence may read what this one wrote: the copy
                // warps meet (barrier 1; barrier 0 is __syncthreads)
                if (k + 1 < count) asm volatile("bar.sync 1, %0;" ::"n"(COPIERS) : "memory");
            }
        }
        op = end_op;
        __syncthreads();
        if (done) break;
        cur ^= 1;
    }
    // the rest of the ring; bytes past op stay zero, so the tail goes bytewise
    fl = flush(ring, o, fl, op & ~15, tid);
    for (int p = fl + tid; p < op; p += THREADS) o[p] = ring[p & RMASK];
    if (tid == 0) {
        out_len[b] = op;
        status[b] = st;
    }
}

}  // namespace

// Same arguments as lz4t_decode128; `out` must be 16-byte aligned and
// out_stride a multiple of 16.  Returns the CUDA error of the shared-memory
// request or of the launch (0 on success).
extern "C" int lz4t_decode_big(const void* comp, long long comp_stride, const void* comp_len,
                               const void* prefix, long long prefix_stride,
                               long long prefix_width, const void* prefix_len, long long limit,
                               void* out, long long out_stride, void* out_len, void* status,
                               int nblocks, void* stream) {
    if (nblocks <= 0) return 0;
    cudaError_t e = cudaFuncSetAttribute(decode_big_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    decode_big_kernel<<<nblocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_len, (const uint8_t*)prefix,
        prefix_stride, prefix_width, (const int32_t*)prefix_len, limit, (uint8_t*)out, out_stride,
        (int32_t*)out_len, (int32_t*)status);
    return (int)cudaGetLastError();
}
