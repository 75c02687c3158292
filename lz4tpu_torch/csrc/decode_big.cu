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
//   * Warp 0 parses ahead, as a warp: while the eight copy warps move batch
//     k (up to 32 sequences, about 8 KiB of output), it parses batch k+1
//     into the other of two queues in shared memory.  The chain is cut to
//     one walk over the tokens: every lane follows the same walk (token,
//     length runs, next token: one or two dependent shared-memory loads a
//     sequence) and lane k keeps what the walk saw at sequence k.  Off the
//     chain, lane k then reads sequence k's offset, a warp prefix sum over
//     the lengths gives every output position, each lane makes the checks
//     of the shared parser in their order, and a ballot finds the first
//     failing sequence: the batch ends before it with its status.  A
//     sequence the walk cannot take whole (the stream or the window ends
//     inside it, or it is longer than 8 KiB) opens a batch of its own
//     through the shared parse_seq.
//   * The copy warps meet only where sequences depend on each other.  Lane
//     k also decides whether sequence k's match reads output that an earlier
//     sequence of the same batch writes.  All literals and all matches that
//     do not are copied at once, a warp a sequence; then the copy warps
//     meet once at a named barrier, and one warp copies the dependent
//     matches in stream order (the multi-round resolution of "massively
//     parallel decompression", arXiv 1606.00519, cut to two rounds).  One
//     block-wide barrier ends a batch.
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
// up to 132 blocks runs in one wave.  The window is still loaded by all
// threads between two batches; a cp.async/TMA read-ahead is left for later.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int COPIERS = 256;           // warps 1-8
constexpr int COPY_WARPS = COPIERS / 32;
constexpr int THREADS = 32 + COPIERS;  // warp 0 parses ahead
constexpr int RING = 1 << 17;          // output ring, bytes (power of two)
constexpr int RMASK = RING - 1;
constexpr int CWIN = 1 << 16;          // compressed-stream window, bytes
constexpr int FLUSH_AT = 1 << 14;      // flush when this much is unflushed
constexpr int PIECE = 1 << 14;         // long sequences move in such pieces
constexpr int SMALL = 1 << 13;         // longer sequences take the piece path
constexpr int BATCH = lz4t::BATCH;     // sequences parsed ahead per barrier: one a lane
constexpr int BATCH_BYTES = 1 << 13;   // a batch ends once it holds this much output
constexpr int REFILL_MARGIN = 3 << 13; // window left for the batch being parsed
constexpr int MAX_DISTANCE = 1 << 16;  // offsets are u16
constexpr int SMEM_BYTES = RING + CWIN;

// ring slots written by a step must hold neither unflushed bytes nor bytes
// a match may still read: 64 KiB of history + unflushed + one step < RING
static_assert(BATCH_BYTES + SMALL <= PIECE, "a batch is at most one piece");
static_assert(MAX_DISTANCE + FLUSH_AT + 16 + 2 * PIECE <= RING, "ring too small");
// the window holds the batch being copied and the batch being parsed: their
// literals, and per sequence a token, an offset and two length runs of at
// most SMALL / 255 + 1 bytes each
constexpr int SEQ_OVERHEAD = 3 + 2 * (SMALL / 255 + 1);
static_assert(BATCH == 32, "lane k parses sequence k");
static_assert(REFILL_MARGIN >= BATCH_BYTES + SMALL + SEQ_OVERHEAD * BATCH,
              "the batch being parsed must fit behind the refill margin");
static_assert(2 * (BATCH_BYTES + SMALL) + REFILL_MARGIN + 2 * SEQ_OVERHEAD * BATCH <= CWIN,
              "window too small");

using lz4t::Batch;
using lz4t::Entry;
using lz4t::FLAG_LAST;
using lz4t::FLAG_LONG;
using lz4t::Window;

__device__ __forceinline__ void load_window(Window& w, uint8_t* win, int n, int from, int tid,
                                            int want = CWIN - 32) {
    lz4t::load_window<THREADS>(w, win, n, from, tid, want);
}

__device__ __forceinline__ void parse_batch(Batch& bt, const Window& w, int n, int pos, int op,
                                            int plen, long long limit, long long out_cap,
                                            int lane) {
    lz4t::parse_batch<BATCH_BYTES, SMALL>(bt, w, n, pos, op, plen, limit, out_cap, lane);
}

// ring[fl .. end) -> device memory with 16-byte stores; fl and end are
// multiples of 16, the row is 16-byte aligned
__device__ __forceinline__ int flush(const uint8_t* ring, uint8_t* o, int fl, int end, int tid) {
    for (int p = fl + 16 * tid; p < end; p += 16 * THREADS)
        *reinterpret_cast<uint4*>(o + p) = *reinterpret_cast<const uint4*>(ring + (p & RMASK));
    return end;
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
    if (tid < 32) parse_batch(batch[0], w, n, 0, 0, plen, limit, out_stride, tid);
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
                if (tid < 32)
                    parse_batch(batch[cur ^ 1], w, n, next_pos, end_op, plen, limit, out_stride,
                                tid);
            }
        } else if (tid < 32) {
            if (!done)
                parse_batch(batch[cur ^ 1], w, n, next_pos, end_op, plen, limit, out_stride, tid);
        } else {
            // round one: every sequence's literals, and every match that
            // reads only older output or its own literals, a warp a sequence
            const int warp = (tid - 32) >> 5, lane = tid & 31;
            const unsigned dependent = bt.dependent;
            for (int k = warp; k < count; k += COPY_WARPS) {
                const Entry q = bt.e[k];
                for (int j = lane; j < q.lit_len; j += 32)
                    ring[(q.op + j) & RMASK] = (uint8_t)w(q.lit_src + j);
                if ((dependent >> k) & 1) continue;
                const int mop = q.op + q.lit_len;
                const int base = mop - q.offset;
                for (int j = lane; j < q.match_len; j += 32) {
                    const int s = base + (q.offset >= q.match_len ? j : j % q.offset);
                    // a source inside this sequence's literals may not be in
                    // the ring yet: take it from the compressed stream
                    ring[(mop + j) & RMASK] =
                        s >= q.op ? (uint8_t)w(q.lit_src + (s - q.op)) : ring[s & RMASK];
                }
            }
            if (dependent) {
                // round two: the copy warps meet once (barrier 1; barrier 0 is
                // __syncthreads), then one warp takes the waiting matches in
                // stream order, each complete before the next begins
                asm volatile("bar.sync 1, %0;" ::"n"(COPIERS) : "memory");
                if (warp == 0) {
                    for (unsigned left = dependent; left; left &= left - 1) {
                        const Entry q = bt.e[__ffs(left) - 1];
                        const int mop = q.op + q.lit_len;
                        const int base = mop - q.offset;
                        for (int j = lane; j < q.match_len; j += 32)
                            ring[(mop + j) & RMASK] =
                                ring[(base + (q.offset >= q.match_len ? j : j % q.offset)) & RMASK];
                        __syncwarp();
                    }
                }
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
