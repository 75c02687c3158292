// LZ4 block decoder for blocks of at most 64 KiB, one thread block per LZ4
// block, the block assembled whole in shared memory.
//
// Replaces: lz4tpu/kernels/decode128.py:225 _decode128_kernel (launched by
// _decode128_jit, decode128.py:997), the lane-parallel decoder that runs
// up to 128 raw blocks in lockstep rounds, one per TPU lane, each with an
// optional right-aligned prefix (dictionary / linked window).
//
// What bounds it on this card: bytes, at best.  Each block's comp stream is
// read once and its output written once, so at the main path's shapes the
// least time is (comp bytes + output bytes) / 3.35 TB/s.  What a block
// actually waits on is latency: LZ4 is byte-serial within a block, and each
// sequence is a chain of dependent reads (token, length bytes, next token).
// A linked frame decodes in waves of one block each, so there a launch lasts
// exactly one block's chain.
//
// What the design does about it: the chain is cut to one walk over the
// tokens in shared memory, and everything else is taken off it.
//   * A block's output is at most 64 KiB where matches may write (the
//     limit is checked at every match), so the whole block is assembled in
//     a 64 KiB buffer in shared memory: matches are served from it, and it
//     leaves in aligned 16-byte stores at the end.  Only literals may run
//     past the limit (by up to the compressed length); such a byte past the
//     staged 64 KiB goes straight to device memory.  The prefix (dictionary
//     or linked window) is read from device memory, where the L2 holds it.
//   * The compressed stream is read ahead into an 8 KiB window in shared
//     memory with 16-byte loads; a byte outside it (a hostile stream, a long
//     literal run) is read from device memory instead.
//   * Warp 0 walks the tokens 32 sequences at a time with the walk that
//     decode_big.cu runs (lz4t::parse_batch in decode_common.cuh): one tight
//     walk in every lane, lane k keeps sequence k, a prefix sum places the
//     output, the checks run in the shared parser's order and a ballot finds
//     the first failure.  While it parses batch k+1, eight copy warps copy
//     batch k: every literal run and every match that reads only older
//     output or its own literals at once, a warp a sequence, then one warp
//     the matches that read their own batch's output, in stream order.
//     A sequence longer than the walk takes is a batch of its own that all
//     threads copy.
// Three thread blocks are resident per SM (72 KiB of shared memory each), so
// a batch of 396 blocks runs in one wave and each SM interleaves three
// chains.  A 32 KiB window (two blocks an SM) and a 64 KiB one (one) were
// measured no faster on one block and slower on a member's batch; staging
// the prefix too was no faster on one block either
// (tools/torch_chip_decode128_cost.py, PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int COPIERS = 256;              // warps 1-8
constexpr int COPY_WARPS = COPIERS / 32;
constexpr int THREADS = 32 + COPIERS;     // warp 0 parses ahead
constexpr int OBUF = 1 << 16;             // output staged in shared memory, bytes
constexpr int MAX_BLOCK = 1 << 16;        // the wrapper's largest limit

// every match ends at or below the limit, so every byte a match writes or
// reads (at or above 0) is staged
static_assert(MAX_BLOCK <= OBUF, "matches must stay in the staged output");

constexpr int CTAS_PER_SM = 3;
constexpr int CWIN = 8 << 10;             // compressed-stream window, bytes
constexpr int BATCH_BYTES = 1 << 10;      // a batch ends once it holds this much output
constexpr int SMALL = 1 << 10;            // longer sequences are a batch of their own
constexpr int REFILL_MARGIN = 5 << 9;     // window left for the batch being parsed
constexpr int SMEM_BYTES = OBUF + CWIN;
// the window holds the batch being copied and the batch being parsed: their
// literals, and per sequence a token, an offset and two length runs of at
// most SMALL / 255 + 1 bytes each (the geometry argument of decode_big.cu)
constexpr int SEQ_OVERHEAD = 3 + 2 * (SMALL / 255 + 1);
static_assert(REFILL_MARGIN >= BATCH_BYTES + SMALL + SEQ_OVERHEAD * lz4t::BATCH,
              "the batch being parsed must fit behind the refill margin");
static_assert(2 * (BATCH_BYTES + SMALL) + REFILL_MARGIN + 2 * SEQ_OVERHEAD * lz4t::BATCH <= CWIN,
              "window too small");

using lz4t::Batch;
using lz4t::Entry;
using lz4t::FLAG_LAST;
using lz4t::FLAG_LONG;
using lz4t::Window;

// output byte p: staged below OBUF, else (a literal past the limit) in
// device memory
__device__ __forceinline__ void put(uint8_t* obuf, uint8_t* o, int p, uint8_t v) {
    if (p < OBUF)
        obuf[p] = v;
    else
        o[p] = v;
}

// V[s], s below the match: staged output, or the right-aligned prefix
__device__ __forceinline__ uint8_t older(const uint8_t* obuf, const uint8_t* pend, int s) {
    return s >= 0 ? obuf[s] : pend[s];
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
decode128_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
                 const int32_t* __restrict__ comp_len, const uint8_t* __restrict__ prefix,
                 long long prefix_stride, long long prefix_width,
                 const int32_t* __restrict__ prefix_len, long long limit, uint8_t* out,
                 long long out_stride, int32_t* __restrict__ out_len,
                 int32_t* __restrict__ status) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ Batch batch[2];
    uint8_t* obuf = smem;
    uint8_t* win = smem + OBUF;
    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    const int n = comp_len[b];
    const int plen = prefix_len[b];
    const uint8_t* pend = prefix + b * prefix_stride + prefix_width;
    uint8_t* o = out + b * out_stride;
    Window w{win, comp + b * comp_stride, 0, 0};  // empty until load_window
    const auto load_window = [&](int from) {
        lz4t::load_window<THREADS>(w, win, n, from, tid, CWIN - 32);
    };

    load_window(0);
    __syncthreads();
    if (tid < 32)
        lz4t::parse_batch<BATCH_BYTES, SMALL>(batch[0], w, n, 0, 0, plen, limit, out_stride, tid);
    __syncthreads();

    int op = 0;
    int cur = 0;
    int st = lz4t::OK;
    for (;;) {
        const Batch& bt = batch[cur];
        const int count = bt.count, next_pos = bt.next_pos, end_op = bt.end_op;
        const int flags = bt.flags;
        st = bt.status;
        const bool done = st != lz4t::OK || (flags & FLAG_LAST);
        if (!(flags & FLAG_LONG) && w.end < n && next_pos + REFILL_MARGIN > w.end) {
            // move the window, keeping this batch's literals in it
            load_window(count ? bt.e[0].lit_src : next_pos);
            __syncthreads();
        }
        if (flags & FLAG_LONG) {
            // every thread copies: the literals (through the window, or from
            // device memory past it), then the match, whose bytes all read
            // output from before it
            const Entry q = bt.e[0];
            for (int j = tid; j < q.lit_len; j += THREADS)
                put(obuf, o, q.op + j, (uint8_t)w(q.lit_src + j));
            __syncthreads();
            const int mop = q.op + q.lit_len;
            const int base = mop - q.offset;
            for (int j = tid; j < q.match_len; j += THREADS)
                obuf[mop + j] = older(obuf, pend, base + (q.offset >= q.match_len ? j : j % q.offset));
            if (!done) {
                if (w.end < n && next_pos + REFILL_MARGIN > w.end) {
                    load_window(next_pos);
                    __syncthreads();
                }
                if (tid < 32)
                    lz4t::parse_batch<BATCH_BYTES, SMALL>(batch[cur ^ 1], w, n, next_pos, end_op,
                                                          plen, limit, out_stride, tid);
            }
        } else if (tid < 32) {
            if (!done)
                lz4t::parse_batch<BATCH_BYTES, SMALL>(batch[cur ^ 1], w, n, next_pos, end_op, plen,
                                                      limit, out_stride, tid);
        } else {
            // round one: every sequence's literals, and every match that
            // reads only older output or its own literals, a warp a sequence
            const int warp = (tid - 32) >> 5, lane = tid & 31;
            const unsigned dependent = bt.dependent;
            for (int k = warp; k < count; k += COPY_WARPS) {
                const Entry q = bt.e[k];
                for (int j = lane; j < q.lit_len; j += 32)
                    put(obuf, o, q.op + j, (uint8_t)w(q.lit_src + j));
                if ((dependent >> k) & 1) continue;
                const int mop = q.op + q.lit_len;
                const int base = mop - q.offset;
                for (int j = lane; j < q.match_len; j += 32) {
                    const int s = base + (q.offset >= q.match_len ? j : j % q.offset);
                    // a source inside this sequence's literals may not be
                    // staged yet: take it from the compressed stream
                    obuf[mop + j] = s >= q.op ? (uint8_t)w(q.lit_src + (s - q.op))
                                              : older(obuf, pend, s);
                }
            }
            if (dependent) {
                // round two: the copy warps meet once (barrier 1; barrier 0 is
                // __syncthreads), then one warp takes the waiting matches in
                // stream order, each complete before the next begins
                asm volatile("barrier.sync 1, %0;" ::"n"(COPIERS) : "memory");
                if (warp == 0) {
                    for (unsigned left = dependent; left; left &= left - 1) {
                        const Entry q = bt.e[__ffs(left) - 1];
                        const int mop = q.op + q.lit_len;
                        const int base = mop - q.offset;
                        for (int j = lane; j < q.match_len; j += 32)
                            obuf[mop + j] = older(obuf, pend,
                                                  base + (q.offset >= q.match_len ? j : j % q.offset));
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
    // the staged output leaves in aligned 16-byte stores, its last bytes one
    // at a time; bytes past op stay zero
    const int staged = min(op, OBUF);
    for (int p = 16 * tid; p + 16 <= staged; p += 16 * THREADS)
        *reinterpret_cast<uint4*>(o + p) = *reinterpret_cast<const uint4*>(obuf + p);
    for (int p = (staged & ~15) + tid; p < staged; p += THREADS) o[p] = obuf[p];
    if (tid == 0) {
        out_len[b] = op;
        status[b] = st;
    }
}

}  // namespace

// prefix rows are right-aligned in `prefix_width` bytes; prefix_stride 0
// shares one row (a dictionary) across the batch.  `limit` is at most
// 64 KiB, `out` 16-byte aligned and out_stride a multiple of 16.  Returns
// the CUDA error of the shared-memory request or of the launch (0 on
// success).
extern "C" int lz4t_decode128(const void* comp, long long comp_stride, const void* comp_len,
                              const void* prefix, long long prefix_stride, long long prefix_width,
                              const void* prefix_len, long long limit, void* out,
                              long long out_stride, void* out_len, void* status, int nblocks,
                              void* stream) {
    if (nblocks <= 0) return 0;
    if (limit > MAX_BLOCK || out_stride % 16) return (int)cudaErrorInvalidValue;
    // the shared-memory request once per device, not at every launch (a
    // wave of one block is short)
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev >= 64 || !ready[dev])) {
        e = cudaFuncSetAttribute(decode128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(decode128_kernel,
                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        if (e == cudaSuccess && dev < 64) ready[dev] = true;
    }
    if (e != cudaSuccess) return (int)e;
    decode128_kernel<<<nblocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_len, (const uint8_t*)prefix,
        prefix_stride, prefix_width, (const int32_t*)prefix_len, limit, (uint8_t*)out, out_stride,
        (int32_t*)out_len, (int32_t*)status);
    return (int)cudaGetLastError();
}
