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
// / 3.35 TB/s.  Like the other decoders it waits on the serial chain of
// each sequence instead; v3's share of that chain is the memory round trip
// of the parse and of every match source.
//
// What the design does about it: each warp owns 6 KiB of shared memory.
//   * A 4 KiB ring holds the newest output: every literal and match byte is
//     written there first, so a match whose source is still in the ring
//     (always when offset <= 3072, the "near" matches: runs, recent
//     history) is a shared-memory read.  Only bytes that left the ring are
//     read from the [prefix | output] buffers in device memory ("far").
//   * Output leaves the ring 1 KiB at a time with aligned 16-byte stores.
//   * The compressed stream is read ahead 2 KiB at a time with 16-byte
//     loads; the parse and the literal copies read the staged bytes (a byte
//     outside the window is read from device memory, so the window is a
//     cache, not a limit).
// Lane 0 parses, the warp copies, as in decode128.cu, whose difference is
// that it reads and writes device memory directly.  Nothing routes here by
// default; the kernel is measured beside decode128 and decode_v4.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int RING = 4096;  // newest output per warp, bytes (power of two)
constexpr int RMASK = RING - 1;
constexpr int CWIN = 2048;  // compressed-stream read-ahead per warp
constexpr int FLUSH_AT = 1024;
constexpr int PIECE = 1024;  // a copy step never exceeds this
constexpr int REFILL_MARGIN = 1024;

// a step writes ring slots that hold neither unflushed bytes nor this
// step's ring sources
static_assert(FLUSH_AT + 16 + 2 * PIECE <= RING, "ring too small");

// the compressed stream: bytes below `end` are staged in shared memory, the
// rest is read from device memory.  The window is reloaded at the start of
// a sequence and a sequence only reads forward, so no read is below the
// window's first byte and one comparison decides.
struct Window {
    const uint8_t* c;  // the staged bytes, indexed by stream position
    const uint8_t* g;
    long long end;
    __device__ __forceinline__ int operator()(long long p) const {
        return p < end ? c[p] : g[p];
    }
};

// stage comp[from ..) into the warp's window; the window starts at the
// 16-byte boundary of device memory at or below `from`
__device__ __forceinline__ void load_window(Window& w, uint8_t* win, long long n, long long from,
                                            int lane) {
    const long long base = from - (long long)((uintptr_t)(w.g + from) & 15);
    const long long end = base + CWIN < n ? base + CWIN : n;
    for (long long p = base + 16 * lane; p < end; p += 16 * 32) {
        uint8_t* d = win + (p - base);
        if (p >= 0 && p + 16 <= n) {
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(w.g + p);
        } else {  // the row's first and last bytes
            for (int i = 0; i < 16; i++)
                if (p + i >= 0 && p + i < n) d[i] = w.g[p + i];
        }
    }
    w.c = win - base;
    w.end = end;
}

// ring[fl .. end) -> device memory with 16-byte stores (fl, end multiples of 16)
__device__ __forceinline__ long long flush(const uint8_t* ring, uint8_t* o, long long fl,
                                           long long end, int lane) {
    for (long long p = fl + 16 * lane; p < end; p += 16 * 32)
        *reinterpret_cast<uint4*>(o + p) = *reinterpret_cast<const uint4*>(ring + (p & RMASK));
    return end;
}

__global__ void __launch_bounds__(WARPS * 32)
decode_v3_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
                 const int32_t* __restrict__ comp_len, const uint8_t* __restrict__ prefix,
                 long long prefix_stride, long long prefix_width,
                 const int32_t* __restrict__ prefix_len, long long limit, uint8_t* out,
                 long long out_stride, int32_t* __restrict__ out_len,
                 int32_t* __restrict__ status, int nblocks) {
    __shared__ __align__(16) uint8_t rings[WARPS][RING];
    __shared__ __align__(16) uint8_t wins[WARPS][CWIN];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * WARPS + warp;
    if (b >= nblocks) return;  // whole warp exits together; no block-wide barrier follows
    uint8_t* ring = rings[warp];
    uint8_t* win = wins[warp];
    const long long n = comp_len[b];
    const long long plen = prefix_len[b];
    const uint8_t* pend = prefix + b * prefix_stride + prefix_width;
    uint8_t* o = out + b * out_stride;
    Window w{win, comp + b * comp_stride, 0};  // empty until load_window
    load_window(w, win, n, 0, lane);
    __syncwarp();

    long long pos = 0, op = 0, fl = 0;
    int st = lz4t::OK;
    while (pos < n) {
        if (w.end < n && pos + REFILL_MARGIN > w.end) {
            load_window(w, win, n, pos, lane);
            __syncwarp();
        }
        lz4t::Seq q{};
        if (lane == 0) q = lz4t::parse_seq_with(w, n, pos, op, plen, limit, out_stride);
        q.status = __shfl_sync(0xffffffffu, q.status, 0);
        if (q.status != lz4t::OK) {
            st = q.status;
            break;
        }
        q.lit_src = __shfl_sync(0xffffffffu, q.lit_src, 0);
        q.lit_len = __shfl_sync(0xffffffffu, q.lit_len, 0);
        q.match_len = __shfl_sync(0xffffffffu, q.match_len, 0);
        q.offset = __shfl_sync(0xffffffffu, q.offset, 0);
        q.next_pos = __shfl_sync(0xffffffffu, q.next_pos, 0);
        // literals: compressed stream -> ring
        long long src = q.lit_src;
        for (long long rem = q.lit_len; rem > 0;) {
            if (op - fl >= FLUSH_AT) {
                fl = flush(ring, o, fl, op & ~15LL, lane);
                __syncwarp();
            }
            const long long len = rem < PIECE ? rem : PIECE;
            for (long long j = lane; j < len; j += 32) ring[(op + j) & RMASK] = (uint8_t)w(src + j);
            op += len;
            src += len;
            rem -= len;
            __syncwarp();
        }
        // match: piece j of a match is a match of the same offset at its own
        // start, so each piece reads only bytes written before it began
        for (long long rem = q.match_len; rem > 0;) {
            if (op - fl >= FLUSH_AT) {
                fl = flush(ring, o, fl, op & ~15LL, lane);
                __syncwarp();  // the flushed bytes may be read back below
            }
            const long long len = rem < PIECE ? rem : PIECE;
            const long long base = op - q.offset;
            // sources at or above `near` are still in the ring when this
            // piece has been written; lower ones were flushed (near <= fl)
            const long long near = op + len - RING > 0 ? op + len - RING : 0;
            for (long long j = lane; j < len; j += 32) {
                const long long s = base + (q.offset >= len ? j : j % q.offset);
                ring[(op + j) & RMASK] = s >= near ? ring[s & RMASK] : (s >= 0 ? o[s] : pend[s]);
            }
            op += len;
            rem -= len;
            __syncwarp();
        }
        pos = q.next_pos;
    }
    // the rest of the ring; bytes past op stay zero, so the tail goes bytewise
    fl = flush(ring, o, fl, op & ~15LL, lane);
    for (long long p = fl + lane; p < op; p += 32) o[p] = ring[p & RMASK];
    if (lane == 0) {
        out_len[b] = (int32_t)op;
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
    int grid = (nblocks + WARPS - 1) / WARPS;
    decode_v3_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_len, (const uint8_t*)prefix,
        prefix_stride, prefix_width, (const int32_t*)prefix_len, limit, (uint8_t*)out, out_stride,
        (int32_t*)out_len, (int32_t*)status, nblocks);
    return (int)cudaGetLastError();
}
