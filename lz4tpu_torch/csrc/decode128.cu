// LZ4 block decoder for blocks of at most 64 KiB, one warp per block.
//
// Replaces: lz4tpu/kernels/decode128.py:225 _decode128_kernel (launched by
// _decode128_jit, decode128.py:997), the lane-parallel decoder that runs
// up to 128 raw blocks in lockstep rounds, one per TPU lane, each with an
// optional right-aligned prefix (dictionary / linked window).
//
// What bounds it on this card: bytes, at best.  Each block's comp stream is
// read once and its output written once, so at the main path's shapes the
// least time is (comp bytes + output bytes) / 3.35 TB/s.  This simple
// version is far from that: a sequence's fields are parsed serially by one
// lane, so the warp waits on a chain of dependent byte loads per sequence,
// and the copies move one byte per lane per step.
//
// What the design does about it: the parse stays serial (LZ4's grammar is
// byte-serial within a block) but the copies go wide: lane 0 parses one
// sequence and validates it completely, the sequence is broadcast with
// warp shuffles, and all 32 lanes copy its literals and its match.  A
// match's overlap is resolved in closed form (decode_common.cuh), so no
// lane waits on another's byte within a match.  Four warps share a thread
// block; blocks of a batch run in parallel across all SMs, so a batch of
// thousands of blocks fills the card.  There is no round cap and therefore
// no STATUS_FALLBACK: every block decodes to its end in-kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
decode128_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
                 const int32_t* __restrict__ comp_len, const uint8_t* __restrict__ prefix,
                 long long prefix_stride, long long prefix_width,
                 const int32_t* __restrict__ prefix_len, long long limit,
                 uint8_t* __restrict__ out, long long out_stride,
                 int32_t* __restrict__ out_len, int32_t* __restrict__ status, int nblocks) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * WARPS + warp;
    if (b >= nblocks) return;  // whole warp exits together
    const uint8_t* c = comp + b * comp_stride;
    const long long n = comp_len[b];
    const long long plen = prefix_len[b];
    const uint8_t* pend = prefix + b * prefix_stride + prefix_width;
    uint8_t* o = out + b * out_stride;
    long long pos = 0, op = 0;
    int st = lz4t::OK;
    while (pos < n) {
        lz4t::Seq q{};
        if (lane == 0) q = lz4t::parse_seq(c, n, pos, op, plen, limit, out_stride);
        q.status = __shfl_sync(0xffffffffu, q.status, 0);
        q.lit_src = __shfl_sync(0xffffffffu, q.lit_src, 0);
        q.lit_len = __shfl_sync(0xffffffffu, q.lit_len, 0);
        if (q.status != lz4t::OK) {
            st = q.status;
            break;
        }
        q.match_len = __shfl_sync(0xffffffffu, q.match_len, 0);
        q.offset = __shfl_sync(0xffffffffu, q.offset, 0);
        q.next_pos = __shfl_sync(0xffffffffu, q.next_pos, 0);
        lz4t::copy_literals(o, c, op, q.lit_src, q.lit_len, lane, 32);
        op += q.lit_len;
        if (q.match_len) {
            __syncwarp();  // the match may read the literals just written
            lz4t::copy_match(o, pend, op, q.offset, q.match_len, lane, 32);
            op += q.match_len;
            __syncwarp();
        }
        pos = q.next_pos;
    }
    if (lane == 0) {
        out_len[b] = (int32_t)op;
        status[b] = st;
    }
}

}  // namespace

// prefix rows are right-aligned in `prefix_width` bytes; prefix_stride 0
// shares one row (a dictionary) across the batch.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int lz4t_decode128(const void* comp, long long comp_stride, const void* comp_len,
                              const void* prefix, long long prefix_stride, long long prefix_width,
                              const void* prefix_len, long long limit, void* out,
                              long long out_stride, void* out_len, void* status, int nblocks,
                              void* stream) {
    if (nblocks <= 0) return 0;
    int grid = (nblocks + WARPS - 1) / WARPS;
    decode128_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_len, (const uint8_t*)prefix,
        prefix_stride, prefix_width, (const int32_t*)prefix_len, limit, (uint8_t*)out,
        out_stride, (int32_t*)out_len, (int32_t*)status, nblocks);
    return (int)cudaGetLastError();
}
