// LZ4 block decoder for blocks of any size, one thread block per block.
//
// Replaces: lz4tpu/kernels/decompress_v4.py:89 _decode_v4_kernel (launched
// by _decompress_batch_v4_jit, decompress_v4.py:434), the scalar-core
// per-block decoder with a parse-ahead ring and a fused drain, capped by
// the TPU's SMEM/VMEM windows at 512 KiB of comp and 2 MiB of output.
// This kernel has neither cap: comp and output live in device memory, so
// it also decodes the 256 KiB-4 MiB blocks of the larger frame geometries.
//
// What bounds it on this card: bytes, at best: (comp bytes + output bytes)
// / 3.35 TB/s.  As with decode128.cu, the serial parse of each sequence is
// what this simple version actually waits on, plus one block-wide barrier
// per sequence.
//
// What the design does about it: one thread parses and validates a
// sequence, publishes it in shared memory, and all 256 threads of the
// block copy its literals and its match (closed-form overlap addressing,
// decode_common.cuh).  Long literal runs and long matches, which big
// blocks of poorly compressible data are made of, move 256 bytes per step
// instead of 32.  Blocks of a batch run in parallel across the SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
decode_v4_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
                 const int32_t* __restrict__ comp_len, const uint8_t* __restrict__ prefix,
                 long long prefix_stride, long long prefix_width,
                 const int32_t* __restrict__ prefix_len, long long limit,
                 uint8_t* __restrict__ out, long long out_stride,
                 int32_t* __restrict__ out_len, int32_t* __restrict__ status) {
    __shared__ lz4t::Seq shared_seq;
    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    const uint8_t* c = comp + b * comp_stride;
    const long long n = comp_len[b];
    const long long plen = prefix_len[b];
    const uint8_t* pend = prefix + b * prefix_stride + prefix_width;
    uint8_t* o = out + b * out_stride;
    long long pos = 0, op = 0;
    int st = lz4t::OK;
    while (pos < n) {
        if (tid == 0) shared_seq = lz4t::parse_seq(c, n, pos, op, plen, limit, out_stride);
        __syncthreads();
        const lz4t::Seq q = shared_seq;
        __syncthreads();  // shared_seq is rewritten next iteration
        if (q.status != lz4t::OK) {
            st = q.status;
            break;
        }
        lz4t::copy_literals(o, c, op, q.lit_src, q.lit_len, tid, THREADS);
        op += q.lit_len;
        if (q.match_len) {
            __syncthreads();  // the match may read the literals just written
            lz4t::copy_match(o, pend, op, q.offset, q.match_len, tid, THREADS);
            op += q.match_len;
            __syncthreads();
        }
        pos = q.next_pos;
    }
    if (tid == 0) {
        out_len[b] = (int32_t)op;
        status[b] = st;
    }
}

}  // namespace

// Same arguments as lz4t_decode128.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int lz4t_decode_v4(const void* comp, long long comp_stride, const void* comp_len,
                              const void* prefix, long long prefix_stride, long long prefix_width,
                              const void* prefix_len, long long limit, void* out,
                              long long out_stride, void* out_len, void* status, int nblocks,
                              void* stream) {
    if (nblocks <= 0) return 0;
    decode_v4_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_len, (const uint8_t*)prefix,
        prefix_stride, prefix_width, (const int32_t*)prefix_len, limit, (uint8_t*)out,
        out_stride, (int32_t*)out_len, (int32_t*)status);
    return (int)cudaGetLastError();
}
