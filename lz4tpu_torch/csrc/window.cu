// The slide of linked frames' 64 KiB carry-over windows after a wave of
// decompress_frames_parallel: one launch for every frame of a wave group.
//
// Replaces: no kernel of lz4tpu/kernels.  The JAX package slides each
// frame's window on the host, as bytes (lz4tpu/parallel/pipeline.py:1406,
// decompress_frames_parallel); the port keeps the windows on the card.
//
// Row r of the wave (a frame's block w) has its window `old[r]` (64 KiB,
// right-aligned: the last `old_len[r]` bytes are the window) and its new
// bytes `data[r, :lens[r]]`.  Where the frame has a block w + 1, its row
// there is `dest[r]` (else -1), and the window of that row becomes the last
// 64 KiB of `old[r] | data[r, :lens[r]]`:
//
//     new[dest[r]][j] = j + lens[r] < 65536 ? old[r][j + lens[r]]
//                                           : data[r][j + lens[r] - 65536]
//     new_len[dest[r]] = min(old_len[r] + lens[r], 65536)
//
// `new` is another tensor than `old` (the next wave's windows, in its row
// order), so no row is read after it is written and the launch needs no
// ordering between its thread blocks.  Bytes a thread, 16: adjacent
// threads read adjacent bytes and each writes one aligned 16-byte vector.
// What bounds it: bytes, 64 KiB read and 64 KiB written a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 1 << 16;
constexpr int THREADS = 256;
constexpr int BYTES = 16;  // a thread's bytes
constexpr int SPLIT = WINDOW / (THREADS * BYTES);  // thread blocks a row

__global__ void __launch_bounds__(THREADS)
push_windows_kernel(const uint8_t* __restrict__ old, long long old_stride,
                    const int32_t* __restrict__ old_len, const uint8_t* __restrict__ data,
                    long long data_stride, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ dest, uint8_t* __restrict__ next,
                    long long next_stride, int32_t* __restrict__ next_len) {
    const long long r = blockIdx.x;
    const int d = dest[r];
    if (d < 0) return;
    const int len = lens[r];
    const uint8_t* o = old + r * old_stride;
    const uint8_t* s = data + r * data_stride;
    const int j = (blockIdx.y * THREADS + threadIdx.x) * BYTES;
    uint32_t word[BYTES / 4];
#pragma unroll
    for (int k = 0; k < BYTES / 4; ++k) {
        uint32_t w = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int t = j + 4 * k + b + len;
            w |= (uint32_t)(t < WINDOW ? o[t] : s[t - WINDOW]) << (8 * b);
        }
        word[k] = w;
    }
    *reinterpret_cast<uint4*>(next + (long long)d * next_stride + j) =
        make_uint4(word[0], word[1], word[2], word[3]);
    if (blockIdx.y == 0 && threadIdx.x == 0) next_len[d] = min(old_len[r] + len, WINDOW);
}

}  // namespace

// Rows of 65536 bytes: `old_stride` and `next_stride` multiples of 16,
// `next` 16-byte aligned; `data` rows hold at least `lens[r]` bytes.
// Returns the CUDA error of the launch (0 on success).
extern "C" int lz4t_push_windows(const void* old, long long old_stride, const void* old_len,
                                 const void* data, long long data_stride, const void* lens,
                                 const void* dest, void* next, long long next_stride,
                                 void* next_len, int nrows, void* stream) {
    if (nrows <= 0) return 0;
    if (old_stride % 16 || next_stride % 16) return (int)cudaErrorInvalidValue;
    push_windows_kernel<<<dim3(nrows, SPLIT), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)old, old_stride, (const int32_t*)old_len, (const uint8_t*)data,
        data_stride, (const int32_t*)lens, (const int32_t*)dest, (uint8_t*)next, next_stride,
        (int32_t*)next_len);
    return (int)cudaGetLastError();
}
