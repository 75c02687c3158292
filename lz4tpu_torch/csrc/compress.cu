// Greedy LZ4 block compressor, one LZ4 block per CUDA block.
//
// Replaces: lz4tpu/kernels/compress.py:71 _compress_kernel (launched by
// _compress_batch_jit, compress.py:481), the byte-exact scalar greedy parse
// of the reference (src/raw/compress/mod.rs:147-260) over a
// [prefix | block] buffer with cursor, cap, acceleration, table offset and
// prime flag.
//
// What bounds it on this card: neither bytes nor operations.  The parse is
// a strictly sequential dependent loop (every probe reads the slot the
// previous probe may have written), so one block's parse is one thread's
// chain of dependent loads; the byte traffic (input read once, output and
// table written once) would take microseconds at 3.35 TB/s.  The kernel is
// latency-bound per block and parallel only across blocks.
//
// What the design does about it: the 16 KiB encoder table (4096 u32 or
// 8192 u16 slots) lives in shared memory, so every probe's table access
// is a ~30-cycle shared load instead of a device-memory round trip; the
// whole warp copies the table in and out, one thread parses.  Blocks run
// in parallel, 14 resident per SM at 16 KiB of shared memory each.  The
// hash is the reference's with native 64-bit arithmetic (no 32-bit limbs,
// no pre-pass).  Cap overflow aborts at group granularity and leaves the
// table mutated up to the abort, exactly like NoPartialWrites.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HASHLOG = 12;
constexpr int SKIP_TRIGGER = 6;
constexpr int64_t MINMATCH = 4;
constexpr int32_t STATUS_OK = 0;
constexpr int32_t STATUS_INCOMPRESSIBLE = 1;
constexpr int THREADS = 32;

__device__ __forceinline__ uint32_t read32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

__device__ __forceinline__ uint64_t read64(const uint8_t* p) {
    return (uint64_t)read32(p) | ((uint64_t)read32(p + 4) << 32);
}

// U32 table: 5 significant bytes of an LE u64 read; positions with fewer
// than 8 readable bytes hash a zero word (spec/table.py hash_all_u32).
struct U32T {
    static constexpr int SLOTS = 1 << HASHLOG;
    using slot_t = uint32_t;
    __device__ static uint32_t hash(const uint8_t* in, int64_t n, int64_t p) {
        uint64_t v = (p + 8 <= n) ? read64(in + p) : 0;
        return (uint32_t)(((v << 24) * 889523592379ULL) >> (64 - HASHLOG));
    }
};

// U16 table: LE u32 read * 2654435761 >> (32 - HASHLOG - 1).
struct U16T {
    static constexpr int SLOTS = 2 << HASHLOG;
    using slot_t = uint16_t;
    __device__ static uint32_t hash(const uint8_t* in, int64_t, int64_t p) {
        return (read32(in + p) * 2654435761u) >> (32 - HASHLOG - 1);
    }
};

template <class T>
__device__ __forceinline__ int64_t table_replace(typename T::slot_t* tab, const uint8_t* in,
                                                 int64_t n, int64_t p, int64_t toff) {
    uint32_t h = T::hash(in, n, p);
    int64_t prev = (int64_t)tab[h];
    tab[h] = (typename T::slot_t)(p + toff);
    int64_t c = prev - toff;  // saturating: stream -> buffer coordinates
    return c > 0 ? c : 0;
}

// longest common prefix of in[a..a_end) and in[b..n)
__device__ __forceinline__ int64_t count_matching(const uint8_t* in, int64_t a, int64_t a_end,
                                                  int64_t b, int64_t n) {
    int64_t limit = a_end - a < n - b ? a_end - a : n - b;
    int64_t m = 0;
    while (m + 8 <= limit) {
        uint64_t x = read64(in + a + m) ^ read64(in + b + m);
        if (x) return m + ((__ffsll((long long)x) - 1) >> 3);
        m += 8;
    }
    while (m < limit && in[a + m] == in[b + m]) m++;
    return m;
}

__device__ __forceinline__ int64_t lsic_len(int64_t v) {
    return v < 0xF ? 0 : (v - 0xF) / 0xFF + 1;
}

__device__ __forceinline__ int64_t put_lsic(uint8_t* out, int64_t op, int64_t v) {
    if (v < 0xF) return op;
    v -= 0xF;
    while (v >= 0xFF) {
        out[op++] = 0xFF;
        v -= 0xFF;
    }
    out[op++] = (uint8_t)v;
    return op;
}

// One block's greedy parse (spec: reference compress/mod.rs:166-238; the
// same steps as lz4tpu/native/src/lz4_native.cpp compress_impl).
template <class T>
__device__ void parse_block(typename T::slot_t* tab, const uint8_t* in, int64_t n,
                            int64_t init_cursor, int64_t cap, int64_t acceleration,
                            int64_t toff, bool prime, uint8_t* out, int64_t out_cap,
                            int32_t* out_len, int32_t* status) {
    // in-kernel prefix priming: positions 0, 3, 6, ... <= cursor-8, later
    // inserts overwriting earlier ones (framed/compress.rs:202-214)
    if (prime && init_cursor >= 8) {
        for (int64_t p = 0; p <= init_cursor - 8; p += 3)
            tab[T::hash(in, n, p)] = (typename T::slot_t)(p + toff);
    }
    int64_t op = 0;
    int64_t cursor = init_cursor < n ? init_cursor : n;
    int32_t st = STATUS_OK;
    while (cursor < n) {
        const int64_t literal_start = cursor;
        int64_t step_counter = acceleration << SKIP_TRIGGER;
        int64_t step = 1;
        int64_t offset = 0, extra = 0;
        bool tail = false;
        for (;;) {
            // tail guard: bail when the NEXT probe would pass n-11
            if (cursor + step > n - 11) {
                tail = true;
                break;
            }
            int64_t candidate = table_replace<T>(tab, in, n, cursor, toff);
            if (cursor != init_cursor && cursor - candidate <= 0xFFFF) {
                int64_t matching = count_matching(in, cursor, n - 5, candidate, n);
                if (matching >= MINMATCH) {
                    extra = matching - MINMATCH;
                    offset = cursor - candidate;
                    // backtrack the match start into pending literals
                    int64_t max_bt = cursor - literal_start;
                    int64_t bt = 0;
                    while (bt < max_bt && candidate - bt > 0 &&
                           in[cursor - bt - 1] == in[candidate - bt - 1])
                        bt++;
                    extra += bt;
                    cursor += matching;
                    table_replace<T>(tab, in, n, cursor - 2, toff);
                    break;
                }
            }
            cursor += step;
            // the step assignment lags one miss: advances go 1, 1, a, a, ...
            if (literal_start + 1 != cursor) {
                step = step_counter >> SKIP_TRIGGER;
                step_counter++;
            }
        }
        if (tail) {
            int64_t literal_len = n - literal_start;
            int64_t group = 1 + lsic_len(literal_len) + literal_len;
            if (op + group > cap || op + group > out_cap) {
                st = STATUS_INCOMPRESSIBLE;
                break;
            }
            out[op++] = (uint8_t)((literal_len < 0xF ? literal_len : 0xF) << 4);
            op = put_lsic(out, op, literal_len);
            for (int64_t i = 0; i < literal_len; i++) out[op + i] = in[literal_start + i];
            op += literal_len;
            break;
        }
        const int64_t literal_end = cursor - extra - MINMATCH;
        const int64_t literal_len = literal_end - literal_start;
        int64_t group = 1 + lsic_len(literal_len) + literal_len + 2 + lsic_len(extra);
        if (op + group > cap || op + group > out_cap) {
            st = STATUS_INCOMPRESSIBLE;
            break;
        }
        out[op++] = (uint8_t)(((literal_len < 0xF ? literal_len : 0xF) << 4) |
                              (extra < 0xF ? extra : 0xF));
        op = put_lsic(out, op, literal_len);
        for (int64_t i = 0; i < literal_len; i++) out[op + i] = in[literal_start + i];
        op += literal_len;
        out[op++] = (uint8_t)(offset & 0xFF);
        out[op++] = (uint8_t)((offset >> 8) & 0xFF);
        op = put_lsic(out, op, extra);
    }
    *out_len = (int32_t)op;
    *status = st;
}

template <class T>
__global__ void __launch_bounds__(THREADS)
compress_kernel(const uint8_t* __restrict__ data, int64_t data_stride,
                const int32_t* __restrict__ n_arr, const int32_t* __restrict__ cursor_arr,
                const int32_t* __restrict__ cap_arr, const int32_t* __restrict__ accel_arr,
                const int32_t* __restrict__ toff_arr, const int32_t* __restrict__ prime_arr,
                const int32_t* __restrict__ table_in, int32_t* __restrict__ table_out,
                uint8_t* __restrict__ out, int64_t out_stride, int32_t* __restrict__ out_len,
                int32_t* __restrict__ status) {
    __shared__ typename T::slot_t tab[T::SLOTS];
    const int64_t b = blockIdx.x;
    const int32_t* tin = table_in + b * T::SLOTS;
    for (int i = threadIdx.x; i < T::SLOTS; i += blockDim.x)
        tab[i] = (typename T::slot_t)(uint32_t)tin[i];
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t cap = cap_arr[b] < 0 ? INT64_MAX : (int64_t)cap_arr[b];
        parse_block<T>(tab, data + b * data_stride, n_arr[b], cursor_arr[b], cap,
                       accel_arr[b], (int64_t)(uint32_t)toff_arr[b], prime_arr[b] != 0,
                       out + b * out_stride, out_stride, out_len + b, status + b);
    }
    __syncthreads();
    int32_t* tout = table_out + b * T::SLOTS;
    for (int i = threadIdx.x; i < T::SLOTS; i += blockDim.x) tout[i] = (int32_t)(uint32_t)tab[i];
}

template <class T>
void launch(const void* data, int64_t data_stride, const void* n_arr, const void* cursor_arr,
            const void* cap_arr, const void* accel_arr, const void* toff_arr,
            const void* prime_arr, const void* table_in, void* table_out, void* out,
            int64_t out_stride, void* out_len, void* status, int nblocks, cudaStream_t s) {
    compress_kernel<T><<<nblocks, THREADS, 0, s>>>(
        (const uint8_t*)data, data_stride, (const int32_t*)n_arr, (const int32_t*)cursor_arr,
        (const int32_t*)cap_arr, (const int32_t*)accel_arr, (const int32_t*)toff_arr,
        (const int32_t*)prime_arr, (const int32_t*)table_in, (int32_t*)table_out,
        (uint8_t*)out, out_stride, (int32_t*)out_len, (int32_t*)status);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lz4t_compress(const void* data, int64_t data_stride, const void* n_arr,
                             const void* cursor_arr, const void* cap_arr, const void* accel_arr,
                             const void* toff_arr, const void* prime_arr, const void* table_in,
                             void* table_out, int table_slots, void* out, int64_t out_stride,
                             void* out_len, void* status, int nblocks, void* stream) {
    if (nblocks <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (table_slots == U32T::SLOTS)
        launch<U32T>(data, data_stride, n_arr, cursor_arr, cap_arr, accel_arr, toff_arr,
                     prime_arr, table_in, table_out, out, out_stride, out_len, status, nblocks, s);
    else if (table_slots == U16T::SLOTS)
        launch<U16T>(data, data_stride, n_arr, cursor_arr, cap_arr, accel_arr, toff_arr,
                     prime_arr, table_in, table_out, out, out_stride, out_len, status, nblocks, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
