// Greedy LZ4 block compressor, one LZ4 block per warp.
//
// Replaces: lz4tpu/kernels/compress.py:71 _compress_kernel (launched by
// _compress_batch_jit, compress.py:481), the byte-exact scalar greedy parse
// of the reference (src/raw/compress/mod.rs:147-260) over a
// [prefix | block] buffer with cursor, cap, acceleration, table offset and
// prime flag.
//
// What bounds it on this card: neither bytes nor operations.  The byte
// traffic (input read once, output and table written once) would take
// microseconds at 3.35 TB/s.  What the greedy parse *decides* is serial:
// every probe sees the table as all earlier probes left it.  The work is
// not: between two matches the parse is a run of misses, the positions it
// probes are fixed by the skip schedule alone, and everything a probe needs
// except its table slot is a function of the input.  The kernel is bound
// by the latency of one batch of probes, a match extension and a group
// write per sequence: a chain of dependent operations in one warp, of
// which the memory reads are the smaller part.
//
// What the design does about it:
//   * The warp probes 32 positions of the skip schedule at once.  Lane l
//     computes the l-th next position in closed form, hashes it and reads
//     its slot.  Lanes of the batch that collide are found by claims in a
//     scratch table (a lane that reads back another's claim on its slot
//     says so) and, only if there are any, by __match_any_sync on the hash,
//     which alone costs about as much as the rest of a batch; a lane's
//     candidate is the position of the nearest lower lane with its hash
//     (taken through the slot type and the table offset, as a stored slot
//     would be), else the slot it read.  Each lane makes the serial test
//     (not the block's first probe, distance <= 0xFFFF, four equal bytes);
//     a ballot gives the first hit, which is the match the serial loop
//     takes.  Lanes up to it write the table, the highest lane of a hash
//     group last; lanes above it write nothing.  The tail guard is one more
//     condition in the same vote.  A batch without a hit is 32 misses for
//     the latency of one.
//   * Words, not bytes: an unaligned read is two or three aligned 32-bit
//     loads and a funnel shift, without a branch (a lane with nothing to
//     read reads a safe position and drops the result), so the loads of a
//     step leave together.  Positions are 32-bit.
//   * A probe compares 8 bytes, and the byte before, while it is at it: a
//     match that ends inside them with nothing to backtrack, the common one
//     in text, is complete when the vote is.  Otherwise the warp extends it
//     128 bytes a round and backtracks 32 bytes a round, the first round of
//     both in one step.
//   * The warp writes tokens, length bytes and literals together; a short
//     literal run is the first byte of each lane's probe word.  The cap is
//     checked per group before any byte of the group is written, so an
//     aborted row keeps zeros past out_len and its table is mutated exactly
//     up to the abort, like NoPartialWrites.
//   * The 16 KiB encoder table and the claims live in shared memory, and
//     the kernel asks for no more of the SM's array than the rows that
//     share an SM need, so that the rest is L1.  The input stays in device
//     memory and is read through that L1, which then holds the 64 KiB a
//     candidate may lie in; rows, literal runs and backtracks of any length
//     need no special case.  Staging the input in a shared-memory ring
//     filled by cp.async was built and measured: it was a quarter slower on
//     rows of every size, since each read then pays a residency check that
//     costs more than the L1's extra latency
//     (tools/torch_chip_compress_cost.py builds that variant).
//   * In-kernel priming runs over the window 32 positions a round; within a
//     round the highest position of a hash group writes, and rounds follow
//     each other, so later inserts overwrite earlier ones as in the serial
//     loop.
// What is left is a chain of some 300 dependent operations a sequence in a
// warp that has its SM to itself, at 4 to 6 cycles each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HASHLOG = 12;
constexpr int SKIP_TRIGGER = 6;
constexpr long long MINMATCH = 4;
constexpr long long MAX_DISTANCE = 0xFFFF;
constexpr int32_t STATUS_OK = 0;
constexpr int32_t STATUS_INCOMPRESSIBLE = 1;
constexpr int THREADS = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The row's bytes, read as aligned 32-bit words of device memory: position
// p is byte q = p + skew of g, where skew is the row's base modulo 4.  The
// SM's L1 (one array with its shared memory) holds the 64 KiB behind the
// cursor that candidates lie in; a copy of them in shared memory, filled by
// cp.async beside the parse, measured slower on this card
// (tools/torch_chip_compress_cost.py builds that variant).
struct Input {
    const uint32_t* g;
    int skew;
    int last_word;  // of the row: (n + skew - 1) >> 2

    __device__ __forceinline__ uint32_t word(int wi) const { return __ldg(g + wi); }
    // p + 1 <= n, p + 4 <= n, p + 8 <= n respectively.  No branch, so that
    // the loads of a step leave together: a word past the ones that hold
    // the bytes is read only where the shift needs it; elsewhere its index
    // is held inside the row and its value shifted away.
    __device__ __forceinline__ uint32_t rd8(int p) const {
        const int q = p + skew;
        return (word(q >> 2) >> ((q & 3) * 8)) & 0xFF;
    }
    __device__ __forceinline__ uint32_t rd32(int p) const {
        const int q = p + skew, wi = q >> 2, sh = (q & 3) * 8;
        return __funnelshift_r(word(wi), word(min(wi + 1, last_word)), sh);
    }
    __device__ __forceinline__ uint64_t rd64(int p) const {
        const int q = p + skew, wi = q >> 2, sh = (q & 3) * 8;
        const uint32_t a = word(wi), b = word(wi + 1), c = word(min(wi + 2, last_word));
        return (uint64_t)__funnelshift_r(a, b, sh) | ((uint64_t)__funnelshift_r(b, c, sh) << 32);
    }
};

// U32 table: 5 significant bytes of an LE u64 read; positions with fewer
// than 8 readable bytes hash a zero word (spec/table.py hash_all_u32).
struct U32T {
    static constexpr int SLOTS = 1 << HASHLOG;
    using slot_t = uint32_t;
    using word_t = uint64_t;
    __device__ static __forceinline__ word_t load(const Input& in, int n, int p) {
        return p + 8 <= n ? in.rd64(p) : 0;
    }
    __device__ static __forceinline__ uint32_t hash(word_t v) {
        return (uint32_t)(((v << 24) * 889523592379ULL) >> (64 - HASHLOG));
    }
    // from the 8 bytes at a position that has them
    __device__ static __forceinline__ uint32_t hash8(uint64_t v8) { return hash(v8); }
};

// U16 table: LE u32 read * 2654435761 >> (32 - HASHLOG - 1).
struct U16T {
    static constexpr int SLOTS = 2 << HASHLOG;
    using slot_t = uint16_t;
    using word_t = uint32_t;
    __device__ static __forceinline__ word_t load(const Input& in, int, int p) {
        return in.rd32(p);
    }
    __device__ static __forceinline__ uint32_t hash(word_t v) {
        return (v * 2654435761u) >> (32 - HASHLOG - 1);
    }
    __device__ static __forceinline__ uint32_t hash8(uint64_t v8) { return hash((uint32_t)v8); }
};

// Which lanes of the warp share this lane's hash (`on`: the lane has one).
// Each lane claims its slot in a scratch table and reads the claim back: a
// lane that finds another's claim says so, and only then the warp sorts the
// groups out, since __match_any_sync costs as much as the rest of a batch.
__device__ __forceinline__ unsigned hash_group(uint8_t* claim, uint32_t h, bool on, int lane) {
    if (on) claim[h] = (uint8_t)lane;
    __syncwarp();
    const bool clash = on & (claim[h] != lane);
    if (!__any_sync(FULL, clash)) return 1u << lane;
    return __match_any_sync(FULL, on ? h : (0x80000000u | lane));
}

// The match at (a, b) and its backtrack, by the warp.  Forward: the longest
// common prefix of in[a..a_end) and in[b..n), 4 bytes a lane, 128 a round,
// from `matching` bytes that are known to be equal.  Backward: while
// t < max_bt, in[a-t-1] == in[b-t-1], a byte a lane.  Either may be switched
// off by the caller, who then knows its result.  The first round of both
// leaves together, and no lane branches: a lane whose share ends early reads
// its word from a position held inside the row and counts only its share.
// n >= 12.
__device__ __forceinline__ void measure_match(const Input& in, int a, int a_end, int b, int n,
                                              int max_bt, int lane, bool forward, bool backward,
                                              int& matching, int& back) {
    const int limit = min(a_end - a, n - b);
    back = 0;
    while (forward || backward) {
        int cnt = 4;
        if (forward) {
            const int off = matching + 4 * lane;
            const int share = limit - off;  // bytes of this lane's 4 inside the limit
            const int pa = min(a + off, n - 4), pb = min(b + off, n - 4);
            const uint32_t x = (in.rd32(pa) >> (8 * min(a + off - pa, 3))) ^
                               (in.rd32(pb) >> (8 * min(b + off - pb, 3)));
            const int equal = x ? (__ffs((int)x) - 1) >> 3 : 4;
            cnt = max(min(equal, share), 0);
        }
        bool same = true;
        if (backward) {
            const int t = back + lane, held = min(t, max_bt - 1);
            same = (t < max_bt) & (in.rd8(a - held - 1) == in.rd8(b - held - 1));
        }
        const unsigned stop = __ballot_sync(FULL, cnt < 4);
        const unsigned differ = __ballot_sync(FULL, !same);
        if (forward) {
            if (stop) {
                const int first = __ffs(stop) - 1;
                matching += 4 * first + __shfl_sync(FULL, cnt, first);
                forward = false;
            } else {
                matching += 4 * THREADS;
            }
        }
        if (backward) {
            if (differ) {
                back += __ffs(differ) - 1;
                backward = false;
            } else {
                back += THREADS;
            }
        }
    }
}

__device__ __forceinline__ int lsic_len(int v) {
    return v < 0xF ? 0 : (int)((unsigned)(v - 0xF) / 0xFFu) + 1;
}

__device__ __forceinline__ long long put_lsic(uint8_t* out, long long op, int v, int lane) {
    if (v < 0xF) return op;
    v -= 0xF;
    const int full = (int)((unsigned)v / 0xFFu);
    for (int j = lane; j < full; j += THREADS) out[op + j] = 0xFF;
    if (lane == 0) out[op + full] = (uint8_t)(v - full * 0xFF);
    return op + full + 1;
}

// out[0..len) = in[src..src+len).  A short run is a byte a lane; a long one
// goes bytes up to the destination's next word boundary, then one 32-bit
// word a lane, then the last bytes.
__device__ __forceinline__ void put_literals(uint8_t* d, const Input& in, int src, int len,
                                             int lane) {
    if (len <= 0) return;
    if (len <= THREADS) {
        const uint32_t byte = in.rd8(src + min(lane, len - 1));
        if (lane < len) d[lane] = (uint8_t)byte;
        return;
    }
    const int head = (4 - (int)((uintptr_t)d & 3)) & 3;
    if (lane < head) d[lane] = (uint8_t)in.rd8(src + lane);
    const int words = (len - head) >> 2;
    uint32_t* dw = reinterpret_cast<uint32_t*>(d + head);
    for (int j = lane; j < words; j += THREADS) dw[j] = in.rd32(src + head + 4 * j);
    const int done = head + 4 * words;
    if (lane < len - done) d[done + lane] = (uint8_t)in.rd8(src + done + lane);
}

// One block's greedy parse (spec: reference compress/mod.rs:166-238; the
// same result as lz4tpu/native/src/lz4_native.cpp compress_impl), run by
// the whole warp; every variable but `lane` and the per-lane probe is the
// same in all lanes.  Positions are 32-bit (n is); the table offset, the
// output position and, past a search's first batch, the skip schedule are
// taken in 64 bits.
template <class T>
__device__ __forceinline__ void parse_block(typename T::slot_t* tab, uint8_t* claim,
                                            const Input& in, int n,
                            int init_cursor, long long cap, int acceleration, long long toff,
                            bool prime, uint8_t* out, long long out_cap, int32_t* out_len,
                            int32_t* status, int lane) {
    using slot_t = typename T::slot_t;
    // in-kernel prefix priming: positions 0, 3, 6, ... <= cursor-8, later
    // inserts overwriting earlier ones (framed/compress.rs:202-214)
    if (prime && init_cursor >= 8) {
        for (int p0 = 0; p0 <= init_cursor - 8; p0 += 3 * THREADS) {
            const int p = p0 + 3 * lane;
            const bool on = p <= init_cursor - 8;
            const uint32_t h = on ? T::hash(T::load(in, n, p)) : 0;
            const unsigned group = hash_group(claim, h, on, lane);
            if (on && (group >> lane) == 1u) tab[h] = (slot_t)(p + toff);
            __syncwarp();
        }
    }
    // the first batch of a search: lane l probes literal_start + ahead, then
    // steps by stride; in 32 bits where that cannot overflow
    const bool narrow = acceleration <= (1 << 20) && n <= (1 << 30);
    const int ahead = lane < 2 || !narrow ? lane : 2 + (lane - 2) * acceleration;
    const int stride = lane < 2 ? 1 : acceleration;
    long long op = 0;
    int cursor = min(init_cursor, n);
    int32_t st = STATUS_OK;
    while (cursor < n) {
        const int literal_start = cursor;
        int offset = 0, extra = 0;
        bool tail = false;
        uint64_t v8 = 0;       // the 8 bytes at this lane's probe
        bool in_order = false;  // lane l probed literal_start + l
        for (int k0 = 0;; k0 += THREADS) {
            // probe k of this search: advances go 1, 1, a, a, ... with the
            // step assignment lagging one miss, so step(k) = a + ((k-2) >> 6)
            bool past;
            int p;
            if (k0 == 0 && narrow) {
                p = literal_start + ahead;
                past = p + stride > n - 11;  // the tail guard, below
                p = min(p, n);
            } else {
                const int k = k0 + lane, m = max(k - 2, 0);
                const int q = m >> SKIP_TRIGGER, r = m & ((1 << SKIP_TRIGGER) - 1);
                const long long far = (long long)literal_start + 2 + (long long)m * acceleration +
                                      (long long)(32 * q) * (q - 1) + q * r;
                const long long at = k < 2 ? (long long)literal_start + k : far;
                const long long step = k < 2 ? 1 : (long long)acceleration + q;
                past = at + step > n - 11;
                p = (int)(at < n ? at : n);
            }
            // tail guard: bail when the NEXT probe would pass n-11
            const unsigned pasts = __ballot_sync(FULL, past);
            if (pasts & 1) {  // at the search's next probe: nothing is inserted
                tail = true;
                break;
            }
            in_order = k0 == 0 && acceleration == 1;
            // every lane loads, a lane past the tail at a position that is safe
            // to read, so that no lane branches; its results are dropped
            v8 = in.rd64(past ? literal_start : p);
            const uint32_t h = T::hash8(v8);
            const slot_t slot = tab[h];  // as the batch found it: the inserts come after the vote
            if (!past) claim[h] = (uint8_t)lane;
            __syncwarp();
            const bool clash = !past & (claim[h] != lane);
            // What the probe finds in its slot, back through the table offset,
            // saturating; the 8 bytes there (from a position held inside the
            // row) against the probe's own; the byte before both.  All of it
            // leaves before the lanes ask each other about collisions.
            long long c = (long long)slot - toff > 0 ? (long long)slot - toff : 0;
            bool near = !past & (p != init_cursor) & (p - c <= MAX_DISTANCE) & (c + MINMATCH <= n);
            int candidate = near ? (int)c : 0;
            int held = min(candidate, n - 8);
            uint64_t c8 = in.rd64(held) >> (8 * (candidate - held));
            uint32_t before = in.rd8(max(candidate - 1, 0));
            const uint32_t before_p = in.rd8(max(p - 1, 0));
            unsigned group = 1u << lane;
            if (__any_sync(FULL, clash)) {
                // lanes of this batch share a hash: a lane's slot is then what
                // the nearest lower lane of its group stores there, taken
                // through the slot type as if stored
                group = __match_any_sync(FULL, past ? (0x80000000u | lane) : h);
                const unsigned lower = group & ((1u << lane) - 1);
                const int p_from = __shfl_sync(FULL, p, lower ? 31 - __clz(lower) : lane);
                if (lower) {
                    const long long raw = (long long)(slot_t)(p_from + toff);
                    c = raw - toff > 0 ? raw - toff : 0;
                    near = !past & (p != init_cursor) & (p - c <= MAX_DISTANCE) & (c + MINMATCH <= n);
                    candidate = near ? (int)c : 0;
                    held = min(candidate, n - 8);
                    c8 = in.rd64(held) >> (8 * (candidate - held));
                    before = in.rd8(max(candidate - 1, 0));
                }
            }
            // equal bytes at the probe, at most 8 and at most the match's limit
            const uint64_t x = v8 ^ c8;
            const int limit = min(n - 5 - p, n - candidate);
            const int equal = min(x ? (__ffsll((long long)x) - 1) >> 3 : 8, limit);
            const bool hit = near & (equal >= (int)MINMATCH);
            const unsigned hits = __ballot_sync(FULL, hit);
            const int first_hit = hits ? __ffs(hits) - 1 : THREADS;
            const int first_past = pasts ? __ffs(pasts) - 1 : THREADS;
            // probes up to the hit, and before the tail, insert
            const int last_writer = min(first_hit, first_past - 1);
            const unsigned writers = last_writer >= 31 ? FULL
                                     : last_writer < 0 ? 0u
                                                       : (2u << last_writer) - 1;
            if (((writers >> lane) & 1) & (((group & writers) >> lane) == 1u))
                tab[h] = (slot_t)(p + toff);
            __syncwarp();
            if (first_hit < THREADS) {
                // the hit lane knows the match's first 8 bytes and whether the
                // byte before it matches: a match that ends inside them, with
                // nothing to backtrack, is complete
                const bool open = (equal == 8) & (limit > 8);
                const bool backs = (p > literal_start) & (candidate > 0) & (before == before_p);
                cursor = __shfl_sync(FULL, p, first_hit);
                candidate = __shfl_sync(FULL, candidate, first_hit);
                int matching = __shfl_sync(FULL, equal, first_hit), back = 0;
                const unsigned more = __shfl_sync(FULL, (unsigned)open | ((unsigned)backs << 1),
                                                  first_hit);
                offset = cursor - candidate;
                if (more)
                    measure_match(in, cursor, n - 5, candidate, n,
                                  min(cursor - literal_start, candidate), lane, more & 1,
                                  more >> 1, matching, back);
                extra = matching - (int)MINMATCH + back;
                cursor += matching;
                const int p2 = cursor - 2;
                const uint32_t h2 = T::hash(T::load(in, n, p2));
                if (lane == 0) tab[h2] = (slot_t)(p2 + toff);
                __syncwarp();
                break;
            }
            if (first_past < THREADS) {
                tail = true;
                break;
            }
        }
        if (tail) {
            const int literal_len = n - literal_start;
            const long long group = 1LL + lsic_len(literal_len) + literal_len;
            if (op + group > cap || op + group > out_cap) {
                st = STATUS_INCOMPRESSIBLE;
                break;
            }
            if (lane == 0) out[op] = (uint8_t)((literal_len < 0xF ? literal_len : 0xF) << 4);
            op = put_lsic(out, op + 1, literal_len, lane);
            put_literals(out + op, in, literal_start, literal_len, lane);
            op += literal_len;
            break;
        }
        const int literal_len = cursor - extra - (int)MINMATCH - literal_start;
        const long long group = 1LL + lsic_len(literal_len) + literal_len + 2 + lsic_len(extra);
        if (op + group > cap || op + group > out_cap) {
            st = STATUS_INCOMPRESSIBLE;
            break;
        }
        if (lane == 0)
            out[op] = (uint8_t)(((literal_len < 0xF ? literal_len : 0xF) << 4) |
                                (extra < 0xF ? extra : 0xF));
        op = put_lsic(out, op + 1, literal_len, lane);
        if (in_order && literal_len <= THREADS) {
            // lane l probed literal_start + l: its probe word begins with its literal
            if (lane < literal_len) out[op + lane] = (uint8_t)v8;
        } else {
            put_literals(out + op, in, literal_start, literal_len, lane);
        }
        op += literal_len;
        if (lane == 0) {
            out[op] = (uint8_t)(offset & 0xFF);
            out[op + 1] = (uint8_t)((offset >> 8) & 0xFF);
        }
        op = put_lsic(out, op + 2, extra, lane);
    }
    if (lane == 0) {
        *out_len = (int32_t)op;
        *status = st;
    }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
compress_kernel(const uint8_t* __restrict__ data, long long data_stride,
                const int32_t* __restrict__ n_arr, const int32_t* __restrict__ cursor_arr,
                const int32_t* __restrict__ cap_arr, const int32_t* __restrict__ accel_arr,
                const int32_t* __restrict__ toff_arr, const int32_t* __restrict__ prime_arr,
                const int32_t* __restrict__ table_in, int32_t* __restrict__ table_out,
                uint8_t* __restrict__ out, long long out_stride, int32_t* __restrict__ out_len,
                int32_t* __restrict__ status) {
    __shared__ typename T::slot_t tab[T::SLOTS];
    __shared__ uint8_t claim[T::SLOTS];  // a batch's lanes claim their slots here
    const long long b = blockIdx.x;
    const int lane = threadIdx.x;
    const int32_t* tin = table_in + b * T::SLOTS;
    for (int i = lane; i < T::SLOTS; i += THREADS) tab[i] = (typename T::slot_t)(uint32_t)tin[i];
    __syncwarp();
    const uint8_t* row = data + b * data_stride;
    const int n = n_arr[b];
    Input in;
    in.skew = (int)((uintptr_t)row & 3);
    in.g = reinterpret_cast<const uint32_t*>(row - in.skew);
    in.last_word = max(n + in.skew - 1, 0) >> 2;
    const long long cap = cap_arr[b] < 0 ? INT64_MAX : (long long)cap_arr[b];
    parse_block<T>(tab, claim, in, n, cursor_arr[b], cap, accel_arr[b],
                   (long long)(uint32_t)toff_arr[b], prime_arr[b] != 0, out + b * out_stride,
                   out_stride, out_len + b, status + b, lane);
    __syncwarp();
    int32_t* tout = table_out + b * T::SLOTS;
    for (int i = lane; i < T::SLOTS; i += THREADS) tout[i] = (int32_t)(uint32_t)tab[i];
}

// The SM's one array is split between shared memory and L1 per kernel, and
// left alone the split goes to shared memory (for as many resident rows as
// the thread count allows), which leaves an L1 too small for a row's window.
// Ask for the shared memory the rows that share an SM need, and no more.
template <class T>
void prefer_l1(int nblocks) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
            cudaSuccess ||
        sms <= 0 || per_sm <= 0)
        return;
    const long long row = T::SLOTS * (sizeof(typename T::slot_t) + 1) + 1024;  // + the system's
    const long long rows = (nblocks + sms - 1) / sms;
    const long long percent = (rows * row * 100 + per_sm - 1) / per_sm;
    cudaFuncSetAttribute(compress_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)(percent < 100 ? percent : 100));
}

template <class T>
void launch(const void* data, long long data_stride, const void* n_arr, const void* cursor_arr,
            const void* cap_arr, const void* accel_arr, const void* toff_arr,
            const void* prime_arr, const void* table_in, void* table_out, void* out,
            long long out_stride, void* out_len, void* status, int nblocks, cudaStream_t s) {
    prefer_l1<T>(nblocks);
    compress_kernel<T><<<nblocks, THREADS, 0, s>>>(
        (const uint8_t*)data, data_stride, (const int32_t*)n_arr, (const int32_t*)cursor_arr,
        (const int32_t*)cap_arr, (const int32_t*)accel_arr, (const int32_t*)toff_arr,
        (const int32_t*)prime_arr, (const int32_t*)table_in, (int32_t*)table_out,
        (uint8_t*)out, out_stride, (int32_t*)out_len, (int32_t*)status);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lz4t_compress(const void* data, long long data_stride, const void* n_arr,
                             const void* cursor_arr, const void* cap_arr, const void* accel_arr,
                             const void* toff_arr, const void* prime_arr, const void* table_in,
                             void* table_out, int table_slots, void* out, long long out_stride,
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
