// Greedy LZ4 block compressor, one LZ4 block per warp, or one block on many
// warps (split_kernel and stitch_kernel, further down).
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
//
// A frame of 4 MiB blocks has only 2 to 13 such warps for 132 SMs, so the
// frame path cuts each independent row at seams and runs a warp a segment,
// all with this parse step (split_kernel); a run's output is used from
// where an earlier exact run's records prove it agrees with it.  A run
// parses its segment and the 150 to 300 KiB it takes two greedy parses of
// the stand-in to meet and stay equal for 64 KiB; with 96 KiB seams a
// 4 MiB row of xml takes 16.6 ms against 103.1 ms
// (tools/torch_chip_split_sweep.py; the rule is split_seam in
// kernels/compress.py).

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

// ---------------------------------------------------------------------------
// One row on many warps.  A split launch cuts each row at seams S, 2S, ...
// and gives every segment a warp (a block of its own).  Segment k's warp runs
// parse_block over the whole row from its seam, on an empty table: a slot
// more than 0xFFFF behind a probe is rejected as an empty one is, and every
// seam lies past 0xFFFF, so the run is a greedy parse from that search start
// with nothing behind it.  Segment 0's run is the row's exact parse.  Each
// run publishes a record of every sequence (below) and checks its records
// against a later segment's as both go: records identical from a common
// search start c0 up to a common search start h >= c0 + HANDOFF_SPAN mean
// the same inserts over the 64 KiB behind h, so every slot a later probe can
// use holds the same position in both tables, and the two runs agree from h
// on.  The run stops there and hands the row over at h.  A check never waits
// for another block: where the target has not published far enough, the run
// parses on and looks again 32 sequences later.  Where the target's records
// end without a proof, the run tries the segment the target handed over to,
// else the next one (a takeover); with none left it parses to the row's end,
// the one-warp kernel's work.  stitch_kernel then copies each row's proven
// pieces in order (kernels/compress.py: parse_split_plain is the model).
// ---------------------------------------------------------------------------

constexpr int HANDOFF_SPAN = 1 << 16;
constexpr int MAX_SEGMENTS = 64;     // kernels/compress.py MAX_SEGMENTS
constexpr int FINAL = INT32_MIN;     // a published count that will not grow
constexpr int PLAN = 6;              // row, segment, scratch at, bytes, records at, records
constexpr int HANDOFF = 8;  // target, h, own op at h, target's op at h, final op, records, deferred
constexpr int DEFER_MIN = 1024;      // a literal run this long is left to the stitch
constexpr int DEFER_CAP = 64;        // deferred runs a warp

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A split run's records and its check against a later segment's.  A record
// is (probe that hit, its candidate, match end, output offset at the search
// start), the tail's (-1, -1, n, offset); a record's search start is the
// end of the one before, the first's the seam.  Every field is the same in
// all lanes.
struct Split {
    const long long* plan;  // PLAN int64 a warp, rows in order
    int4* recs;             // every warp's records
    int* progress;          // every warp's published count (| FINAL)
    int* handoff;           // HANDOFF int32 a warp
    int w, seg, nseg, seam;
    int4* own;
    int cap, count;
    int4* deferred;  // (output offset, input offset, length) of the runs left to the stitch
    int n_deferred;
    // the check: target segment (-1: none), next own and target record and
    // their search starts, the run of identical records from c0
    int tgt, i, j, ci, dj, c0;
    bool anchored;
    int h, h_tgt, own_op, tgt_op;  // the proven hand-off (h < 0: none)

    __device__ void publish(bool final, int lane) {
        __syncwarp();
        if (lane == 0) store_release(progress + w, count | (final ? FINAL : 0));
    }

    // A sequence parsed (by the whole warp): true where the run is to stop.
    __device__ __forceinline__ bool record(int hit, int cand, int end, long long op, int lane) {
        if (count >= cap) return false;
        if (lane == 0) own[count] = make_int4(hit, cand, end, (int)op);
        if ((++count & 31) && count < cap) return false;
        if (count == cap && lane == 0) handoff[HANDOFF * w] = -1;  // for a reader before finish
        publish(count == cap, lane);
        return h < 0 && compare(lane);
    }

    // A long literal run at out[op..) is left for the stitch to copy from the
    // input, and only if the row turns out compressible: a run that no cap
    // stops (the one-warp kernel aborts a row at its cap) would otherwise
    // be copied by every warp that parses over it.  False: copy it here.
    __device__ __forceinline__ bool defer(long long op, int from, int len, int lane) {
        if (len < DEFER_MIN || n_deferred >= DEFER_CAP) return false;
        if (lane == 0) deferred[n_deferred] = make_int4((int)op, from, len, 0);
        ++n_deferred;
        return true;
    }

    // Compare as far as both runs have published; true on a proven hand-off.
    __device__ bool compare(int lane) {
        while (tgt >= 0 && i < count) {
            const int tw = w - seg + tgt;
            const int4* theirs = recs + plan[PLAN * tw + 4];
            const int prog = load_acquire(progress + tw);
            const int lm = min(THREADS, (prog & INT32_MAX) - j);
            if (lm <= 0) {
                if (prog >= 0) return false;  // not there yet: parse on
                // their records end unproven: where they handed over, else the next
                const int next = __ldcg(handoff + HANDOFF * tw);
                tgt = next >= 0 ? next : tgt + 1 < nseg ? tgt + 1 : -1;
                j = 0;
                dj = tgt * seam;
                anchored = false;
                continue;
            }
            const int lo = min(THREADS, count - i);
            int4 o = make_int4(0, 0, 0, 0), t = o;
            if (lane < lo) o = __ldcg(own + i + lane);
            if (lane < lm) t = __ldcg(theirs + j + lane);
            // each lane's search starts: the end of the record before
            int os = __shfl_up_sync(FULL, o.z, 1), ts = __shfl_up_sync(FULL, t.z, 1);
            if (lane == 0) {
                os = ci;
                ts = dj;
            }
            if (anchored) {
                const bool in = lane < min(lo, lm);
                const unsigned differ =
                    __ballot_sync(FULL, in & ((o.x != t.x) | (o.y != t.y) | (o.z != t.z)));
                const unsigned far = __ballot_sync(FULL, in & (os - c0 >= HANDOFF_SPAN));
                const int fd = differ ? __ffs(differ) - 1 : THREADS;
                const int ff = far ? __ffs(far) - 1 : THREADS;
                if (ff <= fd && ff < THREADS) {  // identical from c0 to a start past the span
                    h = __shfl_sync(FULL, os, ff);
                    own_op = __shfl_sync(FULL, o.w, ff);
                    tgt_op = __shfl_sync(FULL, t.w, ff);
                    h_tgt = tgt;
                    return true;
                }
                const int adv = fd < THREADS ? fd + 1 : min(lo, lm);
                anchored = fd >= THREADS;
                ci = __shfl_sync(FULL, o.z, adv - 1);
                dj = __shfl_sync(FULL, t.z, adv - 1);
                i += adv;
                j += adv;
                continue;
            }
            // the first own start the target also has: each lane searches
            // the target's starts of this step for its own
            const int last = __shfl_sync(FULL, ts, lm - 1);
            int a = 0, b = lm;  // the first target lane whose start is >= os
            for (int step = 0; step < 6; ++step) {
                const int mid = (a + b) >> 1;
                const int v = __shfl_sync(FULL, ts, mid & 31);
                if (a < b) {
                    if (v < os) a = mid + 1;
                    else b = mid;
                }
            }
            const bool found = (lane < lo) & (a < lm) & (__shfl_sync(FULL, ts, a & 31) == os);
            const unsigned founds = __ballot_sync(FULL, found);
            const unsigned beyond = __ballot_sync(FULL, (lane < lo) & (os > last));
            const int f = founds ? __ffs(founds) - 1 : THREADS;
            const int u = beyond ? __ffs(beyond) - 1 : THREADS;
            if (f < u) {
                const int at = __shfl_sync(FULL, a, f);
                ci = __shfl_sync(FULL, os, f);
                dj = __shfl_sync(FULL, ts, at);
                i += f;
                j += at;
                c0 = ci;
                anchored = true;
            } else if (u < THREADS) {  // own lane u lies past these target records
                ci = __shfl_sync(FULL, os, u);
                i += u;
                dj = __shfl_sync(FULL, t.z, lm - 1);
                j += lm;
            } else {  // none of these own starts is the target's
                ci = __shfl_sync(FULL, o.z, lo - 1);
                i += lo;
            }
        }
        return false;
    }

    // The run is over (stopped at its hand-off, or at the row's end): a last
    // check, then the hand-off and the final count for the readers.
    __device__ void finish(long long op, int lane) {
        publish(false, lane);
        if (h < 0) compare(lane);
        if (lane == 0) {
            int* ho = handoff + HANDOFF * w;
            ho[0] = h >= 0 ? h_tgt : -1;
            ho[1] = h;
            ho[2] = own_op;
            ho[3] = tgt_op;
            ho[4] = (int)op;
            ho[5] = count;
            ho[6] = n_deferred;
        }
        publish(true, lane);
    }
};

// One block's greedy parse (spec: reference compress/mod.rs:166-238; the
// same result as lz4tpu/native/src/lz4_native.cpp compress_impl), run by
// the whole warp; every variable but `lane` and the per-lane probe is the
// same in all lanes.  Positions are 32-bit (n is); the table offset, the
// output position and, past a search's first batch, the skip schedule are
// taken in 64 bits.
template <class T, bool SPLIT = false>
__device__ __forceinline__ void parse_block(typename T::slot_t* tab, uint8_t* claim,
                                            const Input& in, int n,
                            int init_cursor, long long cap, int acceleration, long long toff,
                            bool prime, uint8_t* out, long long out_cap, int32_t* out_len,
                            int32_t* status, int lane, Split* split = nullptr) {
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
        int offset = 0, extra = 0, hit_at = 0;
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
                hit_at = cursor;
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
            if constexpr (SPLIT) split->record(-1, -1, n, op, lane);
            if (lane == 0) out[op] = (uint8_t)((literal_len < 0xF ? literal_len : 0xF) << 4);
            op = put_lsic(out, op + 1, literal_len, lane);
            if (!SPLIT || !split->defer(op, literal_start, literal_len, lane))
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
        const long long group_at = op;
        if (lane == 0)
            out[op] = (uint8_t)(((literal_len < 0xF ? literal_len : 0xF) << 4) |
                                (extra < 0xF ? extra : 0xF));
        op = put_lsic(out, op + 1, literal_len, lane);
        if (in_order && literal_len <= THREADS) {
            // lane l probed literal_start + l: its probe word begins with its literal
            if (lane < literal_len) out[op + lane] = (uint8_t)v8;
        } else if (!SPLIT || !split->defer(op, literal_start, literal_len, lane)) {
            put_literals(out + op, in, literal_start, literal_len, lane);
        }
        op += literal_len;
        if (lane == 0) {
            out[op] = (uint8_t)(offset & 0xFF);
            out[op + 1] = (uint8_t)((offset >> 8) & 0xFF);
        }
        op = put_lsic(out, op + 2, extra, lane);
        if constexpr (SPLIT) {
            if (split->record(hit_at, hit_at - offset, cursor, group_at, lane)) break;
        }
    }
    if constexpr (SPLIT) {
        split->finish(op, lane);
    } else if (lane == 0) {
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


// Segment plan[w] of its row: parse_block from the seam on an empty table,
// no cap, into the warp's scratch.  Later segments take the lower block
// numbers, so that where the launch's blocks are not all resident a check
// finds its target's records published.
__global__ void __launch_bounds__(THREADS)
split_kernel(const uint8_t* __restrict__ data, long long data_stride,
             const int32_t* __restrict__ n_arr, const int32_t* __restrict__ accel_arr,
             const long long* __restrict__ plan, int n_warps, int seam, int4* recs,
             int4* deferred, uint8_t* scratch, int* progress, int* handoff) {
    __shared__ uint32_t tab[U32T::SLOTS];
    __shared__ uint8_t claim[U32T::SLOTS];
    const int lane = threadIdx.x;
    const int w = n_warps - 1 - (int)blockIdx.x;
    const long long* p = plan + PLAN * (long long)w;
    const int row = (int)p[0], seg = (int)p[1];
    for (int i = lane; i < U32T::SLOTS; i += THREADS) tab[i] = 0;
    __syncwarp();
    const uint8_t* base = data + row * data_stride;
    const int n = n_arr[row];
    Input in;
    in.skew = (int)((uintptr_t)base & 3);
    in.g = reinterpret_cast<const uint32_t*>(base - in.skew);
    in.last_word = max(n + in.skew - 1, 0) >> 2;
    Split sp;
    sp.plan = plan;
    sp.recs = recs;
    sp.progress = progress;
    sp.handoff = handoff;
    sp.w = w;
    sp.seg = seg;
    sp.nseg = max(n / seam, 1);
    sp.seam = seam;
    sp.own = recs + p[4];
    sp.cap = (int)p[5];
    sp.count = 0;
    sp.deferred = deferred + DEFER_CAP * (long long)w;
    sp.n_deferred = 0;
    sp.tgt = seg + 1 < sp.nseg ? seg + 1 : -1;
    sp.i = sp.j = 0;
    sp.ci = seg * seam;
    sp.dj = (seg + 1) * seam;
    sp.c0 = 0;
    sp.anchored = false;
    sp.h = -1;
    sp.h_tgt = sp.own_op = sp.tgt_op = -1;
    parse_block<U32T, true>(tab, claim, in, n, seg * seam, INT64_MAX, accel_arr[row], 0, false,
                            scratch + p[2], p[3], nullptr, nullptr, lane, &sp);
}

// The output offset of a run's sequence that starts at e: from its records,
// or past them by walking its tokens from the last one.  One thread.
__device__ int op_at(const int4* rec, int count, int first, const uint8_t* out, int e) {
    int a = 0, b = count;  // the first record whose start is >= e
    while (a < b) {
        const int mid = (a + b) >> 1;
        if ((mid ? rec[mid - 1].z : first) < e) a = mid + 1;
        else b = mid;
    }
    if (a < count) {
        if ((a ? rec[a - 1].z : first) != e) __trap();
        return rec[a].w;
    }
    int pos = count > 1 ? rec[count - 2].z : first, op = rec[count - 1].w;
    while (pos < e) {
        const int token = out[op++];
        int lit = token >> 4, ml = token & 0xF;
        for (int more = lit == 0xF; more;) {
            const int b8 = out[op++];
            lit += b8;
            more = b8 == 0xFF;
        }
        op += lit + 2;
        for (int more = ml == 0xF; more;) {
            const int b8 = out[op++];
            ml += b8;
            more = b8 == 0xFF;
        }
        pos += lit + ml + (int)MINMATCH;
    }
    if (pos != e) __trap();
    return op;
}

constexpr int STITCH_THREADS = 256;
constexpr int STITCH_CHUNK = 1 << 16;  // output bytes a block copies

// Row blockIdx.y: follow the hand-offs from segment 0 and copy the proven
// pieces' bytes of output chunk blockIdx.x into the row's out.  A hand-off
// that lies before the point the row entered its segment is a chain: the
// target agrees with that segment from its h on, so the row goes on there.
// meta (4, rows): out_len (the stitched length), status, seams, seams taken
// over (whose hand-off did not come from the segment before).
__global__ void __launch_bounds__(STITCH_THREADS)
stitch_kernel(const uint8_t* __restrict__ data, long long data_stride,
              const int32_t* __restrict__ cap_arr,
              const long long* __restrict__ plan, const int32_t* __restrict__ row_first,
              int seam, const int4* __restrict__ recs, const int4* __restrict__ deferred,
              const uint8_t* __restrict__ scratch, const int* __restrict__ handoff,
              uint8_t* __restrict__ out, long long out_stride, int32_t* __restrict__ meta,
              int n_rows) {
    __shared__ long long src[MAX_SEGMENTS];
    __shared__ int dst[MAX_SEGMENTS + 1], from[MAX_SEGMENTS], seg_of[MAX_SEGMENTS];
    __shared__ int n_pieces;
    const int row = blockIdx.y;
    const int w0 = row_first[row], nseg = row_first[row + 1] - w0;
    const long long limit = cap_arr[row] < 0 ? out_stride : min((long long)cap_arr[row], out_stride);
    if (threadIdx.x == 0) {
        int k = 0, e = 0, e_op = 0, hops = 0, np = 0, total = 0;
        for (;;) {
            const int* ho = handoff + HANDOFF * (w0 + k);
            const long long* p = plan + PLAN * (long long)(w0 + k);
            const int tgt = ho[0], h = ho[1];
            if (tgt >= 0 && h < e) {
                hops += tgt == k + 1;
                k = tgt;
                e_op = -1;
                continue;
            }
            if (e_op < 0) e_op = op_at(recs + p[4], ho[5], k * seam, scratch + p[2], e);
            const int end = tgt >= 0 ? ho[2] : ho[4];
            src[np] = p[2] + e_op;
            from[np] = e_op;
            seg_of[np] = w0 + k;
            dst[np++] = total;
            total += end - e_op;
            if (tgt < 0) break;
            hops += tgt == k + 1;
            k = tgt;
            e = h;
            e_op = ho[3];
        }
        dst[np] = total;
        n_pieces = np;
        if (blockIdx.x == 0) {
            meta[row] = total;
            meta[n_rows + row] = total > limit ? STATUS_INCOMPRESSIBLE : STATUS_OK;
            meta[2 * n_rows + row] = nseg - 1;
            meta[3 * n_rows + row] = nseg - 1 - hops;
        }
    }
    __syncthreads();
    const int total = dst[n_pieces];
    if (total > limit) return;  // stored raw: the row stays zero
    const int c0 = blockIdx.x * STITCH_CHUNK, c1 = min(c0 + STITCH_CHUNK, total);
    uint8_t* o = out + row * out_stride;
    for (int q = 0; q < n_pieces; ++q) {
        const int a = max(c0, dst[q]), b = min(c1, dst[q + 1]);
        const uint8_t* at = scratch + src[q] - dst[q];
        for (int x = a + (int)threadIdx.x; x < b; x += STITCH_THREADS) o[x] = at[x];
    }
    __syncthreads();
    // the long literal runs the pieces' warps left: from the input, over
    // the holes just copied
    const uint8_t* in = data + row * data_stride;
    for (int q = 0; q < n_pieces; ++q) {
        const int4* d = deferred + DEFER_CAP * (long long)seg_of[q];
        const int nd = handoff[HANDOFF * seg_of[q] + 6];
        for (int r = 0; r < nd; ++r) {
            const int4 run = d[r];  // (output offset, input offset, length)
            const int at = dst[q] + run.x - from[q];
            if (run.x < from[q] || at >= dst[q + 1]) continue;  // outside the piece
            const int a = max(c0, at), b = min(c1, at + run.z);
            const uint8_t* lit = in + run.y - at;
            for (int x = a + (int)threadIdx.x; x < b; x += STITCH_THREADS) o[x] = lit[x];
        }
    }
}

// The SM's one array is split between shared memory and L1 per kernel, and
// left alone the split goes to shared memory (for as many resident rows as
// the thread count allows), which leaves an L1 too small for a row's window.
// Ask for the shared memory the rows that share an SM need, and no more.
template <class T, class K>
void prefer_l1(K kernel, int nblocks) {
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
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)(percent < 100 ? percent : 100));
}

template <class T>
void launch(const void* data, long long data_stride, const void* n_arr, const void* cursor_arr,
            const void* cap_arr, const void* accel_arr, const void* toff_arr,
            const void* prime_arr, const void* table_in, void* table_out, void* out,
            long long out_stride, void* out_len, void* status, int nblocks, cudaStream_t s) {
    prefer_l1<T>(compress_kernel<T>, nblocks);
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

// Independent rows through the split parse (kernels/compress.py
// compress_split): split_kernel over the plan's warps, then stitch_kernel.
// scratch holds the records (rec_bytes), DEFER_CAP deferred runs a warp,
// then every warp's output.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int lz4t_compress_split(const void* data, long long data_stride, const void* n_arr,
                                   const void* cap_arr, const void* accel_arr, const void* plan,
                                   const void* row_first, int n_warps, int n_rows, int seam,
                                   void* scratch, long long rec_bytes, void* progress,
                                   void* handoff, void* out, long long out_stride, void* meta,
                                   void* stream) {
    if (n_warps <= 0 || n_rows <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    int4* recs = (int4*)scratch;
    int4* deferred = (int4*)((uint8_t*)scratch + rec_bytes);
    uint8_t* outs = (uint8_t*)(deferred + DEFER_CAP * (long long)n_warps);
    prefer_l1<U32T>(split_kernel, n_warps);
    split_kernel<<<n_warps, THREADS, 0, s>>>(
        (const uint8_t*)data, data_stride, (const int32_t*)n_arr, (const int32_t*)accel_arr,
        (const long long*)plan, n_warps, seam, recs, deferred, outs, (int*)progress,
        (int*)handoff);
    const dim3 grid((unsigned)((out_stride + STITCH_CHUNK - 1) / STITCH_CHUNK), (unsigned)n_rows);
    stitch_kernel<<<grid, STITCH_THREADS, 0, s>>>(
        (const uint8_t*)data, data_stride, (const int32_t*)cap_arr, (const long long*)plan,
        (const int32_t*)row_first, seam, recs, deferred, outs, (const int*)handoff,
        (uint8_t*)out, out_stride, (int32_t*)meta, n_rows);
    return (int)cudaGetLastError();
}
