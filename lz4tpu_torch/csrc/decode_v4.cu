// LZ4 block decoder for few blocks of any size: one LZ4 block spread over
// the whole card by speculative segment walks.
//
// Replaces: lz4tpu/kernels/decompress_v4.py:89 _decode_v4_kernel (launched
// by _decompress_batch_v4_jit, decompress_v4.py:434), the scalar-core
// per-block decoder with a parse-ahead ring and a fused drain, capped by
// the TPU's SMEM/VMEM windows at 512 KiB of comp and 2 MiB of output.
// This decoder has neither cap: comp and output live in device memory.
//
// What bounds it on this card: bytes, at best: (comp bytes + output bytes)
// / 3.35 TB/s.  What a block waits on in every decoder that gives it one
// SM is its serial token walk (124-363 cycles a sequence on decode_big's
// walk), and this decoder's callers send it few blocks (batches under 24,
// the single-block adapter, lane_kernel=False frames), so with a block an
// SM the card sits nearly empty.
//
// What the design does about it: the walk is cut into segments that the
// whole card walks at once, and everything after the walk is data-parallel
// (the speculative parse and multi-round resolution of "massively parallel
// decompression", arXiv 1606.00519, and CODAG, arXiv 2307.03760).  A call
// enqueues these launches on the caller's stream, with no host round trip:
//   1. walk: a warp per SEG bytes of compressed stream stages them (and an
//      overhang) in shared memory with 16-byte loads and walks the token
//      chain as if a token started at the segment's first byte, up to the
//      first token at or past the next segment: each lane walks 1/32 of
//      the segment from its first byte and on until it meets another
//      lane's walk, and the chain goes from lane to lane.  The walk parses
//      shapes only (lz4t::parse_shape: lengths, offset, the stream's
//      structural ends; a long run of 0xFF length bytes is skipped 16 bytes
//      at a time), so it needs no output position.  It records every token
//      (position, lengths, offset, the output bytes before it in the walk),
//      a bitmap of the token starts, and its exit.
//   2. resync, a thread per segment: from the exit of the walk before it
//      (the entry, unless a walk before that one reaches past it), a head of
//      at most HEAD sequences is parsed up to the first token the segment's
//      walk visited, from where the walk is the chain; compressor output
//      meets it within some tens of tokens.  A segment still out of step
//      is walked again from its entry by a second walk pass.
//   3. verify, a thread block per LZ4 block: a segment's true entry is the
//      largest exit of the segments before it, once those are true.  Rounds
//      bring every segment in step with that entry until nothing changes,
//      each bringing at least the first wrong segment into step; after the
//      resync, one round that changes nothing is the rule.  After ROUNDS
//      rounds one thread finishes the chain serially (crafted streams
//      only).  Then each segment's sequences and output bytes are counted
//      and scanned.
//   4. place, a warp per segment: every sequence of the chain gets its
//      output position, makes the checks of the shared parser
//      (lz4t::check_seq) in their order, and goes to dense arrays; the first
//      failing one in stream order wins an atomicMin.
//   5. scatter, 16 output bytes a thread: literals are written (16-byte
//      stores), and every match byte records the position it reads,
//      V[op - offset + (j mod offset)], which lies before the match.
//   6. pointer jumping over those positions, HOPS hops a round, until each
//      names a literal or a prefix byte: a launch per round over the tiles
//      of output the last round left unresolved (enough launches for a
//      chain through every output byte are enqueued; a resolved tile
//      returns at once).
//   7. gather: every match byte is read from its literal or prefix byte.
// Grid-wide dependencies are launch boundaries; nothing spins between
// thread blocks.  Positions are block-local int32; output positions and
// byte counts are summed in 64 bits.  The wrapper allocates the scratch
// (lz4t_decode_v4_scratch gives its size): about 16 bytes per byte of the
// padded comp width (records, their output counts, dense arrays, heads)
// and 4 per byte of output capacity (each byte's source), per block.  A
// call takes its blocks in groups whose scratch stays within
// SCRATCH_BUDGET (at least one block a group), each group the launches
// above on the same scratch, so a batch of many blocks needs no more
// scratch than the budget.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

constexpr int SEG = 2048;               // compressed bytes a speculative walk starts from
constexpr int ROUNDS = 4;               // verification rounds before the serial finish
constexpr int HEAD = 128;               // parsed from an entry to meet the walk, at most
constexpr int RCAP = SEG / 3 + 3;       // records a walk may keep (a sequence with a match
                                        // takes 3 bytes or more; two may end the stream)
constexpr int BITWORDS = SEG / 32;      // token-start bitmap of a segment
constexpr int OVERHANG = 256;           // staged past the segment for the last sequence
constexpr int PART = SEG / 32;          // a lane's part of a segment's walk
constexpr int LCAP = (PART / 3 + 3) | 1;  // records of a lane's own part (an odd
                                          // count of 16-byte rows: no bank conflicts)
constexpr int PLACE_WARPS = 4;
constexpr int CWIN = SEG + OVERHANG + 32;
constexpr int VERIFY_THREADS = 1024;
constexpr int TILE_THREADS = 256;
constexpr int TILE = 16 * TILE_THREADS; // output bytes a thread block of the byte passes covers
constexpr int DOUBLE_THREADS = 256;
constexpr int DOUBLE_SPAN = 4 * DOUBLE_THREADS;  // a doubling round's thread block, bytes
static_assert(TILE % DOUBLE_SPAN == 0, "a doubling block lies in one tile");
constexpr int HOPS = 7;                 // pointer hops a doubling round takes
constexpr int END = INT_MAX;            // the exit of a walk whose chain ends inside it
constexpr unsigned long long NO_FAILURE = ~0ULL;
constexpr long long SCRATCH_BUDGET = 512LL << 20;  // scratch bytes of a group of blocks

static_assert(SEG % 32 == 0, "whole bitmap words");

// Where each array lives in the scratch buffer.
struct Layout {
    long long m;     // segments a row
    long long ns;    // segments of the batch
    long long nr;    // record slots a row (m * RCAP)
    int4* rec;       // (pos, lit_len, match_len, offset | code << 16) per record
    long long* cum;  // output bytes of the walk before each record
    unsigned* bits;  // token starts, BITWORDS a segment
    int4* head;      // per segment: up to HEAD records parsed from its entry to the
    long long* hcum; // first token its walk visited, and the head's bytes before each
    int* nrec;       // per segment: the walk's records and exit;
    int* wexit;
    int* first_exit; // the walk kernel's exit, kept for the resync pass
    int* again;      // the resync pass leaves the walk from its entry to a second walk
    int* entry;      // the entry a round's scan gives it;
    int* used;       // the entry it was last brought in step with;
    int* empty;      // whether the chain has no token in it;
    int* nhead;      // its head's records;
    int* tail;       // the walk's record where the chain meets it (nrec: nowhere);
    int* exit;       // the chain's exit;
    long long* hbytes;  // and its head's output bytes
    long long* tot;  // per segment: output bytes of its whole walk, and the scans
    long long* seq_base;
    long long* op_base;
    int* d_op;       // per sequence of the chain, dense in stream order
    int* d_lit;
    int* d_src;
    int* d_ml;
    int* d_off;
    long long* tot_seq;  // per block
    long long* tot_op;
    unsigned long long* first;  // (sequence << 3 | status) of the first failure
    int* src;        // per output byte: the position it reads (itself: a literal)
    int* tile_round; // per tile of output: the last doubling round that left a byte
                     // of it unresolved (0: the scatter; -1: none)
    long long bytes;
};

__host__ __device__ inline long long align16(long long x) { return (x + 15) & ~15LL; }

// a round takes HOPS hops along the pointers it finds, so a pointer's reach
// grows (HOPS + 1) = 8 times a round: enough rounds for a chain through
// every output byte
__host__ __device__ inline int doubling_rounds(long long out_stride) {
    int bits = 0;
    for (long long v = out_stride > 1 ? out_stride - 1 : 1; v; v >>= 1) bits++;
    return (bits + 2) / 3 + 1;
}

__host__ __device__ inline long long tiles_of(long long out_stride) {
    return out_stride > 0 ? (out_stride + TILE - 1) / TILE : 1;
}

__host__ __device__ inline Layout layout(char* base, int nblocks, long long comp_stride,
                                         long long out_stride) {
    Layout L;
    L.m = (comp_stride + SEG - 1) / SEG;
    L.ns = L.m * nblocks;
    L.nr = L.m * RCAP;
    const long long nrec_all = L.nr * nblocks;
    long long at = 0;
    auto take = [&](long long bytes) {
        char* p = base + at;
        at = align16(at + bytes);
        return p;
    };
    L.rec = (int4*)take(nrec_all * 16);
    L.cum = (long long*)take(nrec_all * 8);
    L.tot = (long long*)take(L.ns * 8);
    L.seq_base = (long long*)take(L.ns * 8);
    L.op_base = (long long*)take(L.ns * 8);
    L.tot_seq = (long long*)take(nblocks * 8LL);
    L.tot_op = (long long*)take(nblocks * 8LL);
    L.first = (unsigned long long*)take(nblocks * 8LL);
    L.bits = (unsigned*)take(L.ns * BITWORDS * 4);
    L.head = (int4*)take(L.ns * HEAD * 16);
    L.hcum = (long long*)take(L.ns * HEAD * 8);
    L.hbytes = (long long*)take(L.ns * 8);
    L.nrec = (int*)take(L.ns * 4);
    L.wexit = (int*)take(L.ns * 4);
    L.first_exit = (int*)take(L.ns * 4);
    L.again = (int*)take(L.ns * 4);
    L.entry = (int*)take(L.ns * 4);
    L.used = (int*)take(L.ns * 4);
    L.empty = (int*)take(L.ns * 4);
    L.nhead = (int*)take(L.ns * 4);
    L.tail = (int*)take(L.ns * 4);
    L.exit = (int*)take(L.ns * 4);
    L.d_op = (int*)take(nrec_all * 4);
    L.d_lit = (int*)take(nrec_all * 4);
    L.d_src = (int*)take(nrec_all * 4);
    L.d_ml = (int*)take(nrec_all * 4);
    L.d_off = (int*)take(nrec_all * 4);
    L.src = (int*)take(out_stride * nblocks * 4);
    L.tile_round = (int*)take(tiles_of(out_stride) * nblocks * 4);
    L.bytes = at;
    return L;
}

// The walk from `pos` to the first token at or past `seg_end` (or to the
// chain's end): records, bitmap bits relative to `seg_lo`, exit.  Match
// lengths are kept at most limit + 1, which fails the same check and keeps
// them in 32 bits.  Returns the record count.
template <class Reader>
__device__ int walk(const Reader& rd, int n, int pos, int seg_lo, long long seg_end,
                    long long limit, int4* rec, long long* cum, unsigned* bits, int& exit,
                    long long& tot) {
    int r = 0;
    long long acc = 0;
    for (;;) {
        if (pos >= n) {
            exit = END;
            break;
        }
        const lz4t::Shape sh = lz4t::parse_shape(rd, n, pos);
        const int lit = (int)sh.lit_len;
        const int ml = (int)(sh.match_len < limit + 1 ? sh.match_len : limit + 1);
        rec[r] = make_int4(pos, lit, ml, (int)sh.offset | (sh.code << 16));
        cum[r] = acc;
        bits[(pos - seg_lo) >> 5] |= 1u << ((pos - seg_lo) & 31);
        acc += (long long)lit + ml;
        r++;
        if (sh.code != lz4t::SHAPE_OK) {
            exit = END;
            break;
        }
        pos = (int)sh.next_pos;
        if (pos >= seg_end) {
            exit = pos;
            break;
        }
    }
    tot = acc;
    return r;
}

// 1. a warp per segment: the walk from its first byte, every lane walking
// a 1/32 part of it at once.  Lane k walks its part as if a token started
// at the part's first byte, keeping its records; then it counts on past the
// part's end to the first token that the lane owning that position visited,
// from where that lane's walk is the same chain (or out of the segment, or
// to the chain's end).  Lane 0 follows the chain from lane to lane (at most
// 32 hops), and the lanes on it write their records from the chain's entry
// into their part, then parse their way past the part's end again, writing
// those too: in stream order, the walk of the segment from its first byte.
__global__ void __launch_bounds__(32)
walk_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
            const int32_t* __restrict__ comp_len, long long limit, Layout L, bool again) {
    __shared__ __align__(16) uint8_t win[CWIN];
    __shared__ unsigned seen[BITWORDS];       // token starts of the parts' own walks
    __shared__ unsigned chain_bits[BITWORDS]; // token starts of the segment's walk
    __shared__ int4 lrec[32][LCAP];           // each lane's own records
    __shared__ int lane_count[32];
    __shared__ int lane_exit[32];             // where a lane's walk meets another's
    __shared__ int from[32];                  // a lane's first record on the chain, or -1
    const int lane = threadIdx.x;
    const long long s = blockIdx.x;
    const long long b = s / L.m;
    const int j = (int)(s % L.m);
    const int n = comp_len[b];
    const int lo = j * SEG;
    if (lo >= n || (again && !L.again[s])) return;
    // the walk from the segment's first byte, or (again) from the entry the
    // resync pass found out of step with it for longer than HEAD sequences
    const int start = again ? L.used[s] : lo;
    const int k0 = (start - lo) / PART;  // the lane whose part holds start
    const long long end = (long long)lo + SEG;
    lz4t::Window w{nullptr, comp + b * comp_stride, 0, 0};
    lz4t::load_window<32>(w, win, n, lo, lane, SEG + OVERHANG);
    for (int k = lane; k < BITWORDS; k += 32) seen[k] = chain_bits[k] = 0;
    from[lane] = -1;
    __syncwarp();

    // one step of a walk: the record of the token at `pos`, and the next
    // position (END where the chain ends inside the segment)
    const auto step = [&](int pos, int4& rec) {
        const lz4t::Shape sh = lz4t::parse_shape(w, n, pos);
        const int ml = (int)(sh.match_len < limit + 1 ? sh.match_len : limit + 1);
        rec = make_int4(pos, (int)sh.lit_len, ml, (int)sh.offset | (sh.code << 16));
        const int next = (int)sh.next_pos;
        return sh.code != lz4t::SHAPE_OK || (next >= n && next < end) ? END : next;
    };
    // the part's own walk
    const int part_lo = lo + lane * PART;
    const int first_pos = lane < k0 ? END : lane == k0 ? start : part_lo;
    int4* mine = lrec[lane];
    int count = 0, exit = first_pos < n ? first_pos : END;
    while (exit < part_lo + PART) {
        exit = step(exit, mine[count]);
        atomicOr(&seen[(mine[count].x - lo) >> 5], 1u << ((mine[count].x - lo) & 31));
        count++;
    }
    lane_count[lane] = count;
    const int own_exit = exit;
    __syncwarp();
    // on past the part's end, counting, to the first token another lane visited
    int ext = 0;
    long long ext_bytes = 0;
    while (exit != END && exit < end &&
           !((seen[(exit - lo) >> 5] >> ((exit - lo) & 31)) & 1)) {
        int4 q;
        exit = step(exit, q);
        ext++;
        ext_bytes += (long long)q.y + q.z;
    }
    lane_exit[lane] = exit;
    __syncwarp();
    // lane 0 follows the chain from lane to lane
    if (lane == 0) {
        int k = k0, e = start;
        for (;;) {
            const int4* r = lrec[k];
            int a = 0, z = lane_count[k];  // e is one of the part's own records
            while (a < z) {
                const int mid = (a + z) >> 1;
                if (r[mid].x < e) a = mid + 1;
                else z = mid;
            }
            from[k] = a;
            e = lane_exit[k];
            if (e == END || e >= end) break;
            k = (e - lo) / PART;
        }
    }
    __syncwarp();
    // the lanes on the chain write their records in order: counts and bytes
    // by a warp scan
    const int f = from[lane];
    const int mine_n = f < 0 ? 0 : count - f + ext;
    long long mine_bytes = f < 0 ? 0 : ext_bytes;
    for (int r = f < 0 ? count : f; r < count; r++) mine_bytes += (long long)mine[r].y + mine[r].z;
    int at = mine_n;
    long long bytes_at = mine_bytes;
    for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(lz4t::FULL_MASK, at, d);
        const long long upb = __shfl_up_sync(lz4t::FULL_MASK, bytes_at, d);
        if (lane >= d) {
            at += up;
            bytes_at += upb;
        }
    }
    const int nrec = __shfl_sync(lz4t::FULL_MASK, at, 31);
    const long long total = __shfl_sync(lz4t::FULL_MASK, bytes_at, 31);
    at -= mine_n;
    bytes_at -= mine_bytes;
    int4* rec = L.rec + s * RCAP;
    long long* cum = L.cum + s * RCAP;
    const auto put = [&](const int4& q) {
        rec[at] = q;
        cum[at++] = bytes_at;
        bytes_at += (long long)q.y + q.z;
        atomicOr(&chain_bits[(q.x - lo) >> 5], 1u << ((q.x - lo) & 31));
    };
    if (f >= 0) {
        for (int r = f; r < count; r++) put(mine[r]);
        for (int pos = own_exit, k = 0; k < ext; k++) {  // the walk past the part, again
            int4 q;
            pos = step(pos, q);
            put(q);
        }
    }
    // the segment's exit: that of the last lane on the chain
    const unsigned last = __ballot_sync(lz4t::FULL_MASK, f >= 0 && (exit == END || exit >= end));
    const int seg_exit = lane_exit[__ffs(last) - 1];
    __syncwarp();
    if (lane == 0) {
        L.nrec[s] = nrec;
        L.wexit[s] = seg_exit;
        if (!again) L.first_exit[s] = seg_exit;
        L.exit[s] = seg_exit;
        L.tot[s] = total;
        L.used[s] = start;
        L.again[s] = 0;
        L.empty[s] = 0;
        L.nhead[s] = 0;
        L.tail[s] = 0;
        L.hbytes[s] = 0;
    }
    for (int k = lane; k < BITWORDS; k += 32) L.bits[s * BITWORDS + k] = chain_bits[k];
}

// block-wide exclusive scan of one value a thread (VERIFY_THREADS threads);
// `op` is max or +, `zero` its identity; returns the exclusive value and
// the total in `total`
template <class T, class Op>
__device__ T block_exclusive(T v, T zero, Op op, T* warp_tot, T& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        const T up = __shfl_up_sync(lz4t::FULL_MASK, inc, d);
        if (lane >= d) inc = op(inc, up);
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        T t = lane < VERIFY_THREADS / 32 ? warp_tot[lane] : zero;
        for (int d = 1; d < 32; d <<= 1) {
            const T up = __shfl_up_sync(lz4t::FULL_MASK, t, d);
            if (lane >= d) t = op(t, up);
        }
        warp_tot[lane] = t;  // inclusive over warps
    }
    __syncthreads();
    const T before = warp ? warp_tot[warp - 1] : zero;
    total = warp_tot[VERIFY_THREADS / 32 - 1];
    const T excl = op(before, __shfl_up_sync(lz4t::FULL_MASK, inc, 1));
    const T out = lane ? excl : before;
    __syncthreads();  // warp_tot is reused by the next scan
    return out;
}

struct MaxOp {
    __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct SumOp {
    __device__ long long operator()(long long a, long long b) const { return a + b; }
};

// Bring segment s (index j of its row) in step with entry `e`; true if it
// changed.  From `e` the chain is parsed until it reaches a token the walk
// visited (the bitmap), from where it is the walk; a chain that has not met
// the walk after HEAD sequences walks the segment again from `e`.
__device__ bool settle(const Layout& L, long long s, int j, int e, const uint8_t* c, int n,
                       long long limit, bool defer = false) {
    const long long end = (long long)(j + 1) * SEG;
    if (e >= end || e >= n) {  // no token of the chain in this segment
        if (L.empty[s] && L.used[s] == e) return false;
        L.empty[s] = 1;
        L.used[s] = e;
        L.exit[s] = e;
        return true;
    }
    if (!L.empty[s] && L.used[s] == e) return false;
    L.empty[s] = 0;
    L.used[s] = e;
    const lz4t::PtrReader rd{c};
    const int lo = j * SEG;
    int4* rec = L.rec + s * RCAP;
    unsigned* bits = L.bits + s * BITWORDS;
    int nrec = L.nrec[s];
    int h = 0, tail = nrec, exit;
    long long acc = 0;
    for (int pos = e;;) {
        if (pos >= n || pos >= end) {  // the chain ends, or leaves the segment
            exit = pos >= n ? END : pos;
            break;
        }
        const int rel = pos - lo;
        if ((bits[rel >> 5] >> (rel & 31)) & 1) {  // in step with the walk from here on
            int a = 0, z = nrec;
            while (a < z) {
                const int mid = (a + z) >> 1;
                if (rec[mid].x < pos) a = mid + 1;
                else z = mid;
            }
            tail = a;
            exit = L.wexit[s];
            break;
        }
        if (h == HEAD && defer) {  // out of step for long: the second walk pass takes it
            L.again[s] = 1;
            return true;
        }
        if (h == HEAD) {  // out of step for long: walk the segment again
            for (int k = 0; k < BITWORDS; k++) bits[k] = 0;
            long long tot;
            nrec = walk(rd, n, e, lo, end, limit, rec, L.cum + s * RCAP, bits, exit, tot);
            L.nrec[s] = nrec;
            L.wexit[s] = exit;
            L.tot[s] = tot;
            h = 0;
            tail = 0;
            acc = 0;
            break;
        }
        const lz4t::Shape sh = lz4t::parse_shape(rd, n, pos);
        const int lit = (int)sh.lit_len;
        const int ml = (int)(sh.match_len < limit + 1 ? sh.match_len : limit + 1);
        L.head[s * HEAD + h] = make_int4(pos, lit, ml, (int)sh.offset | (sh.code << 16));
        L.hcum[s * HEAD + h] = acc;
        acc += (long long)lit + ml;
        h++;
        if (sh.code != lz4t::SHAPE_OK) {
            exit = END;
            break;
        }
        pos = (int)sh.next_pos;
    }
    L.nhead[s] = h;
    L.tail[s] = tail;
    L.hbytes[s] = acc;
    L.exit[s] = exit;
    return true;
}

// 2. a thread per segment, over the whole card: each segment brought in
// step with the exit of the walk before it, which is its entry unless a
// walk before that one reaches past it (the verify rounds find out).  This
// takes the heads, which nearly every segment needs, off the one SM a
// block's verify pass runs on.
__global__ void __launch_bounds__(128)
resync_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
              const int32_t* __restrict__ comp_len, long long limit, Layout L) {
    const long long s = (long long)blockIdx.x * 128 + threadIdx.x;
    if (s >= L.ns) return;
    const long long b = s / L.m;
    const int j = (int)(s % L.m);
    const int n = comp_len[b];
    if (j == 0 || (long long)j * SEG >= n) return;
    settle(L, s, j, L.first_exit[s - 1], comp + b * comp_stride, n, limit, true);
}

// 3. a thread block per LZ4 block: the true chain, then the scans
__global__ void __launch_bounds__(VERIFY_THREADS)
verify_kernel(const uint8_t* __restrict__ comp, long long comp_stride,
              const int32_t* __restrict__ comp_len, long long limit, Layout L) {
    __shared__ int warp_max[32];
    __shared__ long long warp_sum[32];
    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    const uint8_t* c = comp + b * comp_stride;
    const int n = comp_len[b];
    const int m = (int)((n + (long long)SEG - 1) / SEG);
    const long long s0 = b * L.m;
    // each thread keeps a run of consecutive segments
    const int per = (m + VERIFY_THREADS - 1) / VERIFY_THREADS;
    const int lo = min(tid * per, m), hi = min(lo + per, m);

    bool converged = m == 0;
    for (int round = 0; round < ROUNDS && !converged; round++) {
        int local = 0;
        for (int j = lo; j < hi; j++) local = max(local, L.exit[s0 + j]);
        int total;
        int run = block_exclusive(local, 0, MaxOp{}, warp_max, total);
        for (int j = lo; j < hi; j++) {
            L.entry[s0 + j] = run;
            run = max(run, L.exit[s0 + j]);
        }
        __syncthreads();
        bool changed = false;
        for (int j = lo; j < hi; j++) changed |= settle(L, s0 + j, j, L.entry[s0 + j], c, n, limit);
        converged = !__syncthreads_or(changed);
    }
    if (!converged) {  // the serial finish
        if (tid == 0) {
            int e = 0;
            for (int j = 0; j < m; j++) {
                L.entry[s0 + j] = e;
                settle(L, s0 + j, j, e, c, n, limit);
                e = L.exit[s0 + j];
            }
        }
        __syncthreads();
    }
    // each segment's part of the chain: its head, then its walk's tail
    const auto part = [&](long long s, long long& cnt, long long& bytes) {
        if (L.empty[s]) return;
        const int t = L.tail[s], nrec = L.nrec[s];
        cnt += L.nhead[s] + (nrec - t);
        bytes += L.hbytes[s] + (t < nrec ? L.tot[s] - L.cum[s * RCAP + t] : 0);
    };
    long long cnt = 0, bytes = 0;
    for (int j = lo; j < hi; j++) part(s0 + j, cnt, bytes);
    long long total_cnt, total_bytes;
    long long seq = block_exclusive(cnt, 0LL, SumOp{}, warp_sum, total_cnt);
    long long op = block_exclusive(bytes, 0LL, SumOp{}, warp_sum, total_bytes);
    for (int j = lo; j < hi; j++) {
        const long long s = s0 + j;
        L.seq_base[s] = seq;
        L.op_base[s] = op;
        part(s, seq, op);
    }
    if (tid == 0) {
        L.tot_seq[b] = total_cnt;
        L.tot_op[b] = total_bytes;
        L.first[b] = NO_FAILURE;
    }
}

// 4. a warp per segment: every sequence of the chain placed and checked
__global__ void __launch_bounds__(PLACE_WARPS * 32)
place_kernel(const int32_t* __restrict__ comp_len, const int32_t* __restrict__ prefix_len,
             long long limit, long long out_cap, Layout L) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long s = (long long)blockIdx.x * PLACE_WARPS + warp;
    if (s >= L.ns) return;
    const long long b = s / L.m;
    const int j = (int)(s % L.m);
    if ((long long)j * SEG >= comp_len[b] || L.empty[s]) return;
    const long long plen = prefix_len[b];
    const int nhead = L.nhead[s], t = L.tail[s], nrec = L.nrec[s];
    const long long* cum = L.cum + s * RCAP;
    const long long dense = b * L.nr;
    unsigned long long bad = NO_FAILURE;
    // the head's records, then the walk's from its tail, in stream order
    const long long tail_base = L.op_base[s] + L.hbytes[s] - (t < nrec ? cum[t] : 0);
    for (int r = lane; r < nhead + nrec - t; r += 32) {
        const bool in_head = r < nhead;
        const int4 q = in_head ? L.head[s * HEAD + r] : L.rec[s * RCAP + t + r - nhead];
        const long long op = in_head ? L.op_base[s] + L.hcum[s * HEAD + r]
                                     : tail_base + cum[t + r - nhead];
        const int code = q.w >> 16, offset = q.w & 0xFFFF;
        const int st = lz4t::check_seq(code, q.y, q.z, offset, op, plen, limit, out_cap);
        const long long i = L.seq_base[s] + r;
        const int lit_src = q.x + 1 + (q.y >= 15 ? (q.y - 15) / 255 + 1 : 0);
        L.d_op[dense + i] = (int)(op < INT_MAX ? op : INT_MAX);
        L.d_lit[dense + i] = q.y;
        L.d_src[dense + i] = lit_src;
        L.d_ml[dense + i] = q.z;
        L.d_off[dense + i] = offset;
        if (st != lz4t::OK && bad == NO_FAILURE) bad = ((unsigned long long)i << 3) | st;
    }
    // the lane's first failure is its earliest; the warp's earliest wins
    for (int d = 16; d; d >>= 1) {
        const unsigned long long o = __shfl_xor_sync(lz4t::FULL_MASK, bad, d);
        bad = o < bad ? o : bad;
    }
    if (lane == 0 && bad != NO_FAILURE) atomicMin(L.first + b, bad);
}

// the tile of output bytes of a thread block of the byte passes, and the
// block's output length; false past it
__device__ __forceinline__ bool tile_of(long long tiles, long long& b, int& p0, int& out_len,
                                        const int32_t* out_lens) {
    b = blockIdx.x / tiles;
    p0 = (int)(blockIdx.x % tiles) * TILE + 16 * threadIdx.x;
    out_len = out_lens[b];
    return p0 < out_len;
}

// 16 output bytes from p0 of one block: literals written, and the position
// every match byte reads; true if one reads output (not the prefix)
__device__ __forceinline__ bool scatter16(const uint8_t* c, uint8_t* o, long long out_stride,
                                          int* src, const Layout& L, long long dense,
                                          long long nvalid, int p0, int out_len) {
    const int* d_op = L.d_op + dense;
    // the last sequence that starts at or before p0
    long long lo = 0, hi = nvalid - 1;
    while (lo < hi) {
        const long long mid = (lo + hi + 1) >> 1;
        if (d_op[mid] <= p0) lo = mid;
        else hi = mid - 1;
    }
    long long i = lo;
    int op = d_op[i], lit = L.d_lit[dense + i], ml = L.d_ml[dense + i];
    int lit_src = L.d_src[dense + i], offset = L.d_off[dense + i];
    alignas(16) uint8_t bytes[16];
    alignas(16) int from[16];
    bool reads_output = false;
    const int count = min(16, out_len - p0);
#pragma unroll
    for (int k = 0; k < 16; k++) {
        bytes[k] = 0;
        from[k] = 0;
        if (k >= count) continue;
        const int p = p0 + k;
        while (i + 1 < nvalid && d_op[i + 1] <= p) {
            i++;
            op = d_op[i];
            lit = L.d_lit[dense + i];
            ml = L.d_ml[dense + i];
            lit_src = L.d_src[dense + i];
            offset = L.d_off[dense + i];
        }
        const int rel = p - op;
        if (rel < lit) {
            bytes[k] = c[lit_src + rel];
            from[k] = p;
        } else {
            const int jj = rel - lit;
            from[k] = op + lit - offset + (offset >= ml ? jj : jj % offset);
            reads_output |= from[k] >= 0;
        }
    }
    if (out_stride % 16 == 0 && p0 + 16 <= out_stride) {
        // bytes past out_len and match bytes stay zero until the gather
        *reinterpret_cast<uint4*>(o + p0) = *reinterpret_cast<const uint4*>(bytes);
    } else {
        for (int k = 0; k < count; k++) o[p0 + k] = bytes[k];
    }
    if (out_stride % 4 == 0 && count == 16) {
        int4* d = reinterpret_cast<int4*>(src + p0);
        for (int k = 0; k < 4; k++) d[k] = reinterpret_cast<const int4*>(from)[k];
    } else {
        for (int k = 0; k < count; k++) src[p0 + k] = from[k];
    }
    return reads_output;
}

// 5. literals written, and the position every match byte reads
__global__ void __launch_bounds__(TILE_THREADS)
scatter_kernel(const uint8_t* __restrict__ comp, long long comp_stride, uint8_t* out,
               long long out_stride, int32_t* __restrict__ out_lens,
               int32_t* __restrict__ status, long long tiles, Layout L) {
    const long long b = blockIdx.x / tiles;
    const unsigned long long first = L.first[b];
    const long long nvalid = first == NO_FAILURE ? L.tot_seq[b] : (long long)(first >> 3);
    const long long dense = b * L.nr;
    const int out_len = first == NO_FAILURE ? (int)L.tot_op[b] : L.d_op[dense + nvalid];
    if (blockIdx.x % tiles == 0 && threadIdx.x == 0) {
        out_lens[b] = out_len;
        status[b] = first == NO_FAILURE ? lz4t::OK : (int)(first & 7);
    }
    const int p0 = (int)(blockIdx.x % tiles) * TILE + 16 * threadIdx.x;
    bool reads_output = false;
    if (p0 < out_len) reads_output = scatter16(comp + b * comp_stride, out + b * out_stride,
                                               out_stride, L.src + b * out_stride, L, dense,
                                               nvalid, p0, out_len);
    // the tile waits for the doubling rounds if a match byte reads output
    const bool pending = __syncthreads_or(reads_output);
    if (threadIdx.x == 0) L.tile_round[blockIdx.x] = pending ? 0 : -1;
}

// 6. one round of pointer jumping, in place, over the tiles the last round
// left unresolved: every pointer read is a position its byte copies from,
// however far the round has moved it.  A thread takes 4 bytes, their hops
// in lockstep, so that the chains' loads overlap.
__global__ void __launch_bounds__(DOUBLE_THREADS)
double_kernel(const int32_t* __restrict__ out_lens, long long out_stride, long long tiles,
              int round, Layout L) {
    const long long parts = (out_stride + DOUBLE_SPAN - 1) / DOUBLE_SPAN;
    const long long b = blockIdx.x / parts;
    const int p0 = (int)(blockIdx.x % parts) * DOUBLE_SPAN + 4 * threadIdx.x;
    const long long tile = b * tiles + (p0 - 4 * (int)threadIdx.x) / TILE;
    // a sibling of this round may have marked the tile already (round)
    if (L.tile_round[tile] < round - 1) return;  // resolved
    const int out_len = out_lens[b];
    bool pending = false;
    if (p0 < out_len) {
        int* src = L.src + b * out_stride;
        const int count = min(4, out_len - p0);
        int v[4], first[4];
        bool live[4];
#pragma unroll
        for (int k = 0; k < 4; k++) {
            first[k] = v[k] = k < count ? src[p0 + k] : -1;
            live[k] = v[k] >= 0 && v[k] != p0 + k;  // not the prefix, not a literal
        }
#pragma unroll
        for (int h = 0; h <= HOPS; h++) {
#pragma unroll
            for (int k = 0; k < 4; k++) {
                if (!live[k]) continue;
                const int w = src[v[k]];
                if (w == v[k]) {  // a literal
                    live[k] = false;
                } else if (h < HOPS) {
                    v[k] = w;
                    live[k] = w >= 0;  // the prefix ends it
                }
            }
        }
#pragma unroll
        for (int k = 0; k < 4; k++) {
            if (v[k] != first[k]) src[p0 + k] = v[k];
            pending |= live[k];
        }
    }
    if (__syncthreads_or(pending) && threadIdx.x == 0) L.tile_round[tile] = round;
}

// 7. every match byte from its literal or prefix byte
__global__ void __launch_bounds__(TILE_THREADS)
gather_kernel(uint8_t* out, long long out_stride, const int32_t* __restrict__ out_lens,
              const uint8_t* __restrict__ prefix, long long prefix_stride,
              long long prefix_width, long long tiles, Layout L) {
    long long b;
    int p0, out_len;
    if (!tile_of(tiles, b, p0, out_len, out_lens)) return;
    const int* src = L.src + b * out_stride;
    uint8_t* o = out + b * out_stride;
    const uint8_t* pend = prefix + b * prefix_stride + prefix_width;
    const int count = min(16, out_len - p0);
    for (int k = 0; k < count; k++) {
        const int p = p0 + k;
        const int v = src[p];
        if (v != p) o[p] = v < 0 ? pend[v] : o[v];
    }
}

// blocks decoded together: as many as SCRATCH_BUDGET holds, at least one
inline int group_blocks(int nblocks, long long comp_stride, long long out_stride) {
    const long long one = layout(nullptr, 1, comp_stride, out_stride).bytes;
    const long long g = SCRATCH_BUDGET / one;
    return (int)(g < 1 ? 1 : g < nblocks ? g : nblocks);
}

// the launches of one group of blocks, on scratch laid out for it
cudaError_t decode_group(const uint8_t* c, long long comp_stride, const int32_t* cl,
                         const uint8_t* prefix, long long prefix_stride, long long prefix_width,
                         const int32_t* prefix_len, long long limit, uint8_t* out,
                         long long out_stride, int32_t* out_len, int32_t* status, int nblocks,
                         char* scratch, cudaStream_t st) {
    const Layout L = layout(scratch, nblocks, comp_stride, out_stride);
    const int rounds = doubling_rounds(out_stride);
    cudaError_t e;
    const long long warp_blocks = (L.ns + PLACE_WARPS - 1) / PLACE_WARPS;
    if (warp_blocks) {
        walk_kernel<<<L.ns, 32, 0, st>>>(c, comp_stride, cl, limit, L, false);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
        resync_kernel<<<(L.ns + 127) / 128, 128, 0, st>>>(c, comp_stride, cl, limit, L);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
        walk_kernel<<<L.ns, 32, 0, st>>>(c, comp_stride, cl, limit, L, true);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    verify_kernel<<<nblocks, VERIFY_THREADS, 0, st>>>(c, comp_stride, cl, limit, L);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (warp_blocks) {
        place_kernel<<<warp_blocks, PLACE_WARPS * 32, 0, st>>>(cl, prefix_len, limit, out_stride,
                                                              L);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    const long long tiles = tiles_of(out_stride);
    const long long grid = tiles * nblocks;
    const long long double_grid = (out_stride + DOUBLE_SPAN - 1) / DOUBLE_SPAN * nblocks;
    scatter_kernel<<<grid, TILE_THREADS, 0, st>>>(c, comp_stride, out, out_stride, out_len,
                                                  status, tiles, L);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    for (int r = 1; r <= rounds; r++) {
        double_kernel<<<double_grid, DOUBLE_THREADS, 0, st>>>(out_len, out_stride, tiles, r, L);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    gather_kernel<<<grid, TILE_THREADS, 0, st>>>(out, out_stride, out_len, prefix, prefix_stride,
                                                 prefix_width, tiles, L);
    return cudaGetLastError();
}

}  // namespace

// Blocks a group of lz4t_decode_v4 takes at once for a batch of this geometry.
extern "C" int lz4t_decode_v4_group(int nblocks, long long comp_stride, long long out_stride) {
    return nblocks > 0 ? group_blocks(nblocks, comp_stride, out_stride) : 0;
}

// Scratch bytes lz4t_decode_v4 needs for a batch of this geometry.
extern "C" long long lz4t_decode_v4_scratch(int nblocks, long long comp_stride,
                                            long long out_stride) {
    const int g = lz4t_decode_v4_group(nblocks, comp_stride, out_stride);
    return layout(nullptr, g, comp_stride, out_stride).bytes;
}

// Same arguments as lz4t_decode128, with the scratch buffer (at least
// lz4t_decode_v4_scratch bytes, 16-byte aligned) before the stream.
// Enqueues the launches on `stream`, a group of blocks after another, and
// returns the first CUDA error of the launches (0 on success).
extern "C" int lz4t_decode_v4(const void* comp, long long comp_stride, const void* comp_len,
                              const void* prefix, long long prefix_stride, long long prefix_width,
                              const void* prefix_len, long long limit, void* out,
                              long long out_stride, void* out_len, void* status, int nblocks,
                              void* scratch, long long scratch_bytes, void* stream) {
    if (nblocks <= 0) return 0;
    const int group = group_blocks(nblocks, comp_stride, out_stride);
    if (scratch_bytes < layout(nullptr, group, comp_stride, out_stride).bytes ||
        ((uintptr_t)scratch & 15))
        return (int)cudaErrorInvalidValue;
    for (int b0 = 0; b0 < nblocks; b0 += group) {
        const cudaError_t e = decode_group(
            (const uint8_t*)comp + b0 * comp_stride, comp_stride, (const int32_t*)comp_len + b0,
            (const uint8_t*)prefix + b0 * prefix_stride, prefix_stride, prefix_width,
            (const int32_t*)prefix_len + b0, limit, (uint8_t*)out + b0 * out_stride, out_stride,
            (int32_t*)out_len + b0, (int32_t*)status + b0,
            nblocks - b0 < group ? nblocks - b0 : group,
            (char*)scratch, (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
