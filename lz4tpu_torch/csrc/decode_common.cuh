// Shared sequence parser, batch walk and stream windows of the CUDA LZ4
// block decoders (decode128.cu and decode_big.cu: one thread block per
// block, warp 0 walking the tokens 32 sequences at a time ahead of copy
// warps, through `parse_batch` below; decode_v3.cu: one warp per block on
// the same walk; decode_v4.cu: speculative walks of segments through
// `parse_shape`, the checks by `check_seq`).  Semantics: reference
// src/raw/decompress.rs:59-138, stated in the port's plain version
// (lz4tpu_torch/kernels/decode128.py decode_plain):
//
//  * token, LSIC literal length, literals; a block may end after literals,
//    and with exactly ONE byte left that byte is re-read as a token (the
//    u16 offset read fails and consumes nothing);
//  * u16 offset, LSIC match length + 4;
//  * the memory limit is checked only at matches, so literals may run past
//    output_limit by up to the compressed length;
//  * offset 0 is ERR_ZERO_OFFSET; an offset reaching before the prefix is
//    ERR_INVALID_OFFSET; the first failing check of a sequence wins.
//
// Addressing: V[s] is out[s] for s >= 0 and the right-aligned prefix byte
// prefix_end[s] for s < 0.  Byte j of a match with offset o that starts at
// op is V[op - o + (j mod o)]: the canonical byte-at-a-time overlap copy
// resolved in closed form, so every byte of a match reads only bytes that
// were written before the match began and the group copies it in parallel.

#pragma once

#include <cstdint>

namespace lz4t {

constexpr int32_t OK = 0;
constexpr int32_t ERR_UNEXPECTED_END = 1;
constexpr int32_t ERR_MEMORY_LIMIT = 2;
constexpr int32_t ERR_ZERO_OFFSET = 3;
constexpr int32_t ERR_INVALID_OFFSET = 4;

// one parsed sequence; lit_len/match_len are 0 when absent
struct Seq {
    long long next_pos;   // comp position after this sequence
    long long lit_src;    // comp position of the literals
    long long lit_len;
    long long match_len;  // 0: no match (block ends after literals)
    long long offset;
    int status;
};

// The shape of the sequence at `pos`: token, LSIC lengths, offset, and the
// structural results, all independent of the output position, so a walk
// can parse a stream from any position before it knows where its output
// goes (decode_v4.cu).  Reads only bytes pos .. n-1 of the compressed
// stream, each through `comp(p)`: a plain pointer for the decoders that
// parse from device memory, a staged window with a fallback for the ones
// that read ahead into shared memory.  The rest of a run of 0xFF length
// bytes is found by `comp.skip_ff` (16 bytes a step): a walk may land inside
// a huge match's length run.
constexpr int SHAPE_OK = 0;
constexpr int SHAPE_END_LITERALS = 1;  // the stream ends in the literal length or literals
constexpr int SHAPE_END_MATCH = 2;     // the stream ends in the match length run

struct Shape {
    long long next_pos;   // comp position after this sequence (SHAPE_OK)
    long long lit_src;    // comp position of the literals
    long long lit_len;
    long long match_len;  // 0: no match (block ends after literals)
    long long offset;
    int code;
};

template <class Reader>
__device__ __forceinline__ Shape parse_shape(const Reader& comp, long long n, long long pos) {
    Shape q;
    q.next_pos = 0;
    q.lit_src = 0;
    q.lit_len = 0;
    q.match_len = 0;
    q.offset = 0;
    q.code = SHAPE_OK;
    int token = comp(pos++);
    long long lit = token >> 4;
    if (lit == 0xF) {
        for (;;) {
            if (pos >= n) {
                q.code = SHAPE_END_LITERALS;
                return q;
            }
            int more = comp(pos++);
            lit += more;
            if (more != 0xFF) break;
            const long long run_end = comp.skip_ff(pos, n);  // the rest of a long run at once
            lit += 255 * (run_end - pos);
            pos = run_end;
        }
    }
    if (pos + lit > n) {
        q.code = SHAPE_END_LITERALS;
        return q;
    }
    q.lit_src = pos;
    q.lit_len = lit;
    pos += lit;
    if (n - pos < 2) {  // ends after literals (a stray byte re-reads as a token)
        q.next_pos = pos;
        return q;
    }
    q.offset = (long long)comp(pos) | ((long long)comp(pos + 1) << 8);
    pos += 2;
    long long ml = token & 0xF;
    if (ml == 0xF) {
        for (;;) {
            if (pos >= n) {
                q.code = SHAPE_END_MATCH;
                return q;
            }
            int more = comp(pos++);
            ml += more;
            if (more != 0xFF) break;
            const long long run_end = comp.skip_ff(pos, n);
            ml += 255 * (run_end - pos);
            pos = run_end;
        }
    }
    q.match_len = ml + 4;
    q.next_pos = pos;
    return q;
}

// The checks that depend on the output position `op`, interleaved with the
// shape's own results in parse_seq_with's order: literals running off the
// stream, output capacity, the match length running off the stream, the
// memory limit, a zero offset, an offset before the prefix.
__device__ __forceinline__ int check_seq(int code, long long lit_len, long long match_len,
                                         long long offset, long long op, long long plen,
                                         long long limit, long long out_cap) {
    if (code == SHAPE_END_LITERALS) return ERR_UNEXPECTED_END;
    // defensive: the wrappers size out_cap >= limit + comp length, which
    // every valid or invalid stream respects
    if (op + lit_len > out_cap) return ERR_MEMORY_LIMIT;
    if (code == SHAPE_END_MATCH) return ERR_UNEXPECTED_END;
    if (match_len == 0) return OK;  // ends after literals
    const long long mop = op + lit_len;
    if (mop + match_len > limit) return ERR_MEMORY_LIMIT;
    if (offset == 0) return ERR_ZERO_OFFSET;
    if (offset > mop + plen) return ERR_INVALID_OFFSET;
    return OK;
}

// Parse the sequence at `pos` given output position `op`: parse_shape and
// check_seq in one pass, each check made as soon as its inputs are read.
// It stays a pass of its own because the form built from the two halves
// made the single sequences of decode_big and decode128 11-14 % slower on
// one block, with or without parse_shape's 0xFF-run skip (the parser
// section of tools/torch_chip_decode_v4_cost.py); a change to either half
// changes this pass the same way.
template <class Reader>
__device__ __forceinline__ Seq parse_seq_with(const Reader& comp, long long n, long long pos,
                                              long long op, long long plen, long long limit,
                                              long long out_cap) {
    Seq q;
    q.lit_len = 0;
    q.match_len = 0;
    q.offset = 0;
    q.status = OK;
    int token = comp(pos++);
    long long lit = token >> 4;
    if (lit == 0xF) {
        for (;;) {
            if (pos >= n) {
                q.status = ERR_UNEXPECTED_END;
                return q;
            }
            int more = comp(pos++);
            lit += more;
            if (more != 0xFF) break;
        }
    }
    if (pos + lit > n) {
        q.status = ERR_UNEXPECTED_END;
        return q;
    }
    q.lit_src = pos;
    q.lit_len = lit;
    pos += lit;
    // defensive: the wrappers size out_cap >= limit + comp length, which
    // every valid or invalid stream respects
    if (op + lit > out_cap) {
        q.status = ERR_MEMORY_LIMIT;
        return q;
    }
    if (n - pos < 2) {  // ends after literals (a stray byte re-reads as a token)
        q.next_pos = pos;
        return q;
    }
    long long offset = (long long)comp(pos) | ((long long)comp(pos + 1) << 8);
    pos += 2;
    long long ml = token & 0xF;
    if (ml == 0xF) {
        for (;;) {
            if (pos >= n) {
                q.status = ERR_UNEXPECTED_END;
                return q;
            }
            int more = comp(pos++);
            ml += more;
            if (more != 0xFF) break;
        }
    }
    ml += 4;
    long long mop = op + lit;
    if (mop + ml > limit) {
        q.status = ERR_MEMORY_LIMIT;
        return q;
    }
    if (offset == 0) {
        q.status = ERR_ZERO_OFFSET;
        return q;
    }
    if (offset > mop + plen) {
        q.status = ERR_INVALID_OFFSET;
        return q;
    }
    q.offset = offset;
    q.match_len = ml;
    q.next_pos = pos;
    return q;
}

// the first position at or after p, below n, whose byte in device memory is
// not 0xFF (n if none): 16 bytes a step once aligned, so that a walk that
// lands in a long length run of a huge match does not read it a byte a time
__device__ __forceinline__ long long skip_ff_global(const uint8_t* __restrict__ g, long long p,
                                                    long long n) {
    for (; p < n && ((uintptr_t)(g + p) & 15); p++)
        if (__ldg(g + p) != 0xFF) return p;
    for (; p + 16 <= n; p += 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(g + p));
        if ((v.x & v.y & v.z & v.w) != 0xFFFFFFFFu) break;
    }
    for (; p < n; p++)
        if (__ldg(g + p) != 0xFF) return p;
    return n;
}

// a stream read straight from device memory, through the read-only cache
struct PtrReader {
    const uint8_t* __restrict__ p;
    __device__ __forceinline__ int operator()(long long i) const { return __ldg(p + i); }
    __device__ __forceinline__ long long skip_ff(long long i, long long n) const {
        return skip_ff_global(p, i, n);
    }
};

// ---------------------------------------------------------------------------
// The batch walk of decode128.cu and decode_big.cu: warp 0 parses up to 32
// sequences ahead of the copy warps, out of a window of the compressed stream
// staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int BATCH = 32;  // sequences parsed ahead per barrier: one a lane
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

struct Entry {
    int op, lit_src, lit_len, match_len, offset;
};

constexpr int FLAG_LAST = 1;  // the stream ends with this batch
constexpr int FLAG_LONG = 2;  // one sequence longer than the walk takes, alone

struct Batch {
    int count;           // sequences in e[]
    int next_pos;        // compressed position after them
    int end_op;          // output position after them
    int status;          // not OK: the sequence after them failed, decoding ends
    int flags;
    unsigned dependent;  // bit k: e[k]'s match reads what e[0..k) write
    Entry e[BATCH];
};

// the compressed stream: bytes [base, end) staged in shared memory, the
// rest read from device memory.  The window only moves forward and never
// past the oldest byte still to be read (the literals of the batch being
// copied), so no read is below `base` and one comparison decides.
struct Window {
    const uint8_t* c;  // the staged bytes, indexed by stream position
    const uint8_t* g;
    int base, end;
    __device__ __forceinline__ int operator()(long long p) const {
        const int i = (int)p;
        return i < end ? c[i] : g[i];
    }
    // the first position at or after p, below n, whose byte is not 0xFF
    __device__ __forceinline__ long long skip_ff(long long p, long long n) const {
        for (; p < end && ((uintptr_t)(c + p) & 3); p++)  // end <= n
            if (c[p] != 0xFF) return p;
        for (; p + 4 <= end; p += 4)
            if (*reinterpret_cast<const unsigned*>(c + p) != 0xFFFFFFFFu) break;
        for (; p < end; p++)
            if (c[p] != 0xFF) return p;
        return skip_ff_global(g, p, n);
    }
};

// stage comp[from .. from + want) into the window, NTHREADS threads; the
// window starts at the 16-byte boundary of device memory at or below `from`
template <int NTHREADS>
__device__ __forceinline__ void load_window(Window& w, uint8_t* win, int n, int from, int tid,
                                            int want) {
    const int skew = (int)((uintptr_t)(w.g + from) & 15);
    const int base = from - skew;  // may be as low as -15
    const int end = min(from + want, n);
    for (int p = base + 16 * tid; p < end; p += 16 * NTHREADS) {
        uint8_t* d = win + (p - base);
        if (p >= 0 && p + 16 <= n) {
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(w.g + p);
        } else {  // the row's first and last bytes
            for (int i = 0; i < 16; i++)
                if (p + i >= 0 && p + i < n) d[i] = w.g[p + i];
        }
    }
    w.c = win - base;
    w.base = base;
    w.end = end;
}

// load_window with the aligned 16-byte pieces issued as cp.async copies
// (the row's first and last bytes are stored at once): the window is
// staged only after cp_async_wait_all() and a barrier, so it can fill one
// buffer while the threads still read another
template <int NTHREADS>
__device__ __forceinline__ void load_window_async(Window& w, uint8_t* win, int n, int from,
                                                  int tid, int want) {
    const int skew = (int)((uintptr_t)(w.g + from) & 15);
    const int base = from - skew;
    const int end = min(from + want, n);
    for (int p = base + 16 * tid; p < end; p += 16 * NTHREADS) {
        uint8_t* d = win + (p - base);
        if (p >= 0 && p + 16 <= n) {
            const unsigned to = (unsigned)__cvta_generic_to_shared(d);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(w.g + p)
                         : "memory");
        } else {
            for (int i = 0; i < 16; i++)
                if (p + i >= 0 && p + i < n) d[i] = w.g[p + i];
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    w.c = win - base;
    w.base = base;
    w.end = end;
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lane 0 of warp 0: the batch of one sequence that the walk cannot take,
// from (pos, op), through the shared parser.  A batch with no sequence has
// FLAG_LAST or a failing status.
template <int SMALL>
__device__ void parse_single(Batch& bt, const Window& w, int n, int pos, int op, int plen,
                             long long limit, long long out_cap) {
    int count = 0, flags = 0, status = OK;
    if (pos >= n) {
        flags = FLAG_LAST;
    } else {
        const Seq s = parse_seq_with(w, n, pos, op, plen, limit, out_cap);
        if (s.status != OK) {
            status = s.status;
        } else {
            const int len = (int)(s.lit_len + s.match_len);
            if (len > SMALL) flags |= FLAG_LONG;
            bt.e[count++] =
                Entry{op, (int)s.lit_src, (int)s.lit_len, (int)s.match_len, (int)s.offset};
            pos = (int)s.next_pos;
            op += len;
            if (pos >= n) flags |= FLAG_LAST;
        }
    }
    bt.count = count;
    bt.next_pos = pos;
    bt.end_op = op;
    bt.status = status;
    bt.flags = flags;
    bt.dependent = 0;
}

// Warp 0: parse the next batch, from (pos, op).  A batch ends after 32
// sequences or once it holds BATCH_BYTES of output; a sequence longer than
// SMALL is a batch of its own (FLAG_LONG).
template <int BATCH_BYTES, int SMALL>
__device__ void parse_batch(Batch& bt, const Window& w, int n, int pos, int op, int plen,
                            long long limit, long long out_cap, int lane) {
    const int start_op = op, start_pos = pos;
    // The walk, the same in every lane: sequences that lie whole inside the
    // window with their offset (so the stream does not end inside them) and
    // are at most SMALL long.  Lane k keeps sequence k.
    const uint8_t* c = w.c;
    const int lim = w.end;
    int count = 0, bytes = 0;
    int my_src = 0, my_lit = 0, my_ml = 0;
    for (;;) {
        // the common sequence, both lengths in the token and all of it well
        // inside the window: the chain from one token to the next is this
        // load, a shift and an add, and one test decides whether it goes on
        while (count < BATCH && bytes < BATCH_BYTES && pos + 18 <= lim) {
            const int token = c[pos];
            const int lit = token >> 4, ml = (token & 0xF) + 4;
            if (lit == 0xF || ml == 0xF + 4) break;
            if (count == lane) {
                my_src = pos + 1;
                my_lit = lit;
                my_ml = ml;
            }
            count++;
            bytes += lit + ml;
            pos += lit + 3;
        }
        if (count >= BATCH || bytes >= BATCH_BYTES || pos >= lim) break;
        // any other sequence: length runs, or the window's end close by
        const int token = c[pos];
        int q = pos + 1;
        int lit = token >> 4;
        bool whole = true;
        if (lit == 0xF) {
            int more;
            do {
                if (q >= lim) {
                    whole = false;
                    break;
                }
                more = c[q++];
                lit += more;
            } while (more == 0xFF);
        }
        const int src = q;
        q += lit;
        if (!whole || q + 2 > lim) break;
        q += 2;
        int ml = token & 0xF;
        if (ml == 0xF) {
            int more;
            do {
                if (q >= lim) {
                    whole = false;
                    break;
                }
                more = c[q++];
                ml += more;
            } while (more == 0xFF);
        }
        ml += 4;
        if (!whole || lit + ml > SMALL) break;
        if (count == lane) {
            my_src = src;
            my_lit = lit;
            my_ml = ml;
        }
        count++;
        bytes += lit + ml;
        pos = q;
    }
    if (count == 0) {
        if (lane == 0) parse_single<SMALL>(bt, w, n, start_pos, start_op, plen, limit, out_cap);
        __syncwarp();
        return;
    }
    // Off the chain, lane k for sequence k: output position by a prefix sum,
    // offset, the checks of parse_seq_with in their order.
    const bool mine = lane < count;
    const int len = mine ? my_lit + my_ml : 0;
    int upto = len;
    for (int d = 1; d < 32; d <<= 1) {
        const int below = __shfl_up_sync(FULL_MASK, upto, d);
        if (lane >= d) upto += below;
    }
    const int my_op = start_op + upto - len;
    const long long mop = (long long)my_op + my_lit;
    int offset = 0, st = OK;
    if (mine) {
        const int at = my_src + my_lit;
        offset = c[at] | (c[at + 1] << 8);
        st = mop > out_cap || mop + my_ml > limit ? ERR_MEMORY_LIMIT
             : offset == 0                        ? ERR_ZERO_OFFSET
             : offset > mop + plen                ? ERR_INVALID_OFFSET
                                                  : OK;
    }
    // the first failing sequence ends the batch before it
    const unsigned bad = __ballot_sync(FULL_MASK, st != OK);
    int status = OK;
    int end_op = start_op + __shfl_sync(FULL_MASK, upto, 31);
    if (bad) {
        const int first = __ffs(bad) - 1;
        status = __shfl_sync(FULL_MASK, st, first);
        end_op = __shfl_sync(FULL_MASK, my_op, first);
        count = first;
    }
    // a match that reads what an earlier sequence of this batch writes waits
    // for it; its own literals it reads from the window
    bool waits = false;
    if (lane < count) {
        const int from = (int)mop - offset;
        const int upper = min(from + min(my_ml, offset), my_op);
        waits = from < my_op && upper > start_op;
        bt.e[lane] = Entry{my_op, my_src, my_lit, my_ml, offset};
    }
    const unsigned dependent = __ballot_sync(FULL_MASK, waits);
    if (lane == 0) {
        bt.count = count;
        bt.next_pos = pos;
        bt.end_op = end_op;
        bt.status = status;
        bt.flags = status == OK && pos >= n ? FLAG_LAST : 0;
        bt.dependent = dependent;
    }
    __syncwarp();
}

}  // namespace lz4t
