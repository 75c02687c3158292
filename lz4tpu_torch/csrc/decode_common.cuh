// Shared sequence parser, batch walk and copy loops of the CUDA LZ4 block
// decoders (decode_v3.cu: one warp per block; decode_v4.cu: one thread block
// per block, serial parse; decode128.cu and decode_big.cu: one thread block
// per block, warp 0 walking the tokens 32 sequences at a time ahead of copy
// warps, through `parse_batch` below).  Semantics: reference
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

// Parse the sequence at `pos` given output position `op`.  Reads only
// bytes pos .. n-1 of the compressed stream, each through `comp(p)`: a
// plain pointer for the decoders that parse from device memory, a staged
// window with a fallback for the ones that read ahead into shared memory.
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

struct PtrReader {
    const uint8_t* __restrict__ p;
    __device__ __forceinline__ int operator()(long long i) const { return p[i]; }
};

__device__ __forceinline__ Seq parse_seq(const uint8_t* __restrict__ comp, long long n,
                                         long long pos, long long op, long long plen,
                                         long long limit, long long out_cap) {
    return parse_seq_with(PtrReader{comp}, n, pos, op, plen, limit, out_cap);
}

// literals: out[op + j] = comp[src + j], j = tid, tid + nthreads, ...
__device__ __forceinline__ void copy_literals(uint8_t* __restrict__ out,
                                              const uint8_t* __restrict__ comp, long long op,
                                              long long src, long long len, int tid,
                                              int nthreads) {
    for (long long j = tid; j < len; j += nthreads) out[op + j] = comp[src + j];
}

// match: out[op + j] = V[op - offset + (j mod offset)]
__device__ __forceinline__ void copy_match(uint8_t* out, const uint8_t* __restrict__ prefix_end,
                                           long long op, long long offset, long long len, int tid,
                                           int nthreads) {
    const long long base = op - offset;
    if (offset >= len) {
        for (long long j = tid; j < len; j += nthreads) {
            long long s = base + j;
            out[op + j] = s >= 0 ? out[s] : prefix_end[s];
        }
    } else {
        for (long long j = tid; j < len; j += nthreads) {
            long long s = base + j % offset;
            out[op + j] = s >= 0 ? out[s] : prefix_end[s];
        }
    }
}

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
