// lz4tpu_torch native engine: the host's LZ4 block codec and xxHash32.
//
// The port's own copy of the parts of lz4tpu/native/src/lz4_native.cpp
// that its frame layer and block API use, with the same semantics as the
// reference (greedy parse: src/raw/compress/mod.rs:147-260, decoder:
// src/raw/decompress.rs:28-138):
//  * xxHash32, one-shot and streaming, state in a caller-owned buffer;
//  * the greedy compressor on U32 and U16 encoder tables, the table
//    mutated in the caller's numpy array (also up to an abort at the cap);
//  * the high-compression parse (hash chains and lazy matching) of
//    lz4tpu_torch/spec/hc.py, byte for byte;
//  * the decoder, behind an optional prefix and under an output limit.
//
// Left out of the copy, because the port does that work elsewhere or has
// no use for it: lz4tpu's decode128 round model (model_rounds) and the
// decodebig window repack (repack_window), both layouts of the TPU's lane
// kernels; the lane-table priming walk (prime_tables), which the port does
// in kernels/compress128.py::prime_tables_packed; and tail_split with the
// stream splice, which kernels/splice.py does.
//
// Plain host C++ with a C interface, built by the host C++ compiler
// (lz4tpu_torch/native/build.py) and bound with ctypes
// (lz4tpu_torch/native/__init__.py).  Bit-exact parity with lz4tpu's
// native engine and with the port's plain versions is held by
// tests/test_torch_native.py.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

// ---------------------------------------------------------------------------
// xxHash32
// ---------------------------------------------------------------------------

static const u32 P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                 P4 = 668265263u, P5 = 374761393u;

static inline u32 rotl32(u32 x, int r) { return (x << r) | (x >> (32 - r)); }

static inline u32 read32(const u8* p) {
    u32 v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86-64, aarch64)
}
static inline u64 read64(const u8* p) {
    u64 v;
    std::memcpy(&v, p, 8);
    return v;
}

struct XXH32State {
    u32 v[4];
    u64 total;
    u32 buflen;
    u8 buf[16];
};

extern "C" int lz4t_xxh32_state_size() { return (int)sizeof(XXH32State); }

extern "C" void lz4t_xxh32_init(XXH32State* s, u32 seed) {
    s->v[0] = seed + P1 + P2;
    s->v[1] = seed + P2;
    s->v[2] = seed;
    s->v[3] = seed - P1;
    s->total = 0;
    s->buflen = 0;
}

static inline u32 xxh_round(u32 acc, u32 lane) {
    return rotl32(acc + lane * P2, 13) * P1;
}

extern "C" void lz4t_xxh32_update(XXH32State* s, const u8* data, u64 len) {
    s->total += len;
    if (s->buflen) {
        u64 need = 16 - s->buflen;
        u64 take = std::min(need, len);
        std::memcpy(s->buf + s->buflen, data, take);
        s->buflen += (u32)take;
        data += take;
        len -= take;
        if (s->buflen < 16) return;
        for (int i = 0; i < 4; i++) s->v[i] = xxh_round(s->v[i], read32(s->buf + 4 * i));
        s->buflen = 0;
    }
    u32 v0 = s->v[0], v1 = s->v[1], v2 = s->v[2], v3 = s->v[3];
    while (len >= 16) {
        v0 = xxh_round(v0, read32(data));
        v1 = xxh_round(v1, read32(data + 4));
        v2 = xxh_round(v2, read32(data + 8));
        v3 = xxh_round(v3, read32(data + 12));
        data += 16;
        len -= 16;
    }
    s->v[0] = v0; s->v[1] = v1; s->v[2] = v2; s->v[3] = v3;
    if (len) {
        std::memcpy(s->buf, data, len);
        s->buflen = (u32)len;
    }
}

extern "C" u32 lz4t_xxh32_digest(const XXH32State* s, u32 seed) {
    u32 h;
    if (s->total >= 16) {
        h = rotl32(s->v[0], 1) + rotl32(s->v[1], 7) + rotl32(s->v[2], 12) +
            rotl32(s->v[3], 18);
    } else {
        h = seed + P5;
    }
    h += (u32)s->total;
    const u8* p = s->buf;
    u32 rem = s->buflen;
    while (rem >= 4) {
        h = rotl32(h + read32(p) * P3, 17) * P4;
        p += 4;
        rem -= 4;
    }
    while (rem) {
        h = rotl32(h + (*p) * P5, 11) * P1;
        p++;
        rem--;
    }
    h ^= h >> 15;
    h *= P2;
    h ^= h >> 13;
    h *= P3;
    h ^= h >> 16;
    return h;
}

extern "C" u32 lz4t_xxh32(const u8* data, u64 len, u32 seed) {
    XXH32State s;
    lz4t_xxh32_init(&s, seed);
    lz4t_xxh32_update(&s, data, len);
    return lz4t_xxh32_digest(&s, seed);
}

// ---------------------------------------------------------------------------
// Raw block compressor
// ---------------------------------------------------------------------------

static const int HASHLOG = 12;
static const u64 MINMATCH = 4;
static const int SKIP_TRIGGER = 6;

// 5-byte hash of an LE u64 (spec/table.py hash_all_u32; positions with
// fewer than 8 readable bytes hash 0, as in the reference).
static inline u64 hash_u32t(const u8* in, u64 n, u64 off) {
    u64 v = (off + 8 <= n) ? read64(in + off) : 0;
    return ((v << 24) * 889523592379ULL) >> (64 - HASHLOG);
}
static inline u64 hash_u16t(const u8* in, u64 off) {
    return ((u64)(read32(in + off) * 2654435761u)) >> (32 - HASHLOG - 1);
}

struct U32TableRef {
    u32* slots;
    u64 offset;
    static const u64 kSlots = 1ull << HASHLOG;
    inline u64 replace(const u8* in, u64 n, u64 pos) {
        u64 h = hash_u32t(in, n, pos);
        u64 prev = slots[h];
        slots[h] = (u32)(pos + offset);
        return prev > offset ? prev - offset : 0;  // saturating
    }
};
struct U16TableRef {
    u16* slots;
    u64 offset;
    static const u64 kSlots = 2ull << HASHLOG;
    inline u64 replace(const u8* in, u64 /*n*/, u64 pos) {
        u64 h = hash_u16t(in, pos);
        u64 prev = slots[h];
        slots[h] = (u16)(pos + offset);
        return prev > offset ? prev - offset : 0;
    }
};

// Longest common prefix of in[a..a_end) and in[b..n), word-at-a-time.
static inline u64 count_matching(const u8* in, u64 a, u64 a_end, u64 b, u64 n) {
    u64 limit = std::min(a_end - a, n - b);
    u64 m = 0;
    while (m + 8 <= limit) {
        u64 x = read64(in + a + m) ^ read64(in + b + m);
        if (x) return m + (__builtin_ctzll(x) >> 3);
        m += 8;
    }
    while (m < limit && in[a + m] == in[b + m]) m++;
    return m;
}

// LSIC continuation bytes; returns bytes written (caller checked capacity).
static inline u64 lsic_tail(u8* out, u64 value) {
    if (value < 0xF) return 0;
    value -= 0xF;
    u64 k = value / 0xFF;
    std::memset(out, 0xFF, k);
    out[k] = (u8)(value % 0xFF);
    return k + 1;
}

// Greedy LZ4 parse (kernels/compress.py parse_plain).  Returns compressed
// length, or -1 when `cap` (>=0) would be exceeded — in which case the
// encoder table keeps all mutations up to the abort point (linked-mode
// bit-exactness; see spec/block.py Incompressible).
template <typename Table>
static i64 compress_impl(const u8* in, u64 n, u64 cursor, Table table_ref,
                         i64 cap, u64 acceleration,
                         u8* out, u64 out_capacity) {
    u64 out_pos = 0;
    const u64 init_cursor = cursor;
    u64 capu = cap < 0 ? ~0ull : (u64)cap;

    while (cursor < n) {
        const u64 literal_start = cursor;
        u64 step_counter = acceleration << SKIP_TRIGGER;
        u64 step = 1;
        u64 match_offset = 0, extra = 0;

        for (;;) {
            // tail guard: bail when the NEXT probe would pass n-11 — at
            // step==1 this is the reference's `n - cursor < 12`; at larger
            // steps it replicates C's `forwardIp > mflimitPlusOne` bail
            if (cursor + step + 11 > n) {  // end: literal-only tail
                u64 literal_len = n - literal_start;
                u64 group_len = 1 + (literal_len < 0xF ? 0 : (literal_len - 0xF) / 0xFF + 1) + literal_len;
                if (out_pos + group_len > capu || out_pos + group_len > out_capacity)
                    return -1;
                out[out_pos++] = (u8)(std::min<u64>(literal_len, 0xF) << 4);
                out_pos += lsic_tail(out + out_pos, literal_len);
                std::memcpy(out + out_pos, in + literal_start, literal_len);
                out_pos += literal_len;
                return (i64)out_pos;
            }

            u64 candidate = table_ref.replace(in, n, cursor);

            if (cursor != init_cursor && cursor - candidate <= 0xFFFF) {
                u64 matching = count_matching(in, cursor, n - 5, candidate, n);
                if (matching >= MINMATCH) {
                    extra = matching - MINMATCH;
                    match_offset = cursor - candidate;
                    // backtrack the match start into pending literals
                    u64 max_backtrack = cursor - literal_start;
                    u64 bt = 0;
                    while (bt < max_backtrack && candidate - bt > 0 &&
                           in[cursor - bt - 1] == in[candidate - bt - 1])
                        bt++;
                    extra += bt;
                    cursor += matching;
                    table_ref.replace(in, n, cursor - 2);
                    break;
                }
            }

            cursor += step;
            // step assignment lags one miss (C's forwardIp += step uses the
            // previous iteration's step): advances go 1, 1, a, a, ... —
            // byte-exact with LZ4_compress_fast for every acceleration
            if (literal_start + 1 != cursor) {
                step = step_counter >> SKIP_TRIGGER;
                step_counter++;
            }
        }

        const u64 literal_end = cursor - extra - MINMATCH;
        const u64 literal_len = literal_end - literal_start;
        const u64 group_len = 1 + (literal_len < 0xF ? 0 : (literal_len - 0xF) / 0xFF + 1) +
                              literal_len + 2 +
                              (extra < 0xF ? 0 : (extra - 0xF) / 0xFF + 1);
        if (out_pos + group_len > capu || out_pos + group_len > out_capacity) return -1;

        out[out_pos++] = (u8)((std::min<u64>(literal_len, 0xF) << 4) | std::min<u64>(extra, 0xF));
        out_pos += lsic_tail(out + out_pos, literal_len);
        std::memcpy(out + out_pos, in + literal_start, literal_len);
        out_pos += literal_len;
        out[out_pos++] = (u8)(match_offset & 0xFF);
        out[out_pos++] = (u8)(match_offset >> 8);
        out_pos += lsic_tail(out + out_pos, extra);
    }
    return (i64)out_pos;
}

extern "C" i64 lz4t_compress_block_u32(const u8* in, u64 n, u64 cursor, u32* table,
                              u64 table_offset, i64 cap, u64 acceleration,
                              u8* out, u64 out_capacity) {
    U32TableRef t{table, table_offset};
    return compress_impl(in, n, cursor, t, cap, acceleration, out, out_capacity);
}

extern "C" i64 lz4t_compress_block_u16(const u8* in, u64 n, u64 cursor, u16* table,
                              u64 table_offset, i64 cap, u64 acceleration,
                              u8* out, u64 out_capacity) {
    U16TableRef t{table, table_offset};
    return compress_impl(in, n, cursor, t, cap, acceleration, out, out_capacity);
}

// ---------------------------------------------------------------------------
// High-compression parse (hash-chain + lazy) — mirrors spec/hc.py exactly
// (differential-tested); see that module's docstring for the design.
// ---------------------------------------------------------------------------

static const int HASH_LOG_HC = 15;

static inline u32 hash4_hc(const u8* in, u64 pos) {
    return (read32(in + pos) * 2654435761u) >> (32 - HASH_LOG_HC);
}

struct HCState {
    std::vector<i64> head;  // hash -> last pos + 1 (0 = empty)
    std::vector<i64> prev;  // pos -> previous pos + 1 with same hash
    explicit HCState(u64 capacity)
        : head(1ull << HASH_LOG_HC, 0), prev(capacity, 0) {}
    inline void insert(const u8* in, u64 pos) {
        u32 h = hash4_hc(in, pos);
        prev[pos] = head[h];
        head[h] = (i64)pos + 1;
    }
};

extern "C" i64 lz4t_compress_block_hc(const u8* in, u64 n, u64 cursor,
                                        u64 level, i64 cap,
                                        u8* out, u64 out_capacity) {
    if (cursor >= n) return 0;
    u64 out_pos = 0;
    u64 capu = cap < 0 ? ~0ull : (u64)cap;

    HCState state(n);
    u64 hi = 0;  // positions [0, hi) are in the chains
    const u64 insert_limit = n >= MINMATCH - 1 ? n - (MINMATCH - 1) : 0;
    auto insert_up_to = [&](u64 q) {
        q = std::min(q, insert_limit);
        for (; hi < q; hi++) state.insert(in, hi);
    };
    insert_up_to(cursor);

    const u64 nb_attempts = std::min<u64>(1ull << (std::max<u64>(level, 2) - 1), 16384);
    const bool lazy = level >= 3;

    struct Best { u64 len, off, bt; };
    auto find_best = [&](u64 pos, u64 literal_start) -> Best {
        if (pos + 12 > n) return {0, 0, 0};
        Best best{0, 0, 0};
        i64 cand = state.prev[pos] - 1;  // skip the self entry at the head
        u64 tries = nb_attempts;
        u64 max_bt = pos - literal_start;
        while (cand >= 0 && tries > 0) {
            u64 off = pos - (u64)cand;
            if (off > 0xFFFF) break;  // chains are newest-first
            u64 fwd = count_matching(in, pos, n - 5, (u64)cand, n);
            if (fwd >= MINMATCH) {
                u64 bt = 0;
                while (bt < max_bt && (u64)cand - bt > 0 &&
                       in[pos - bt - 1] == in[(u64)cand - bt - 1])
                    bt++;
                if (fwd + bt > best.len) best = {fwd + bt, off, bt};
            }
            cand = state.prev[cand] - 1;
            tries--;
        }
        return best;
    };

    auto emit = [&](u64 literal_start, u64 literal_end, u64 offset, u64 extra) -> bool {
        u64 literal_len = literal_end - literal_start;
        u64 group_len = 1 + (literal_len < 0xF ? 0 : (literal_len - 0xF) / 0xFF + 1) +
                        literal_len + 2 + (extra < 0xF ? 0 : (extra - 0xF) / 0xFF + 1);
        if (out_pos + group_len > capu || out_pos + group_len > out_capacity)
            return false;
        out[out_pos++] = (u8)((std::min<u64>(literal_len, 0xF) << 4) |
                              std::min<u64>(extra, 0xF));
        out_pos += lsic_tail(out + out_pos, literal_len);
        std::memcpy(out + out_pos, in + literal_start, literal_len);
        out_pos += literal_len;
        out[out_pos++] = (u8)(offset & 0xFF);
        out[out_pos++] = (u8)(offset >> 8);
        out_pos += lsic_tail(out + out_pos, extra);
        return true;
    };

    u64 pos = cursor, literal_start = cursor;
    for (;;) {
        if (n - pos < 12) {  // literal-only tail
            u64 literal_len = n - literal_start;
            u64 group_len = 1 + (literal_len < 0xF ? 0 : (literal_len - 0xF) / 0xFF + 1) +
                            literal_len;
            if (out_pos + group_len > capu || out_pos + group_len > out_capacity)
                return -1;
            out[out_pos++] = (u8)(std::min<u64>(literal_len, 0xF) << 4);
            out_pos += lsic_tail(out + out_pos, literal_len);
            std::memcpy(out + out_pos, in + literal_start, literal_len);
            out_pos += literal_len;
            return (i64)out_pos;
        }
        insert_up_to(pos + 1);
        Best m = find_best(pos, literal_start);
        if (m.len == 0) { pos++; continue; }

        if (lazy && pos + 1 + 12 <= n) {
            insert_up_to(pos + 2);
            Best nx = find_best(pos + 1, literal_start);
            if (nx.len > m.len) { pos++; m = nx; }
        }
        u64 start = pos - m.bt;
        u64 end = pos + (m.len - m.bt);
        if (!emit(literal_start, start, m.off, m.len - MINMATCH)) return -1;
        insert_up_to(end);
        pos = end;
        literal_start = end;
    }
}

// ---------------------------------------------------------------------------
// Raw block decompressor
// ---------------------------------------------------------------------------

// error codes mirror spec/block.py DecodeError kinds
static const i64 ERR_UNEXPECTED_END = -1;
static const i64 ERR_MEMORY_LIMIT = -2;
static const i64 ERR_ZERO_OFFSET = -3;
static const i64 ERR_INVALID_OFFSET = -4;
static const i64 ERR_CAPACITY = -5;  // out buffer too small (caller bug)

// Overlap-aware backward copy: out[dst..dst+len) = out[dst-offset..), where
// the source may overlap the destination (pattern replication).  Uses a
// doubling span so even offset==1 runs in O(log len) memcpys.
static inline void copy_within(u8* out, u64 dst, u64 offset, u64 len) {
    if (offset >= len) {
        std::memcpy(out + dst, out + dst - offset, len);
        return;
    }
    u64 src = dst - offset;
    u64 avail = offset;
    u64 copied = 0;
    while (copied < len) {
        u64 chunk = std::min(avail, len - copied);
        std::memcpy(out + dst + copied, out + src, chunk);
        copied += chunk;
        avail += chunk;  // the pattern region just grew
    }
}

extern "C" i64 lz4t_decompress_block(const u8* in, u64 n, const u8* prefix, u64 prefix_len,
                            u8* out, u64 out_capacity, u64 output_limit) {
    u64 pos = 0, out_len = 0;
    while (pos < n) {
        u32 token = in[pos++];

        // literal length
        u64 literal_len = token >> 4;
        if (literal_len == 0xF) {
            for (;;) {
                if (pos >= n) return ERR_UNEXPECTED_END;
                u8 more = in[pos++];
                literal_len += more;
                if (more != 0xFF) break;
            }
        }
        if (pos + literal_len > n) return ERR_UNEXPECTED_END;
        if (out_len + literal_len > out_capacity) return ERR_CAPACITY;
        std::memcpy(out + out_len, in + pos, literal_len);
        out_len += literal_len;
        pos += literal_len;

        // a failed 2-byte offset read consumes nothing: with 1 byte left the
        // next iteration re-reads it as a token (as the reference's decoder does)
        if (n - pos < 2) continue;
        u64 offset = in[pos] | ((u64)in[pos + 1] << 8);
        pos += 2;
        u64 match_len = token & 0xF;
        if (match_len == 0xF) {
            for (;;) {
                if (pos >= n) return ERR_UNEXPECTED_END;
                u8 more = in[pos++];
                match_len += more;
                if (more != 0xFF) break;
            }
        }
        match_len += MINMATCH;
        if (out_len + match_len > output_limit) return ERR_MEMORY_LIMIT;
        if (out_len + match_len > out_capacity) return ERR_CAPACITY;

        if (offset == 0) return ERR_ZERO_OFFSET;
        if (offset > out_len) {
            // serve the head of the match from the prefix (dictionary /
            // linked-block carry-over window)
            u64 prefix_needed = offset - out_len;
            if (prefix_needed > prefix_len) return ERR_INVALID_OFFSET;
            u64 take = std::min(prefix_needed, match_len);
            std::memcpy(out + out_len, prefix + prefix_len - prefix_needed, take);
            out_len += take;
            u64 remaining = match_len - take;
            if (remaining) {
                if (offset > out_len) return ERR_INVALID_OFFSET;
                copy_within(out, out_len, offset, remaining);
                out_len += remaining;
            }
        } else {
            copy_within(out, out_len, offset, match_len);
            out_len += match_len;
        }
    }
    return (i64)out_len;
}
