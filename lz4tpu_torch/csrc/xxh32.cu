// Host-side xxHash32 for the frame layer's block and content checksums.
//
// Not a kernel: plain host C++ that nvcc compiles into the same shared
// library as the CUDA kernels, so a run on the card checksums 200 MB of
// content in tens of milliseconds instead of the pure-Python version's
// minute.  A copy of the streaming xxHash32 of
// lz4tpu/native/src/lz4_native.cpp (state in a caller-owned buffer).

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u, P4 = 668265263u,
               P5 = 374761393u;

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only
}

inline uint32_t xxh_round(uint32_t acc, uint32_t lane) { return rotl32(acc + lane * P2, 13) * P1; }

struct XXH32State {
    uint32_t v[4];
    uint64_t total;
    uint32_t buflen;
    uint8_t buf[16];
};

}  // namespace

extern "C" int lz4t_xxh32_state_size() { return (int)sizeof(XXH32State); }

extern "C" void lz4t_xxh32_init(void* state, uint32_t seed) {
    XXH32State* s = (XXH32State*)state;
    s->v[0] = seed + P1 + P2;
    s->v[1] = seed + P2;
    s->v[2] = seed;
    s->v[3] = seed - P1;
    s->total = 0;
    s->buflen = 0;
}

extern "C" void lz4t_xxh32_update(void* state, const void* input, uint64_t len) {
    XXH32State* s = (XXH32State*)state;
    const uint8_t* data = (const uint8_t*)input;
    s->total += len;
    if (s->buflen) {
        uint64_t take = std::min<uint64_t>(16 - s->buflen, len);
        std::memcpy(s->buf + s->buflen, data, take);
        s->buflen += (uint32_t)take;
        data += take;
        len -= take;
        if (s->buflen < 16) return;
        for (int i = 0; i < 4; i++) s->v[i] = xxh_round(s->v[i], read32(s->buf + 4 * i));
        s->buflen = 0;
    }
    uint32_t v0 = s->v[0], v1 = s->v[1], v2 = s->v[2], v3 = s->v[3];
    while (len >= 16) {
        v0 = xxh_round(v0, read32(data));
        v1 = xxh_round(v1, read32(data + 4));
        v2 = xxh_round(v2, read32(data + 8));
        v3 = xxh_round(v3, read32(data + 12));
        data += 16;
        len -= 16;
    }
    s->v[0] = v0;
    s->v[1] = v1;
    s->v[2] = v2;
    s->v[3] = v3;
    if (len) {
        std::memcpy(s->buf, data, len);
        s->buflen = (uint32_t)len;
    }
}

extern "C" uint32_t lz4t_xxh32_digest(const void* state, uint32_t seed) {
    const XXH32State* s = (const XXH32State*)state;
    uint32_t h;
    if (s->total >= 16)
        h = rotl32(s->v[0], 1) + rotl32(s->v[1], 7) + rotl32(s->v[2], 12) + rotl32(s->v[3], 18);
    else
        h = seed + P5;
    h += (uint32_t)s->total;
    const uint8_t* p = s->buf;
    uint32_t rem = s->buflen;
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

extern "C" uint32_t lz4t_xxh32(const void* data, uint64_t len, uint32_t seed) {
    XXH32State s;
    lz4t_xxh32_init(&s, seed);
    lz4t_xxh32_update(&s, data, len);
    return lz4t_xxh32_digest(&s, seed);
}
