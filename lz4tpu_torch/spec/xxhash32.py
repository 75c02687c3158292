"""Pure-Python xxHash32 (seed 0 everywhere in the LZ4 frame format).

The LZ4 frame format uses xxHash32 in three places (reference
``src/framed/compress.rs:172,197,260``):

* frame-header checksum: ``(xxh32(header[4:]) >> 8) & 0xFF``
* optional per-block checksum over the block payload *as stored*
* optional content checksum over the decompressed frame content

This is the slow-but-obviously-correct version; ``utils.hashing`` picks
the C one built beside the CUDA kernels when the work runs on the card.
"""

from __future__ import annotations

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


class XXHash32:
    """Streaming xxHash32, mirroring twox-hash's ``XxHash32::with_seed(0)``.

    ``update`` may be called repeatedly; ``digest`` returns the hash of all
    bytes seen so far (does not reset).
    """

    def __init__(self, seed: int = 0):
        self.seed = seed & _M32
        self.v1 = (seed + _P1 + _P2) & _M32
        self.v2 = (seed + _P2) & _M32
        self.v3 = seed & _M32
        self.v4 = (seed - _P1) & _M32
        self.total_len = 0
        self._buf = bytearray()  # <16 leftover bytes

    def update(self, data) -> "XXHash32":
        data = bytes(data)
        self.total_len += len(data)
        buf = self._buf + data
        n_stripes = len(buf) // 16
        v1, v2, v3, v4 = self.v1, self.v2, self.v3, self.v4
        for i in range(n_stripes):
            s = buf[i * 16 : i * 16 + 16]
            l1 = int.from_bytes(s[0:4], "little")
            l2 = int.from_bytes(s[4:8], "little")
            l3 = int.from_bytes(s[8:12], "little")
            l4 = int.from_bytes(s[12:16], "little")
            v1 = (_rotl((v1 + l1 * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + l2 * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + l3 * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + l4 * _P2) & _M32, 13) * _P1) & _M32
        self.v1, self.v2, self.v3, self.v4 = v1, v2, v3, v4
        self._buf = bytearray(buf[n_stripes * 16 :])
        return self

    def digest(self) -> int:
        if self.total_len >= 16:
            h = (
                _rotl(self.v1, 1)
                + _rotl(self.v2, 7)
                + _rotl(self.v3, 12)
                + _rotl(self.v4, 18)
            ) & _M32
        else:
            h = (self.seed + _P5) & _M32
        h = (h + self.total_len) & _M32
        buf = self._buf
        i = 0
        while i + 4 <= len(buf):
            lane = int.from_bytes(buf[i : i + 4], "little")
            h = (_rotl((h + lane * _P3) & _M32, 17) * _P4) & _M32
            i += 4
        while i < len(buf):
            h = (_rotl((h + buf[i] * _P5) & _M32, 11) * _P1) & _M32
            i += 1
        h ^= h >> 15
        h = (h * _P2) & _M32
        h ^= h >> 13
        h = (h * _P3) & _M32
        h ^= h >> 16
        return h


def xxh32(data, seed: int = 0) -> int:
    """One-shot xxHash32 of ``data`` (bytes-like)."""
    return XXHash32(seed).update(data).digest()
