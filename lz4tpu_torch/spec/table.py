"""Encoder hash tables — the match-finder state of the LZ4 greedy parser.

The port's own copy of the reference's ``EncoderTable`` trait and its two
implementations (reference ``src/raw/compress/mod.rs:19-101``):

* ``U32Table`` — 4096 (``1 << HASHLOG``) u32 slots, hashing 5 bytes out of a
  little-endian u64 read; payload limit 4 GiB.
* ``U16Table`` — 8192 u16 slots hashing a u32 read; payload limit 64 KiB.

The hash constants and shift amounts are load-bearing for byte-exact output
parity with the C implementation — changing any of them yields valid but
different LZ4 streams.  The CUDA compressor (``csrc/compress.cu``) and the
plain version in ``kernels/compress.py`` implement the same semantics.
"""

from __future__ import annotations

import numpy as np

HASHLOG = 12
DICTIONARY_SIZE = 1 << HASHLOG  # 4096
MINMATCH = 4

# (v << 24) * 889523592379 >> (64 - HASHLOG), little-endian u64 read.
HASH64_MUL = 889523592379
# v * 2654435761 >> (32 - HASHLOG - 1), little-endian u32 read.
HASH32_MUL = 2654435761

U32_SLOTS = DICTIONARY_SIZE
U16_SLOTS = DICTIONARY_SIZE * 2

_M32 = (1 << 32) - 1


def hash_all_u32(data: bytes) -> np.ndarray:
    """The U32 table's hash at every position of ``data``: 5 significant
    bytes of a little-endian u64 read; positions past ``len(data) - 8``
    hash a zero word (the reference's ``input.get(..8).unwrap_or(0)``)."""
    n = len(data)
    v = np.zeros(n, dtype=np.uint64)
    if n >= 8:
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
        words = np.lib.stride_tricks.sliding_window_view(buf, 8).astype(np.uint64)
        for b in range(8):
            v[: n - 7] |= words[:, b] << np.uint64(8 * b)
    with np.errstate(over="ignore"):
        h = ((v << np.uint64(24)) * np.uint64(HASH64_MUL)) >> np.uint64(64 - HASHLOG)
    return h.astype(np.int64)


def hash_all_u16(data: bytes) -> np.ndarray:
    """The U16 table's hash at every position of ``data``: a little-endian
    u32 read (bytes past the end read as zero; such positions are never
    probed)."""
    n = len(data)
    buf = np.zeros(n + 3, dtype=np.uint8)
    buf[:n] = np.frombuffer(bytes(data), dtype=np.uint8)
    v = np.zeros(n, dtype=np.uint64)
    for b in range(4):
        v |= buf[b : b + n].astype(np.uint64) << np.uint64(8 * b)
    h = ((v * np.uint64(HASH32_MUL)) & np.uint64(_M32)) >> np.uint64(32 - HASHLOG - 1)
    return h.astype(np.int64)


class U32Table:
    """4096-slot u32 encoder table (reference ``compress/mod.rs:28-76``).

    Slots hold stream coordinates; ``offset`` (moved by ``slide``) turns
    them into buffer coordinates with a saturating subtraction, which the
    kernel and its plain version apply at each probe.
    """

    payload_size_limit = _M32
    __slots__ = ("dict", "offset")

    def __init__(self):
        self.dict = np.zeros(U32_SLOTS, dtype=np.uint32)
        self.offset = 0

    def copy(self) -> "U32Table":
        t = U32Table.__new__(U32Table)
        t.dict = self.dict.copy()
        t.offset = self.offset
        return t

    def slide(self, amount: int) -> None:
        """Shift buffer coordinates by ``amount`` (window forgot that many bytes)."""
        self.offset += amount


class U16Table:
    """8192-slot u16 encoder table for payloads ≤ 64 KiB
    (reference ``compress/mod.rs:78-101``)."""

    payload_size_limit = 0xFFFF
    __slots__ = ("dict", "offset")

    def __init__(self):
        self.dict = np.zeros(U16_SLOTS, dtype=np.uint16)
        self.offset = 0

    def copy(self) -> "U16Table":
        t = U16Table.__new__(U16Table)
        t.dict = self.dict.copy()
        t.offset = self.offset
        return t

    def slide(self, amount: int) -> None:
        self.offset += amount


def prime_u32_table(table: U32Table, dict_bytes: bytes) -> None:
    """Dictionary priming: insert positions 0, 3, 6, … ≤ len-8 of the
    dictionary into the table (reference ``framed/compress.rs:202-214``).
    Later inserts overwrite earlier ones on hash collision, which NumPy
    fancy assignment reproduces (last index wins)."""
    n = len(dict_bytes)
    if n < 8:
        return
    positions = np.arange(0, n - 7, 3, dtype=np.uint32)
    h = hash_all_u32(dict_bytes)[positions.astype(np.int64)]
    table.dict[h] = positions + np.uint32(table.offset)
