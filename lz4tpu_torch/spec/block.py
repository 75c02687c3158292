"""Raw LZ4 block format: constants and the typed errors of the codec.

The port's own copy of the error types of the reference's raw codec
(reference ``src/raw/decompress.rs:8-17`` and the ``NoPartialWrites``
writer of ``src/framed/compress.rs:285-314``), of the block-format
constants that the kernels and their plain versions share, and of the
LSIC writer of the host HC parse (``spec/hc.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .table import MINMATCH  # noqa: F401  (re-exported block constant)

SKIP_TRIGGER = 6  # every 64 misses the skip stride grows by one

# end-of-block rules (reference compress/mod.rs:178-195): the last 12 bytes
# are always emitted as literals, and the last 5 bytes may never be part of
# a match
LAST_LITERALS = 12
MFLIMIT = 5

# the part of a prefix (dictionary / linked window) that a block can
# address: offsets are u16
WINDOW_SIZE = 64 * 1024


def _write_lsic_tail(out: bytearray, value: int) -> None:
    """LSIC varint continuation bytes (reference ``compress/mod.rs:243-260``).

    The head (min(value, 15)) lives in the token; if it saturated, emit
    (value-15) as a run of 0xFF bytes plus a final byte < 0xFF.
    """
    if value < 0xF:
        return
    value -= 0xF
    out.extend(b"\xff" * (value // 0xFF))
    out.append(value % 0xFF)


def compress_bound(n: int) -> int:
    """Worst-case compressed size of ``n`` input bytes (every byte a
    literal, one LSIC continuation byte per 255 literals, plus a token)."""
    return n + n // 255 + 16


class BlockTooBig(ValueError):
    """Input exceeds the encoder table's payload size limit."""


class Incompressible(Exception):
    """Raised when output would exceed the caller's byte cap.

    Mirrors the reference's all-or-nothing writer: the frame layer caps
    compressed output at the raw input size and stores the block
    uncompressed on overflow.  The encoder table keeps all mutations made
    up to the abort point, which is what makes linked-mode blocks
    byte-exact.  Abort is checked per emitted group.
    """


@dataclass(frozen=True)
class DecodeError(Exception):
    """Typed decode failure, mirroring reference ``raw/decompress.rs:8-17``."""

    kind: str  # one of the KIND_* constants below

    KIND_UNEXPECTED_END = "unexpected_end"
    KIND_MEMORY_LIMIT = "memory_limit_exceeded"
    KIND_ZERO_OFFSET = "zero_deduplication_offset"
    KIND_INVALID_OFFSET = "invalid_deduplication_offset"

    def __str__(self) -> str:
        return f"DecodeError({self.kind})"
