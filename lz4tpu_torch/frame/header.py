"""LZ4 frame descriptor: flag byte, block descriptor ("BD") byte, constants.

The port's own copy of the reference's ``src/framed/header.rs`` and
``src/framed/mod.rs:16-20``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .errors import (
    ReservedBdBitsSet,
    ReservedFlagBitsSet,
    UnimplementedBlocksize,
    UnsupportedVersion,
)

#: The four magic bytes at the start of every LZ4 frame (little-endian).
MAGIC = 0x184D2204
#: High bit of a block length field: block stored uncompressed.
INCOMPRESSIBLE = 1 << 31
#: The LZ4 raw format's lookback window (linked-block carry-over size).
WINDOW_SIZE = 64 * 1024

FLAG_INDEPENDENT_BLOCKS = 0b0010_0000
FLAG_BLOCK_CHECKSUMS = 0b0001_0000
FLAG_CONTENT_SIZE = 0b0000_1000
FLAG_CONTENT_CHECKSUM = 0b0000_0100
FLAG_DICTIONARY_ID = 0b0000_0001
_FLAG_RESERVED = 0b0000_0010

#: Valid block-maxsize codes: code c in 4..=7 -> 1 << (2c + 8) bytes
#: (64 KiB, 256 KiB, 1 MiB, 4 MiB) — ``header.rs:72-80``.
BLOCK_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


@dataclass(frozen=True)
class Flags:
    """Parsed FLG byte (``header.rs:8-49``)."""

    independent_blocks: bool = False
    block_checksums: bool = False
    content_size: bool = False
    content_checksum: bool = False
    dictionary_id: bool = False

    @classmethod
    def parse(cls, byte: int) -> "Flags":
        version = byte >> 6
        if version != 1:
            raise UnsupportedVersion(f"file version {version} not supported")
        if byte & _FLAG_RESERVED:
            raise ReservedFlagBitsSet("reserved bits in flags set")
        return cls(
            independent_blocks=bool(byte & FLAG_INDEPENDENT_BLOCKS),
            block_checksums=bool(byte & FLAG_BLOCK_CHECKSUMS),
            content_size=bool(byte & FLAG_CONTENT_SIZE),
            content_checksum=bool(byte & FLAG_CONTENT_CHECKSUM),
            dictionary_id=bool(byte & FLAG_DICTIONARY_ID),
        )

    def encode(self) -> int:
        byte = 1 << 6  # version
        if self.independent_blocks:
            byte |= FLAG_INDEPENDENT_BLOCKS
        if self.block_checksums:
            byte |= FLAG_BLOCK_CHECKSUMS
        if self.content_size:
            byte |= FLAG_CONTENT_SIZE
        if self.content_checksum:
            byte |= FLAG_CONTENT_CHECKSUM
        if self.dictionary_id:
            byte |= FLAG_DICTIONARY_ID
        return byte


@dataclass(frozen=True)
class BlockDescriptor:
    """The BD byte (``header.rs:51-81``)."""

    byte: int

    @classmethod
    def parse(cls, byte: int) -> "BlockDescriptor":
        if byte & 0b1000_1111:
            raise ReservedBdBitsSet("reserved bits in bd set")
        return cls(byte)

    @classmethod
    def for_block_maxsize(cls, block_maxsize: int) -> "BlockDescriptor | None":
        """Reproduces ``BlockDescriptor::new`` including its quirky
        round-trip validation: compute a candidate code from trailing
        zeros and accept only if it maps back to the requested size."""
        if block_maxsize <= 0:
            return None
        tz = (block_maxsize & -block_maxsize).bit_length() - 1
        code = max(tz - 8, 0) // 2
        if code not in BLOCK_SIZES or BLOCK_SIZES[code] != block_maxsize:
            return None
        return cls(code << 4)

    def block_maxsize(self) -> int:
        code = (self.byte >> 4) & 0b111
        if code not in BLOCK_SIZES:
            raise UnimplementedBlocksize(f"spec says blocksize code {code} is reserved")
        return BLOCK_SIZES[code]
