"""Typed error hierarchy for the LZ4 frame layer (the port's own copy).

Mirrors the reference's error enums:

* header parse errors — reference ``src/framed/header.rs:18-28``
* frame compression errors — reference ``src/framed/compress.rs:15-23``
* frame decompression errors — reference ``src/framed/decompress.rs:16-36``

Decoding hostile input must fail with one of these, never crash or balloon
memory (the reference's explicit OOM-attack guard,
``raw/decompress.rs:53-57,72-74``).
"""

from __future__ import annotations


class LZ4Error(Exception):
    """Base class for every error this framework raises on bad data/config."""


class HeaderParseError(LZ4Error):
    """Invalid frame descriptor (``header.rs:18-28``)."""


class UnsupportedVersion(HeaderParseError):
    pass


class ReservedFlagBitsSet(HeaderParseError):
    pass


class ReservedBdBitsSet(HeaderParseError):
    pass


class UnimplementedBlocksize(HeaderParseError):
    pass


class CompressionError(LZ4Error):
    """Frame compression failure (``framed/compress.rs:15-23``)."""


class InvalidBlockSize(CompressionError):
    """Block size is not one of 64 KiB / 256 KiB / 1 MiB / 4 MiB."""


class DecompressionError(LZ4Error):
    """Frame decompression failure (``framed/decompress.rs:16-36``)."""


class WrongMagic(DecompressionError):
    pass


class HeaderChecksumFail(DecompressionError):
    pass


class BlockChecksumFail(DecompressionError):
    pass


class FrameChecksumFail(DecompressionError):
    pass


class BlockLengthOverflow(DecompressionError):
    pass


class BlockSizeOverflow(DecompressionError):
    pass


class InputTruncated(DecompressionError):
    """The underlying stream ended inside a frame structure."""


class CodecError(DecompressionError):
    """Raw-block decode failed; wraps a ``lz4tpu_torch.spec.block.DecodeError`` kind."""

    def __init__(self, kind: str):
        super().__init__(kind)
        self.kind = kind
