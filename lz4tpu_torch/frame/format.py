"""The frame format's steps, each written once for every writer and reader.

A writer emits the header with ``frame_header`` and each block's length
word with ``block_word``.  A reader takes the block chain one block at a
time with ``read_block`` (the serial ``LZ4FrameReader.decode_block``) or
whole with ``scan_frame`` (the one-launch readers), with the streaming
reader's hostile-input checks in its order (reference
``framed/decompress.rs:197-244``): the length word, the maxsize check, the
payload, the checksum.
"""

from __future__ import annotations

from ..spec.xxhash32 import xxh32
from .errors import BlockSizeOverflow, InputTruncated
from .header import INCOMPRESSIBLE, MAGIC


def frame_header(flags, bd, content_size, dictionary_id) -> bytes:
    """The frame's header: magic, ``flags``, the block descriptor ``bd``,
    the content size and the dictionary id where they are not ``None``,
    and the header checksum."""
    header = bytearray(MAGIC.to_bytes(4, "little"))
    header.append(flags.encode())
    header.append(bd.byte)
    if content_size is not None:
        header.extend(int(content_size).to_bytes(8, "little"))
    if dictionary_id is not None:
        header.extend(int(dictionary_id).to_bytes(4, "little"))
    header.append((xxh32(header[4:]) >> 8) & 0xFF)
    return bytes(header)


def block_word(length: int, stored: bool) -> bytes:
    """A block's length word: its payload's ``length``, with the
    ``INCOMPRESSIBLE`` bit for a block stored raw."""
    return (length | (INCOMPRESSIBLE if stored else 0)).to_bytes(4, "little")


def read_exact(stream, n: int) -> bytes:
    """``n`` bytes of ``stream``, or ``InputTruncated``."""
    # read(n) may legally return fewer bytes before EOF, so loop like the
    # reference's read_exact
    parts = []
    got = 0
    while got < n:
        chunk = stream.read(n - got)
        if not chunk:
            raise InputTruncated(f"needed {n} bytes, got {got}")
        parts.append(chunk)
        got += len(chunk)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def read_checksum(stream, present: bool) -> int | None:
    """The checksum word at ``stream`` where the frame has one
    (``present``), else ``None``."""
    return int.from_bytes(read_exact(stream, 4), "little") if present else None


def read_block(stream, flags, block_maxsize: int):
    """The next block of the chain: ``(compressed, payload, checksum)``,
    the checksum ``None`` without block checksums, or ``None`` at the
    EndMark.  A length past ``block_maxsize`` raises ``BlockSizeOverflow``
    before its payload is read."""
    word = int.from_bytes(read_exact(stream, 4), "little")
    if word == 0:
        return None
    length = word & ~INCOMPRESSIBLE & 0xFFFFFFFF
    if length > block_maxsize:
        raise BlockSizeOverflow("a block is larger than the frame's block maxsize")
    payload = read_exact(stream, length)
    return (word & INCOMPRESSIBLE) == 0, payload, read_checksum(stream, flags.block_checksums)


def scan_frame(reader, blocks=None):
    """The block chain of ``reader`` (an ``LZ4FrameReader`` past its
    header) without decoding: [(compressed, payload, checksum)] and the
    trailer checksum.  The blocks are appended to ``blocks`` when given,
    so that the caller keeps those read before an error."""
    blocks = [] if blocks is None else blocks
    while (block := read_block(reader.reader, reader.flags, reader.block_maxsize)) is not None:
        blocks.append(block)
    return blocks, read_checksum(reader.reader, reader.flags.content_checksum)
