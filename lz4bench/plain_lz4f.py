"""The plain reference reader of LZ4 frames: a straightforward loop over
``bytes``, for the comparison that decides ``correct`` where a cell reads
frames whose content has no checksum, and for the tests.

It reads one frame in the order of the LZ4 frame format
(https://github.com/lz4/lz4/blob/v1.9.4/doc/lz4_Frame_format.md) and the
block format (``doc/lz4_Block_format.md``): the magic number, FLG and BD,
the header checksum (the second byte of the XXH32 of the descriptor, from
``liblz4.xxh32``); then each block's size word and its stored bit, its
sequences (a token, the literal length's extra bytes, the literals, a
2-byte offset, the match length's extra bytes, and a match copied byte by
byte, so that it may overlap its own output); in a frame of linked blocks
a match may reach up to 64 KiB back across the blocks before it; then the
end mark, and the content checksum where the frame has one.  Every block
is held to the frame's ``block_maxsize``.

It raises ``FrameError`` on a truncated frame, on a match offset of 0 or
past the bytes before the match (before the frame's first byte, or before
the block's in a frame of independent blocks), and on each check above.

Where it departs from the frame format: it reads one frame, with no
skippable frames around it and no bytes after it; a frame that names a
dictionary (``dictID``) is refused, since no caller of the benchmark
passes one; it does not enforce the block format's end-of-block
conditions (the last five bytes literals, the last match starting twelve
bytes before the end), which the C library's decoder does not check
either, apart from a block that ends on a match, which it refuses as
truncated.  Nothing here imports the program under test.
"""

from __future__ import annotations

from . import liblz4

MAGIC = 0x184D2204
WINDOW = 1 << 16
MAXSIZE = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


class FrameError(ValueError):
    """The frame is not a valid LZ4 frame."""


def _word(data: bytes, at: int, n: int) -> int:
    if at + n > len(data):
        raise FrameError("truncated frame")
    return int.from_bytes(data[at : at + n], "little")


def _length(src: bytes, at: int, n: int) -> tuple[int, int]:
    """A 4-bit length ``n`` and its extra bytes from ``src[at:]``: (length,
    position after them)."""
    if n == 15:
        while True:
            if at >= len(src):
                raise FrameError("truncated block")
            b = src[at]
            at += 1
            n += b
            if b != 255:
                break
    return n, at


def decode_block(src: bytes, out: bytearray, floor: int, limit: int) -> None:
    """Append the content of the compressed block ``src`` to ``out``; a
    match may reach back to ``out[floor]`` and no further; the block may
    decode to at most ``limit`` bytes."""
    start, at, end = len(out), 0, len(src)
    while True:
        if at >= end:
            raise FrameError("truncated block")
        token = src[at]
        lits, at = _length(src, at + 1, token >> 4)
        if at + lits > end:
            raise FrameError("truncated block")
        out += src[at : at + lits]
        at += lits
        if at == end:  # the last sequence: literals alone
            break
        if at + 2 > end:
            raise FrameError("truncated block")
        offset = src[at] | src[at + 1] << 8
        at += 2
        mlen, at = _length(src, at, token & 15)
        mlen += 4
        pos = len(out)
        if offset == 0:
            raise FrameError("match offset of 0")
        if pos - offset < floor:
            raise FrameError("match offset past the bytes before the match")
        if len(out) - start + mlen > limit:
            raise FrameError("block decodes past block_maxsize")
        if offset >= mlen:
            out += out[pos - offset : pos - offset + mlen]
        else:  # an overlapping copy repeats the last ``offset`` bytes
            period = out[pos - offset : pos]
            out += (period * (mlen // offset + 1))[:mlen]
        if at == end:
            raise FrameError("block ends on a match")
    if len(out) - start > limit:
        raise FrameError("block decodes past block_maxsize")


def decompress(frame: bytes) -> bytes:
    """The content of the one LZ4 frame ``frame``."""
    frame = bytes(frame)
    if _word(frame, 0, 4) != MAGIC:
        raise FrameError("not an LZ4 frame")
    flg, bd = _word(frame, 4, 1), _word(frame, 5, 1)
    if flg >> 6 != 1 or flg & 0x02 or bd & 0x8F or (bd >> 4) & 7 not in MAXSIZE:
        raise FrameError("unsupported frame descriptor")
    independent, block_sums = bool(flg & 0x20), bool(flg & 0x10)
    has_size, content_sum, has_dict = bool(flg & 0x08), bool(flg & 0x04), bool(flg & 0x01)
    maxsize = MAXSIZE[(bd >> 4) & 7]
    at = 6
    size = _word(frame, at, 8) if has_size else None
    at += 8 * has_size
    if has_dict:
        raise FrameError("a frame with a dictionary id")
    if (liblz4.xxh32(frame[4:at]) >> 8) & 0xFF != _word(frame, at, 1):
        raise FrameError("header checksum")
    at += 1
    out = bytearray()
    while True:
        word = _word(frame, at, 4)
        at += 4
        if word == 0:
            break
        n = word & 0x7FFFFFFF
        if n > maxsize:
            raise FrameError("block larger than block_maxsize")
        if at + n > len(frame):
            raise FrameError("truncated frame")
        payload = frame[at : at + n]
        at += n
        if block_sums:
            if liblz4.xxh32(payload) != _word(frame, at, 4):
                raise FrameError("block checksum")
            at += 4
        if word >> 31:
            out += payload
        else:
            decode_block(payload, out, len(out) if independent else 0, maxsize)
    if content_sum:
        if liblz4.xxh32(bytes(out)) != _word(frame, at, 4):
            raise FrameError("content checksum")
        at += 4
    if at != len(frame):
        raise FrameError("bytes after the frame")
    if size is not None and size != len(out):
        raise FrameError("content size")
    return bytes(out)
